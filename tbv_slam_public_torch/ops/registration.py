"""Sliding-window scan registration as batched Levenberg-Marquardt.

Port of ``tbv_slam_public_tpu.ops.registration``: the P2P, P2L and P2D
costs with all five robust losses, the time-continuous variant (a velocity
pre-pass over the source cells, then P2P), joint refinement of a whole
window, and the sampled and Ceres-style covariances.  Every function
carries a leading batch axis B: the reference ``jax.vmap``s over
loop-candidate pairs (and over the scans of a joint refinement), the port
writes that axis out, and odometry runs at B = 1.  ``fori_loop``s become
Python loops of fixed length whose updates are masked, so the iterate
trajectory is the reference's and the loop never waits on the device.

Cost convention (Ceres): total cost = 0.5 * sum_i w_i * rho(|r_i|^2).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import refmath as plain
from ..core import se2
from ..core.config import RegistrationConfig
from ..core.device import constant
from ..core.refmath import mul_ftz, recip
from ..core.types import Cells, RegistrationResult
from ..kernels import lm_solve as lm_kernel
from ..kernels import refmath
from ..kernels.refmath import ftz

COST_P2L = 0
COST_P2D = 1
COST_P2P = 2

DEFAULT_COV_DIAG = (0.1 ** 2, 0.1 ** 2, 0.01 ** 2)  # x, y [m^2], yaw [rad^2]

LOSS_NONE = 0
LOSS_HUBER = 1
LOSS_CAUCHY = 2
LOSS_SOFTLONE = 3
LOSS_TUKEY = 4
LOSS_COMBINED = 5

_COST_CODES = {"P2L": COST_P2L, "P2D": COST_P2D, "P2P": COST_P2P}
_LOSS_CODES = {"none": LOSS_NONE, "huber": LOSS_HUBER, "cauchy": LOSS_CAUCHY,
               "softlone": LOSS_SOFTLONE, "tukey": LOSS_TUKEY,
               "combined": LOSS_COMBINED}


def cost_code(name: str) -> int:
    return _COST_CODES[name.upper()]


def loss_code(name: str) -> int:
    return _LOSS_CODES[name.lower()]


@dataclass
class Associations:
    """Per (target scan, source cell) association, fixed during LM."""

    tgt_mean_w: torch.Tensor  # [B, T, C, 2] world-frame target mean
    tgt_normal_w: torch.Tensor  # [B, T, C, 2] world-frame target normal
    weight: torch.Tensor  # [B, T, C] association (similarity) weight
    mask: torch.Tensor  # [B, T, C] bool
    # [B, T, C, 2, 2] P2D sqrt-information; None for P2P and P2L, whose
    # residuals are not whitened (the reference stores the identity)
    tgt_sqrtinfo: Optional[torch.Tensor] = None

    def repeat(self, s: int) -> "Associations":
        """Repeat every batch row s times (row b -> rows b*s .. b*s+s-1)."""
        r = lambda x: None if x is None else x.repeat_interleave(s, dim=0)
        return Associations(r(self.tgt_mean_w), r(self.tgt_normal_w),
                            r(self.weight), r(self.mask),
                            r(self.tgt_sqrtinfo))


def _similarity(x, y):
    """2*min/(x+y) similarity (registration.h:96)."""
    return 2.0 * torch.minimum(x, y) / torch.clamp(x + y, min=1e-12)


def _rho_and_weight(s: torch.Tensor, loss: int, delta: float):
    """Robust loss rho(s) on squared residuals and IRLS weight rho'(s)."""
    if loss == LOSS_HUBER:
        sqrt_s = refmath.sqrt(torch.clamp(s, min=1e-20))
        inside = s <= delta * delta
        # 2 delta sqrt(s) - delta^2 as one fused multiply-add, as the
        # reference's program computes it
        rho = torch.where(inside, s, refmath.fma(
            sqrt_s, torch.full_like(s, 2.0 * delta),
            torch.full_like(s, -(delta * delta))))
        # delta / sqrt(s) divided once (a number over a tensor is its
        # reciprocal times the number in torch)
        w = torch.where(inside, torch.ones_like(s),
                        torch.full_like(s, delta) / sqrt_s)
        return rho, w
    if loss == LOSS_CAUCHY:
        # s / b is a product by the reciprocal, fused into 1 + s / b; a
        # subnormal weight (s near the float32 maximum) is zero, as the
        # reference's threads flush it
        b = delta * delta
        s_b = s * recip(b)
        return b * refmath.log1p(s_b), ftz(1.0 / refmath.fma(
            s, torch.full_like(s, recip(b)), torch.ones_like(s)))
    if loss == LOSS_SOFTLONE:
        # s / b a product by the reciprocal, fused into 1 + s / b; 2 b folded
        # into one constant
        b = delta * delta
        one = torch.ones_like(s)
        t = refmath.sqrt(refmath.fma(s, torch.full_like(s, recip(b)), one))
        return (t - 1.0) * (2.0 * b), 1.0 / t
    if loss == LOSS_TUKEY:
        # 1 - s / b and 1 - u^3 = 1 - u (u u) each one fused multiply-add,
        # b / 3 folded into one constant
        b = delta * delta
        one = torch.ones_like(s)
        u = torch.clamp(refmath.fma(-s, torch.full_like(s, recip(b)), one),
                        min=0.0)
        u2 = u * u
        return refmath.fma(-u, u2, one) * (b / 3.0), u2
    if loss == LOSS_COMBINED:
        # Huber(1) o Cauchy(1); IRLS weight by the chain rule, its
        # subnormal factor and product flushed as the reference's threads do
        g = refmath.log1p(s)
        gp = ftz(1.0 / (1.0 + s))
        sqrt_g = refmath.sqrt(torch.clamp(g, min=1e-20))
        rho = torch.where(g <= 1.0, g, 2.0 * sqrt_g - 1.0)
        fp = torch.where(g <= 1.0, torch.ones_like(g), 1.0 / sqrt_g)
        return rho, ftz(fp * gp)
    return s, torch.ones_like(s)


def _chol2x2_inv_sqrt(m: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with U^T U = M^{-1}, for batched 2x2 SPD M: the
    P2D Mahalanobis whitening, r = U e gives r^T r = e^T M^{-1} e."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]
    # rounded as the reference's program: a*c - b*b with a*c fused, and
    # u12 = (-b / det) / u22 rewritten as -b / (det * u22)
    det = torch.clamp(refmath.fma(a, c, -(b * b)), min=1e-20)
    # M^{-1} = [[c, -b], [-b, a]] / det; its Cholesky factor, upper form
    ia, ic = c / det, a / det
    u22 = refmath.sqrt(torch.clamp(ic, min=1e-20))
    u12 = -b / (det * u22)
    u11 = refmath.sqrt(torch.clamp(refmath.fma(-u12, u12, ia), min=1e-20))
    return torch.stack([torch.stack([u11, u12], -1),
                        torch.stack([torch.zeros_like(u11), u22], -1)], -2)


def associate(src: Cells, src_pose: torch.Tensor, tgt_mean_w: torch.Tensor,
              tgt_normal_w: torch.Tensor, tgt_cov_w: Optional[torch.Tensor],
              tgt_nsamples: torch.Tensor, tgt_planarity: torch.Tensor,
              tgt_valid: torch.Tensor, radius: float, *, weight_option: int,
              cost: int, regularization: float, cov_scale: float,
              angle_gate_cos: float) -> Associations:
    """Top-1 NN association of the source cells [B, C] into each target scan
    [B, T, Ct]: nearest valid target cell within ``radius`` whose normal
    agrees within the angle gate; weights from (nsamples, normal direction,
    planarity) similarities (n_scan_normal.cpp:224-261).  For P2D the
    winner's world-frame covariance ``tgt_cov_w`` [B, T, Ct, 2, 2] gives the
    whitening of its residual; other costs may pass None."""
    src_mean_w = se2.apply(src_pose, src.mean)  # [B, C, 2]
    src_normal_w = se2.rotate(src_pose, src.normal)

    def sqdist(d):
        # rounded as the reference's program: a two-term sum of squares is
        # fma(dy, dy, dx * dx), its operands (a subnormal offset's square
        # is below them) and its result flushed where subnormal (its
        # threads run with DAZ and FTZ), so two subnormal distances tie at
        # zero and the first target wins
        return refmath.fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])

    d2 = sqdist(src_mean_w[:, None, :, None, :]
                - tgt_mean_w[:, :, None, :, :])  # [B, T, C, Ct]
    d2 = torch.where(tgt_valid[:, :, None, :], d2,
                     torch.full((), math.inf, device=d2.device))
    nn = torch.argmin(d2, dim=-1)  # [B, T, C]

    def fetch(x):  # winner attribute, [B, T, Ct, ...] -> [B, T, C, ...]
        idx = nn.reshape(nn.shape + (1,) * (x.ndim - 3))
        return torch.gather(x, 2, idx.expand(nn.shape + x.shape[3:]))

    # the reference fetches the winner's attributes with a one-hot product,
    # which reads a subnormal attribute as zero
    nn_mean = ftz(fetch(tgt_mean_w))
    nn_normal = ftz(fetch(tgt_normal_w))
    n_tgt = fetch(tgt_nsamples)
    plan_tgt = fetch(tgt_planarity)
    nn_valid = fetch(tgt_valid)
    in_radius = (sqdist(src_mean_w[:, None] - nn_mean)
                 < plain.f32_ftz(radius * radius)) & nn_valid
    # the normals' agreement as two rounded products and their sum, each
    # flushed where subnormal (the reference's associate compiled alone
    # fuses this sum too; fused here it moves a P2D trajectory past its
    # held bound through a guard flip, so it waits for the LM sums' order,
    # ROADMAP.md section 3)
    prod = ftz(src_normal_w[:, None] * nn_normal)
    dir_sim = torch.clamp(ftz(prod[..., 0] + prod[..., 1]), min=0.0)
    ok = in_radius & (dir_sim > angle_gate_cos) & src.valid[:, None]
    sim_n = _similarity(src.nsamples[:, None], n_tgt)
    sim_plan = _similarity(src.planarity[:, None], plan_tgt)
    if weight_option == 0:
        w = torch.ones_like(dir_sim)
    elif weight_option == 1:
        w = sim_n
    elif weight_option == 2:
        w = dir_sim
    elif weight_option == 3:
        w = sim_plan
    else:  # combined weights (registration.cpp:73)
        w = sim_n + dir_sim + sim_plan
    sqrtinfo = None
    if cost == COST_P2D:
        eye = constant(((1.0, 0.0), (0.0, 1.0)), nn_mean.dtype,
                       nn_mean.device)
        sqrtinfo = _chol2x2_inv_sqrt(
            (regularization * eye + fetch(tgt_cov_w)) * cov_scale)
    return Associations(tgt_mean_w=nn_mean, tgt_normal_w=nn_normal,
                        weight=torch.where(ok, w, torch.zeros_like(w)),
                        mask=ok, tgt_sqrtinfo=sqrtinfo)


def _residual_terms(theta: torch.Tensor, src: Cells, assoc: Associations,
                    cost: int):
    """Residuals r [B,T,C,R], jacobians J [B,T,C,R,3] wrt (x, y, theta) and
    squared norms [B,T,C]."""
    # rounded as the reference's program: each sum's first product fused
    # into it, a two-term reduction as fma(second, second, first product);
    # subnormal operands and every subnormal product and sum flushed, as
    # the reference's threads flush them (DAZ and FTZ: refmath.fma flushes
    # its operands and result, the first products are flushed by their
    # exact value (mul), ftz the rest)
    fma = refmath.fma
    mul = refmath.mul  # a lone product of flushed operands
    s, c = refmath.sincos(theta[:, 2:3])
    # sinf returns a subnormal theta unchanged; every product reads it as
    # zero (DAZ)
    s = ftz(s)
    ux, uy = ftz(src.mean[..., 0]), ftz(src.mean[..., 1])  # [B, C]
    dy = fma(c, ux, -mul(s, uy))  # c ux - s uy
    wx = ftz(dy + theta[:, 0:1])
    wy = ftz(fma(s, ux, mul(c, uy)) + theta[:, 1:2])
    dx = fma(-s, ux, -mul(c, uy))  # -s ux - c uy
    e = ftz(torch.stack([wx, wy], -1)[:, None]
            - ftz(assoc.tgt_mean_w))  # [B,T,C,2]
    if cost == COST_P2L:
        n = ftz(assoc.tgt_normal_w)
        r = fma(n[..., 1], e[..., 1], mul(n[..., 0], e[..., 0]))[
            ..., None]
        J = torch.stack([n[..., 0], n[..., 1],
                         fma(n[..., 0], dx[:, None],
                             mul(n[..., 1], dy[:, None]))],
                        -1)[..., None, :]
        return r, J, ftz(r[..., 0] * r[..., 0])
    ones, zeros = torch.ones_like(dx), torch.zeros_like(dx)
    Jp = torch.stack([torch.stack([ones, zeros, dx], -1),
                      torch.stack([zeros, ones, dy], -1)], -2)
    if cost == COST_P2D:  # whitened by the target's sqrt-information
        u = ftz(assoc.tgt_sqrtinfo)
        r = fma(u[..., 1], e[..., None, 1], mul(u[..., 0], e[..., None, 0]))
        J = fma(u[..., 1:2], Jp[:, None, :, None, 1],
                mul(u[..., 0:1], Jp[:, None, :, None, 0]))
    else:  # P2P
        r = e
        J = Jp[:, None].expand(e.shape[:3] + (2, 3))
    return r, J, fma(r[..., 1], r[..., 1], r[..., 0] * r[..., 0])


def _prior_terms(theta, prior):
    """The motion prior's (cost, g, H) [B], [B, 3], [B, 3, 3]: pr =
    sqrt_info (theta - guess) pw, 0.5 |pr|^2, Jp^T pr and Jp^T Jp with Jp =
    sqrt_info pw, each sum one fused multiply-add a term in order from zero,
    as the reference's program adds them (not a library product, whose
    order is the library's)."""
    guess, sqrt_info, pw = prior  # [B,3], [3,3], [B]
    fma = refmath.fma
    d = theta - guess
    pr = torch.zeros_like(d)
    for k in range(3):
        pr = fma(d[:, k:k + 1], sqrt_info[:, k].expand_as(d), pr)
    pr = pr * pw[:, None]
    jp = sqrt_info[None] * pw[:, None, None]  # [B, 3, 3]
    cost = torch.zeros_like(pw)
    g = torch.zeros_like(d)
    h = torch.zeros_like(jp)
    for k in range(3):
        cost = fma(pr[:, k], pr[:, k], cost)
        g = fma(jp[:, k], pr[:, k:k + 1].expand_as(d), g)
        h = fma(jp[:, k, :, None].expand_as(jp), jp[:, k, None, :]
                .expand_as(jp), h)
    return 0.5 * cost, g, h


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis of [..., N] in one fixed order, pairwise:
    the row is padded with zeros to a power of two, then each even element
    is added to the odd one after it, until one value is left.  An
    elementwise add rounds alike whatever the leading (batch) sizes and the
    device, so a row of a batch sums as its own solve does, on the card as
    on the CPU; a library reduction or matrix product picks its blocking
    from the shape (torch's reduction split, cuBLAS's batched GEMM)."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _cost_grad_hess(theta, src, assoc, *, cost, loss, delta, prior=None):
    r, J, sq = _residual_terms(theta, src, assoc, cost)
    rho, w_irls = _rho_and_weight(sq, loss, delta)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    bsz = rho.shape[0]
    wt = ftz(assoc.weight)
    # H and g from one contraction J^T [J | r], summed over the residuals
    # of each row by ``_row_sums``: a row of a batch must equal its own solve;
    # each product flushed where its exact value rounded with an unbounded
    # exponent is below 2^-126, as the reference's threads (DAZ and FTZ)
    # and the kernel's .ftz products flush it (``mul_ftz``; the refmath op
    # ``mul`` on the card: its operands here are flushed already)
    mul = refmath.mul
    w = torch.where(assoc.mask, mul(wt, ftz(w_irls)), zero)
    Jr = torch.cat([J, r[..., None]], -1)  # [B, T, C, R, 4]
    terms = mul(mul(w[..., None, None, None], J[..., :, None]),
                Jr[..., None, :])  # [B, T, C, R, 3, 4]
    # the cost joins the same sum as a 13th row, each association's term at
    # its first residual and zeros at the others (R <= 2: the first level of
    # the pairwise tree adds them exactly, so it is the cost's own tree)
    wrho = torch.where(assoc.mask, mul(wt, ftz(rho)), zero)  # [B, T, C]
    cost_row = torch.nn.functional.pad(wrho[..., None], (0, r.shape[-1] - 1))
    sums = _row_sums(torch.cat([cost_row.reshape(bsz, 1, -1),
                                terms.reshape(bsz, -1, 12).transpose(1, 2)],
                               1))
    total = mul_ftz(0.5, sums[:, 0])
    H, g = sums[:, 1:].reshape(bsz, 3, 4).split([3, 1], -1)
    g = g[..., 0]
    if prior is not None:
        p_cost, p_g, p_h = _prior_terms(theta, prior)
        total, g, H = total + p_cost, g + p_g, H + p_h
    return total, g, H


def _cost_only(theta, src, assoc, *, cost, loss, delta, prior=None):
    _, _, sq = _residual_terms(theta, src, assoc, cost)
    rho, _ = _rho_and_weight(sq, loss, delta)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    c = mul_ftz(0.5, _row_sums(torch.where(
        assoc.mask, refmath.mul(ftz(assoc.weight), ftz(rho)),
        zero).reshape(rho.shape[0], -1)))
    if prior is not None:
        c = c + _prior_terms(theta, prior)[0]
    return c


def _lm_solve(theta0, src, assoc, *, cost, loss, delta, max_iter, init_lambda,
              prior=None, one_system=False):
    """Fixed-iteration 3-DoF LM with accept/reject damping, one residual
    pass per iteration; returns (theta, cost, last relative decrease).
    ``one_system``: the step rounded as the reference's unbatched odometry
    step rounds it (``refmath.lm_update``).  CPU tensors take the plain
    version, CUDA tensors one launch of ``csrc/lm_solve.cu``'s solve entry
    (``register_window``'s device code with association and guards off),
    which is bit-equal to it."""
    kw = dict(cost=cost, loss=loss, delta=delta, max_iter=max_iter,
              init_lambda=init_lambda, prior=prior, one_system=one_system)
    if theta0.device.type == "cpu" or lm_kernel.plain_on_card_enabled():
        return _lm_solve_reference(theta0, src, assoc, **kw)
    return lm_kernel.lm_solve(theta0, src.mean, assoc.tgt_mean_w,
                              assoc.tgt_normal_w, assoc.weight, assoc.mask,
                              assoc.tgt_sqrtinfo, **kw)


def _lm_solve_reference(theta0, src, assoc, *, cost, loss, delta, max_iter,
                        init_lambda, prior=None, one_system=False):
    """The plain version of ``_lm_solve`` (and of its kernel): on CPU
    tensors, or on CUDA tensors inside ``kernels.lm_solve.plain_on_card``
    only."""
    if theta0.device.type != "cpu" and \
            not lm_kernel.plain_on_card_enabled():
        raise RuntimeError("the plain LM solve runs on the CPU; on "
                           f"{theta0.device} it is the kernel's")
    kw = dict(cost=cost, loss=loss, delta=delta, prior=prior)
    cur_cost, g, H = _cost_grad_hess(theta0, src, assoc, **kw)
    theta = theta0
    lam = torch.full_like(cur_cost, init_lambda)
    rel_dec = torch.ones_like(cur_cost)
    for _ in range(max_iter):
        # lam diag(H) + 1e-12 I, the product fused into the add as the
        # reference's program rounds it
        damp = torch.diag_embed(refmath.fma(
            lam[:, None], torch.diagonal(H, dim1=-2, dim2=-1),
            torch.full_like(g, 1e-12)))
        cand = refmath.lm_update(theta, H + damp, g, one_system=one_system)
        cand_cost, cand_g, cand_H = _cost_grad_hess(cand, src, assoc, **kw)
        acc = cand_cost < cur_cost
        theta = torch.where(acc[:, None], cand, theta)
        g = torch.where(acc[:, None], cand_g, g)
        H = torch.where(acc[:, None, None], cand_H, H)
        lam = torch.where(acc, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        rel_dec = torch.where(
            acc, (cur_cost - cand_cost) / torch.clamp(cur_cost, min=1e-20),
            rel_dec)
        cur_cost = torch.where(acc, cand_cost, cur_cost)
    return theta, cur_cost, rel_dec


def _world_targets(tgt: Cells, tgt_poses: torch.Tensor,
                   tgt_scan_mask: torch.Tensor, cost: int):
    """Fixed targets [B, T, C] in the world frame: means, normals, for P2D
    covariances (rot @ cov @ rot^T, else None), and validity; one refmath
    site (one launch on the card)."""
    return refmath.site("world_targets", tgt_poses, tgt.mean, tgt.normal,
                        tgt.cov if cost == COST_P2D else None, tgt.valid,
                        tgt_scan_mask)


def _mm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of [..., 2, 2] operands as torch's CPU matrix product rounds
    them at this size (its small-size loop): each entry (0 + a_i0 b_0j) +
    a_i1 b_1j, unfused."""
    return torch.stack([torch.stack([
        (0.0 + a[..., i, 0] * b[..., 0, j]) + a[..., i, 1] * b[..., 1, j]
        for j in range(2)], -1) for i in range(2)], -2)


def _world_targets_plain(tgt_poses: torch.Tensor, mean: torch.Tensor,
                         normal: torch.Tensor, cov: Optional[torch.Tensor],
                         valid: torch.Tensor, scan_mask: torch.Tensor):
    """The site's plain version: se2's apply, rotate and rotmat, and for
    P2D rot @ cov @ rot^T with the matrix products' rounding written out
    (``_mm2``)."""
    tmw = se2._apply_plain(tgt_poses, mean)
    tnw = se2._rotate_plain(tgt_poses, normal)
    tcw = None
    if cov is not None:
        rot = se2._rotmat_plain(tgt_poses[..., 2])[..., None, :, :]
        tcw = _mm2(_mm2(rot, cov), rot.transpose(-1, -2))
    return tmw, tnw, tcw, valid & scan_mask[..., None]


def _world_targets_layout(tgt_poses, mean, normal, cov, valid, scan_mask):
    """The site's operands: poses [B, T, 3] over the cells [B, T, C] and
    the scan mask [B, T]; outputs the means, normals, covariances (when
    given) and validity."""
    return [(tgt_poses[..., None, :], (3,), False), (mean, (2,), False),
            (normal, (2,), False), (cov, (2, 2), False), (valid, (), True),
            (scan_mask[..., None], (), True)], \
        [(2,), (2,), None if cov is None else (2, 2), "bool"], 0, ()


refmath.register_site("world_targets", _world_targets_plain,
                      _world_targets_layout)


def _associator(src, tgt, tgt_poses, tgt_scan_mask, cfg: RegistrationConfig):
    cost = cost_code(cfg.cost)
    tmw, tnw, tcw, tvalid = _world_targets(tgt, tgt_poses, tgt_scan_mask,
                                           cost)
    gate = math.cos(math.radians(cfg.angle_gate_deg))

    def make(pose, radius):
        return associate(src, pose, tmw, tnw, tcw, tgt.nsamples,
                         tgt.planarity, tvalid, radius,
                         weight_option=cfg.weight_option, cost=cost,
                         regularization=cfg.regularization,
                         cov_scale=cfg.cov_scale, angle_gate_cos=gate)
    return make


def _default_cov(bsz: int, dt, dev) -> torch.Tensor:
    return torch.diag(constant(DEFAULT_COV_DIAG, dt, dev)).expand(bsz, 3, 3)


def register_window(src: Cells, src_pose0: torch.Tensor, tgt: Cells,
                    tgt_poses: torch.Tensor, tgt_scan_mask: torch.Tensor,
                    cfg: RegistrationConfig,
                    guess: Optional[torch.Tensor] = None,
                    guess_sqrt_info: Optional[torch.Tensor] = None,
                    one_system: bool = False) -> RegistrationResult:
    """Register each source scan [B, C] against its window of fixed target
    scans [B, T, C] (n_scan_normal_reg::Register, incremental mode): outer
    re-association loop (doubled radius on the first) around LM, with the
    reference's guards (revert on regression after min_itr, stop on relative
    improvement below score_tolerance) applied per batch row.
    ``one_system``: B = 1 from the unbatched odometry step, whose LM step the
    reference rounds otherwise than its batched code's.  CPU tensors take
    the plain version; on CUDA tensors the whole call, ``_world_targets``'
    placement of the targets included, is one launch of
    ``csrc/lm_solve.cu``, which is bit-equal to it."""
    if src.mean.device.type == "cpu" or lm_kernel.plain_on_card_enabled():
        return _register_window_reference(
            src, src_pose0, tgt, tgt_poses, tgt_scan_mask, cfg, guess=guess,
            guess_sqrt_info=guess_sqrt_info, one_system=one_system)
    cost = cost_code(cfg.cost)
    pose, score, n_res, used = lm_kernel.register_window(
        src_pose0, src.mean, src.normal, src.nsamples, src.planarity,
        src.valid, tgt_poses, tgt.mean, tgt.normal, tgt.cov, tgt.valid,
        tgt_scan_mask, tgt.nsamples, tgt.planarity, cost=cost, loss=loss_code(cfg.loss), delta=cfg.loss_limit,
        max_inner=cfg.max_inner_iterations, init_lambda=cfg.init_lambda,
        max_outer=cfg.max_outer_iterations,
        min_outer=cfg.min_outer_iterations, radius=cfg.radius,
        angle_gate_cos=math.cos(math.radians(cfg.angle_gate_deg)),
        weight_option=cfg.weight_option, regularization=cfg.regularization,
        cov_scale=cfg.cov_scale, score_tolerance=cfg.score_tolerance,
        guess=guess, sqrt_info=guess_sqrt_info, one_system=one_system)
    return RegistrationResult(pose=pose, score=score, num_residuals=n_res,
                              iterations=used, success=n_res > 1,
                              cov=_default_cov(pose.shape[0], pose.dtype,
                                               pose.device))


def _register_window_reference(src: Cells, src_pose0: torch.Tensor,
                               tgt: Cells, tgt_poses: torch.Tensor,
                               tgt_scan_mask: torch.Tensor,
                               cfg: RegistrationConfig,
                               guess: Optional[torch.Tensor] = None,
                               guess_sqrt_info: Optional[torch.Tensor] = None,
                               one_system: bool = False
                               ) -> RegistrationResult:
    """The plain version of ``register_window`` (and of its kernel): on CPU
    tensors, or on CUDA tensors inside ``kernels.lm_solve.plain_on_card``
    only.  Once a row is inactive none of its outputs changes again (every
    update is gated on ``active`` or ``run``), which lets the kernel leave
    the loop there."""
    if src.mean.device.type != "cpu" and \
            not lm_kernel.plain_on_card_enabled():
        raise RuntimeError("the plain register_window runs on the CPU; on "
                           f"{src.mean.device} it is the kernel's")
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    make_assoc = _associator(src, tgt, tgt_poses, tgt_scan_mask, cfg)
    prior = None
    if guess is not None:
        n_src = refmath.sqrt(torch.clamp(
            src.valid.sum(-1).to(src.mean.dtype), min=1.0))
        prior = (guess, guess_sqrt_info, n_src)

    dt, dev = src.mean.dtype, src.mean.device
    bsz = src_pose0.shape[0]
    theta = src_pose0
    score = torch.full((bsz,), torch.finfo(dt).max / 4, dtype=dt, device=dev)
    active = torch.ones(bsz, dtype=torch.bool, device=dev)
    used = torch.zeros(bsz, dtype=torch.long, device=dev)
    n_res = torch.zeros(bsz, dtype=torch.long, device=dev)
    for itr in range(cfg.max_outer_iterations):
        radius = 2.0 * cfg.radius if itr == 0 else cfg.radius
        assoc = make_assoc(theta, radius)
        cnt = assoc.mask.sum((1, 2))
        run = active & (cnt > 1)
        new_theta, new_score, rel_dec = _lm_solve(
            theta, src, assoc, cost=cost, loss=loss, delta=cfg.loss_limit,
            max_iter=cfg.max_inner_iterations, init_lambda=cfg.init_lambda,
            prior=prior, one_system=one_system)
        past_min = (itr + 1) > cfg.min_outer_iterations
        regressed = past_min & (score < new_score)
        rel_imp = (score - new_score) / torch.clamp(score, min=1e-20)
        converged = past_min & ((rel_imp < cfg.score_tolerance)
                                | (rel_dec < cfg.score_tolerance))
        take = run & ~regressed
        theta = torch.where(take[:, None], new_theta, theta)
        score = torch.where(take, new_score, score)
        used = torch.where(active, torch.full_like(used, itr + 1), used)
        n_res = torch.where(run, cnt, n_res)
        active = run & ~regressed & ~converged

    return RegistrationResult(pose=theta, score=score, num_residuals=n_res,
                              iterations=used, success=n_res > 1,
                              cov=_default_cov(bsz, dt, dev))


def cell_rel_timestamps(mean: torch.Tensor, ccw: bool) -> torch.Tensor:
    """Relative in-sweep time of each cell in [-0.5, 0.5], from the azimuth
    of its local position (GetRelTimeStamp, utils.h:28-32)."""
    a = refmath.atan2(mean[..., 1], mean[..., 0])
    a = torch.where(a > 1e-5, a, 2.0 * math.pi + a)
    # d / (2 pi) - 0.5 as the reference's program computes it: the division
    # by a constant is a product with its reciprocal, fused into the add
    t = refmath.fma(a, torch.full_like(a, recip(2.0 * math.pi)),
                    torch.full_like(a, -0.5))
    return -t if ccw else t


def motion_correct_cells(src: Cells, vel: torch.Tensor, ccw: bool) -> Cells:
    """Per-cell velocity (distortion) correction for time-continuous
    registration: mean -> R(t_i v_theta) mean + t_i v_xy, the normal rotated
    by the same rotation (P2PEfficientContinuousCost,
    n_scan_normal.h:363-404).  ``vel`` [..., 3] is the per-sweep motion of
    each row, held constant during the solve."""
    t = cell_rel_timestamps(src.mean, ccw)  # [..., C]
    ang = t * vel[..., None, 2]
    s, c = refmath.sincos(ang)
    # rounded as the reference's fused program: each sum's first product
    # and the added t*v fused into it
    mx, my = src.mean[..., 0], src.mean[..., 1]
    fma = refmath.fma
    mean = torch.stack([fma(t, vel[..., None, 0], fma(c, mx, -(s * my))),
                        fma(t, vel[..., None, 1], fma(s, mx, c * my))], -1)
    nx, ny = src.normal[..., 0], src.normal[..., 1]
    normal = torch.stack([fma(c, nx, -(s * ny)), fma(s, nx, c * ny)], -1)
    return src.replace(mean=mean, normal=normal)


def register_time_continuous(src: Cells, src_pose0: torch.Tensor, tgt: Cells,
                             tgt_poses: torch.Tensor,
                             tgt_scan_mask: torch.Tensor,
                             cfg: RegistrationConfig, vel: torch.Tensor,
                             ccw: bool = False,
                             guess: Optional[torch.Tensor] = None,
                             guess_sqrt_info: Optional[torch.Tensor] = None,
                             one_system: bool = False
                             ) -> RegistrationResult:
    """Time-continuous P2P window registration (RegisterTimeContinuous,
    n_scan_normal.cpp:67-80).  The velocity block ``vel`` [B, 3] is constant
    during the solve, so correcting each source cell once up front equals
    the reference's per-pass correction: a pre-pass, then P2P
    ``register_window``."""
    return register_window(
        motion_correct_cells(src, vel, ccw), src_pose0, tgt, tgt_poses,
        tgt_scan_mask, dataclasses.replace(cfg, cost="P2P"), guess=guess,
        guess_sqrt_info=guess_sqrt_info, one_system=one_system)


@functools.lru_cache(maxsize=None)
def _quad_fit_pinv(xy_range: float, yaw_range: float, steps: int, device):
    """Pseudo-inverse [10, steps^3] of the quadratic-fit design matrix over
    the steps^3 sampling grid and the grid's offsets [steps^3, 3]
    (approximateCovarianceBySampling), as tensors on ``device``; computed and
    uploaded once per grid and device."""
    xs = np.linspace(-xy_range / 2, xy_range / 2, steps)
    ts = np.linspace(-yaw_range / 2, yaw_range / 2, steps)
    rows, offs = [], []
    for t in ts:
        for x in xs:
            for y in xs:
                rows.append([x * x, y * y, t * t, x * y, y * t, t * x,
                             x, y, t, 1.0])
                offs.append([x, y, t])
    a = np.asarray(rows, np.float64)
    return (torch.as_tensor(np.linalg.pinv(a).astype(np.float32),
                            device=device),
            torch.as_tensor(np.asarray(offs, np.float32), device=device))


def sampled_covariance(src: Cells, theta_opt: torch.Tensor, tgt: Cells,
                       tgt_poses: torch.Tensor, tgt_scan_mask: torch.Tensor,
                       cfg: RegistrationConfig, final_score: torch.Tensor,
                       n_res: torch.Tensor, xy_range: float = 0.4,
                       yaw_range: float = 0.0043625, steps: int = 3,
                       cov_scaler: float = 4.0):
    """Grid-sampled covariance: cost on a steps^3 grid around each optimum
    (one association at the optimum, as the reference's default), quadratic
    least-squares fit, inverse Hessian with Censi scaling.  Returns
    (cov [B, 3, 3], convex [B]).  CPU tensors take the plain version; on
    CUDA tensors the whole call (the targets' placement, the association,
    the steps^3 costs, the fit and the 3 x 3 covariance) is one launch of
    ``csrc/lm_solve.cu``'s evaluation entry, bit-equal to the plain
    version, with no host synchronisation."""
    if src.mean.device.type == "cpu" or lm_kernel.plain_on_card_enabled():
        return _sampled_covariance_reference(
            src, theta_opt, tgt, tgt_poses, tgt_scan_mask, cfg, final_score,
            n_res, xy_range, yaw_range, steps, cov_scaler)
    pinv, offs = _quad_fit_pinv(xy_range, yaw_range, steps, src.mean.device)
    *_, cov, convex = _evaluate_on_card(
        src, theta_opt, tgt, tgt_poses, tgt_scan_mask, cfg, offsets=offs,
        pinv=pinv, covariance=(final_score.float(), n_res.long(), cov_scaler,
                               DEFAULT_COV_DIAG))
    return cov, convex


def _sampled_covariance_reference(src: Cells, theta_opt: torch.Tensor,
                                  tgt: Cells, tgt_poses: torch.Tensor,
                                  tgt_scan_mask: torch.Tensor,
                                  cfg: RegistrationConfig,
                                  final_score: torch.Tensor,
                                  n_res: torch.Tensor, xy_range: float = 0.4,
                                  yaw_range: float = 0.0043625,
                                  steps: int = 3, cov_scaler: float = 4.0):
    """The plain version of ``sampled_covariance`` (and of the evaluation
    entry's costs and fit): on CPU tensors, or on CUDA tensors inside
    ``kernels.lm_solve.plain_on_card`` only.  The steps^3 poses of a row
    are one batch of rows over repeated copies of its sources and
    associations; each equals the same pose's cost pass over the one
    association set, which is the order the kernel runs."""
    _, q = _sampled_fit_reference(src, theta_opt, tgt, tgt_poses,
                                  tgt_scan_mask, cfg, xy_range, yaw_range,
                                  steps)
    return _covariance_from_fit(q, cost_code(cfg.cost), final_score, n_res,
                                cov_scaler)


def _sampled_fit_reference(src: Cells, theta_opt: torch.Tensor, tgt: Cells,
                           tgt_poses: torch.Tensor,
                           tgt_scan_mask: torch.Tensor,
                           cfg: RegistrationConfig, xy_range: float,
                           yaw_range: float, steps: int):
    """The plain sampled costs [B, steps^3] and their quadratic fit
    [B, 10] (the evaluation entry's outputs in ``sampled_covariance``)."""
    _plain_device("sampled_covariance", src.mean.device)
    pinv, offs = _quad_fit_pinv(xy_range, yaw_range, steps, src.mean.device)
    s = offs.shape[0]
    bsz = theta_opt.shape[0]
    assoc = _associator(src, tgt, tgt_poses, tgt_scan_mask, cfg)(
        theta_opt, cfg.radius)
    poses = (theta_opt[:, None, :] + offs[None]).reshape(bsz * s, 3)
    src_s = src.map(lambda x: x.repeat_interleave(s, dim=0))
    costs = _cost_only(poses, src_s, assoc.repeat(s),
                       cost=cost_code(cfg.cost), loss=loss_code(cfg.loss),
                       delta=cfg.loss_limit).reshape(bsz, s)
    # the quadratic fit, each coefficient summed as the reference's: one
    # fused multiply-add a sample, in order (no library blocking: a row is
    # the same whatever B)
    return costs, refmath.dot(costs, pinv)  # [B, 10]


def _covariance_from_fit(q: torch.Tensor, cost: int,
                         final_score: torch.Tensor, n_res: torch.Tensor,
                         cov_scaler: float):
    """(cov [B, 3, 3], convex [B]) from the quadratic fit q [B, 10]: its
    Hessian, convex where every eigenvalue is positive, the inverse scaled
    by 2 final_score / (residual dim - 3) and ``cov_scaler``, else the
    default diagonal.  Elementwise torch on either device, rounded as the
    reference's program on the CPU: the eigenvalues and the inverse as the
    library jaxlib calls computes them (``core/refmath.py::eigvalsh3``,
    ``inv3``), every subnormal operand and result flushed.  The evaluation
    entry's covariance (``csrc/lm_solve.cu``) runs the same steps."""
    q = plain.ftz(q)
    two = lambda x: plain.ftz(2.0 * x)
    h = torch.stack([
        torch.stack([two(q[:, 0]), q[:, 3], q[:, 5]], -1),
        torch.stack([q[:, 3], two(q[:, 1]), q[:, 4]], -1),
        torch.stack([q[:, 5], q[:, 4], two(q[:, 2])], -1)], -2)
    convex = (plain.eigvalsh3(h) > 0).all(-1)
    resid_dim = (1 if cost == COST_P2L else 2) * n_res
    denom = torch.clamp(resid_dim - 3, min=1).to(q.dtype)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    hinv = plain.inv3(plain.ftz(h + (~convex).to(q.dtype)[:, None, None]
                                * eye))
    scale = plain.ftz(final_score / denom)[:, None, None]
    cov = plain.ftz(plain.ftz(two(hinv) * scale) * cov_scaler)
    fallback = torch.diag(constant(DEFAULT_COV_DIAG, q.dtype, q.device))
    return torch.where(convex[:, None, None], cov, fallback), convex


def evaluate_cost(src: Cells, src_pose: torch.Tensor, tgt: Cells,
                  tgt_poses: torch.Tensor, tgt_scan_mask: torch.Tensor,
                  cfg: RegistrationConfig):
    """One association + cost pass without solving (GetCost); returns
    (total_cost [B], num_residuals [B]).  CPU tensors take the plain
    version; on CUDA tensors it is one launch of ``csrc/lm_solve.cu``'s
    evaluation entry (the targets placed in the world inside it), which is
    bit-equal to it."""
    if src.mean.device.type == "cpu" or lm_kernel.plain_on_card_enabled():
        return _evaluate_cost_reference(src, src_pose, tgt, tgt_poses,
                                        tgt_scan_mask, cfg)
    costs, count, *_ = _evaluate_on_card(src, src_pose, tgt, tgt_poses,
                                         tgt_scan_mask, cfg)
    return costs[:, 0], count


def _evaluate_cost_reference(src: Cells, src_pose: torch.Tensor, tgt: Cells,
                             tgt_poses: torch.Tensor,
                             tgt_scan_mask: torch.Tensor,
                             cfg: RegistrationConfig):
    """The plain version of ``evaluate_cost`` (and of the evaluation
    entry): on CPU tensors, or on CUDA tensors inside
    ``kernels.lm_solve.plain_on_card`` only."""
    _plain_device("evaluate_cost", src.mean.device)
    assoc = _associator(src, tgt, tgt_poses, tgt_scan_mask, cfg)(
        src_pose, cfg.radius)
    total = _cost_only(src_pose, src, assoc, cost=cost_code(cfg.cost),
                       loss=loss_code(cfg.loss), delta=cfg.loss_limit)
    return total, assoc.mask.sum((1, 2))


def _plain_device(name: str, dev: torch.device) -> None:
    """A plain registration function runs on the CPU, and on the card only
    inside ``kernels.lm_solve.plain_on_card``."""
    if dev.type != "cpu" and not lm_kernel.plain_on_card_enabled():
        raise RuntimeError(f"the plain {name} runs on the CPU; on {dev} it "
                           "is the kernel's")


def _evaluate_on_card(src: Cells, pose: torch.Tensor, tgt: Cells,
                      tgt_poses: torch.Tensor, tgt_scan_mask: torch.Tensor,
                      cfg: RegistrationConfig, offsets=None, pinv=None,
                      covariance=None):
    """The evaluation entry, the targets placed in the world inside it:
    (costs [B, S], association counts [B], fit [B, 10], cov [B, 3, 3] and
    convex [B], each None unless asked for)."""
    cost = cost_code(cfg.cost)
    return lm_kernel.evaluate(
        pose, src.mean, src.normal, src.nsamples, src.planarity, src.valid,
        tgt_poses, tgt.mean, tgt.normal, tgt.cov, tgt.valid, tgt_scan_mask,
        tgt.nsamples, tgt.planarity, cost=cost,
        loss=loss_code(cfg.loss), delta=cfg.loss_limit, radius=cfg.radius,
        angle_gate_cos=math.cos(math.radians(cfg.angle_gate_deg)),
        weight_option=cfg.weight_option, regularization=cfg.regularization,
        cov_scale=cfg.cov_scale, offsets=offsets, pinv=pinv,
        covariance=covariance)


def ceres_covariance(src: Cells, theta_opt: torch.Tensor, tgt: Cells,
                     tgt_poses: torch.Tensor, tgt_scan_mask: torch.Tensor,
                     cfg: RegistrationConfig, final_score: torch.Tensor,
                     n_res: torch.Tensor):
    """Ceres-covariance-style output (GetCovariance, n_scan_normal.cpp:
    390-431): the inverse Gauss-Newton Hessian at each optimum, scaled by
    30 * final_cost / (residual dim - 3).  Returns (cov [B, 3, 3], ok [B]);
    where the Hessian's smallest eigenvalue is <= 1e-9 or the denominator is
    <= 0, ok is False and cov the default diagonal."""
    dt, dev = src.mean.dtype, src.mean.device
    cost = cost_code(cfg.cost)
    assoc = _associator(src, tgt, tgt_poses, tgt_scan_mask, cfg)(
        theta_opt, cfg.radius)
    _, _, h = _cost_grad_hess(theta_opt, src, assoc, cost=cost,
                              loss=loss_code(cfg.loss), delta=cfg.loss_limit)
    return _ceres_from_hessian(h, final_score, n_res, cost)


def _ceres_from_hessian(h: torch.Tensor, final_score: torch.Tensor,
                        n_res: torch.Tensor, cost: int):
    """(cov [B, 3, 3], ok [B]) of ``ceres_covariance`` from its Hessian h
    [B, 3, 3], rounded as the reference's program on the CPU (its
    ``lapack_ssyevd_ffi``, ``lapack_sgetrf_ffi`` and two
    ``lapack_strsm_ffi`` calls, written out): the refmath op
    ``ceres_covariance``, its plain version on the CPU
    (``core/refmath.py::ceres_covariance``: ``eigvalsh3``, ``inv3``) and
    one launch with no host sync on the card."""
    return refmath.ceres_covariance(h, final_score, n_res,
                                    p2l=cost == COST_P2L,
                                    fallback=DEFAULT_COV_DIAG)


def register_joint(scans: Cells, poses0: torch.Tensor,
                   scan_mask: torch.Tensor, fixed: torch.Tensor,
                   cfg: RegistrationConfig) -> RegistrationResult:
    """Joint refinement of every scan of a window [T, C]
    (many_to_many_refinement, n_scan_normal.cpp:360-365).  With the target
    pose baked into each residual at association time only the source
    scan's 3 DoF are free, so one outer iteration is T independent 3-DoF LM
    solves, each scan against all others at their last poses; the batch
    axis carries the T solves in one call.  Where no valid scan is fixed,
    the first valid one is held as the gauge.  Returns the poses [T, 3] and
    the summed score and residual count of the movable scans."""
    cost = cost_code(cfg.cost)
    loss = loss_code(cfg.loss)
    dt, dev = poses0.dtype, poses0.device
    t = poses0.shape[0]
    gate = math.cos(math.radians(cfg.angle_gate_deg))
    rows = torch.arange(t, device=dev)
    any_fixed = (fixed & scan_mask).any()
    first_valid = torch.argmax(scan_mask.to(torch.uint8))
    gauge = torch.where(any_fixed, fixed, rows == first_valid) & scan_mask
    movable = scan_mask & ~gauge
    # row j: scan j against every other valid scan of the window
    tvalid = scans.valid[None] & scan_mask[None, :, None] \
        & (rows[:, None] != rows[None, :])[..., None]
    every = lambda x: x[None].expand((t,) + x.shape)
    nsamples, planarity = every(scans.nsamples), every(scans.planarity)
    zero = torch.zeros((), dtype=dt, device=dev)
    poses = poses0
    score = torch.zeros((), dtype=dt, device=dev)
    n_res = torch.zeros((), dtype=torch.long, device=dev)
    n_outer = cfg.max_outer_iterations
    for itr in range(n_outer):
        radius = 2.0 * cfg.radius if itr == 0 else cfg.radius
        tmw, tnw, tcw, _ = _world_targets(scans, poses, scan_mask, cost)
        assoc = associate(scans, poses, every(tmw), every(tnw),
                          None if tcw is None else every(tcw), nsamples,
                          planarity, tvalid, radius,
                          weight_option=cfg.weight_option, cost=cost,
                          regularization=cfg.regularization,
                          cov_scale=cfg.cov_scale, angle_gate_cos=gate)
        new_poses, scores, _ = _lm_solve(
            poses, scans, assoc, cost=cost, loss=loss, delta=cfg.loss_limit,
            max_iter=cfg.max_inner_iterations, init_lambda=cfg.init_lambda)
        poses = torch.where(movable[:, None], new_poses, poses)
        score = torch.where(movable, scores, zero).sum()
        n_res = torch.where(movable, assoc.mask.sum((1, 2)), 0).sum()
    return RegistrationResult(
        pose=poses, score=score, num_residuals=n_res,
        iterations=torch.full((), n_outer, dtype=torch.long, device=dev),
        success=n_res > 1, cov=_default_cov(1, dt, dev)[0])
