"""The registration's window solve, LM solve and cost evaluation as CUDA
kernel launches.

The kernel is ``csrc/lm_solve.cu``, with three entries over the same device
code:

* ``register_window``: ``ops/registration.py::register_window`` after
  ``_world_targets``, whole, in one launch a call: every outer iteration's
  association of the source cells into the target scans, the LM solve (the
  initial cost, gradient and Hessian, then ``max_iter`` damped steps, each
  with the candidate's residuals, robust loss, weights, the 13 pairwise row
  sums and the accept / reject) and the outer guards, bit-equal to the plain
  version ``ops/registration.py::_register_window_reference``;
* ``lm_solve``: ``_lm_solve`` alone on given associations (``register_joint``),
  one launch a solve, bit-equal to ``_lm_solve_reference``;
* ``evaluate``: ``evaluate_cost`` and ``sampled_covariance`` after
  ``_world_targets`` in one launch a call: the association at each row's
  pose, then the cost-only pass at all S poses over it in one pass (and the
  sampled covariance's quadratic fit and its 3 x 3 covariance and
  convexity, with nothing read on the host), bit-equal to
  ``_evaluate_cost_reference`` and ``_sampled_covariance_reference``.

A batch row runs on a thread-block cluster of K CTAs (``cluster_size``),
each owning an aligned 1/K of the row's ``_row_sums`` leaves; the sums do
not depend on K.  Neither entry has a Pallas counterpart: the JAX package
leaves the registration to XLA's fusions.

Dispatch is in ``ops/registration.py``: a CPU tensor takes the plain
version, a CUDA tensor launches this kernel or raises.  ``LAUNCHES`` counts
kernel launches and nothing else (``LAUNCHES_BY_ENTRY`` splits them).
``plain_on_card`` lets a test or ``chip_smoke.py`` run the plain versions on
CUDA tensors, to hold the kernel to them; nothing else uses it.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional

import numpy as np
import torch

from ..core.refmath import f32_ftz, recip
from .refmath import _entry, _launch_on

#: number of kernel launches made by ``register_window`` and ``lm_solve``
LAUNCHES = 0
#: launches by entry ("window", "solve", "evaluate")
LAUNCHES_BY_ENTRY: collections.Counter = collections.Counter()

_PLAIN_ON_CARD = False

# ops/registration.py's cost and loss codes
_P2L, _P2D = 0, 1
_HUBER, _CAUCHY, _SOFTLONE, _TUKEY = 1, 2, 3, 4

# csrc/lm_solve.cu's limits: SMs of the card, the portable cluster size,
# threads and leaves a CTA, dynamic shared memory a CTA
SMS = 132
MAX_CLUSTER = 8
THREADS = 256
MAX_LEAVES_PER_THREAD = 128
SHARED_BYTES = 200 * 1024
#: the evaluation entry's most poses S (steps^3 <= 64)
MAX_POSES = 64


def _f32(x: float) -> float:
    return float(np.float32(x))


def loss_constants(loss: int, delta: float):
    """The float32 constants of ``_rho_and_weight`` for ``loss`` at
    ``delta``, as its tensor operations round them: Huber (delta^2,
    2 delta, -delta^2, delta), Cauchy (1 / b, b), SoftLOne (1 / b, 2 b),
    Tukey (1 / b, b / 3), with b = delta^2; zeros elsewhere."""
    b = delta * delta
    if loss == _HUBER:
        return _f32(b), _f32(2.0 * delta), _f32(-b), _f32(delta)
    if loss == _CAUCHY:
        return recip(b), _f32(b), 0.0, 0.0
    if loss == _SOFTLONE:
        return recip(b), _f32(2.0 * b), 0.0, 0.0
    if loss == _TUKEY:
        return recip(b), _f32(b / 3.0), 0.0, 0.0
    return 0.0, 0.0, 0.0, 0.0


def row_leaves(t: int, c: int, cost: int):
    """(leaves N, padded width W, residuals a cell R) of one row of T x C
    associations: ``_row_sums``'s tree over W = the power of two >= N."""
    r = 1 if cost == _P2L else 2
    n = t * c * r
    return n, 1 << max(n - 1, 0).bit_length(), r


def shared_bytes(k: int, t: int, c: int, ct: int, cost: int,
                 window: bool) -> int:
    """Dynamic shared memory of one CTA at cluster size k: its records (the
    associations of its W / k leaves) and, in the window, one staged target
    scan; ``csrc/lm_solve.cu::layout`` computes the same."""
    _, w, r = row_leaves(t, c, cost)
    qk = w // k // r
    q = -(-qk // 4) * 4
    floats = 5 * q + (2 * q if cost == _P2L else 4 * q if cost == _P2D else 0)
    if window:
        floats += -(-2 * ct // 4) * 4
    return 4 * floats + -(-qk // 16) * 16 + (-(-ct // 16) * 16 if window
                                             else 0)


def cluster_size(rows: int, t: int, c: int, ct: int, cost: int,
                 window: bool) -> int:
    """CTAs a row: the largest power of two K <= 8 with K rows' clusters
    side by side on the card (K B <= 132) and at least R leaves a CTA,
    raised until a CTA's records fit its shared memory.  B = 1 and 4, an
    online wave of 12 and ``register_joint``'s 5 rows get 8; a 64-pair loop
    wave 2."""
    _, w, r = row_leaves(t, c, cost)
    most = min(MAX_CLUSTER, max(1, w // r))
    k = 1
    while 2 * k <= min(most, max(1, SMS // max(rows, 1))):
        k *= 2
    while shared_bytes(k, t, c, ct, cost, window) > SHARED_BYTES and \
            k < most:
        k *= 2
    if shared_bytes(k, t, c, ct, cost, window) > SHARED_BYTES or \
            w // k > THREADS * MAX_LEAVES_PER_THREAD:
        raise ValueError(f"lm_solve: a row of T={t} x C={c} (Ct={ct}) does "
                         f"not fit {MAX_CLUSTER} CTAs")
    return k


@contextlib.contextmanager
def plain_on_card():
    """Inside the block ``register_window``, ``_lm_solve``,
    ``evaluate_cost`` and ``sampled_covariance`` run their plain versions
    on CUDA tensors too (the kernel's yardstick in tests and
    ``chip_smoke.py``)."""
    global _PLAIN_ON_CARD
    was, _PLAIN_ON_CARD = _PLAIN_ON_CARD, True
    try:
        yield
    finally:
        _PLAIN_ON_CARD = was


def plain_on_card_enabled() -> bool:
    return _PLAIN_ON_CARD


def _check(name, dev, floats, bools, shapes):
    """Device, type and shape checks of an entry's tensors."""
    if any(x is None for x in floats):
        raise ValueError(f"{name}: the cost's target normals (P2L), "
                         "covariances or sqrt-information (P2D) are missing")
    if any(x.dtype != torch.float32 or x.device != dev for x in floats) or \
            any(x.dtype != torch.bool or x.device != dev for x in bools):
        raise TypeError(f"{name}: float32 tensors and bool masks on {dev}")
    for what, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: {what} has shape {tuple(x.shape)}, "
                             f"expected {want}")


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _count(entry: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1


def lm_solve(theta0: torch.Tensor, src_mean: torch.Tensor,
             tgt_mean_w: torch.Tensor, tgt_normal_w: Optional[torch.Tensor],
             weight: torch.Tensor, mask: torch.Tensor,
             tgt_sqrtinfo: Optional[torch.Tensor], *, cost: int, loss: int,
             delta: float, max_iter: int, init_lambda: float, prior=None,
             one_system: bool = False, cluster: Optional[int] = None):
    """(theta [B, 3], cost [B], rel_dec [B]) of the LM solve of B rows of
    [T, C] associations, one launch on CUDA tensors (float32; ``mask``
    bool).  ``prior`` is (guess [B, 3], sqrt_info [3, 3], pw [B]) or None;
    ``cluster`` forces the CTAs a row (default ``cluster_size``)."""
    dev = theta0.device
    if dev.type != "cuda":
        raise RuntimeError(f"lm_solve: no kernel for device {dev}")
    bsz = theta0.shape[0]
    t, c = weight.shape[1:]
    floats = [theta0, src_mean, tgt_mean_w, weight]
    shapes = {"theta0": (theta0, (bsz, 3)), "src_mean": (src_mean, (bsz, c, 2)),
              "tgt_mean_w": (tgt_mean_w, (bsz, t, c, 2)),
              "mask": (mask, (bsz, t, c))}
    if cost == _P2L:
        floats.append(tgt_normal_w)
        if tgt_normal_w is not None:
            shapes["tgt_normal_w"] = (tgt_normal_w, (bsz, t, c, 2))
    if cost == _P2D:
        floats.append(tgt_sqrtinfo)
        if tgt_sqrtinfo is not None:
            shapes["tgt_sqrtinfo"] = (tgt_sqrtinfo, (bsz, t, c, 2, 2))
    if prior is not None:
        floats.extend(prior)
        shapes.update(guess=(prior[0], (bsz, 3)),
                      sqrt_info=(prior[1], (3, 3)), pw=(prior[2], (bsz,)))
    _check("lm_solve", dev, floats, [mask], shapes)
    out_theta = torch.empty((bsz, 3), dtype=torch.float32, device=dev)
    out_cost = torch.empty((bsz,), dtype=torch.float32, device=dev)
    out_rel = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out_theta, out_cost, out_rel
    k = cluster or cluster_size(bsz, t, c, c, cost, False)
    keep = [x.contiguous() for x in (theta0, src_mean, tgt_mean_w, weight,
                                     mask)]
    opt = lambda x, on: x.contiguous() if on else None
    tn = opt(tgt_normal_w, cost == _P2L)
    si = opt(tgt_sqrtinfo, cost == _P2D)
    guess, sqrt_info, pw = (None,) * 3 if prior is None else \
        (x.contiguous() for x in prior)
    err = _launch_on(dev, _entry("lm_solve_launch"), _ptr(keep[0]),
                     _ptr(keep[1]), _ptr(keep[2]), _ptr(tn), _ptr(keep[3]),
                     _ptr(keep[4]), _ptr(si), _ptr(guess), _ptr(sqrt_info),
                     _ptr(pw), out_theta.data_ptr(), out_cost.data_ptr(),
                     out_rel.data_ptr(), bsz, t, c, cost, loss,
                     *loss_constants(loss, delta), max_iter,
                     _f32(init_lambda), int(one_system), k)
    if err != 0:
        raise RuntimeError(f"lm_solve_launch failed: CUDA error {err} "
                           f"(B={bsz}, T={t}, C={c}, cost={cost}, K={k})")
    _count("solve")
    return out_theta, out_cost, out_rel


def register_window(theta0: torch.Tensor, src_mean: torch.Tensor,
                    src_normal: torch.Tensor, src_nsamples: torch.Tensor,
                    src_planarity: torch.Tensor, src_valid: torch.Tensor,
                    tgt_mean_w: torch.Tensor, tgt_normal_w: torch.Tensor,
                    tgt_cov_w: Optional[torch.Tensor],
                    tgt_valid: torch.Tensor, tgt_nsamples: torch.Tensor,
                    tgt_planarity: torch.Tensor, *, cost: int, loss: int,
                    delta: float, max_inner: int, init_lambda: float,
                    max_outer: int, min_outer: int, radius: float,
                    angle_gate_cos: float, weight_option: int,
                    regularization: float, cov_scale: float,
                    score_tolerance: float, guess=None, sqrt_info=None,
                    one_system: bool = False,
                    cluster: Optional[int] = None):
    """(pose [B, 3], score [B], num_residuals [B], iterations [B]) of
    ``register_window`` for B source scans of C cells against T world-frame
    target scans of Ct cells (``_world_targets``' outputs, with the targets'
    nsamples and planarity), one launch on CUDA tensors.  ``guess`` [B, 3]
    with ``sqrt_info`` [3, 3] is the motion prior (its weight, the root of
    each row's valid source cells, is computed in the kernel);
    ``cluster`` forces the CTAs a row (default ``cluster_size``)."""
    dev = theta0.device
    if dev.type != "cuda":
        raise RuntimeError(f"register_window: no kernel for device {dev}")
    bsz, c = src_valid.shape
    t, ct = tgt_valid.shape[1:]
    floats = [theta0, src_mean, src_normal, src_nsamples, src_planarity,
              tgt_mean_w, tgt_normal_w, tgt_nsamples, tgt_planarity]
    shapes = {"theta0": (theta0, (bsz, 3)),
              "src_mean": (src_mean, (bsz, c, 2)),
              "src_normal": (src_normal, (bsz, c, 2)),
              "src_nsamples": (src_nsamples, (bsz, c)),
              "src_planarity": (src_planarity, (bsz, c)),
              "tgt_mean_w": (tgt_mean_w, (bsz, t, ct, 2)),
              "tgt_normal_w": (tgt_normal_w, (bsz, t, ct, 2)),
              "tgt_valid": (tgt_valid, (bsz, t, ct)),
              "tgt_nsamples": (tgt_nsamples, (bsz, t, ct)),
              "tgt_planarity": (tgt_planarity, (bsz, t, ct))}
    if cost == _P2D:
        floats.append(tgt_cov_w)
        if tgt_cov_w is not None:
            shapes["tgt_cov_w"] = (tgt_cov_w, (bsz, t, ct, 2, 2))
    if guess is not None:
        floats.extend([guess, sqrt_info])
        shapes.update(guess=(guess, (bsz, 3)),
                      sqrt_info=(sqrt_info, (3, 3)))
    _check("register_window", dev, floats, [src_valid, tgt_valid], shapes)
    if ct < 1:
        raise ValueError("register_window: the target scans hold no cell")
    out_theta = torch.empty((bsz, 3), dtype=torch.float32, device=dev)
    out_score = torch.empty((bsz,), dtype=torch.float32, device=dev)
    out_nres = torch.empty((bsz,), dtype=torch.long, device=dev)
    out_iters = torch.empty((bsz,), dtype=torch.long, device=dev)
    if bsz == 0:
        return out_theta, out_score, out_nres, out_iters
    k = cluster or cluster_size(bsz, t, c, ct, cost, True)
    ins = [x.contiguous() for x in (
        theta0, src_mean, src_normal, src_nsamples, src_planarity, src_valid,
        tgt_mean_w, tgt_normal_w)]
    tcw = tgt_cov_w.contiguous() if cost == _P2D else None
    more = [x.contiguous() for x in (tgt_valid, tgt_nsamples, tgt_planarity)]
    pr = [None, None] if guess is None else [guess.contiguous(),
                                             sqrt_info.contiguous()]
    r0 = 2.0 * radius  # the first outer iteration's doubled radius
    err = _launch_on(
        dev, _entry("register_window_launch"), *map(_ptr, ins), _ptr(tcw),
        *map(_ptr, more), *map(_ptr, pr), out_theta.data_ptr(),
        out_score.data_ptr(), out_nres.data_ptr(), out_iters.data_ptr(), bsz,
        t, c, ct, cost, loss, *loss_constants(loss, delta), max_inner,
        _f32(init_lambda), int(one_system), max_outer, min_outer,
        weight_option, f32_ftz(r0 * r0), f32_ftz(radius * radius),
        _f32(angle_gate_cos), _f32(regularization), _f32(cov_scale),
        _f32(score_tolerance), k)
    if err != 0:
        raise RuntimeError(f"register_window_launch failed: CUDA error {err} "
                           f"(B={bsz}, T={t}, C={c}, Ct={ct}, cost={cost}, "
                           f"K={k})")
    _count("window")
    return out_theta, out_score, out_nres, out_iters


def evaluate(pose: torch.Tensor, src_mean: torch.Tensor,
             src_normal: torch.Tensor, src_nsamples: torch.Tensor,
             src_planarity: torch.Tensor, src_valid: torch.Tensor,
             tgt_mean_w: torch.Tensor, tgt_normal_w: torch.Tensor,
             tgt_cov_w: Optional[torch.Tensor], tgt_valid: torch.Tensor,
             tgt_nsamples: torch.Tensor, tgt_planarity: torch.Tensor, *,
             cost: int, loss: int, delta: float, radius: float,
             angle_gate_cos: float, weight_option: int,
             regularization: float, cov_scale: float,
             offsets: Optional[torch.Tensor] = None,
             pinv: Optional[torch.Tensor] = None,
             covariance=None,
             cluster: Optional[int] = None):
    """(costs [B, S], association counts [B], fit [B, 10] or None, cov
    [B, 3, 3] or None, convex [B] or None) of B source scans of C cells at
    their poses ``pose`` [B, 3] against T world-frame target scans of Ct
    cells (``_world_targets``' outputs, with the targets' nsamples and
    planarity), one launch on CUDA tensors: one association at each row's
    pose within ``radius``, then the cost-only pass at ``pose +
    offsets[s]`` for each of the S <= 64 offsets [S, 3] (none: S = 1 at the
    pose itself), all S in one pass; with ``pinv`` [10, S] also the sampled
    covariance's fit, one fused multiply-add a sample in order; with
    ``covariance`` = (final_score [B] float32, n_res [B] int64, cov_scaler,
    default diagonal (3 floats)) also the covariance of the fit and its
    convexity (``_covariance_from_fit``), read from nothing on the host.
    ``cluster`` forces the CTAs a row (default ``cluster_size``)."""
    dev = pose.device
    if dev.type != "cuda":
        raise RuntimeError(f"evaluate: no kernel for device {dev}")
    bsz, c = src_valid.shape
    t, ct = tgt_valid.shape[1:]
    s = 1 if offsets is None else offsets.shape[0]
    floats = [pose, src_mean, src_normal, src_nsamples, src_planarity,
              tgt_mean_w, tgt_normal_w, tgt_nsamples, tgt_planarity]
    shapes = {"pose": (pose, (bsz, 3)),
              "src_mean": (src_mean, (bsz, c, 2)),
              "src_normal": (src_normal, (bsz, c, 2)),
              "src_nsamples": (src_nsamples, (bsz, c)),
              "src_planarity": (src_planarity, (bsz, c)),
              "tgt_mean_w": (tgt_mean_w, (bsz, t, ct, 2)),
              "tgt_normal_w": (tgt_normal_w, (bsz, t, ct, 2)),
              "tgt_valid": (tgt_valid, (bsz, t, ct)),
              "tgt_nsamples": (tgt_nsamples, (bsz, t, ct)),
              "tgt_planarity": (tgt_planarity, (bsz, t, ct))}
    if cost == _P2D:
        floats.append(tgt_cov_w)
        if tgt_cov_w is not None:
            shapes["tgt_cov_w"] = (tgt_cov_w, (bsz, t, ct, 2, 2))
    if offsets is not None:
        floats.append(offsets)
        shapes["offsets"] = (offsets, (s, 3))
    if pinv is not None:
        floats.append(pinv)
        shapes["pinv"] = (pinv, (10, s))
    if covariance is not None:
        final_score, n_res = covariance[:2]
        if pinv is None:
            raise ValueError("evaluate: the covariance needs the fit (pinv)")
        floats.append(final_score)
        shapes["final_score"] = (final_score, (bsz,))
        shapes["n_res"] = (n_res, (bsz,))
        if n_res.dtype != torch.long or n_res.device != dev:
            raise TypeError(f"evaluate: n_res must be int64 on {dev}")
    _check("evaluate", dev, floats, [src_valid, tgt_valid], shapes)
    if not 1 <= s <= MAX_POSES:
        raise ValueError(f"evaluate: S = {s} poses (1 to {MAX_POSES})")
    if ct < 1:
        raise ValueError("evaluate: the target scans hold no cell")
    out_costs = torch.empty((bsz, s), dtype=torch.float32, device=dev)
    out_count = torch.empty((bsz,), dtype=torch.long, device=dev)
    out_q = None if pinv is None else torch.empty(
        (bsz, 10), dtype=torch.float32, device=dev)
    out_cov = out_convex = None
    cov_in, scaler, diag = [None, None], 0.0, (0.0, 0.0, 0.0)
    if covariance is not None:
        out_cov = torch.empty((bsz, 3, 3), dtype=torch.float32, device=dev)
        out_convex = torch.empty((bsz,), dtype=torch.bool, device=dev)
        cov_in = [x.contiguous() for x in covariance[:2]]
        scaler, diag = _f32(covariance[2]), tuple(map(_f32, covariance[3]))
    if bsz == 0:
        return out_costs, out_count, out_q, out_cov, out_convex
    k = cluster or cluster_size(bsz, t, c, ct, cost, True)
    ins = [x.contiguous() for x in (
        pose, src_mean, src_normal, src_nsamples, src_planarity, src_valid,
        tgt_mean_w, tgt_normal_w)]
    tcw = tgt_cov_w.contiguous() if cost == _P2D else None
    more = [x.contiguous() for x in (tgt_valid, tgt_nsamples, tgt_planarity)]
    fit = [None if x is None else x.contiguous() for x in (offsets, pinv)]
    err = _launch_on(
        dev, _entry("evaluate_cost_launch"), *map(_ptr, ins), _ptr(tcw),
        *map(_ptr, more), *map(_ptr, fit), *map(_ptr, cov_in),
        out_costs.data_ptr(), out_count.data_ptr(), _ptr(out_q),
        _ptr(out_cov), _ptr(out_convex), bsz, t, c, ct, s, cost, loss,
        *loss_constants(loss, delta), weight_option,
        f32_ftz(radius * radius), _f32(angle_gate_cos), _f32(regularization),
        _f32(cov_scale), scaler, *diag, k)
    if err != 0:
        raise RuntimeError(f"evaluate_cost_launch failed: CUDA error {err} "
                           f"(B={bsz}, T={t}, C={c}, Ct={ct}, S={s}, "
                           f"cost={cost}, K={k})")
    _count("evaluate")
    return out_costs, out_count, out_q, out_cov, out_convex
