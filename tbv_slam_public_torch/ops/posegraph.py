"""Pose-graph optimization as robust SE(2) Levenberg-Marquardt.

Port of ``tbv_slam_public_tpu.ops.posegraph``: whitened edge residuals and
Jacobians, Cauchy IRLS on loop edges, the LAGO two-stage linear
initialisation, and one line-search (or damping-ladder) LM loop over three
linear solvers:

- ``schur``: SLAM graphs are an odometry chain plus sparse loop edges.  The
  block-tridiagonal chain part T is factorised by one level of substructuring
  (segments of ``schur_seg`` nodes eliminated by one batched Cholesky, a small
  dense separator system) and the L loop edges fold in exactly through a
  Woodbury solve with a 3L x 3L capacitance, followed by ``schur_refine``
  levels of iterative refinement.
- ``cholesky``: the dense [3N, 3N] normal equations, factorised by
  ``torch.linalg.cholesky_ex``.
- ``cg``: matrix-free block-Jacobi preconditioned conjugate gradients with a
  fixed trip count and an ``active`` mask (no host read inside the loop).

Edge-to-node sums (the reference's one-hot products served its matrix unit)
add each node's values one at a time in index order, as a sequential
``index_add_`` does, in an order fixed once per graph (``_GraphSums``): the
card gives the CPU's bits, run after run, where float atomics would make two
runs differ in the last bits.  The segment interiors keep the reference's
explicit inverse: it is computed once per LM iteration by ``cholesky_solve``
against the identity, and every one of the 4-6 chain solves of that iteration
(batched Woodbury right-hand sides, refinement passes) is then a batched
matrix product; the float32 error of the explicit inverse is removed by the
Jacobi equilibration and the refinement passes, as in the reference.  A
failed factorisation yields NaN steps, whose cost is never accepted.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import PGOConfig
from ..core.types import ODOMETRY, GraphEdges
from ..kernels import refmath


class PGOResult(NamedTuple):
    poses: torch.Tensor  # [N, 3] optimized
    cost0: torch.Tensor  # [] initial cost
    cost: torch.Tensor  # [] final cost
    iterations: torch.Tensor  # [] accepted LM iterations


def default_sqrt_info(etype: torch.Tensor, cfg: PGOConfig) -> torch.Tensor:
    """Per-edge diagonal sqrt-information [E, 3] under
    replace_cov_by_identity; loop edges divided by loop_scaling."""
    base = torch.sqrt(torch.tensor(
        [1.0 / cfg.odom_vxx, 1.0 / cfg.odom_vyy, 1.0 / cfg.odom_vtt],
        dtype=torch.float32, device=etype.device))
    # 1 / sqrt(loop_scaling) rounded as the reference rounds it: the square
    # root in float32, then the quotient in float32
    loop = 1.0 / torch.sqrt(torch.tensor(cfg.loop_scaling, dtype=torch.float32,
                                         device=etype.device))
    scale = torch.where(etype == ODOMETRY, torch.ones((), device=etype.device),
                        loop).float()
    return scale[:, None] * base[None, :]


def measured_sqrt_info(cov: torch.Tensor, etype: torch.Tensor,
                       cfg: PGOConfig) -> torch.Tensor:
    """Full-matrix whitening chol(cov^-1 * scale) from measured covariances
    [E, 3, 3]; degenerate covariances fall back to the default diagonal.
    The inverse and the factor as the reference's LAPACK calls round them
    (``core/refmath.py::measured_sqrt_info``; one launch on the card)."""
    scale = torch.where(etype == ODOMETRY, 1.0, 1.0 / cfg.loop_scaling).float()
    fallback = torch.diag_embed(default_sqrt_info(etype, cfg))
    return refmath.measured_sqrt_info(cov.float(), scale, fallback)


def _edge_residuals(poses: torch.Tensor, edges: GraphEdges):
    """Whitened residuals r [E, 3] = S [R(th_b)^T (p_e - p_b) - t_be ;
    wrap(th_e - th_b - th_be)] and the geometry terms for the Jacobians."""
    pb = poses[edges.idx[:, 0]]
    pe = poses[edges.idx[:, 1]]
    s, c = refmath.sincos(pb[:, 2])
    dx = pe[:, 0] - pb[:, 0]
    dy = pe[:, 1] - pb[:, 1]
    rx = c * dx + s * dy
    ry = -s * dx + c * dy
    rt = se2.wrap_angle(pe[:, 2] - pb[:, 2] - edges.meas[:, 2])
    raw = torch.stack([rx - edges.meas[:, 0], ry - edges.meas[:, 1], rt], -1)
    # subnormal residuals flushed, as the reference's threads flush a result
    # (FTZ); the whitening's subnormal entries were flushed when the edges
    # were made (``make_edges``: DAZ)
    r = refmath.ftz(torch.einsum("eij,ej->ei", edges.sqrt_info, raw))
    return r, (c, s, dx, dy)


def _edge_jacobians(poses: torch.Tensor, edges: GraphEdges):
    """Whitened Jacobian blocks Jb, Je [E, 3, 3] wrt (x, y, theta)."""
    r, (c, s, dx, dy) = _edge_residuals(poses, edges)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Jb = torch.stack([torch.stack([-c, -s, -s * dx + c * dy], -1),
                      torch.stack([s, -c, -c * dx - s * dy], -1),
                      torch.stack([z, z, -o], -1)], -2)
    Je = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    S = edges.sqrt_info
    return r, refmath.ftz(S @ Jb), refmath.ftz(S @ Je)


def _cauchy_weights(r: torch.Tensor, edges: GraphEdges, cfg: PGOConfig):
    """Per-edge (rho(s), IRLS weight): Cauchy on loops, none on odometry."""
    # the squares and the weight flushed where subnormal (the weight of a
    # residual above about 1e18), as the reference's threads flush them;
    # a sum of squares that are zero or normal is zero or normal
    s = refmath.ftz(r * r).sum(-1)
    b = cfg.cauchy_scale * cfg.cauchy_scale
    is_odom = edges.etype == ODOMETRY
    rho = torch.where(is_odom, s, b * refmath.log1p(s / b))
    w = torch.where(is_odom, torch.ones_like(s),
                    refmath.ftz(1.0 / (1.0 + s / b)))
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return torch.where(edges.mask, rho, zero), torch.where(edges.mask, w, zero)


def graph_cost(poses: torch.Tensor, edges: GraphEdges, cfg: PGOConfig):
    r, _ = _edge_residuals(poses, edges)
    rho, _ = _cauchy_weights(r, edges, cfg)
    return 0.5 * rho.sum()


class _Sums(NamedTuple):
    """The order of ``out[idx] += vals`` along axis 0: the distinct targets,
    ascending, and in column s of ``slots`` [K, S] the entries of target s
    in index order, padded with E (a zero row appended to the values)."""
    targets: torch.Tensor  # [S]
    slots: torch.Tensor  # [K, S]


def _sums_plan(idx: torch.Tensor) -> _Sums:
    """The order of the sum over index ``idx`` [E]: one stable sort and one
    host read of the largest count."""
    e = idx.shape[0]
    key, order = torch.sort(idx, stable=True)
    targets, counts = torch.unique_consecutive(key, return_counts=True)
    k = int(counts.max()) if e else 0
    starts = torch.cumsum(counts, 0) - counts
    pos = starts[None, :] + torch.arange(k, device=idx.device)[:, None]
    slots = torch.where(pos < (starts + counts)[None, :],
                        order[torch.clamp(pos, max=max(e - 1, 0))], e)
    return _Sums(targets, slots)


def _add_in_order(out: torch.Tensor, plan: _Sums,
                  vals: torch.Tensor) -> torch.Tensor:
    """out[idx] += vals for the index of ``plan``: each target's values are
    added one at a time in index order, as a sequential ``index_add_`` adds
    them: one gather of the [K, S] entries, then K adds, no atomics."""
    v = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])[plan.slots]
    acc = out[plan.targets]
    for k in range(v.shape[0]):
        acc = acc + v[k]
    out[plan.targets] = acc
    return out


class _GraphSums:
    """The edge-to-node sums of one graph of ``n`` nodes, each in an order
    made on its first use (``_sums_plan``) and kept for the graph's other
    sums of that kind."""

    def __init__(self, n: int, edges: GraphEdges):
        self.n, self.edges = n, edges
        self._plans: Dict[str, _Sums] = {}

    def add(self, name: str, out: torch.Tensor,
            index: Callable[[], torch.Tensor],
            vals: torch.Tensor) -> torch.Tensor:
        """out[index()] += vals; ``name`` keys the index's order."""
        if name not in self._plans:
            self._plans[name] = _sums_plan(index())
        return _add_in_order(out, self._plans[name], vals)

    def nodes(self, vb: torch.Tensor, ve: torch.Tensor) -> torch.Tensor:
        """Per-node [N, ...] sums of the begin (``vb``) and end (``ve``)
        node's per-edge values [E, ...]: the begin values first."""
        idx = self.edges.idx
        return self.add("nodes", vb.new_zeros((self.n,) + vb.shape[1:]),
                        lambda: torch.cat([idx[:, 0], idx[:, 1]]),
                        torch.cat([vb, ve]))


def _gradient_and_blocks(poses, edges, cfg: PGOConfig, sums=None):
    """IRLS cost, gradient [N, 3] and the sqrt(w)-weighted Jacobian blocks;
    ``sums`` the graph's ``_GraphSums``."""
    r, Jb, Je = _edge_jacobians(poses, edges)
    rho, w = _cauchy_weights(r, edges, cfg)
    # a lone product of the reference, flushed by its exact value (the
    # refmath op mul: one launch on the card)
    wr = refmath.mul(w[:, None], r)
    sums = sums or _GraphSums(poses.shape[0], edges)
    g = refmath.ftz(sums.nodes(torch.einsum("eij,ei->ej", Jb, wr),
                               torch.einsum("eij,ei->ej", Je, wr)))
    sw = refmath.sqrt(w)[:, None, None]
    return 0.5 * rho.sum(), g, (sw * Jb, sw * Je)


def _dense_hessian(n: int, edges: GraphEdges, blocks, gauge_mask,
                   sums=None):
    """Dense [3N, 3N] H = J^T J from the weighted 3x3 edge blocks, with
    identity rows/cols at fixed nodes (``gauge_mask`` marks FREE nodes)."""
    Jb, Je = blocks
    dev, dt = Jb.device, Jb.dtype
    pairs = [(Jb, Jb, 0, 0), (Jb, Je, 0, 1), (Je, Jb, 1, 0), (Je, Je, 1, 1)]
    k = torch.arange(3, device=dev)
    flat, vals = [], []
    for A, B, ia, ib in pairs:
        rows = 3 * edges.idx[:, ia, None, None] + k[None, :, None]
        cols = 3 * edges.idx[:, ib, None, None] + k[None, None, :]
        flat.append((rows * (3 * n) + cols).reshape(-1))
        vals.append((A.transpose(-1, -2) @ B).reshape(-1))
    H = torch.zeros(9 * n * n, dtype=dt, device=dev)
    sums = sums or _GraphSums(n, edges)
    vals = torch.cat(vals)
    if vals.dtype == torch.float32:  # flushed as the reference's products
        vals = refmath.ftz(vals)
    sums.add("hessian", H, lambda: torch.cat(flat), vals)
    H = H.reshape(3 * n, 3 * n)
    free = gauge_mask.repeat_interleave(3)
    H = H * (free[:, None] & free[None, :]).to(dt)
    return H + torch.diag((~free).to(dt))


def _hvp(v, edges, w, Jb, Je, gauge_mask, sums=None):
    """Matrix-free H v for the cg path, v [N, 3] -> [N, 3]: edge-wise
    y_e = w (Jb v_b + Je v_e), then Jb^T y and Je^T y summed per node."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    v = torch.where(gauge_mask[:, None], v, zero)
    y = w[:, None] * (torch.einsum("eij,ej->ei", Jb, v[edges.idx[:, 0]])
                      + torch.einsum("eij,ej->ei", Je, v[edges.idx[:, 1]]))
    sums = sums or _GraphSums(v.shape[0], edges)
    out = sums.nodes(torch.einsum("eij,ei->ej", Jb, y),
                     torch.einsum("eij,ei->ej", Je, y))
    return torch.where(gauge_mask[:, None], out, zero)


def _block_diag(n, edges, blocks, gauge_mask, sums=None):
    """3x3 diagonal blocks [N, 3, 3] of H; identity at fixed nodes."""
    wJb, wJe = blocks
    D = (sums or _GraphSums(n, edges)).nodes(wJb.transpose(-1, -2) @ wJb,
                                             wJe.transpose(-1, -2) @ wJe)
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    return torch.where(gauge_mask[:, None, None], D, eye)


def _pcg(A, precond, b, iters, tol, early_stop=False):
    """Preconditioned CG on A x = b (``A`` and ``precond`` map [N, 3] to
    [N, 3]) until the residual falls below ``tol`` of |b| or ``iters``
    steps.  The trip count is fixed and convergence freezes the state through
    ``active``, so the loop reads nothing back to the host; ``early_stop``
    reads ``active`` once a step and leaves the loop when it falls, with the
    same result."""
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = (r * p).sum()
    bnorm = torch.sqrt((b * b).sum()) + 1e-30
    active = torch.ones((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        Ap = A(p)
        denom = (p * Ap).sum()
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30),
                            zero)
        xn = x + alpha * p
        rn = r - alpha * Ap
        zn = precond(rn)
        rzn = (rn * zn).sum()
        pn = zn + rzn / torch.clamp(rz, min=1e-30) * p
        done = torch.sqrt((rn * rn).sum()) < tol * bnorm
        x, r, p = (torch.where(active, xn, x), torch.where(active, rn, r),
                   torch.where(active, pn, p))
        rz = torch.where(active, rzn, rz)
        active = active & ~done & (denom > 0)
        if early_stop and not bool(active):
            break
    return x


def _pcg_solve(b, edges, w, Jb, Je, diag_blocks, gauge_mask, lam, iters, tol,
               sums=None):
    """Block-Jacobi preconditioned CG on (H + lam*diag(H)) x = b, at a fixed
    trip count."""
    sums = sums or _GraphSums(b.shape[0], edges)
    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    lam_diag = lam * torch.diagonal(diag_blocks, dim1=-2, dim2=-1)  # [N, 3]
    Minv = torch.linalg.inv(diag_blocks + torch.diag_embed(lam_diag)
                            + 1e-9 * eye)

    def A(v):
        return _hvp(v, edges, w, Jb, Je, gauge_mask, sums) + lam_diag * v \
            + 1e-9 * v

    def precond(v):
        return torch.einsum("nij,nj->ni", Minv, v)

    return _pcg(A, precond, b, iters, tol)


def _ptd_interior(Dr, Orr, f_prev):
    """Segment-interior elimination for a batch of segments: Dr/Orr
    [B, seg, 3, 3], ``f_prev`` [B, 3, 3] the coupling from each segment's
    preceding separator into its first node (zeros for the first segment).
    Returns the per-segment factors and separator-reduction contributions."""
    nb, seg = Dr.shape[0], Dr.shape[1]
    m = seg - 1  # interior nodes per segment
    A = Dr.new_zeros((nb, m, 3, m, 3))
    for i in range(m):
        A[:, i, :, i, :] = Dr[:, i]
    for i in range(m - 1):
        A[:, i, :, i + 1, :] = Orr[:, i]
        A[:, i + 1, :, i, :] = Orr[:, i].transpose(-1, -2)
    A = A.reshape(nb, 3 * m, 3 * m)
    eye_m = torch.eye(3 * m, dtype=Dr.dtype, device=Dr.device)
    L, _ = torch.linalg.cholesky_ex(A + 1e-12 * eye_m)
    A_inv = torch.cholesky_solve(eye_m.expand(nb, -1, -1), L)

    # E: coupling of the segment to its own separator, at interior row m-1;
    # F: coupling to the preceding separator, at interior row 0
    E = Dr.new_zeros((nb, 3 * m, 3))
    E[:, 3 * (m - 1):, :] = Orr[:, m - 1]
    F = Dr.new_zeros((nb, 3 * m, 3))
    F[:, :3, :] = f_prev.transpose(-1, -2)
    Ainv_E, Ainv_F = A_inv @ E, A_inv @ F
    return dict(A_inv=A_inv, E=E, F=F, Ainv_E=Ainv_E, Ainv_F=Ainv_F,
                EtAE=E.transpose(-1, -2) @ Ainv_E,
                FtAF=F.transpose(-1, -2) @ Ainv_F,
                FtAE=F.transpose(-1, -2) @ Ainv_E, d_sep=Dr[:, seg - 1])


def _shift_up(x):
    """x[i + 1] at row i, zeros at the last row."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


def _shift_down(x):
    """x[i - 1] at row i, zeros at the first row."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _ptd_reduce(d_sep, EtAE, FtAF, FtAE):
    """Assemble and invert the reduced separator system from the per-segment
    contributions [B, 3, 3] (dense 3B x 3B: B is small)."""
    nb = d_sep.shape[0]
    # D~_s = D_sep_s - E_s^T A_s^-1 E_s - F_{s+1}^T A_{s+1}^-1 F_{s+1}
    d_red = d_sep - EtAE - _shift_up(FtAF)
    # off-diagonal (sep s, sep s+1): - F_{s+1}^T A_{s+1}^-1 E_{s+1}
    o_red = -_shift_up(FtAE)
    R = d_sep.new_zeros((nb, 3, nb, 3))
    di = torch.arange(nb, device=d_sep.device)
    R[di, :, di, :] = d_red
    R[di[:-1], :, di[:-1] + 1, :] = o_red[:-1]
    R[di[:-1] + 1, :, di[:-1], :] = o_red[:-1].transpose(-1, -2)
    R = R.reshape(3 * nb, 3 * nb)
    eye_r = torch.eye(3 * nb, dtype=d_sep.dtype, device=d_sep.device)
    chol, _ = torch.linalg.cholesky_ex(R + 1e-12 * eye_r)
    return torch.cholesky_solve(eye_r, chol)


def _partitioned_tridiag_prepare(D, O, seg: int):
    """Factorisation phase of the substructured block-tridiagonal solve.

    Nodes are partitioned into chunks of ``seg``; the last node of each chunk
    is a separator.  Everything that does not depend on the right-hand side
    (interior inverses, separator reduction, its inverse) is computed here,
    so repeated solves against the same T factorise once.

    D [N, 3, 3], O [N, 3, 3] (O[i] couples i, i+1; O[N-1] must be zero); N
    must be divisible by ``seg``."""
    n = D.shape[0]
    if n % seg:
        raise ValueError(f"node count {n} is not a multiple of seg={seg}")
    nb = n // seg
    Dr = D.reshape(nb, seg, 3, 3)
    Orr = O.reshape(nb, seg, 3, 3)
    # f_s = O[separator s -> first node of chunk s+1]; f[B-1] == 0
    loc = _ptd_interior(Dr, Orr, _shift_down(Orr[:, seg - 1]))
    R_inv = _ptd_reduce(loc["d_sep"], loc["EtAE"], loc["FtAF"], loc["FtAE"])
    return dict(n=n, nb=nb, seg=seg, m=seg - 1, A_inv=loc["A_inv"],
                E=loc["E"], F=loc["F"], Ainv_E=loc["Ainv_E"],
                Ainv_F=loc["Ainv_F"], R_inv=R_inv)


def _ptd_apply_interior(A_inv, E, F, b_r):
    """Per-segment forward phase: ``b_r`` [B, seg, 3, K] -> (Ainv_b
    [B, 3m, K], EtAb, FtAb, b_sep [B, 3, K])."""
    nb, seg, _, k = b_r.shape
    Ainv_b = A_inv @ b_r[:, :seg - 1].reshape(nb, 3 * (seg - 1), k)
    return (Ainv_b, E.transpose(-1, -2) @ Ainv_b,
            F.transpose(-1, -2) @ Ainv_b, b_r[:, seg - 1])


def _ptd_apply_back(Ainv_E, Ainv_F, Ainv_b, x_sep, x_sep_prev):
    """Per-segment back-substitution:
    x_seg_s = A^-1 b_seg - A^-1 E x_sep_s - A^-1 F x_sep_{s-1}."""
    return Ainv_b - Ainv_E @ x_sep - Ainv_F @ x_sep_prev


def _partitioned_tridiag_apply(ctx, b):
    """Solve phase: b [N, 3, K] -> T^-1 b from a prepared factorisation;
    matrix products only."""
    n, nb, seg, m = ctx["n"], ctx["nb"], ctx["seg"], ctx["m"]
    k = b.shape[-1]
    Ainv_b, EtAb, FtAb, b_sep = _ptd_apply_interior(
        ctx["A_inv"], ctx["E"], ctx["F"], b.reshape(nb, seg, 3, k))
    b_red = b_sep - EtAb - _shift_up(FtAb)
    x_sep = (ctx["R_inv"] @ b_red.reshape(3 * nb, k)).reshape(nb, 3, k)
    x_int = _ptd_apply_back(ctx["Ainv_E"], ctx["Ainv_F"], Ainv_b, x_sep,
                            _shift_down(x_sep))
    x = torch.cat([x_int.reshape(nb, m, 3, k), x_sep[:, None]], 1)
    return x.reshape(n, 3, k)


def _partitioned_tridiag_solve(D, O, b, seg: int):
    """One-shot prepare + apply."""
    return _partitioned_tridiag_apply(_partitioned_tridiag_prepare(D, O, seg),
                                      b)


def _is_chain(edges: GraphEdges):
    return ((edges.idx[:, 1] == edges.idx[:, 0] + 1)
            & (edges.etype == ODOMETRY) & edges.mask)


def _chain_blocks(n, edges, wJb, wJe, gauge_mask, sums=None):
    """Block-tridiagonal (D, O) of the odometry-chain part of H from
    gauge-projected whitened Jacobians: D [N, 3, 3] diagonal blocks, O
    [N, 3, 3] with O[i] coupling (i, i+1).  A node has at most two chain
    edges, so the two-term sums do not depend on the order of the adds."""
    chain = _is_chain(edges)[:, None, None]
    cb = torch.where(chain, wJb, torch.zeros_like(wJb))
    ce = torch.where(chain, wJe, torch.zeros_like(wJe))
    sums = sums or _GraphSums(n, edges)
    D = sums.nodes(cb.transpose(-1, -2) @ cb, ce.transpose(-1, -2) @ ce)
    O = sums.add("begins", D.new_zeros((n, 3, 3)),
                 lambda: torch.clamp(edges.idx[:, 0], max=n - 1),
                 cb.transpose(-1, -2) @ ce)
    return D, O


def _equilibrated_chain(D, O, gauge_mask, lam_diag):
    """T = chain + damping (+ identity at fixed nodes) under Jacobi
    equilibration (the chain spans ~4 orders of magnitude between translation
    and rotation information): (Ds, Os, dscale [N, 3])."""
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    D = D + torch.diag_embed(lam_diag) + 1e-8 * eye
    D = torch.where(gauge_mask[:, None, None], D, eye)
    both = torch.cat([gauge_mask[:-1] & gauge_mask[1:],
                      gauge_mask.new_zeros(1)])
    O = torch.where(both[:, None, None], O, torch.zeros_like(O))
    dscale = 1.0 / refmath.sqrt(torch.clamp(
        torch.diagonal(D, dim1=-2, dim2=-1), min=1e-20))  # [N, 3]
    Ds = D * dscale[:, :, None] * dscale[:, None, :]
    ds_next = torch.cat([dscale[1:], torch.ones_like(dscale[:1])])
    Os = O * dscale[:, :, None] * ds_next[:, None, :]
    return Ds, Os, dscale


def _chain_precond_prepare(D, O, gauge_mask, lam_diag, seg: int = 16):
    """Factorise T = chain + damping (+ identity at fixed nodes): Jacobi
    equilibration, identity padding to a multiple of ``seg`` and the
    partitioned tridiagonal factorisation.  Apply with
    :func:`_chain_precond_apply`."""
    n = D.shape[0]
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    Ds, Os, dscale = _equilibrated_chain(D, O, gauge_mask, lam_diag)
    pad_n = (-n) % seg
    ctx = _partitioned_tridiag_prepare(
        torch.cat([Ds, eye.expand(pad_n, 3, 3)]),
        torch.cat([Os, Os.new_zeros((pad_n, 3, 3))]), seg=seg)
    return dict(ctx=ctx, dscale=dscale, pad_n=pad_n, n=n, Ds=Ds, Os=Os)


def _chain_matvec(prep, x):
    """T_s x of the equilibrated, padded chain system; x [N + pad, 3, K]."""
    n, Ds, Os = prep["n"], prep["Ds"], prep["Os"]
    xs = x[:n]
    y = Ds @ xs + Os @ _shift_up(xs) \
        + _shift_down(Os).transpose(-1, -2) @ _shift_down(xs)
    return torch.cat([y, x[n:]])


def _chain_precond_apply(prep, v, refine: bool = False):
    """v [N, 3, K] -> T^-1 v from a prepared chain factorisation;
    ``refine`` adds one pass of iterative refinement (twice the cost)."""
    ctx, dscale, pad_n, n = (prep["ctx"], prep["dscale"], prep["pad_n"],
                             prep["n"])
    rs = v * dscale[:, :, None]
    rs = torch.cat([rs, rs.new_zeros((pad_n,) + rs.shape[1:])])
    x = _partitioned_tridiag_apply(ctx, rs)
    if refine:
        x = x + _partitioned_tridiag_apply(ctx, rs - _chain_matvec(prep, x))
    return x[:n] * dscale[:, :, None]


def _schur_solve(n, edges, blocks, gauge_mask, lam_diag, g, loop_idx,
                 refine_level: int = 2, seg_cap: int = 16, sums=None):
    """Direct solve of (H + damping) x = -g exploiting SLAM structure:
    H = T + U^T U, where T is the block-tridiagonal odometry-chain part
    (+ damping + gauge) and U stacks the whitened loop-edge Jacobian rows.

    Woodbury: x = T^-1 b - T^-1 U^T (I + U T^-1 U^T)^-1 U T^-1 b, with one
    batched chain solve over the 3L columns of U^T and a dense Cholesky of
    the 3L x 3L capacitance.  ``loop_idx`` [L] indexes the non-chain edges;
    slots that point at a chain edge contribute nothing.  ``sums``, the
    graph's ``_GraphSums``, is for one ``loop_idx``."""
    wJb, wJe = blocks
    sums = sums or _GraphSums(n, edges)
    dt, dev = wJb.dtype, wJb.device
    zero = torch.zeros((), dtype=dt, device=dev)
    # gauge projection: zero Jacobian columns of fixed nodes
    wJb = torch.where(gauge_mask[edges.idx[:, 0]][:, None, None], wJb, zero)
    wJe = torch.where(gauge_mask[edges.idx[:, 1]][:, None, None], wJe, zero)

    D, O = _chain_blocks(n, edges, wJb, wJe, gauge_mask, sums)
    # damping over the FULL diagonal (chain + loops) goes into T; the
    # segment size follows the node count up to ``seg_cap``
    seg = min(seg_cap, max(4, 1 << (max(n, 2) - 1).bit_length() - 2))
    prep = _chain_precond_prepare(D, O, gauge_mask, lam_diag, seg=seg)
    solve_t = lambda rhs, refine=False: _chain_precond_apply(prep, rhs,
                                                              refine)

    is_loop = edges.mask & ~_is_chain(edges)
    lv = is_loop[loop_idx][:, None, None]
    lb = torch.where(lv, wJb[loop_idx], zero)  # [L, 3, 3]
    le = torch.where(lv, wJe[loop_idx], zero)
    bidx = edges.idx[loop_idx, 0]
    eidx = edges.idx[loop_idx, 1]
    l = loop_idx.shape[0]

    # batched rhs U^T [N, 3, 3L]: the U row block of loop k occupies columns
    # 3k..3k+2, with wJb^T at node b and wJe^T at node e
    k3 = torch.arange(3, device=dev)
    cols = 3 * torch.arange(l, device=dev)[:, None, None] + k3[None, None, :]
    flat = lambda node: ((node[:, None, None] * 3 + k3[None, :, None])
                         * (3 * l) + cols).reshape(-1)
    ut = sums.add("loop_columns", torch.zeros(n * 3 * 3 * l, dtype=dt,
                                              device=dev),
                  lambda: torch.cat([flat(bidx), flat(eidx)]),
                  torch.cat([lb.transpose(1, 2).reshape(-1),
                             le.transpose(1, 2).reshape(-1)]))
    tut = solve_t(ut.reshape(n, 3, 3 * l))  # T^-1 U^T

    def apply_u(x):  # x [N, 3, K] -> U x [3L, K]
        return (lb @ x[bidx] + le @ x[eidx]).reshape(3 * l, -1)

    eye_l = torch.eye(3 * l, dtype=dt, device=dev)
    chol, _ = torch.linalg.cholesky_ex(eye_l + apply_u(tut) + 1e-9 * eye_l)

    def woodbury(bv):  # [N, 3] -> (T + U^T U)^-1 bv, reusing tut and chol
        tbv = solve_t(bv[:, :, None], refine=refine_level >= 1)
        z = torch.cholesky_solve(apply_u(tbv), chol)  # [3L, 1]
        return tbv[..., 0] - (tut.reshape(3 * n, 3 * l) @ z).reshape(n, 3)

    def matvec_h(x):  # full damped H x (all edges + damping + gauge)
        xv = torch.where(gauge_mask[:, None], x, zero)
        y = (torch.einsum("eri,ei->er", wJb, xv[edges.idx[:, 0]])
             + torch.einsum("eri,ei->er", wJe, xv[edges.idx[:, 1]]))
        out = sums.nodes(torch.einsum("eri,er->ei", wJb, y),
                         torch.einsum("eri,er->ei", wJe, y))
        return torch.where(gauge_mask[:, None], out + lam_diag * xv, xv)

    b = -g
    x = woodbury(b)
    if refine_level >= 2:
        x = x + woodbury(b - matvec_h(x))  # full-solve refinement
    return torch.where(gauge_mask[:, None], x, zero)


def _laplacian_solve(n, edges, free, w, rhs_edge, sums=None):
    """Solve (D^T W D) x = D^T (w * rhs) over the edge incidence D (end minus
    begin), gauge-fixed at non-free nodes."""
    dev, dt = w.device, w.dtype
    b, e = edges.idx[:, 0], edges.idx[:, 1]
    sums = sums or _GraphSums(n, edges)
    lap = sums.add("laplacian", torch.zeros(n * n, dtype=dt, device=dev),
                   lambda: torch.cat([b * n + b, e * n + e, b * n + e,
                                      e * n + b]),
                   torch.cat([w, w, -w, -w]))
    lap = lap.reshape(n, n)
    lap = lap * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
    wr = w[:, None] * rhs_edge
    rhs = sums.add("incidence", torch.zeros((n, rhs_edge.shape[1]), dtype=dt,
                                            device=dev),
                   lambda: torch.cat([e, b]), torch.cat([wr, -wr]))
    rhs = rhs * free[:, None]
    chol, _ = torch.linalg.cholesky_ex(
        lap + 1e-6 * torch.eye(n, dtype=dt, device=dev))
    return torch.cholesky_solve(rhs, chol)


def _lago_initialize(poses, gauge_mask, edges: GraphEdges, sums=None):
    """Two-stage linear initialisation (LAGO-style): orientations from a
    graph-Laplacian solve, then positions given orientations."""
    n = poses.shape[0]
    sums = sums or _GraphSums(n, edges)
    free = gauge_mask.to(poses.dtype)
    zero = torch.zeros((), dtype=poses.dtype, device=poses.device)
    info_diag = (edges.sqrt_info ** 2).sum(1)  # [E, 3]
    w_th = torch.where(edges.mask, info_diag[:, 2], zero)
    pb = poses[edges.idx[:, 0]]
    pe = poses[edges.idx[:, 1]]
    r_th = se2.wrap_angle(pe[:, 2] - pb[:, 2] - edges.meas[:, 2])
    delta = _laplacian_solve(n, edges, free, w_th, -r_th[:, None],
                             sums)[:, 0]
    theta = se2.wrap_angle(poses[:, 2] + delta)

    tb = theta[edges.idx[:, 0]]
    s, c = refmath.sincos(tb)
    dx = c * edges.meas[:, 0] - s * edges.meas[:, 1]
    dy = s * edges.meas[:, 0] + c * edges.meas[:, 1]
    w_xy = torch.where(edges.mask, 0.5 * (info_diag[:, 0] + info_diag[:, 1]),
                       zero)
    cur = poses[:, :2]
    rhs = torch.stack([dx, dy], -1) - (cur[edges.idx[:, 1]]
                                       - cur[edges.idx[:, 0]])
    p = cur + _laplacian_solve(n, edges, free, w_xy, rhs, sums)
    out = torch.cat([p, theta[:, None]], 1)
    return torch.where(gauge_mask[:, None], out, poses)


SOLVERS = ("cholesky", "schur", "cg")


def optimize(poses: torch.Tensor, node_mask: torch.Tensor, edges: GraphEdges,
             cfg: PGOConfig, solver: str = "cholesky",
             loop_cap: Optional[int] = None) -> PGOResult:
    """Robust LM over the whole pose graph, first pose gauge-fixed
    (CeresLeastSquares::Solve semantics): trust-region LM with accept/reject,
    up to ``cfg.max_iterations`` outer steps, converging on the relative cost
    decrease.  ``solver`` is ``cholesky``, ``schur`` or ``cg``; ``schur``
    needs ``loop_cap`` >= the number of non-chain edges."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}: one of {SOLVERS}")
    n = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    gauge_mask = node_mask & (torch.arange(n, device=dev) != 0)
    zero = torch.zeros((), dtype=dt, device=dev)
    loop_idx = None
    if solver == "schur":
        if loop_cap is None:
            raise ValueError("solver='schur' requires loop_cap")
        is_loop = edges.mask & ~_is_chain(edges)
        n_loop = int(is_loop.sum())
        if n_loop > loop_cap:
            # loop edges beyond loop_cap would be left out of the Woodbury
            # correction while still counting in cost and gradient
            raise ValueError(
                f"solver='schur': loop_cap={loop_cap} < {n_loop} non-chain "
                "edges: raise loop_cap (truncation would yield a wrong solve)")
        loop_idx = torch.argsort((~is_loop).to(torch.uint8),
                                 stable=True)[:loop_cap]

    sums = _GraphSums(n, edges)  # every edge sum's order, made once
    cost0 = graph_cost(poses, edges, cfg)
    cur = cost0
    if cfg.lago_init:
        cand = _lago_initialize(poses, gauge_mask, edges, sums)
        cand_cost = graph_cost(cand, edges, cfg)
        better = cand_cost < cost0
        poses = torch.where(better, cand, poses)
        cur = torch.where(better, cand_cost, cost0)

    def stepped(p, step):
        c = p + step
        c = torch.cat([c[:, :2], se2.wrap_angle(c[:, 2:3])], 1)
        return torch.where(gauge_mask[:, None], c, p)

    def linearize(p):
        """The normal equations at ``p`` as a function lam -> LM step."""
        _, g, blocks = _gradient_and_blocks(p, edges, cfg, sums)
        gm = torch.where(gauge_mask[:, None], g, zero)
        if solver == "cholesky":
            H = _dense_hessian(n, edges, blocks, gauge_mask, sums)
            hdiag = torch.diagonal(H)
            eye = torch.eye(3 * n, dtype=dt, device=dev)

            def solve(lam):
                chol, _ = torch.linalg.cholesky_ex(
                    H + torch.diag(lam * hdiag) + 1e-9 * eye)
                return -torch.cholesky_solve(gm.reshape(-1, 1),
                                             chol).reshape(n, 3)
        elif solver == "schur":
            wJb, wJe = blocks
            hdiag = sums.nodes(torch.einsum("eri,eri->ei", wJb, wJb),
                               torch.einsum("eri,eri->ei", wJe, wJe))

            def solve(lam):
                return _schur_solve(n, edges, blocks, gauge_mask, lam * hdiag,
                                    gm, loop_idx,
                                    refine_level=cfg.schur_refine,
                                    seg_cap=cfg.schur_seg, sums=sums)
        else:
            r, Jb, Je = _edge_jacobians(p, edges)
            _, w = _cauchy_weights(r, edges, cfg)
            diag_blocks = _block_diag(n, edges, blocks, gauge_mask, sums)

            def solve(lam):
                step = -_pcg_solve(gm, edges, w, Jb, Je, diag_blocks,
                                   gauge_mask, lam, cfg.cg_iterations,
                                   cfg.cg_tol, sums)
                return torch.where(gauge_mask[:, None], step, zero)
        return solve

    # LM state on the host in float32, as the reference carries it; one
    # device->host read of the candidate costs per iteration drives the loop
    f32 = np.float32
    p = poses
    cur_h = f32(cur.item())
    lam = f32(cfg.init_lambda)
    accepted = 0
    small_prev = False
    for _ in range(cfg.max_iterations):
        solve = linearize(p)
        lams = [lam]
        if solver == "cg":
            cands = [stepped(p, solve(float(lam)))]
        elif cfg.line_search:
            s = solve(float(lam))
            cands = [stepped(p, a * s) for a in cfg.step_ladder]
        else:
            if cfg.tri_damping:
                lams = [f32(m) * lam for m in cfg.damping_ladder]
            cands = [stepped(p, solve(float(l))) for l in lams]
        costs = torch.stack([graph_cost(c, edges, cfg) for c in cands])
        costs_h = costs.cpu().numpy()
        best = int(np.argmin(costs_h))  # first NaN wins, as jnp.argmin
        if cfg.line_search and solver != "cg":
            lam_next = max(lam * f32(0.5), f32(1e-12)) if best == 0 else \
                min(lam * f32(4.0), f32(1e8))
        else:
            lam_next = max(lams[best] * f32(0.5), f32(1e-12))
        new_h = costs_h[best]
        acc = bool(new_h < cur_h)
        rel_dec = (cur_h - new_h) / max(cur_h, f32(1e-20))
        small = abs(rel_dec) < cfg.function_tolerance
        small_now = (acc and small) or (not acc and small and lam > 1e2)
        done = (small_now and small_prev) or lam > 1e7
        if acc:
            p, lam, cur_h, cur = cands[best], lam_next, new_h, costs[best]
            accepted += 1
        else:
            lam = min(lam * f32(10.0), f32(1e8))
        small_prev = small_now
        if done:
            break
    return PGOResult(poses=p, cost0=cost0, cost=cur,
                     iterations=torch.tensor(accepted))


def make_edges(idx, meas, sqrt_info, etype, mask, device=None) -> GraphEdges:
    """Edges from arrays or tensors; ``sqrt_info`` may be per-edge diagonal
    [E, 3] or full [E, 3, 3]."""
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    # subnormal whitening entries flushed once here: the reference's
    # threads treat them as zeros in every operation (DAZ)
    s = refmath.ftz(t(sqrt_info, torch.float32))
    if s.ndim == 2:
        s = torch.diag_embed(s)
    return GraphEdges(idx=t(idx, torch.long), meas=t(meas, torch.float32),
                      sqrt_info=s, etype=t(etype, torch.long),
                      mask=t(mask, torch.bool))
