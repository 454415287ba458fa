"""Distributed pose-graph optimization over the ranks of a mesh.

Port of ``tbv_slam_public_tpu.parallel.pgo``: the edges are split over the
ranks (padded to a multiple of the mesh size with masked edges), the poses
are replicated.  Each LM iteration runs a preconditioned CG in which every
edge-indexed sum (the cost, the gradient, the block diagonal, the chain
blocks and every Hessian-vector product) is a rank-local sum followed by an
``all_reduce``.  Everything after a sum is computed from summed, hence
identical, values on every rank, so every rank takes the same accept/reject
decisions and CG stops, and ends on the same poses, which the function
checks.

The LM loop is the reference's own, not that of
``ops.posegraph.optimize``: ``cfg.max_iterations`` accept/reject steps,
lambda x0.5 (at least 1e-12) on accept and x4 (at most 1e8) on reject, no
function-tolerance stop; CG runs until converged or ``cfg.cg_iterations``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import se2
from ..core.config import PGOConfig
from ..core.types import ODOMETRY, GraphEdges
from ..ops import posegraph as pg
from .multihost import Mesh, agree, all_gather, make_mesh, psum, rows

__all__ = ["make_mesh", "optimize_distributed", "PRECONDITIONERS"]

PRECONDITIONERS = ("chain", "chain_sharded", "jacobi")


def _edge_shard(edges: GraphEdges, mesh: Mesh) -> GraphEdges:
    """This rank's block of the edges, padded to a multiple of the mesh size
    with masked edges (0 -> 0, zero weight everywhere)."""
    e = edges.mask.shape[0]
    pad = -e % mesh.size
    if pad:
        dev = edges.meas.device
        eye = torch.eye(3, dtype=edges.sqrt_info.dtype, device=dev)
        edges = GraphEdges(
            idx=torch.cat([edges.idx, edges.idx.new_zeros((pad, 2))]),
            meas=torch.cat([edges.meas, edges.meas.new_zeros((pad, 3))]),
            sqrt_info=torch.cat([edges.sqrt_info, eye.expand(pad, 3, 3)]),
            etype=torch.cat([edges.etype,
                             edges.etype.new_full((pad,), ODOMETRY)]),
            mask=torch.cat([edges.mask, edges.mask.new_zeros(pad)]))
    lo, hi = rows(e + pad, mesh)
    return edges.map(lambda x: x[lo:hi])


def _sharded_chain_prepare(mesh: Mesh, D, O, gauge_mask, lam_diag, seg: int):
    """Chain-preconditioner factorisation with the segment work split over
    the ranks: each rank eliminates the interiors of its whole segments and
    the [3, 3] separator contributions are gathered to build the replicated
    3B x 3B reduced system.  Apply with :func:`_sharded_chain_apply`."""
    n = D.shape[0]
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    Ds, Os, dscale = pg._equilibrated_chain(D, O, gauge_mask, lam_diag)
    pad_n = -n % (seg * mesh.size)  # every rank gets whole segments
    Ds = torch.cat([Ds, eye.expand(pad_n, 3, 3)])
    Os = torch.cat([Os, Os.new_zeros((pad_n, 3, 3))])
    nb = (n + pad_n) // seg
    Dr = Ds.reshape(nb, seg, 3, 3)
    Orr = Os.reshape(nb, seg, 3, 3)
    f_prev = pg._shift_down(Orr[:, seg - 1])
    lo, hi = rows(nb, mesh)
    loc = pg._ptd_interior(Dr[lo:hi], Orr[lo:hi], f_prev[lo:hi])
    parts = torch.stack([loc["EtAE"], loc["FtAF"], loc["FtAE"]])
    EtAE, FtAF, FtAE = all_gather(parts, mesh).transpose(0, 1).reshape(
        3, nb, 3, 3)
    R_inv = pg._ptd_reduce(Dr[:, seg - 1], EtAE, FtAF, FtAE)
    return dict(loc=loc, R_inv=R_inv, dscale=dscale, pad_n=pad_n, n=n,
                nb=nb, seg=seg, lo=lo, hi=hi)


def _sharded_chain_apply(mesh: Mesh, prep, v):
    """v [N, 3] -> T^-1 v with the per-segment solves split over the ranks
    (2 collectives: separator contributions, interior solutions)."""
    loc, seg, nb, lo, hi = (prep["loc"], prep["seg"], prep["nb"], prep["lo"],
                            prep["hi"])
    rs = (v * prep["dscale"])[:, :, None]
    rs = torch.cat([rs, rs.new_zeros((prep["pad_n"], 3, 1))])
    b_r = rs.reshape(nb, seg, 3, 1)
    Ainv_b, EtAb, FtAb, _ = pg._ptd_apply_interior(loc["A_inv"], loc["E"],
                                                   loc["F"], b_r[lo:hi])
    EtAb, FtAb = all_gather(torch.stack([EtAb, FtAb]), mesh).transpose(
        0, 1).reshape(2, nb, 3, 1)
    b_red = b_r[:, seg - 1] - EtAb - pg._shift_up(FtAb)
    x_sep = (prep["R_inv"] @ b_red.reshape(3 * nb, 1)).reshape(nb, 3, 1)
    x_int = pg._ptd_apply_back(loc["Ainv_E"], loc["Ainv_F"], Ainv_b,
                               x_sep[lo:hi], pg._shift_down(x_sep)[lo:hi])
    x_int = all_gather(x_int, mesh).reshape(nb, seg - 1, 3, 1)
    x = torch.cat([x_int, x_sep[:, None]], 1).reshape(-1, 3, 1)
    return x[:prep["n"], :, 0] * prep["dscale"]


def optimize_distributed(
    mesh: Mesh,
    poses: torch.Tensor,  # [N, 3] replicated
    node_mask: torch.Tensor,  # [N]
    edges: GraphEdges,  # [E] replicated; split here
    cfg: PGOConfig,
    preconditioner: str = "chain",
    precond_seg: Optional[int] = None,
) -> pg.PGOResult:
    """Robust LM with edge-sharded CG; the result is the same on every rank.

    ``preconditioner``:

    - ``"chain"`` (default): the odometry-chain block-tridiagonal T (+
      damping), factorised on every rank, so CG converges like the direct
      schur/Woodbury solve;
    - ``"chain_sharded"``: the per-segment interior factorisation and solves
      split over the ranks, only the 3B x 3B separator system replicated;
    - ``"jacobi"``: the block-Jacobi diagonal.

    ``precond_seg``: segment size of the chain preconditioners (default
    ``2 * cfg.schur_seg``, ``4 * cfg.schur_seg`` for ``chain_sharded``, whose
    larger segments move work into the split interior batch).
    """
    if preconditioner not in PRECONDITIONERS:
        raise ValueError(f"unknown preconditioner {preconditioner!r}: one of "
                         f"{PRECONDITIONERS}")
    n = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    # the edge split and every collective's shape follow from (N, E)
    agree((n, edges.mask.shape[0]), mesh)
    loc = _edge_shard(edges, mesh)
    sums = pg._GraphSums(n, loc)  # the order of this rank's edge sums
    seg = int(precond_seg or (4 if preconditioner == "chain_sharded" else 2)
              * cfg.schur_seg)
    gauge = node_mask & (torch.arange(n, device=dev) != 0)
    eye = torch.eye(3, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def cost_fn(p):
        r, _ = pg._edge_residuals(p, loc)
        rho, _ = pg._cauchy_weights(r, loc, cfg)
        return psum(0.5 * rho.sum(), mesh)

    def sum_blocks(p):
        """(g, diag, D, O) of H at ``p``, the local sums joined by one
        collective, and the local terms of the Hessian-vector product."""
        _, g, blocks = pg._gradient_and_blocks(p, loc, cfg, sums)
        parts = [g, pg._block_diag(n, loc, blocks, gauge, sums)]
        if preconditioner != "jacobi":
            wJb, wJe = blocks  # sqrt(w)-weighted whitened Jacobians
            wJb = torch.where(gauge[loc.idx[:, 0]][:, None, None], wJb, zero)
            wJe = torch.where(gauge[loc.idx[:, 1]][:, None, None], wJe, zero)
            parts += pg._chain_blocks(n, loc, wJb, wJe, gauge, sums)
        flat = psum(torch.cat([x.reshape(-1) for x in parts]), mesh)
        out, lo = [], 0
        for x in parts:
            out.append(flat[lo:lo + x.numel()].reshape(x.shape))
            lo += x.numel()
        r, Jb, Je = pg._edge_jacobians(p, loc)
        _, w = pg._cauchy_weights(r, loc, cfg)
        return out, (w, Jb, Je)

    cost0 = cost_fn(poses)
    p, cur = poses, cost0
    lam = torch.tensor(cfg.init_lambda, dtype=dt, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_iterations):
        (g, diag, *chain), (w, Jb, Je) = sum_blocks(p)
        # fixed nodes: every rank added an identity; reset it to one
        diag = torch.where(gauge[:, None, None], diag, eye)
        lam_diag = lam * torch.diagonal(diag, dim1=-2, dim2=-1)

        def A(v):
            hv = pg._hvp(v, loc, w, Jb, Je, gauge, sums)
            return psum(hv, mesh) + lam_diag * v + 1e-9 * v

        if preconditioner == "chain_sharded":
            prep = _sharded_chain_prepare(mesh, *chain, gauge, lam_diag, seg)
            apply = lambda v: _sharded_chain_apply(mesh, prep, v)
        elif preconditioner == "chain":
            prep = pg._chain_precond_prepare(*chain, gauge, lam_diag, seg=seg)
            apply = lambda v: pg._chain_precond_apply(prep, v[:, :, None])[
                ..., 0]
        else:
            minv = torch.linalg.inv(diag + torch.diag_embed(lam_diag)
                                    + 1e-9 * eye)
            apply = lambda v: torch.einsum("nij,nj->ni", minv, v)
        precond = lambda v: torch.where(gauge[:, None], apply(v), zero)

        # the stop test reads one summed scalar a step, the same on every
        # rank
        step = pg._pcg(A, precond, torch.where(gauge[:, None], -g, zero),
                       cfg.cg_iterations, cfg.cg_tol, early_stop=True)
        cand = p + torch.where(gauge[:, None], step, zero)
        cand = torch.cat([cand[:, :2], se2.wrap_angle(cand[:, 2:3])], 1)
        new_cost = cost_fn(cand)
        accept = new_cost < cur
        p = torch.where(accept, cand, p)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-12),
                          torch.clamp(lam * 4.0, max=1e8))
        cur = torch.where(accept, new_cost, cur)
        accepted = accepted + accept.to(torch.int32)
    if mesh.size > 1:
        got = all_gather(p, mesh)
        if not bool((got == got[0]).all()):
            raise RuntimeError("distributed PGO: the ranks ended on "
                               "different poses")
    return pg.PGOResult(poses=p, cost0=cost0, cost=cur, iterations=accepted)
