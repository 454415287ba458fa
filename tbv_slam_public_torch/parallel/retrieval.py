"""Descriptor-database retrieval sharded over the ranks of a mesh.

Port of ``tbv_slam_public_tpu.parallel.retrieval``.  The reference's
place-recognition search is a linear scan over all history on one CPU core
(``OdometryNNSearch``, RadarScancontext.cpp:259-284).  Here each rank holds a
contiguous block of the keyframe axis of the [N, R, S] descriptors and the
[N, R] ring keys (the large part: 4471 x 40 x 120 float32 is 86 MB at Oxford
scale); the mask and the odometry poses, which ``detect`` needs whole, stay
whole on every rank.  Retrieval is:

1. per rank: masked ring-key distance (+ the odometry term) and a local
   top-k by stable sort,
2. per rank: the ScanContext distance of the local winners only,
3. one gather of the D x K records (5 scalars each) and a global merge,
   ordered by distance and then by global index, so that ``index``,
   ``shift`` and ``valid`` equal ``ops.scancontext.retrieve`` bit for bit.

Communication per query: D x K records, independent of the database size.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import refmath
from ..ops import scancontext
from ..ops.scancontext import RetrievalResult
from .multihost import Mesh, _pack, _unpack, all_gather, make_mesh, rows

make_db_mesh = make_mesh


def shard_db(mesh: Mesh, db):
    """A ``models.loopclosure.LoopDB`` that keeps only this rank's block of
    ``desc`` and ``ring`` (``lo`` is its first global slot); ``mask`` and
    ``odom_pose`` stay whole.  The capacity must divide by the mesh size."""
    lo, hi = rows(db.mask.shape[0], mesh)
    return dataclasses.replace(db, desc=db.desc[lo:hi].clone(),
                               ring=db.ring[lo:hi].clone(), lo=lo)


def unshard_db(mesh: Mesh, db):
    """The whole database on every rank (to grow a sharded one)."""
    full = lambda x: all_gather(x, mesh).reshape((-1,) + x.shape[1:])
    return dataclasses.replace(db, desc=full(db.desc), ring=full(db.ring),
                               lo=0)


def sharded_retrieve(
    mesh: Mesh,
    query_desc: torch.Tensor,  # [..., R, S] replicated
    query_key: torch.Tensor,  # [..., R]
    db_desc: torch.Tensor,  # [N / D, R, S] this rank's rows (shard_db)
    db_key: torch.Tensor,  # [N / D, R]
    db_mask: torch.Tensor,  # [..., N] bool, whole
    odom_similarity: torch.Tensor,  # [..., N], whole
    *,
    num_candidates: int,
    search_ratio: float,
    odometry_coupled: bool = True,
) -> RetrievalResult:
    """Mesh-sharded equivalent of ``ops.scancontext.retrieve``; N must
    divide by the mesh size."""
    lo, hi = rows(db_mask.shape[-1], mesh)
    if db_desc.shape[0] != hi - lo or db_key.shape[0] != hi - lo:
        raise ValueError(f"the descriptors hold {db_desc.shape[0]} rows, not "
                         f"this rank's {hi - lo} (see shard_db)")
    mask, osim = db_mask[..., lo:hi], odom_similarity[..., lo:hi]
    inf = torch.full((), math.inf, device=db_key.device)

    d2 = refmath.sc_ring_distance(  # [..., N / D], +inf off the mask
        query_key, db_key, mask, osim if odometry_coupled else None)
    srt, lidx = torch.sort(d2, dim=-1, stable=True)
    srt, lidx = srt[..., :num_candidates], lidx[..., :num_candidates]
    # score the local winners only: the descriptors stay on their rank
    dist_sc, shift = scancontext.sc_distance(
        query_desc[..., None, :, :], db_desc[lidx], search_ratio=search_ratio)
    if odometry_coupled:
        dist_odom = torch.gather(
            osim.expand(lidx.shape[:-1] + d2.shape[-1:]), -1, lidx)
    else:
        dist_odom = torch.zeros_like(dist_sc)

    # gather the D x K records: [D, ..., K, 5] -> [..., D * K, 5]
    lead, k = srt.shape[:-1], srt.shape[-1]
    like = [srt, lidx + lo, dist_sc, shift, dist_odom]
    rec = _pack([x.reshape(-1, 1) for x in like])
    got = all_gather(rec.reshape(lead + (k, 5)), mesh)
    got = got.movedim(0, -3).reshape(lead + (mesh.size * k, 5))
    # stable global merge: by distance, equal distances by global index (the
    # order of the single-device stable sort); a stable sort by index first
    order = torch.sort(got[..., 1], dim=-1, stable=True)[1]
    got = torch.gather(got, -2, order[..., None].expand(order.shape + (5,)))
    order = torch.sort(got[..., 0], dim=-1, stable=True)[1][
        ..., :num_candidates]
    got = torch.gather(got, -2, order[..., None].expand(order.shape + (5,)))
    srt, index, dist_sc, shift, dist_odom = (
        x.reshape(order.shape) for x in _unpack(
            got.reshape(-1, 5), [x.reshape(-1, 1) for x in like]))
    valid = torch.isfinite(srt)
    total = torch.where(valid, dist_sc + dist_odom, inf)
    return RetrievalResult(dist=total, dist_sc=dist_sc, dist_odom=dist_odom,
                           index=index, shift=shift, valid=valid)
