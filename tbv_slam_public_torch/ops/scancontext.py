"""Radar ScanContext place recognition, batched over queries.

Port of ``tbv_slam_public_tpu.ops.scancontext``: the sum-mode descriptor is
an ``index_add_`` scatter (the reference's one-hot contractions served the
TPU), the max-mode one a ``scatter_reduce`` with a spill bin, and
``sc_distance`` / ``retrieve`` take any leading batch dimensions
where the reference ``vmap``s.  The keys, the ring-key distance and
``sc_distance`` are ``kernels/refmath.py``'s ScanContext ops: plain
versions in ``core/refmath.py`` (the reference's order of every sum),
``csrc/scancontext.cu`` on the card.  Retrieval's top-k is a stable ascending sort
(lower database index first on ties, as ``lax.top_k`` of the negated key).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import ScanContextConfig
from ..core.device import constant, deterministic
from ..core.refmath import recip
from ..core.types import PointCloud
from ..kernels import refmath


def _sector_scale(ns: int) -> float:
    """(180 / pi) / 360 * ns as the reference's compiler folds it: one
    float32 rounding a constant product, the division a reciprocal."""
    f = np.float32
    return float(f(f(f(180.0 / math.pi) * f(recip(360.0))) * f(ns)))


def make_descriptor(cloud: PointCloud, cfg: ScanContextConfig) -> torch.Tensor:
    """Point clouds [..., P] -> [..., ring, sector] ScanContext descriptors
    (MakeRadarCloudContext): the sum (``desc_function="sum"``) or the
    maximum (``"max"``) of the intensities in each bin, divided by
    ``desc_divider``; ``no_point`` where a bin holds no point."""
    xy, inten, mask = cloud.xy, cloud.intensity, cloud.mask
    nr, ns = cfg.num_ring, cfg.num_sector
    lead = mask.shape[:-1]
    # the radius and its ring as the reference's program computes them: the
    # two-term sum fused, the IEEE square root, and a true division by
    # max_radius (a runtime operand there; torch on the card would divide
    # by a number as a product by its reciprocal, so it divides by a tensor)
    r = refmath.norm2(xy)
    in_range = mask & (r <= cfg.max_radius)
    ring = torch.clamp(torch.ceil(
        r / constant(cfg.max_radius, r.dtype, r.device) * nr), 1, nr) - 1
    # degrees / 360 * ns: the reference's compiler folds the three constant
    # factors (the last two a division by a constant, so a reciprocal) into
    # one float32 product
    ang = torch.remainder(refmath.atan2(xy[..., 1], xy[..., 0]), 2 * math.pi)
    sector = torch.clamp(torch.ceil(ang * _sector_scale(ns)), 1, ns) - 1
    nb = nr * ns
    row = torch.arange(mask[..., 0].numel(), device=xy.device).reshape(lead)
    lin = (row[..., None] * nb + (ring * ns + sector).long()).reshape(-1)
    fin = in_range.to(inten.dtype).reshape(-1)
    total = nb * row.numel()
    counts = torch.zeros(total, dtype=inten.dtype,
                         device=xy.device).index_add_(0, lin, fin)
    if cfg.desc_function == "sum":
        with deterministic():  # float sums in index order on the card too
            desc = torch.zeros(total, dtype=inten.dtype,
                               device=xy.device).index_add_(
                0, lin, inten.reshape(-1) * fin)
    elif cfg.desc_function == "max":
        # points out of range go to a spill bin past the last one
        spill = torch.where(in_range.reshape(-1), lin, total)
        desc = torch.zeros(total + 1, dtype=inten.dtype,
                           device=xy.device).scatter_reduce_(
            0, spill, inten.reshape(-1), "amax", include_self=False)[:-1]
    else:
        raise ValueError(f"unknown desc_function {cfg.desc_function!r}")
    desc = (desc / cfg.desc_divider).reshape(lead + (nr, ns))
    counts = counts.reshape(lead + (nr, ns))
    return torch.where(counts > 0.5, desc, torch.full_like(desc, cfg.no_point))


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row-wise mean (rotation-invariant key), summed and scaled as the
    reference's program (``core/refmath.py::sc_key``; one launch on the
    card)."""
    return refmath.sc_key(desc, ring=True)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Column-wise mean (``core/refmath.py::sc_key``)."""
    return refmath.sc_key(desc, ring=False)


def all_column_shifts(desc: torch.Tensor) -> torch.Tensor:
    """[..., shift, ring, sector] stack of circular column shifts:
    shifted[..., :, (c + s) mod S] = desc[..., :, c]."""
    s = desc.shape[-1]
    cols = torch.arange(s, device=desc.device)
    src = torch.remainder(cols[None, :] - cols[:, None], s)  # [shift, col]
    return desc[..., src].movedim(-2, -3)


def sc_distance(query: torch.Tensor, candidate: torch.Tensor,
                search_ratio: float = 0.1):
    """(min distance, argmin shift) between descriptors [..., R, S]
    (distanceBtnScanContext): sector-key alignment picks a centre shift, and
    the column-wise cosine distance is taken over +-round(0.5*ratio*S)
    shifts around it, every sum in the reference's order
    (``core/refmath.py::sc_distance``; one launch on the card, a block a
    pair)."""
    return refmath.sc_distance(query, candidate, search_ratio=search_ratio)


class RetrievalResult(NamedTuple):
    dist: torch.Tensor  # [..., K] combined score (sc + odom when coupled)
    dist_sc: torch.Tensor
    dist_odom: torch.Tensor
    index: torch.Tensor  # [..., K] database ids
    shift: torch.Tensor
    valid: torch.Tensor


def retrieve(query_desc: torch.Tensor, query_key: torch.Tensor,
             db_desc: torch.Tensor, db_key: torch.Tensor,
             db_mask: torch.Tensor, odom_similarity: torch.Tensor, *,
             num_candidates: int, search_ratio: float,
             odometry_coupled: bool = True) -> RetrievalResult:
    """Ring-key NN retrieval + ScanContext distance (OdometryNNSearch).

    query_desc [..., R, S], query_key [..., R], db_desc [N, R, S],
    db_key [N, R]; db_mask and odom_similarity [..., N] (per query)."""
    d2 = refmath.sc_ring_distance(  # [..., N], +inf off the mask
        query_key, db_key, db_mask,
        odom_similarity if odometry_coupled else None)
    srt, idx = torch.sort(d2, dim=-1, stable=True)
    idx = idx[..., :num_candidates]
    valid = torch.isfinite(srt[..., :num_candidates])
    cands = db_desc[idx]  # [..., K, R, S]
    dist_sc, shift = sc_distance(query_desc[..., None, :, :], cands,
                                 search_ratio=search_ratio)
    if odometry_coupled:
        dist_odom = torch.gather(
            odom_similarity.expand(idx.shape[:-1] + d2.shape[-1:]), -1, idx)
    else:
        dist_odom = torch.zeros_like(dist_sc)
    total = torch.where(valid, dist_sc + dist_odom,
                        torch.full((), math.inf, device=d2.device))
    return RetrievalResult(dist=total, dist_sc=dist_sc, dist_odom=dist_odom,
                           index=idx, shift=shift, valid=valid)


def shift_to_yaw(shift: torch.Tensor, num_sector: int) -> torch.Tensor:
    """Column shift -> yaw alignment in radians."""
    return shift.float() * (2.0 * math.pi / num_sector)


def _segment_lengths(d: torch.Tensor) -> torch.Tensor:
    """|d_i| of [N, 2] steps as the reference's program computes them in
    ``detect`` (its object code at capacity 256; held at ten capacities
    from 128 to 4608): a vector loop of 8 steps at a time squares and adds
    without fusing, sqrt(x*x + y*y); the remainder past the last multiple
    of 8 is scalar code that fuses, sqrt(fma(y, y, x*x))."""
    n = d.shape[0]
    x, y = d[:, 0], d[:, 1]
    plain = refmath.sqrt(x * x + y * y)
    vector = torch.arange(n, device=d.device) < n // 8 * 8
    return torch.where(vector, plain, refmath.norm2(d))


def _travel(positions: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """[..., N] path length from keyframe i to keyframe ``cur`` [...]; the
    cumulative sum in the reference's blocked order (``refmath.cumsum``)."""
    seg = _segment_lengths(positions[1:] - positions[:-1])
    cum = refmath.cumsum(torch.cat([seg.new_zeros(1), seg]))  # [N]
    return cum[cur][..., None] - cum


def odometry_similarity(positions: torch.Tensor, mask: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """Per-past-pose odometry similarity of the NEWEST masked pose, for each
    row of ``mask`` [..., N] over shared positions [N, 2]
    (ExcludeAndUpdateLikelihood); padded slots get 1 (worst)."""
    count = mask.sum(-1)
    cur = torch.clamp(count - 1, min=0)
    trav = _travel(positions, cur)
    d_est = refmath.norm2(positions[cur][..., None, :] - positions)
    err = torch.clamp(d_est - 5.0, min=0.0)
    rel = err / torch.clamp(trav, min=1e-9)
    # the division by a constant as the reference's product by its reciprocal
    sim = 1.0 - refmath.exp(-rel * rel * recip(2.0 * sigma * sigma))
    idx = torch.arange(positions.shape[0], device=positions.device)
    return torch.where(mask & (idx < (count - 1)[..., None]), sim,
                       torch.ones_like(sim))


def num_exclude_recent(positions: torch.Tensor, mask: torch.Tensor,
                       distance: float) -> torch.Tensor:
    """Dynamic recent-exclusion count from travelled distance, per row."""
    count = mask.sum(-1)
    cur = torch.clamp(count - 1, min=0)
    trav = _travel(positions, cur)
    idx = torch.arange(positions.shape[0], device=positions.device)
    within = mask & (idx <= cur[..., None]) & (trav < distance)
    floor = torch.where(count <= 2, torch.full_like(count, 2),
                        torch.zeros_like(count))
    return torch.maximum(within.sum(-1), floor)
