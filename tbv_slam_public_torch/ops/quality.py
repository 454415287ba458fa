"""Additional alignment-quality metrics (the secondary AlignmentQuality
subclasses, AlignmentQuality.h:119-236).

Port of ``tbv_slam_public_tpu.ops.quality``; every function takes clouds
with any leading batch dimensions ([..., P]):

- ``p2p_quality``: mean squared distance of each source point to its
  nearest reference point, over those within ``radius`` (p2pQuality),
- ``keypoint_repeatability``: fraction of source points with a reference
  neighbour within ``radius`` (keypointRepetability),
- ``p2d_quality``: mean Mahalanobis distance of source points to the nearest
  CFEAR cell distribution within ``radius`` (p2dQuality),
- ``cartesian_absdiff_quality``: mean absolute difference of two Cartesian
  intensity images rendered from the clouds (CorAlCartQuality).

Distances use the reference's |a|^2 + |b|^2 - 2 a.b form at full float32
(TF32 is off for the process).
"""
from __future__ import annotations

import math

import torch

from ..core.device import deterministic
from ..core.types import Cells, PointCloud
from ..kernels import refmath


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, M] squared distances between [..., N, 2] and [..., M, 2] in
    the |a|^2 + |b|^2 - 2 a.b form, each two-term sum rounded once as the
    reference's compiled program rounds it (a multiply-add): near a point
    the form cancels to a few ulp of |a|^2, so the rounding shows."""
    a0, a1 = a[..., :, None, 0], a[..., :, None, 1]
    b0, b1 = b[..., None, :, 0], b[..., None, :, 1]
    return (refmath.fma(a1, a1, a0 * a0) + refmath.fma(b1, b1, b0 * b0)) \
        - 2.0 * refmath.fma(a1, b1, a0 * b0)


def _nn_sq_dists(src: PointCloud, ref: PointCloud) -> torch.Tensor:
    d2 = _sq_dists(src.xy, ref.xy)
    d2 = torch.where(ref.mask[..., None, :], d2,
                     torch.full_like(d2, math.inf))
    return d2.min(-1)[0]


def p2p_quality(src: PointCloud, ref: PointCloud, radius: float = 2.0):
    """(mean nearest-neighbour squared distance, hit count) over source
    points with a neighbour within ``radius``."""
    nn = _nn_sq_dists(src, ref)
    ok = src.mask & (nn <= radius * radius)
    n = ok.sum(-1)
    return torch.where(ok, nn, torch.zeros_like(nn)).sum(-1) \
        / torch.clamp(n, min=1), n


def keypoint_repeatability(src: PointCloud, ref: PointCloud,
                           radius: float = 1.0):
    """Fraction of valid source points with a reference neighbour within
    ``radius``."""
    ok = src.mask & (_nn_sq_dists(src, ref) <= radius * radius)
    return ok.sum(-1) / torch.clamp(src.mask.sum(-1), min=1)


def p2d_quality(src: PointCloud, cells: Cells, radius: float = 2.0,
                regularization: float = 0.01):
    """(mean Mahalanobis distance, hit count) of source points to the
    nearest valid cell within ``radius``."""
    d2 = _sq_dists(src.xy, cells.mean)
    d2 = torch.where(cells.valid[..., None, :], d2,
                     torch.full_like(d2, math.inf))
    nn = torch.argmin(d2, -1)
    nn_d2 = torch.gather(d2, -1, nn[..., None])[..., 0]
    ok = src.mask & (nn_d2 <= radius * radius)
    mu = torch.gather(cells.mean, -2, nn[..., None].expand(nn.shape + (2,)))
    cov = torch.gather(cells.cov, -3,
                       nn[..., None, None].expand(nn.shape + (2, 2))) \
        + regularization * torch.eye(2, dtype=d2.dtype, device=d2.device)
    e = src.xy - mu
    det = cov[..., 0, 0] * cov[..., 1, 1] - cov[..., 0, 1] * cov[..., 1, 0]
    inv00 = cov[..., 1, 1] / det
    inv11 = cov[..., 0, 0] / det
    inv01 = -cov[..., 0, 1] / det
    maha = (e[..., 0] ** 2 * inv00 + 2 * e[..., 0] * e[..., 1] * inv01
            + e[..., 1] ** 2 * inv11)
    n = ok.sum(-1)
    return torch.where(ok, maha, torch.zeros_like(maha)).sum(-1) \
        / torch.clamp(n, min=1), n


def render_cartesian(cloud: PointCloud, extent: float,
                     size: int = 128) -> torch.Tensor:
    """Scatter-add clouds [..., P] into [..., size, size] intensity
    images."""
    lead = cloud.mask.shape[:-1]
    scale = size / (2.0 * extent)
    ij = torch.floor((cloud.xy + extent) * scale).long()
    inside = cloud.mask & ((ij >= 0) & (ij < size)).all(-1)
    pix = size * size
    row = torch.arange(math.prod(lead), device=ij.device).reshape(
        lead + (1,))
    lin = torch.where(inside, row * pix + ij[..., 0] * size + ij[..., 1],
                      math.prod(lead) * pix)  # outside: one spill bin
    with deterministic():  # float sums in index order on the card too
        img = torch.zeros(math.prod(lead) * pix + 1,
                          dtype=cloud.intensity.dtype,
                          device=ij.device).index_add_(
            0, lin.reshape(-1), torch.where(inside, cloud.intensity,
                                            torch.zeros_like(cloud.intensity))
            .reshape(-1))
    return img[:-1].reshape(lead + (size, size))


def cartesian_absdiff_quality(src: PointCloud, ref: PointCloud,
                              extent: float = 100.0, size: int = 128):
    """Mean |img_src - img_ref| over the pixels occupied in either."""
    a = render_cartesian(src, extent, size)
    b = render_cartesian(ref, extent, size)
    occupied = (a > 0) | (b > 0)
    n = torch.clamp(occupied.sum((-2, -1)), min=1)
    return torch.where(occupied, (a - b).abs(),
                       torch.zeros_like(a)).sum((-2, -1)) / n
