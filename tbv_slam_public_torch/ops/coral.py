"""CorAl: entropy-based alignment quality for radar point clouds.

Port of ``tbv_slam_public_tpu.ops.coral``, batched over a leading pair axis
M (the reference ``vmap``s ``coral_quality`` over the candidate wave).  The
radius-neighbour moments come from ``kernels.coral_moments.pair_moments``,
which launches the CUDA kernel once per call for CUDA tensors and runs its
plain version for CPU tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.types import PointCloud
from ..kernels import refmath
from ..kernels.coral_moments import pair_moments


class CoralResult(NamedTuple):
    joint: torch.Tensor  # [M] mean joint entropy
    sep: torch.Tensor  # [M] mean separate entropy
    overlap: torch.Tensor  # [M] valid fraction of the merged cloud
    valid: torch.Tensor  # [M] bool, overlap >= 0.1


# The reference's compiled program contracts each a*b + c below into one
# fused multiply-add.  On collinear neighbourhoods (k-strongest peaks on one
# azimuth ray) the covariance determinant is rounding noise, so two
# roundings instead of one change its sign and size, and the point passes
# the entropy gate in one package and not in the other; every such sum is
# therefore rounded once here, on both devices.


def _det2x2(c):
    """c00 c11 - c01 c10 as fma(c00, c11, -(c01 c10)), the product c01 c10
    (an operation of its own) and the result flushed to zero where they are
    subnormal, as the reference's threads flush them."""
    return refmath.ftz(refmath.fma(c[..., 0, 0], c[..., 1, 1],
                                   -refmath.ftz(c[..., 0, 1] * c[..., 1, 0])))


def _mean_cov_from_moments(n, s1, s2):
    """Sample mean and covariance (1/(n-1)) from query-centred moments:
    s2 - n m m^T as fma(-(n m_i), m_j, s2).  Subnormal values are flushed
    as the reference's threads flush them: s2 as an operand (DAZ), the mean
    and the covariance as results (FTZ).  A subnormal s1 or centred sum
    gives a subnormal mean or covariance (n >= 1 divides them), and n m is
    normal where m is, so these three flushes cover every operation."""
    mean = refmath.ftz(s1 / torch.clamp(n, min=1.0)[..., None])
    nm = n[..., None] * mean
    centered = refmath.fma(-nm[..., :, None], mean[..., None, :],
                           refmath.ftz(s2))
    cov = refmath.ftz(centered / torch.clamp(n - 1.0, min=1.0)[..., None,
                                                               None])
    return mean, cov


def _entropy_from_moments(n, s1, s2, eps):
    _, cov = _mean_cov_from_moments(n, s1, s2)
    det = _det2x2(cov)
    arg = refmath.fma(torch.full_like(det, 2.0 * math.pi * math.e), det,
                      torch.full_like(det, eps))
    return 0.5 * refmath.log(arg), det


def _kl_divergence_2d(u0, s0, u1, s1):
    """KL((u0, S0) || (u1, S1)) with the reference's k=3 constant."""
    det0 = _det2x2(s0)
    det1 = _det2x2(s1)
    # the inverse determinant and the inverse's entries flushed (FTZ): the
    # inverse of a determinant above 2^126 is subnormal
    inv_det1 = refmath.ftz(1.0 / torch.where(det1 == 0.0,
                                             torch.ones_like(det1), det1))
    s1i = refmath.ftz(torch.stack([
        torch.stack([s1[..., 1, 1], -s1[..., 0, 1]], -1),
        torch.stack([-s1[..., 1, 0], s1[..., 0, 0]], -1)], -2)
        * inv_det1[..., None, None])
    trace = torch.einsum("...ij,...ji->...", s1i, s0)
    d = u1 - u0
    mahal = torch.einsum("...i,...ij,...j->...", d, s1i, d)
    score = 0.5 * (trace + mahal - 3.0 + refmath.log(det1 / det0))
    finite = torch.isfinite(score) & (det1 != 0.0)
    return torch.where(finite, score, torch.zeros_like(score)), finite


def coral_quality(src: PointCloud, ref: PointCloud, radius: float = 1.0,
                  eps: float = 1e-8, mode: str = "entropy") -> CoralResult:
    """CorAl quality of M pairs of WORLD-FRAME peak clouds ([M, S] and
    [M, R]).  One ``pair_moments`` call gives every point's moments over its
    own and over the other cloud; the per-point terms then run once over the
    merged query axis (S src slots, then R ref slots)."""
    n, s1, s2 = pair_moments(src.xy, src.mask, ref.xy, ref.mask, radius)
    n_own, s1_own, s2_own = n[0], s1[0], s2[0]
    n_oth = n[1]
    n_joint = n_own + n_oth
    s1_joint = s1_own + s1[1]
    s2_joint = s2_own + s2[1]
    q_mask = torch.cat([src.mask, ref.mask], -1)
    ok = q_mask & (n_oth >= 1) & (n_own > 2) & (n_joint > 2)
    if mode == "kl":
        # src points: KL(sep || sep); ref points: KL(sep || joint)
        u_sep, s_sep = _mean_cov_from_moments(n_own, s1_own, s2_own)
        u_j, s_j = _mean_cov_from_moments(n_joint, s1_joint, s2_joint)
        is_ref = torch.arange(q_mask.shape[-1],
                              device=q_mask.device) >= src.mask.shape[-1]
        joint, fin = _kl_divergence_2d(
            u_sep, s_sep, torch.where(is_ref[:, None], u_j, u_sep),
            torch.where(is_ref[:, None, None], s_j, s_sep))
        sep = torch.zeros_like(joint)
        ok = ok & fin
    else:
        sep, _ = _entropy_from_moments(n_own, s1_own, s2_own, eps)
        joint, _ = _entropy_from_moments(n_joint, s1_joint, s2_joint, eps)
        ok = ok & torch.isfinite(sep) & torch.isfinite(joint)
    zero = torch.zeros((), dtype=sep.dtype, device=sep.device)
    count_valid = ok.sum(-1)
    denom = torch.clamp(count_valid.to(sep.dtype), min=1.0)
    sep_mean = torch.where(ok, sep, zero).sum(-1) / denom
    joint_mean = torch.where(ok, joint, zero).sum(-1) / denom
    merged = src.mask.sum(-1) + ref.mask.sum(-1)
    overlap = count_valid / torch.clamp(merged, min=1)
    return CoralResult(joint=joint_mean, sep=sep_mean, overlap=overlap,
                       valid=overlap >= 0.1)


def compact_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Keep the ``capacity`` strongest returns of a padded cloud [P] (ties:
    lower slot first, as ``lax.top_k``)."""
    score = torch.where(cloud.mask, cloud.intensity,
                        torch.full_like(cloud.intensity, -1.0))
    idx = torch.sort(score, descending=True, stable=True)[1][:capacity]
    return PointCloud(xy=cloud.xy[idx], intensity=cloud.intensity[idx],
                      mask=cloud.mask[idx] & (score[idx] >= 0))
