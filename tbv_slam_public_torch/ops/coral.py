"""CorAl: entropy-based alignment quality for radar point clouds.

Port of ``tbv_slam_public_tpu.ops.coral``, batched over a leading pair axis
M (the reference ``vmap``s ``coral_quality`` over the candidate wave).  The
radius-neighbour moments come from ``kernels.coral_moments.pair_moments``
and the per-point terms and the pairs' sums from ``coral_tail``: each one
CUDA kernel launch a call for CUDA tensors, its plain version for CPU
tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import refmath as plain
from ..core.types import PointCloud
from ..kernels import coral_moments as coral_kernel
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
# therefore rounded once here.  These functions are the plain version of
# ``coral_tail``: elementwise torch on either device (``core/refmath.py``),
# every subnormal operand and result flushed as the reference's threads
# flush it; ``csrc/coral_moments.cu``'s ``coral_tail_kernel`` runs the same
# operations.


def _det2x2(c):
    """c00 c11 - c01 c10 as fma(c00, c11, -(c01 c10)), the product c01 c10
    (an operation of its own) and the result flushed as the reference's
    threads flush them (the product by its exact value, ``mul_ftz``)."""
    return plain.ftz(plain.fma(c[..., 0, 0], c[..., 1, 1],
                               -plain.mul_ftz(c[..., 0, 1], c[..., 1, 0])))


def _mean_cov_from_moments(n, s1, s2):
    """Sample mean and covariance (1/(n-1)) from query-centred moments:
    s2 - n m m^T as fma(-(n m_i), m_j, s2).  Subnormal values are flushed
    as the reference's threads flush them: s2 as an operand (DAZ), the mean
    and the covariance as results (FTZ).  A subnormal s1 or centred sum
    gives a subnormal mean or covariance (n >= 1 divides them), and n m is
    normal where m is, so these three flushes cover every operation."""
    mean = plain.ftz(s1 / torch.clamp(n, min=1.0)[..., None])
    nm = n[..., None] * mean
    centered = plain.fma(-nm[..., :, None], mean[..., None, :],
                         plain.ftz(s2))
    cov = plain.ftz(centered / torch.clamp(n - 1.0, min=1.0)[..., None,
                                                             None])
    return mean, cov


def _entropy_from_moments(n, s1, s2, eps):
    _, cov = _mean_cov_from_moments(n, s1, s2)
    det = _det2x2(cov)
    arg = plain.fma(torch.full_like(det, 2.0 * math.pi * math.e), det,
                    torch.full_like(det, eps))
    return 0.5 * plain.log(arg), det


def _kl_divergence_2d(u0, s0, u1, s1):
    """KL((u0, S0) || (u1, S1)) with the reference's k=3 constant, its sums
    in the reference's order (its optimized HLO and the functions compiled
    alone: tr(S1^-1 S0) a dot of the four products in order, each rounded;
    the Mahalanobis term two dots of fused multiply-adds from zero,
    (d^T S1^-1) first; then 0.5 (((tr + mahal) - 3) + log(det1 / det0)))."""
    f = plain.ftz
    det0 = _det2x2(s0)
    det1 = _det2x2(s1)
    # the inverse determinant and the inverse's entries flushed (FTZ): the
    # inverse of a determinant above 2^126 is subnormal; every lone product
    # flushed by its exact value (mul_ftz)
    inv_det1 = f(1.0 / torch.where(det1 == 0.0, torch.ones_like(det1), det1))
    mul = plain.mul_ftz
    s1i = mul(torch.stack([
        torch.stack([s1[..., 1, 1], -s1[..., 0, 1]], -1),
        torch.stack([-s1[..., 1, 0], s1[..., 0, 0]], -1)], -2),
        inv_det1[..., None, None])
    trace = mul(s1i[..., 0, 0], s0[..., 0, 0])
    for i, j in ((0, 1), (1, 0), (1, 1)):
        trace = f(trace + mul(s1i[..., i, j], s0[..., j, i]))
    d = f(u1 - u0)
    t = [plain.fma(d[..., 1], s1i[..., 1, k], mul(d[..., 0], s1i[..., 0, k]))
         for k in range(2)]
    mahal = plain.fma(d[..., 1], t[1], mul(d[..., 0], t[0]))
    score = f(0.5 * f(f(f(trace + mahal) - 3.0) + plain.log(f(det1 / det0))))
    finite = torch.isfinite(score) & (det1 != 0.0)
    return torch.where(finite, score, torch.zeros_like(score)), finite


def coral_tail_reference(n, s1, s2, src_mask, ref_mask, eps: float = 1e-8,
                         mode: str = "entropy") -> CoralResult:
    """The plain version of ``coral_tail``: M pairs' CorAl quality from
    their moments (``pair_moments``' outputs n [2, M, Q], s1 [2, M, Q, 2],
    s2 [2, M, Q, 2, 2], Q = S + R) and masks (src [M, S], ref [M, R]),
    elementwise torch on either device.  Each query's joint moments, gates,
    covariances and entropies (or, in ``kl`` mode, KL divergences: src
    points KL(sep || sep), ref points KL(sep || joint)), then over the
    valid queries of a pair the count, the two masked sums in the
    reference's order (``core/refmath.py::tree_sum``), the means and the
    overlap."""
    q_mask = torch.cat([src_mask, ref_mask], -1)
    n_own, s1_own, s2_own, n_oth = n[0], s1[0], s2[0], n[1]
    n_joint = n_own + n_oth  # counts: exact
    s1_joint = plain.ftz(s1_own + s1[1])
    s2_joint = plain.ftz(s2_own + s2[1])
    ok = q_mask & (n_oth >= 1) & (n_own > 2) & (n_joint > 2)
    if mode == "kl":
        u_sep, s_sep = _mean_cov_from_moments(n_own, s1_own, s2_own)
        u_j, s_j = _mean_cov_from_moments(n_joint, s1_joint, s2_joint)
        is_ref = torch.arange(q_mask.shape[-1],
                              device=q_mask.device) >= src_mask.shape[-1]
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
    sep_mean = plain.tree_sum(torch.where(ok, sep, zero)) / denom
    joint_mean = plain.tree_sum(torch.where(ok, joint, zero)) / denom
    merged = src_mask.sum(-1) + ref_mask.sum(-1)
    overlap = count_valid / torch.clamp(merged, min=1)
    return CoralResult(joint=joint_mean, sep=sep_mean, overlap=overlap,
                       valid=overlap >= 0.1)


def coral_tail(n, s1, s2, src_mask, ref_mask, eps: float = 1e-8,
               mode: str = "entropy") -> CoralResult:
    """CorAl's quality from the pair moments: on CPU tensors the plain
    version, on CUDA tensors one launch of ``csrc/coral_moments.cu``'s
    ``coral_tail_kernel`` (bit-equal to the plain version given the same
    moments)."""
    if n.device.type == "cpu":
        return coral_tail_reference(n, s1, s2, src_mask, ref_mask, eps, mode)
    return CoralResult(*coral_kernel.coral_tail(n, s1, s2, src_mask,
                                                ref_mask, eps, mode))


def coral_quality(src: PointCloud, ref: PointCloud, radius: float = 1.0,
                  eps: float = 1e-8, mode: str = "entropy") -> CoralResult:
    """CorAl quality of M pairs of WORLD-FRAME peak clouds ([M, S] and
    [M, R]).  One ``pair_moments`` call gives every point's moments over its
    own and over the other cloud; ``coral_tail`` then runs the per-point
    terms once over the merged query axis (S src slots, then R ref slots)
    and the pairs' sums: two launches on the card."""
    n, s1, s2 = pair_moments(src.xy, src.mask, ref.xy, ref.mask, radius)
    return coral_tail(n, s1, s2, src.mask, ref.mask, eps, mode)


def compact_cloud(cloud: PointCloud, capacity: int) -> PointCloud:
    """Keep the ``capacity`` strongest returns of a padded cloud [P] (ties:
    lower slot first, as ``lax.top_k``)."""
    score = torch.where(cloud.mask, cloud.intensity,
                        torch.full_like(cloud.intensity, -1.0))
    idx = torch.sort(score, descending=True, stable=True)[1][:capacity]
    return PointCloud(xy=cloud.xy[idx], intensity=cloud.intensity[idx],
                      mask=cloud.mask[idx] & (score[idx] >= 0))
