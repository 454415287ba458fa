"""Polar radar image filtering: k-strongest + axial non-max suppression,
CA-CFAR and BFAR.

Port of ``tbv_slam_public_tpu.ops.radar``.  The reference's ``lax.top_k``
puts the lower range index first on equal intensities, which are common on
uint8 images; ``torch.topk`` promises no order, so every selection is a
stable descending sort cut at k.  The CFAR window sums are differences of a
row cumsum at clipped indices, as in the reference.  BFAR's row sums of
uint8 intensities stay under 2^24, where any float32 order is exact, so its
cumsum runs in int64.  CA-CFAR sums squares, whose rows pass 2^24 (3768
bins at intensity 67 do), so its float32 cumsum adds in the order of the
reference's compiled program (:func:`_scan_f32`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core import refmath as plain_refmath
from ..core.config import RadarConfig
from ..core.device import constant
from ..core.types import PointCloud
from ..kernels import refmath


@functools.lru_cache(maxsize=None)
def _azimuth_steps(num_azimuths: int, range_res: float):
    """((range_res cos t, range_res sin t) for each azimuth a), float32, with
    t = (a + 1) * (2 pi / A) in float32: the reference's compiled program
    folds (a + 1) / A * 2 pi into that form (one ulp of t moves far points
    by ~5 ulp, enough to flip CFEAR radius gates downstream), takes cos and
    sin from the C library's ``cosf`` and ``sinf`` (which round otherwise
    than torch's), and multiplies them by range_res before the range.  t
    takes A values only, so the table is made once on the host, by the plain
    version of those functions (``core.refmath.sincos``: the reference's
    bits whatever the host's C library)."""
    theta = (torch.arange(num_azimuths, dtype=torch.float32) + 1.0) \
        * (2.0 * math.pi / num_azimuths)
    s, c = plain_refmath.sincos(theta)
    unit = torch.stack([c, s], -1)
    return tuple(map(tuple, (unit * range_res).tolist()))


def polar_to_xy(azimuth_idx: torch.Tensor, range_idx: torch.Tensor,
                num_azimuths: int, range_res: float) -> torch.Tensor:
    """Reference bin->point mapping (radar_filters.cpp:316-331):
    (bin + 0.5) * (range_res cos t, range_res sin t)."""
    step = constant(_azimuth_steps(num_azimuths, float(range_res)),
                    torch.float32, azimuth_idx.device)
    return (range_idx.float() + 0.5)[..., None] * step[azimuth_idx]


def _axial_nms_peak_mask(image: torch.Tensor, window: int) -> torch.Tensor:
    """Boolean [A, R] map of axial box-score local maxima (ties allowed),
    restricted to the interior [window, R-window-1]."""
    a, r = image.shape
    img = image.to(torch.int32)
    padded = F.pad(img, (window + 1, window))
    csum = torch.cumsum(padded, 1, dtype=torch.int32)
    score = csum[:, 2 * window + 1:] - csum[:, :r]  # sum over [r-w, r+w]
    ok = torch.ones((a, r), dtype=torch.bool, device=image.device)
    for i in range(1, window + 1):
        prev = F.pad(score, (i, 0))[:, :r]
        nxt = F.pad(score, (0, i))[:, i:]
        ok = ok & (prev <= score) & (score >= nxt)
    rng = torch.arange(r, device=image.device)
    interior = (rng >= window) & (rng < r - window)
    return ok & interior[None, :]


def kstrongest_filter(image: torch.Tensor, cfg: RadarConfig):
    """Polar image [A, R] (uint8) -> (filtered cloud, peaks cloud), both of
    capacity A*k; the peaks cloud keeps only axial-NMS maxima."""
    if image.ndim != 2:
        raise ValueError(f"expected an [A, R] polar image, got "
                         f"{tuple(image.shape)}")
    num_az, k = image.shape[0], cfg.k_strongest
    img = image.float()
    gated = torch.where(img >= cfg.z_min, img, torch.full_like(img, -1.0))
    vals, idxs = torch.sort(gated, dim=1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k]

    a_idx = torch.arange(num_az, device=image.device)[:, None].expand(-1, k)
    xy = polar_to_xy(a_idx, idxs, num_az, cfg.range_res)
    min_range_bin = int(math.ceil(cfg.min_distance / cfg.range_res))
    max_range_bin = cfg.max_distance / cfg.range_res
    valid = (vals >= cfg.z_min) & (idxs > min_range_bin) & \
        (idxs.float() <= max_range_bin)
    peak_sel = torch.gather(_axial_nms_peak_mask(image, cfg.nms_window), 1,
                            idxs)

    xy, vals = xy.reshape(-1, 2), vals.reshape(-1)
    cloud = PointCloud(xy=xy, intensity=vals, mask=valid.reshape(-1))
    peaks = PointCloud(xy=xy, intensity=vals,
                       mask=(valid & peak_sel).reshape(-1))
    return cloud, peaks


#: XLA rewrites a cumulative sum as sums within blocks of this many
#: elements, the block totals scanned the same way
_SCAN_BLOCK = 16


def _prefix_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along axis 1, added left to right in float32."""
    cols = [x[:, 0]]
    for j in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, j])
    return torch.stack(cols, 1)


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum along axis 1 of [A, N], rounded as the
    reference's ``jnp.cumsum`` on the CPU: its compiled program pads each
    row to whole blocks of 16, takes left-to-right prefix sums inside each
    block, scans the block totals the same way (left to right once at most
    16 remain), and adds to each block the sum of the blocks before it."""
    a, n = x.shape
    if n <= _SCAN_BLOCK:
        return _prefix_f32(x)
    nb = -(-n // _SCAN_BLOCK)
    local = _prefix_f32(F.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        a * nb, _SCAN_BLOCK)).reshape(a, nb, _SCAN_BLOCK)
    totals = local[:, :, -1]
    before = F.pad((_prefix_f32(totals) if nb <= _SCAN_BLOCK
                    else _scan_f32(totals))[:, :-1], (1, 0))
    return (local + before[:, :, None]).reshape(a, -1)[:, :n]


def _window_sums(values: torch.Tensor, starts: torch.Tensor, size: int):
    """Per-row sums of values[:, s:s+size] for each start s [R], clipped to
    the row, and the number of bins summed [R]: differences of a cumsum,
    float32 in the reference's order for float input, exact for integers."""
    r = values.shape[1]
    padded = F.pad(values, (1, 0))
    csum = _scan_f32(padded) if values.dtype.is_floating_point \
        else torch.cumsum(padded.to(torch.int64), 1)
    lo = torch.clamp(starts, 0, r)
    hi = torch.clamp(starts + size, 0, r)
    return csum[:, hi] - csum[:, lo], hi - lo


def _strongest_detections(img: torch.Tensor, detected: torch.Tensor,
                          cfg: RadarConfig) -> PointCloud:
    """At most k detections per azimuth, strongest first (ties: lower range
    bin first), as a cloud of capacity A*k."""
    a, k = img.shape[0], cfg.k_strongest
    gated = torch.where(detected, img, torch.full_like(img, -1.0))
    vals, idxs = torch.sort(gated, dim=1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k]
    a_idx = torch.arange(a, device=img.device)[:, None].expand(-1, k)
    xy = polar_to_xy(a_idx, idxs, a, cfg.range_res)
    min_range_bin = int(math.ceil(cfg.min_distance / cfg.range_res))
    valid = (vals > 0) & (idxs > min_range_bin) & \
        (idxs.float() <= cfg.max_distance / cfg.range_res)
    return PointCloud(xy=xy.reshape(-1, 2), intensity=vals.reshape(-1),
                      mask=valid.reshape(-1))


def cacfar_filter(image: torch.Tensor, cfg: RadarConfig) -> PointCloud:
    """Cell-averaging CFAR detector (AzimuthCACFAR, cfar.cpp:19-84): squared
    intensities against alpha times the mean of ``cfar_window_size``
    training cells on each side beyond ``cfar_guard_cells`` guard cells,
    alpha = N (FAR^(-1/N) - 1)."""
    r = image.shape[1]
    guard, size = cfg.cfar_guard_cells, max(cfg.cfar_window_size, 1)
    n = 2 * size
    alpha = n * (cfg.cfar_false_alarm_rate ** (-1.0 / n) - 1.0)
    img = image.float()
    sq = img * img
    rng = torch.arange(r, device=image.device)
    lead, _ = _window_sums(sq, rng - guard - size, size)
    trail, _ = _window_sums(sq, rng + guard + 1, size)
    noise = (lead + trail) / n
    detected = (sq > alpha * noise) & (img >= cfg.z_min)
    return _strongest_detections(img, detected, cfg)


def bfar_filter(image: torch.Tensor, cfg: RadarConfig) -> PointCloud:
    """BFAR detector: CFAR with an affine threshold ``bfar_scale`` * noise +
    ``bfar_offset`` over ``cfar_window_size`` training cells on each side,
    no guard cells."""
    r = image.shape[1]
    size = max(cfg.cfar_window_size, 1)
    img = image.float()
    rng = torch.arange(r, device=image.device)
    lead, n_lead = _window_sums(image, rng - size, size)
    trail, n_trail = _window_sums(image, rng + 1, size)
    count = torch.clamp(n_lead + n_trail, min=1).float()
    noise = (lead.float() + trail.float()) / count
    detected = img > cfg.bfar_scale * noise + cfg.bfar_offset
    return _strongest_detections(img, detected, cfg)


def filter_scan(image: torch.Tensor, cfg: RadarConfig):
    """Detector dispatch on ``cfg.filter_type``: ``kstrong`` (filtered +
    axial-NMS peaks clouds), ``cacfar`` or ``bfar`` (the detections serve as
    both clouds)."""
    if cfg.filter_type == "kstrong":
        return kstrongest_filter(image, cfg)
    if cfg.filter_type == "cacfar":
        cloud = cacfar_filter(image, cfg)
        return cloud, cloud
    if cfg.filter_type == "bfar":
        cloud = bfar_filter(image, cfg)
        return cloud, cloud
    raise ValueError(f"unknown filter_type {cfg.filter_type!r}")


def motion_compensate(cloud: PointCloud, motion: torch.Tensor,
                      ccw: bool) -> PointCloud:
    """Per-point constant-velocity de-skew (utils.cpp:96-113): each point
    moves by the motion scaled by its azimuth-derived time in [-0.5, 0.5].
    One refmath site (one launch on the card)."""
    return cloud.replace(xy=refmath.site("motion_compensate", cloud.xy,
                                         motion, ccw=ccw))


def motion_compensate_pair(cloud: PointCloud, peaks: PointCloud,
                           motion: torch.Tensor, ccw: bool):
    """``motion_compensate`` of a frame's cloud and peaks under one motion
    [3], one chain of two segments (one launch on the card)."""
    xy, pxy = refmath.chain("motion_compensate_pair", cloud.xy, peaks.xy,
                            motion, ccw=ccw)
    return cloud.replace(xy=xy), peaks.replace(xy=pxy)


def _compensate(k, xy, motion, *, ccw):
    return k.site("motion_compensate", xy, motion, ccw=ccw)


def _motion_compensate_plain(xy: torch.Tensor, motion: torch.Tensor,
                             ccw: bool = False) -> torch.Tensor:
    """The site's plain version: points [..., 2] under the motion [3] (or
    motions [..., 3] broadcast against them, as a chain calls it)."""
    x, y = xy[..., 0], xy[..., 1]
    ang = refmath.atan2(y, x)
    ang = torch.where(ang > 1e-5, ang, 2.0 * math.pi + ang)
    # rounded as the reference's program: d / (2 pi) - 0.5 one fused
    # multiply-add by the reciprocal, each sum's first product and the
    # added motion fused into it
    factor = refmath.fma(ang, torch.full_like(
        ang, plain_refmath.recip(2.0 * math.pi)), torch.full_like(ang, -0.5))
    factor = -factor if ccw else factor
    s, c = refmath.sincos(motion[..., 2] * factor)
    nx = refmath.fma(motion[..., 0], factor, refmath.fma(c, x, -(s * y)))
    ny = refmath.fma(motion[..., 1], factor, refmath.fma(s, x, c * y))
    return torch.stack([nx, ny], -1)


def _motion_compensate_layout(xy, motion, ccw=False):
    """The site's operands: points [..., 2] under the motion [3]; the ccw
    flag and the body's float32 constants."""
    return [(xy, (2,), False), (motion, (3,), False)], [(2,)], \
        int(bool(ccw)), plain_refmath.motion_constants()


refmath.register_site("motion_compensate", _motion_compensate_plain,
                      _motion_compensate_layout)
refmath.register_chain("motion_compensate_pair",
                       [(_compensate, (0, 2)), (_compensate, (1, 2))],
                       ((2,), (2,), (3,)))
