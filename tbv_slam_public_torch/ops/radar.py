"""Polar radar image filtering: k-strongest + axial non-max suppression,
CA-CFAR and BFAR.

Port of ``tbv_slam_public_tpu.ops.radar``.  The reference's ``lax.top_k``
puts the lower range index first on equal intensities, which are common on
uint8 images; ``torch.topk`` promises no order, so every selection is a
stable descending sort cut at k.  The CFAR window sums are differences of a
row cumsum at clipped indices, as in the reference; the cumsum runs in
int64, so every window sum is exact (the reference's float32 cumsum is
exact while a row's sum stays under 2^24).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.config import RadarConfig
from ..core.types import PointCloud


def polar_to_xy(azimuth_idx: torch.Tensor, range_idx: torch.Tensor,
                num_azimuths: int, range_res: float) -> torch.Tensor:
    """Reference bin->point mapping (radar_filters.cpp:316-331)."""
    # (a + 1) * (2 pi / A): XLA folds the reference's (a + 1) / A * 2 pi into
    # this form, and the one-ulp difference in theta moves far points by ~5
    # ulp, enough to flip CFEAR radius gates downstream
    theta = (azimuth_idx.float() + 1.0) * (2.0 * math.pi / num_azimuths)
    r = range_res * (range_idx.float() + 0.5)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


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


def _window_sums(values: torch.Tensor, starts: torch.Tensor, size: int):
    """Per-row sums of values[:, s:s+size] for each start s [R], clipped to
    the row, and the number of bins summed [R]."""
    r = values.shape[1]
    csum = torch.cumsum(F.pad(values.to(torch.int64), (1, 0)), 1)
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
    sq = image.to(torch.int64) ** 2
    rng = torch.arange(r, device=image.device)
    lead, _ = _window_sums(sq, rng - guard - size, size)
    trail, _ = _window_sums(sq, rng + guard + 1, size)
    noise = (lead.float() + trail.float()) / n
    detected = (img * img > alpha * noise) & (img >= cfg.z_min)
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
    moves by the motion scaled by its azimuth-derived time in [-0.5, 0.5]."""
    x, y = cloud.xy[..., 0], cloud.xy[..., 1]
    ang = torch.atan2(y, x)
    d = torch.where(ang > 1e-5, ang, 2.0 * math.pi + ang) / (2.0 * math.pi)
    factor = -(d - 0.5) if ccw else (d - 0.5)
    c = torch.cos(motion[2] * factor)
    s = torch.sin(motion[2] * factor)
    nx = c * x - s * y + motion[0] * factor
    ny = s * x + c * y + motion[1] * factor
    return cloud.replace(xy=torch.stack([nx, ny], -1))
