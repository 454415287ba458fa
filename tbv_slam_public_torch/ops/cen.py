"""Cen 2018 / Cen 2019 radar landmark detectors.

Port of ``tbv_slam_public_tpu.ops.cen`` (the alternative detectors of the
reference's alignment-evaluation scan-type zoo, Utils.cpp cen2018features /
cen2019features).  Cen 2018 is row-wise filtering and runs on tensors:
per azimuth row, subtract the row mean, smooth with a 1-D Gaussian
(reflect-101 padding), take the noise sigma from the negative samples, score
y = q (1 - N(q|p,sigma)) + p (N(q|p,sigma) - N(p|0,sigma)), threshold at
zq * sigma, and keep the middle bin of each contiguous run above it.  Cen
2019's greedy region marking is sequential and stays host NumPy, a copy of
the reference's function.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import RadarConfig
from ..core.device import resolve
from ..core.refmath import recip
from ..core.types import PointCloud
from ..kernels import refmath
from .radar import polar_to_xy


def _row_gaussian_smooth(q: torch.Tensor, sigma_gauss: int) -> torch.Tensor:
    """1-D Gaussian filter along range with reflect-101 padding
    (cv::filter2D BORDER_REFLECT101)."""
    fsize = sigma_gauss * 3
    mu = fsize // 2
    i = torch.arange(fsize, dtype=torch.float32, device=q.device)
    filt = refmath.exp(-0.5 * (i - mu) ** 2
                       * recip(float(sigma_gauss * sigma_gauss)))
    filt = filt / filt.sum()
    qp = F.pad(q, (mu, fsize - 1 - mu), mode="reflect")
    return F.conv1d(qp[:, None, :], filt[None, None, :])[:, 0, :]


def cen2018_scores(image: torch.Tensor, zq: float = 3.0,
                   sigma_gauss: int = 17, min_range: int = 0):
    """Per-bin Cen 2018 score y [A, R], the per-row threshold zq * sigma
    [A, 1] and the detection map [A, R] (one bin per run above it)."""
    img = image.float()
    r = img.shape[1]
    q = img - img.mean(1, keepdim=True)
    p = _row_gaussian_smooth(q, sigma_gauss)
    neg = q < 0
    n_neg = neg.sum(1)
    sig = refmath.sqrt(torch.where(neg, 2.0 * q * q, torch.zeros_like(q))
                       .sum(1) / torch.clamp(n_neg, min=1))
    sig = torch.where(n_neg > 0, sig, torch.full_like(sig, 0.034))[:, None]
    nqp = refmath.exp(-0.5 * ((q - p) / sig) ** 2)
    npp = refmath.exp(-0.5 * (p / sig) ** 2)
    y = q * (1.0 - nqp) + p * (nqp - npp)
    idx = torch.arange(r, device=img.device)
    thres = zq * sig
    above = (y > thres) & (idx[None, :] >= min_range)
    # each run start..end of bins above the threshold yields one detection at
    # start + len // 2
    prev = F.pad(above[:, :-1], (1, 0))
    nxt = F.pad(above[:, 1:], (0, 1))
    run_start = torch.cummax(torch.where(above & ~prev, idx, -1), 1)[0]
    run_end = torch.cummin(torch.where(above & ~nxt, idx, r + 1).flip(1),
                           1)[0].flip(1)
    mid = run_start + (run_end - run_start + 1) // 2
    return y, thres, above & (idx[None, :] == mid)


def cen2018_filter(image: torch.Tensor, cfg: RadarConfig, zq: float = 3.0,
                   sigma_gauss: int = 17, capacity: int | None = None):
    """Cen 2018 detector -> fixed-capacity point cloud, strongest score
    first (Cen2018Radar: zq=3.0, sigma_gauss=17, min_range =
    sensor_min_distance in bins)."""
    min_range = int(math.ceil(cfg.min_distance / cfg.range_res))
    cap = capacity or cfg.num_azimuths * cfg.k_strongest
    a, r = image.shape
    y, _, detect = cen2018_scores(image, zq, sigma_gauss, min_range)
    flat = torch.where(detect, y, torch.full_like(y, -math.inf)).reshape(-1)
    top, pick = torch.sort(flat, descending=True, stable=True)
    top, pick = top[:cap], pick[:cap]
    ai, ri = pick // r, pick % r
    xy = polar_to_xy(ai, ri, a, 1.0) * cfg.range_res
    return PointCloud(xy=xy, intensity=image[ai, ri].float(),
                      mask=torch.isfinite(top))


def cen2019_features(image: np.ndarray, max_points: int = 1000,
                     min_range: int = 0) -> np.ndarray:
    """Cen 2019 detector (host implementation; returns [N, 2] int array of
    (azimuth, range-bin) detections).

    Greedy region marking in descending score order (cen2019features,
    Utils.cpp): the loop's data-dependence (regions exclude previously
    marked cells) makes it inherently sequential — acceptable here because
    this detector only feeds the offline scan evaluator.
    """
    img = np.asarray(image, np.float32)
    a_n, r_n = img.shape
    # Prewitt gradient along range, reflect-101 border, normalized
    gl = np.empty_like(img)
    gl[:, 1:-1] = img[:, 2:] - img[:, :-2]
    gl[:, 0] = img[:, 1] - img[:, 1]
    gl[:, -1] = img[:, -2] - img[:, -2]
    g = np.abs(gl)
    g /= max(g.max(), 1e-12)
    s = img - img.mean()
    h = s * (1.0 - g)
    mean_h = h.mean()

    cand = np.argwhere(h > mean_h)
    order = np.argsort(-h[cand[:, 0], cand[:, 1]])
    cand = cand[order]

    marked = np.zeros_like(img, bool)
    false_count = img.size
    l = 0
    for (ai, ri) in cand:
        if l >= max_points or false_count <= 0:
            break
        if marked[ai, ri]:
            continue
        # expand while the mean-subtracted signal stays negative
        rlow = ri
        for i in range(ri - 1, -1, -1):
            if s[ai, i] < 0:
                rlow = i
            else:
                break
        rhigh = ri
        for i in range(ri + 1, r_n):
            if s[ai, i] < 0:
                rhigh = i
            else:
                break
        already = marked[ai, rlow:rhigh + 1].any()
        newly = ~marked[ai, rlow:rhigh + 1]
        marked[ai, rlow:rhigh + 1] = True
        false_count -= int(newly.sum())
        if not already:
            l += 1

    out = []
    for ai in range(a_n):
        row = marked[ai]
        below = marked[(ai - 1) % a_n]
        above = marked[(ai + 1) % a_n]
        j = min_range
        while j < r_n:
            if row[j]:
                start = j
                while j < r_n and row[j]:
                    j += 1
                end = j - 1
                if below[start:end + 1].any() or above[start:end + 1].any():
                    out.append((ai, start + int(np.argmax(h[ai, start:end + 1]))))
            else:
                j += 1
    return np.asarray(out, np.int32).reshape(-1, 2)


def cen2019_filter(image: np.ndarray, cfg: RadarConfig,
                   max_points: int = 1000,
                   capacity: int | None = None, device=None) -> PointCloud:
    """Cen 2019 detections as a fixed-capacity point cloud, computed on the
    host and handed over as tensors on ``device`` (the card unless given)."""
    dev = resolve(device)
    min_range = int(np.ceil(cfg.min_distance / cfg.range_res))
    det = cen2019_features(image, max_points=max_points, min_range=min_range)
    cap = capacity or cfg.num_azimuths * cfg.k_strongest
    n = min(det.shape[0], cap)
    xy = np.zeros((cap, 2), np.float32)
    intensity = np.zeros((cap,), np.float32)
    mask = np.zeros((cap,), bool)
    if n:
        theta = (det[:n, 0].astype(np.float32) + np.float32(1.0)) \
            / np.float32(cfg.num_azimuths) * np.float32(2.0 * np.pi)
        rng = np.float32(cfg.range_res) * (det[:n, 1].astype(np.float32)
                                           + np.float32(0.5))
        xy[:n] = np.stack([rng * np.cos(theta), rng * np.sin(theta)], -1)
        img = np.asarray(image, np.float32)
        intensity[:n] = img[det[:n, 0], det[:n, 1]]
        mask[:n] = True
    return PointCloud(xy=torch.as_tensor(xy, device=dev),
                      intensity=torch.as_tensor(intensity, device=dev),
                      mask=torch.as_tensor(mask, device=dev))
