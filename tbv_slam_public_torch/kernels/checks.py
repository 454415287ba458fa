"""Inputs that hold the hand kernels to their plain versions, shared by
``chip_smoke.py`` and the tests: the value ranges of each refmath op, its
special values, a bit-for-bit comparison, and CorAl clouds whose
neighbours lie within an ulp of the radius gate.
"""
from __future__ import annotations

import numpy as np

#: each elementwise op of ``csrc/refmath.cu`` and the range its sites see
REFMATH_RANGES = {"exp": (-90.0, 90.0), "log": (1e-3, 1e3),
                  "log1p": (-0.99, 10.0), "sigmoid": (-90.0, 90.0),
                  "sincos": (-200.0, 200.0), "wrap_angle": (-10.0, 10.0),
                  "atan2": (-80.0, 80.0), "sqrt": (0.0, 1e4)}

#: zeros, subnormals (the reference flushes them), the range reductions'
#: boundaries, large values, infinities and NaN
REFMATH_SPECIAL = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 1.2e-38, 1e-30, -1e-30, 1.0, -1.0, 0.5,
     2.0 ** -12, -(2.0 ** -12), 0.78539813, 0.78539819, -0.78539819,
     119.99999, 120.0, -120.0, 1e10, -1e10, 3.4e38, np.inf, -np.inf, np.nan],
    np.float32)


def bits_differ(a, b) -> int:
    """Values of two float32 arrays or tensors whose bits differ (a NaN
    equals any NaN: its payload is not held); a shape mismatch raises."""
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{a.shape} {a.dtype} against {b.shape} {b.dtype}")
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    return int((~same).sum())


def on_gate_clouds(rng, m: int, n: int, r: float):
    """Query and point clouds [m, n, 2]: query k at about (3k, 0), point k
    within a few ulp of the circle of radius r around it, so far from the
    others that each query sees its own point only.  In half the slots the
    fused and the unfused sum of squares fall on opposite sides of r^2."""
    r2 = np.float32(r * r)
    q = np.zeros((m, n, 2), np.float32)
    p = np.zeros((m, n, 2), np.float32)
    split = np.zeros((m, n), bool)
    for _ in range(4000):
        qq = np.stack([3.0 * np.arange(n) + rng.uniform(-1, 1, (m, n)),
                       rng.uniform(-1, 1, (m, n))], -1).astype(np.float32)
        a = rng.uniform(0, 2 * np.pi, (m, n))
        pp = (qq + r * np.stack([np.cos(a), np.sin(a)], -1)).astype(
            np.float32)
        pp += (rng.integers(-3, 4, pp.shape) * np.spacing(pp)).astype(
            np.float32)
        sq = (pp - qq).astype(np.float64) ** 2
        fused = (sq[..., 1] + np.float64(np.float32(sq[..., 0]))).astype(
            np.float32)
        unfused = np.float32(sq[..., 0]) + np.float32(sq[..., 1])
        differ = (fused <= r2) != (unfused <= r2)
        take = (differ & ~split) | ((q == 0).all(-1) & (rng.uniform(
            size=(m, n)) < 0.5))
        take &= (np.arange(n) % 2 == 0)[None] == differ
        q[take], p[take] = qq[take], pp[take]
        split |= take & differ
        if split.sum() >= m * n // 2 and not (q == 0).all(-1).any():
            break
    if split.sum() < m * n // 8:
        raise RuntimeError(f"only {split.sum()} of {m * n} slots split")
    return q, p
