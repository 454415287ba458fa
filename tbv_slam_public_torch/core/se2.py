"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Port of ``tbv_slam_public_tpu.core.se2``; every function broadcasts over
leading batch dimensions.  Sums of products are rounded as the reference's
compiled program rounds them: a product that feeds an add is fused into it
(the first one where both operands are products; ``core.refmath.fma``).
The ``_np`` helpers are host-side NumPy for the keyframe bookkeeping
loops.
"""
from __future__ import annotations

import numpy as np
import torch

from .refmath import fma


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi].  The atan2 runs in float64: torch's float32
    atan2 on the CPU rounds a tensor's vectorised body and its tail
    differently, so a row's angle would depend on the rows beside it."""
    return torch.atan2(torch.sin(theta).double(),
                       torch.cos(theta).double()).to(theta.dtype)


def rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 2, 2]`` for angles ``[...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((3,), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition ``a * b`` (apply b, then a). Shapes broadcast."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = fma(-sa, b[..., 1], fma(ca, b[..., 0], a[..., 0]))
    y = fma(ca, b[..., 1], fma(sa, b[..., 0], a[..., 1]))
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], -1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -fma(c, a[..., 0], s * a[..., 1])
    y = -fma(c, a[..., 1], -(s * a[..., 0]))
    return torch.stack([x, y, -a[..., 2]], -1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 * b``: pose of b expressed in frame a."""
    return compose(inverse(a), b)


def _rotated(c, s, vx, vy):
    """(c vx - s vy, s vx + c vy)."""
    return fma(c, vx, -(s * vy)), fma(s, vx, c * vy)


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points ``[..., N, 2]`` by pose ``[..., 3]``."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = _rotated(c, s, points[..., 0], points[..., 1])
    return torch.stack([x + pose[..., 0][..., None],
                        y + pose[..., 1][..., None]], -1)


def rotate(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors ``[..., N, 2]`` by a pose's rotation."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    return torch.stack(_rotated(c, s, vecs[..., 0], vecs[..., 1]), -1)


def interpolate(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """Linear interpolation from a (factor=0) to b (factor=1): linear in
    translation, shortest arc in angle (the reference's slerp + lerp for
    planar motion)."""
    f = torch.as_tensor(factor, dtype=a.dtype, device=a.device)
    dt = wrap_angle(b[..., 2] - a[..., 2])
    x = fma(b[..., 0] - a[..., 0], f, a[..., 0])
    y = fma(b[..., 1] - a[..., 1], f, a[..., 1])
    t = wrap_angle(fma(dt, f, a[..., 2]))
    return torch.stack([x, y, t], -1)


def scale(pose: torch.Tensor, factor) -> torch.Tensor:
    """Scale a relative motion by ``factor`` (translation and angle
    linearly), as the per-point motion compensation does."""
    return torch.stack([pose[..., 0] * factor, pose[..., 1] * factor,
                        pose[..., 2] * factor], -1)


# ---- NumPy host-side variants ---------------------------------------------

def relative_np(a, b):
    """NumPy wrap(a^-1 * b) for [3] poses."""
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    th = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
    return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1], th],
                      np.float32)


def apply_np(pose, points):
    """NumPy pose application to [P, 2] points."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    r = np.asarray([[c, -s], [s, c]], points.dtype)
    return points @ r.T + np.asarray(pose[:2], points.dtype)


def compose_np(a, b):
    """NumPy a * b for [3] poses (wrap like ``compose``)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    th = (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi
    return np.asarray([a[0] + c * b[0] - s * b[1],
                       a[1] + s * b[0] + c * b[1], th], np.float32)
