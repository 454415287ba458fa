"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Port of ``tbv_slam_public_tpu.core.se2``; every function broadcasts over
leading batch dimensions.  The ``_np`` helpers are host-side NumPy for the
keyframe bookkeeping loops.
"""
from __future__ import annotations

import numpy as np
import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 2, 2]`` for angles ``[...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((3,), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition ``a * b`` (apply b, then a). Shapes broadcast."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], -1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], -1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 * b``: pose of b expressed in frame a."""
    return compose(inverse(a), b)


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points ``[..., N, 2]`` by pose ``[..., 3]``."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = c * px - s * py + pose[..., 0][..., None]
    y = s * px + c * py + pose[..., 1][..., None]
    return torch.stack([x, y], -1)


def rotate(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors ``[..., N, 2]`` by a pose's rotation."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    vx, vy = vecs[..., 0], vecs[..., 1]
    return torch.stack([c * vx - s * vy, s * vx + c * vy], -1)


def interpolate(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """Linear interpolation from a (factor=0) to b (factor=1): linear in
    translation, shortest arc in angle (the reference's slerp + lerp for
    planar motion)."""
    dt = wrap_angle(b[..., 2] - a[..., 2])
    x = a[..., 0] + (b[..., 0] - a[..., 0]) * factor
    y = a[..., 1] + (b[..., 1] - a[..., 1]) * factor
    t = wrap_angle(a[..., 2] + dt * factor)
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
