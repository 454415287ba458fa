"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Port of ``tbv_slam_public_tpu.core.se2``; every function broadcasts over
leading batch dimensions.  Sums of products are rounded as the reference's
compiled program rounds them: a product that feeds an add is fused into it
(the first one where both operands are products; ``refmath.fma``), and
sin, cos and the wrap's atan2 are the C library's, as the reference's
program calls them (``kernels.refmath``: one launch per call on the card).
So this core module depends on the kernels layer: the dispatch by device
(the plain version on the CPU, the kernel on the card) lives there.  The
``_np`` helpers are host-side NumPy for the keyframe bookkeeping
loops.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import refmath


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]: atan2f(sinf(t), cosf(t)), elementwise, so a
    row's angle depends on nothing beside it."""
    return refmath.wrap_angle(theta)


def rotmat(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 2, 2]`` for angles ``[...]``."""
    s, c = refmath.sincos(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((3,), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition ``a * b`` (apply b, then a). Shapes broadcast."""
    sa, ca = refmath.sincos(a[..., 2])
    x = refmath.fma(-sa, b[..., 1], refmath.fma(ca, b[..., 0], a[..., 0]))
    y = refmath.fma(ca, b[..., 1], refmath.fma(sa, b[..., 0], a[..., 1]))
    t = wrap_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], -1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    s, c = refmath.sincos(a[..., 2])
    x = -refmath.fma(c, a[..., 0], s * a[..., 1])
    y = -refmath.fma(c, a[..., 1], -(s * a[..., 0]))
    return torch.stack([x, y, -a[..., 2]], -1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 * b``: pose of b expressed in frame a."""
    return compose(inverse(a), b)


def _rotated(c, s, vx, vy):
    """(c vx - s vy, s vx + c vy)."""
    return refmath.fma(c, vx, -(s * vy)), refmath.fma(s, vx, c * vy)


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points ``[..., N, 2]`` by pose ``[..., 3]``."""
    s, c = refmath.sincos(pose[..., 2][..., None])
    x, y = _rotated(c, s, points[..., 0], points[..., 1])
    return torch.stack([x + pose[..., 0][..., None],
                        y + pose[..., 1][..., None]], -1)


def rotate(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors ``[..., N, 2]`` by a pose's rotation."""
    s, c = refmath.sincos(pose[..., 2][..., None])
    return torch.stack(_rotated(c, s, vecs[..., 0], vecs[..., 1]), -1)


def interpolate(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """Linear interpolation from a (factor=0) to b (factor=1): linear in
    translation, shortest arc in angle (the reference's slerp + lerp for
    planar motion)."""
    f = torch.as_tensor(factor, dtype=a.dtype, device=a.device)
    dt = wrap_angle(b[..., 2] - a[..., 2])
    x = refmath.fma(b[..., 0] - a[..., 0], f, a[..., 0])
    y = refmath.fma(b[..., 1] - a[..., 1], f, a[..., 1])
    t = wrap_angle(refmath.fma(dt, f, a[..., 2]))
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
