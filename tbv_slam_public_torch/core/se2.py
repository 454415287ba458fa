"""SE(2) pose algebra on tensors ``[..., 3]`` = (x, y, theta).

Port of ``tbv_slam_public_tpu.core.se2``; every function broadcasts over
leading batch dimensions.  Sums of products are rounded as the reference's
compiled program rounds them: a product that feeds an add is fused into it
(the first one where both operands are products; ``refmath.fma``), and
sin, cos and the wrap's atan2 are the C library's, as the reference's
program calls them.  Each function is a refmath site (``kernels.refmath``:
one launch per call on the card, its plain version ``_<name>_plain`` below
on the CPU), so this core module depends on the kernels layer: the
dispatch by device lives there.  The
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
    return refmath.site("rotmat", theta)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((3,), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition ``a * b`` (apply b, then a). Shapes broadcast."""
    return refmath.site("compose", a, b)


def inverse(a: torch.Tensor) -> torch.Tensor:
    return refmath.site("inverse", a)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 * b``: pose of b expressed in frame a (one launch on the
    card)."""
    return refmath.site("relative", a, b)


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points ``[..., N, 2]`` by pose ``[..., 3]``."""
    return refmath.site("apply", pose, points)


def rotate(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate direction vectors ``[..., N, 2]`` by a pose's rotation."""
    return refmath.site("rotate", pose, vecs)


def interpolate(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    """Linear interpolation from a (factor=0) to b (factor=1): linear in
    translation, shortest arc in angle (the reference's slerp + lerp for
    planar motion)."""
    f = torch.as_tensor(factor, dtype=a.dtype, device=a.device)
    return refmath.site("interpolate", a, b, f)


# ---- the sites' plain versions: refmath's ops one at a time (its CPU
# plain versions; registered below) ----------------------------------------
#
# The reference's threads read a subnormal operand as zero (DAZ) and flush a
# subnormal result (FTZ): a lone product or a sum of these sites reads a
# subnormal sine, coordinate or angle as zero and flushes its result
# (:func:`_mul`, :func:`_add`), as refmath.fma does its own.  Negation and
# sinf / cosf of a subnormal angle (the angle itself, and 1) keep it.

def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A lone product: operands and result flushed (``refmath.mul``)."""
    return refmath.mul(refmath.ftz(a), refmath.ftz(b))


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, operands and result flushed (the exact sum of two float32
    values is a multiple of 2^-149: rounding never reaches the flush
    tie)."""
    return refmath.ftz(refmath.ftz(a) + refmath.ftz(b))


def _rotmat_plain(theta: torch.Tensor) -> torch.Tensor:
    s, c = refmath.sincos(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _compose_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sa, ca = refmath.sincos(a[..., 2])
    x = refmath.fma(-sa, b[..., 1], refmath.fma(ca, b[..., 0], a[..., 0]))
    y = refmath.fma(ca, b[..., 1], refmath.fma(sa, b[..., 0], a[..., 1]))
    t = wrap_angle(_add(a[..., 2], b[..., 2]))
    return torch.stack([x, y, t], -1)


def _inverse_plain(a: torch.Tensor) -> torch.Tensor:
    s, c = refmath.sincos(a[..., 2])
    x = -refmath.fma(c, a[..., 0], _mul(s, a[..., 1]))
    y = -refmath.fma(c, a[..., 1], -_mul(s, a[..., 0]))
    return torch.stack([x, y, -a[..., 2]], -1)


def _relative_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _compose_plain(_inverse_plain(a), b)


def _rotated(c, s, vx, vy):
    """(c vx - s vy, s vx + c vy)."""
    return refmath.fma(c, vx, -_mul(s, vy)), refmath.fma(s, vx, _mul(c, vy))


def _apply_elem(pose: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Points [..., 2] moved by poses [..., 3] of the same rank (broadcast
    element by element): the arithmetic of ``apply``."""
    s, c = refmath.sincos(pose[..., 2])
    x, y = _rotated(c, s, point[..., 0], point[..., 1])
    return torch.stack([_add(x, pose[..., 0]), _add(y, pose[..., 1])], -1)


def _rotate_elem(pose: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Vectors [..., 2] rotated by poses [..., 3] of the same rank."""
    s, c = refmath.sincos(pose[..., 2])
    return torch.stack(_rotated(c, s, vec[..., 0], vec[..., 1]), -1)


def _apply_plain(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return _apply_elem(pose[..., None, :], points)


def _rotate_plain(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    return _rotate_elem(pose[..., None, :], vecs)


def _interpolate_plain(a: torch.Tensor, b: torch.Tensor,
                       f: torch.Tensor) -> torch.Tensor:
    dt = wrap_angle(_add(b[..., 2], -a[..., 2]))
    x = refmath.fma(_add(b[..., 0], -a[..., 0]), f, a[..., 0])
    y = refmath.fma(_add(b[..., 1], -a[..., 1]), f, a[..., 1])
    t = wrap_angle(refmath.fma(dt, f, a[..., 2]))
    return torch.stack([x, y, t], -1)


# ---- the sites' operand layouts (kernels/refmath.py::register_site) -------

def _poses(*ts):
    """Poses [..., 3] in, a pose [..., 3] out."""
    return [(t, (3,), False) for t in ts], [(3,)], 0, ()


def _pose_points(pose, pts):
    """A pose [..., 3] over points [..., N, 2], points out."""
    return [(pose[..., None, :], (3,), False), (pts, (2,), False)], \
        [(2,)], 0, ()


def _pose_pair_factor(a, b, f):
    """Two poses [..., 3] and a factor [...], a pose out."""
    return [(a, (3,), False), (b, (3,), False), (f, (), False)], \
        [(3,)], 0, ()


def _angles(theta):
    """Angles [...] in, 2x2 matrices out."""
    return [(theta, (), False)], [(2, 2)], 0, ()


for _name, _plain, _layout, _elem in (
        ("compose", _compose_plain, _poses, None),
        ("inverse", _inverse_plain, _poses, None),
        ("relative", _relative_plain, _poses, None),
        ("apply", _apply_plain, _pose_points, _apply_elem),
        ("rotate", _rotate_plain, _pose_points, _rotate_elem),
        ("interpolate", _interpolate_plain, _pose_pair_factor, None),
        ("rotmat", _rotmat_plain, _angles, None)):
    refmath.register_site(_name, _plain, _layout, _elem)


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
