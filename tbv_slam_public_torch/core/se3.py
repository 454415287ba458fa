"""SE(2) <-> SE(3) lifting for export and ground-truth handling.

The reference stores poses as 3D (position + quaternion, types.h:26-60) but the
motion is planar; we lift only for trajectory files (KITTI 3x4 matrices, TUM
quaternions) and ground-truth comparison.  NumPy only — this is host-side I/O
math, not a TPU code path.
"""
from __future__ import annotations

import numpy as np


def se2_to_matrix4(poses: np.ndarray) -> np.ndarray:
    """[N,3] (x,y,theta) -> [N,4,4] homogeneous SE(3) matrices (z=0 plane)."""
    poses = np.asarray(poses)
    n = poses.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    out[:, 0, 0] = c
    out[:, 0, 1] = -s
    out[:, 1, 0] = s
    out[:, 1, 1] = c
    out[:, 0, 3] = poses[:, 0]
    out[:, 1, 3] = poses[:, 1]
    return out


def matrix4_to_se2(mats: np.ndarray) -> np.ndarray:
    """[N,4,4] (or [N,3,4]) SE(3) matrices -> [N,3] (x,y,yaw)."""
    mats = np.asarray(mats)
    yaw = np.arctan2(mats[:, 1, 0], mats[:, 0, 0])
    return np.stack([mats[:, 0, 3], mats[:, 1, 3], yaw], axis=-1)


def se2_to_quat(poses: np.ndarray) -> np.ndarray:
    """[N,3] -> [N,4] quaternions (x,y,z,w) for yaw-only rotation."""
    poses = np.asarray(poses)
    half = poses[:, 2] / 2.0
    n = poses.shape[0]
    q = np.zeros((n, 4))
    q[:, 2] = np.sin(half)
    q[:, 3] = np.cos(half)
    return q
