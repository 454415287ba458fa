"""Core record types as dataclasses of tensors.

Port of ``tbv_slam_public_tpu.core.types``: same field names, shapes, padded
capacities and validity masks.  A leading batch axis (the reference's
``jax.vmap`` axis) is simply an extra leading dimension on every field.
``map`` applies a function to every field, the counterpart of ``jax.tree.map``
over one record; fields may also hold numpy arrays (checkpoints on the host).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch


class _Record:
    def map(self, fn: Callable):
        """``fn`` applied to every tensor field, nested records included."""
        def one(x):
            return x.map(fn) if isinstance(x, _Record) else fn(x)
        return type(self)(**{f.name: one(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def stack_records(recs):
    """One record whose fields are the stacked fields of ``recs`` (the
    counterpart of ``jax.tree.map(jnp.stack)`` over a list of records)."""
    def one(xs):
        return stack_records(xs) if isinstance(xs[0], _Record) \
            else torch.stack(xs)
    return type(recs[0])(**{
        f.name: one([getattr(r, f.name) for r in recs])
        for f in dataclasses.fields(recs[0])})


@dataclass
class PointCloud(_Record):
    """Padded 2D point cloud with intensity; ``mask`` marks real points."""

    xy: torch.Tensor  # [..., P, 2] float32
    intensity: torch.Tensor  # [..., P] float32
    mask: torch.Tensor  # [..., P] bool


@dataclass
class Cells(_Record):
    """CFEAR oriented-surface-point feature set (struct of arrays)."""

    mean: torch.Tensor  # [..., C, 2] weighted sample mean
    cov: torch.Tensor  # [..., C, 2, 2] weighted covariance
    normal: torch.Tensor  # [..., C, 2] unit normal, oriented to the sensor
    nsamples: torch.Tensor  # [..., C] contributing points
    planarity: torch.Tensor  # [..., C] log(1 + cond/2)
    avg_intensity: torch.Tensor  # [..., C]
    valid: torch.Tensor  # [..., C] bool


@dataclass
class Scan(_Record):
    """One processed radar frame: filtered cloud, peaks cloud, features."""

    cloud: PointCloud  # k-strongest filtered cloud
    peaks: PointCloud  # axial-NMS peaks cloud
    cells: Cells  # CFEAR features


# Constraint type codes for the SoA pose graph.
ODOMETRY = 0
LOOP_APPEARANCE = 1
MINI_LOOP = 2
CANDIDATE = 3


@dataclass
class GraphEdges(_Record):
    """SoA edge store for pose-graph optimization.  ``meas`` is the pose of
    node ``idx[:, 1]`` in the frame of node ``idx[:, 0]``; ``sqrt_info`` the
    per-edge 3x3 whitening of (x, y, theta)."""

    idx: torch.Tensor  # [E, 2] int64
    meas: torch.Tensor  # [E, 3] float32
    sqrt_info: torch.Tensor  # [E, 3, 3] float32
    etype: torch.Tensor  # [E] int64
    mask: torch.Tensor  # [E] bool


@dataclass
class RegistrationResult(_Record):
    """Output of a (batched) window registration solve."""

    pose: torch.Tensor  # [..., 3] optimized source pose (world frame)
    score: torch.Tensor  # [...] final cost (0.5 * sum rho)
    num_residuals: torch.Tensor  # [...] int64
    iterations: torch.Tensor  # [...] int64 outer iterations used
    success: torch.Tensor  # [...] bool
    cov: torch.Tensor  # [..., 3, 3]


def make_point_cloud(capacity: int, device=None,
                     dtype=torch.float32) -> PointCloud:
    return PointCloud(xy=torch.zeros((capacity, 2), dtype=dtype,
                                     device=device),
                      intensity=torch.zeros((capacity,), dtype=dtype,
                                            device=device),
                      mask=torch.zeros((capacity,), dtype=torch.bool,
                                       device=device))


def make_cells(capacity: int, device=None, dtype=torch.float32) -> Cells:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return Cells(mean=z(capacity, 2), cov=z(capacity, 2, 2),
                 normal=z(capacity, 2), nsamples=z(capacity),
                 planarity=z(capacity), avg_intensity=z(capacity),
                 valid=torch.zeros((capacity,), dtype=torch.bool,
                                   device=device))
