"""Batched odometry with its sequences sharded over the ranks of a mesh.

The counterpart of the reference running ``models.odometry``'s
``batched_first_frame`` / ``batched_odometry_step`` on inputs sharded along
the batch axis (one sequence per device in the JAX package's multi-device
dry run, ``dryrun_multichip``).  Sequences never exchange data: each rank
keeps its own contiguous ``multihost.rows`` share of the B sequences'
``OdometryState`` and steps it on its rows of the [B, A, R] images with the
single-device code; the frame's ``OdometryOutput`` rows are then gathered in
sequence order, one collective a frame, so every rank returns the whole
batch.  B must divide by the mesh size, as the reference's sharding
demands.
"""
from __future__ import annotations

import torch

from ..core.config import TBVConfig
from ..models import odometry as odo
from .multihost import Mesh, agree, gather_record, rows

__all__ = ["init_state", "batched_first_frame", "batched_odometry_step",
           "run_sequences"]


def init_state(cfg: TBVConfig, batch: int, mesh: Mesh) -> odo.OdometryState:
    """This rank's share of the state of ``batch`` sequences, on the mesh's
    device."""
    lo, hi = rows(batch, mesh)
    return odo.init_batched_state(cfg, hi - lo, device=mesh.device)


def _step(fn, mesh: Mesh, state: odo.OdometryState, images: torch.Tensor,
          cfg: TBVConfig):
    b = images.shape[0]
    lo, hi = rows(b, mesh)
    if state.kf_poses.shape[0] != hi - lo:
        raise ValueError(f"state holds {state.kf_poses.shape[0]} sequences, "
                         f"this rank's share of {b} is {hi - lo}")
    # the gather's shape follows the images: every rank must see the same
    agree(tuple(images.shape) + (state.frame_idx,), mesh)
    state, out = fn(state, images[lo:hi].to(mesh.device), cfg)
    return state, gather_record(out, mesh)


def batched_first_frame(mesh: Mesh, state: odo.OdometryState,
                        images: torch.Tensor, cfg: TBVConfig):
    """Frame 0 of B sequences, ``images`` [B, A, R] on every rank: this
    rank's new state share and the whole batch's output."""
    return _step(odo.batched_first_frame, mesh, state, images, cfg)


def batched_odometry_step(mesh: Mesh, state: odo.OdometryState,
                          images: torch.Tensor, cfg: TBVConfig):
    """One frame of B sequences, ``images`` [B, A, R] on every rank: this
    rank's new state share and the whole batch's ``OdometryOutput`` [B, ...]
    in sequence order."""
    return _step(odo.batched_odometry_step, mesh, state, images, cfg)


def run_sequences(mesh: Mesh, images: torch.Tensor, cfg: TBVConfig):
    """B sequences of N frames, ``images`` [N, B, A, R] on every rank, from
    a fresh state: the poses [N, B, 3] and keyframe flags [N, B] of every
    frame, the whole batch's on every rank."""
    state = init_state(cfg, images.shape[1], mesh)
    state, out = batched_first_frame(mesh, state, images[0], cfg)
    poses, fused = [out.pose], [out.fused]
    for k in range(1, images.shape[0]):
        state, out = batched_odometry_step(mesh, state, images[k], cfg)
        poses.append(out.pose)
        fused.append(out.fused)
    return torch.stack(poses), torch.stack(fused)
