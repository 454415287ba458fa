"""Process groups, the mesh, and the collectives of the parallel paths.

Port of ``tbv_slam_public_tpu.parallel.multihost`` over ``torch.distributed``.
The reference runs one JAX program over a ``Mesh`` of devices; here every
rank is a process of its own (launched by ``torchrun``) that runs the same
code on its own device with the full, replicated inputs, works on its slice
of the sharded axis and joins the slices with collectives, so that every
rank returns the full result:

- ``initialize()``: ``init_process_group`` from the environment ``torchrun``
  sets; nothing happens without it or when a group exists already,
- ``make_mesh()`` / ``global_mesh()``: the :class:`Mesh` over a process group
  (the default one unless given),
- ``psum``, ``all_gather``, ``broadcast`` and their record forms: every
  collective is one ``all_reduce`` SUM, exact because each element receives
  one non-zero term (``all_reduce`` is the one collective that NCCL and gloo
  both run on CUDA tensors),
- ``my_jobs(items)``: deterministic round-robin partition of independent
  jobs (sweep jobs, sequences) over processes,
- ``scaling_report(frames, seconds)``: frames/s summed over processes.

Single-process runs degrade gracefully: without an initialised process group
a mesh has size 1, every collective is the identity and every function
equals its single-device counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

from ..core.device import resolve

T = TypeVar("T")


@dataclass
class Mesh:
    """The ranks of one process group; ``size`` takes the place of the
    reference's ``mesh.devices.size``.  ``all_reduces`` counts the
    collectives run over the mesh."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device
    all_reduces: int = 0


def initialize(backend: Optional[str] = None, device=None) -> None:
    """``init_process_group`` from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  A no-op without that
    environment or when a group exists.  The backend defaults to ``nccl``
    for a CUDA device and ``gloo`` for the CPU; a failure raises."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://")


def process_info():
    """(rank, world size) of this process; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def make_mesh(device=None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh over ``group`` (the default group: every process), whose
    tensors live on ``device`` (``core.device.resolve``: under ``torchrun``
    the card of this rank's ``LOCAL_RANK``)."""
    if not dist.is_initialized():
        return Mesh(group=None, rank=0, size=1, device=resolve(device))
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=resolve(device))


def global_mesh(device=None) -> Mesh:
    """Mesh over all processes (every host's cards)."""
    return make_mesh(device)


def my_jobs(items: Sequence[T]) -> List[T]:
    """Round-robin partition of independent jobs across processes."""
    pid, n = process_info()
    return [x for i, x in enumerate(items) if i % n == pid]


def _collective_device() -> torch.device:
    """Where a host scalar crosses the default group: NCCL needs the card."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_hosts_sum(value: float) -> float:
    """Sum a process-local scalar across processes."""
    if not dist.is_initialized():
        return float(value)
    mesh = make_mesh(_collective_device())
    return float(psum(torch.tensor([float(value)], dtype=torch.float64,
                                   device=mesh.device), mesh)[0])


def scaling_report(frames: int, seconds: float) -> dict:
    """Frames/s over all processes; efficiency = rate_N / (N * rate_1) is
    computed by the caller against a stored single-process baseline."""
    total_frames = all_hosts_sum(float(frames))
    return dict(hosts=process_info()[1], frames=int(total_frames),
                seconds=seconds,
                frames_per_s=total_frames / max(seconds, 1e-9))


def rows(n: int, mesh: Mesh):
    """(lo, hi): this rank's contiguous share of an axis of ``n``, which
    must divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"axis of {n} does not divide by the mesh size "
                         f"{mesh.size}")
    share = n // mesh.size
    return mesh.rank * share, (mesh.rank + 1) * share


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks (``all_reduce`` SUM into a copy)."""
    if not dist.is_initialized():
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.all_reduces += 1
    return out


def _summable(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a type every backend sums: bool and narrow ints as int32."""
    if x.dtype == torch.bool or (not x.dtype.is_floating_point
                                 and x.element_size() < 4):
        return x.to(torch.int32)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[size, ...]: every rank's ``x`` in rank order, as the ``psum`` of a
    zero-filled buffer in which each rank fills its own row."""
    w = _summable(x)
    buf = w.new_zeros((mesh.size,) + tuple(x.shape))
    buf[mesh.rank] = w
    return psum(buf, mesh).to(x.dtype)


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (the ``psum`` of it and zeros)."""
    w = _summable(x)
    return psum(w if mesh.rank == src else torch.zeros_like(w),
                mesh).to(x.dtype)


def agree(values: Sequence[int], mesh: Mesh) -> None:
    """Raise on every rank unless all ranks pass the same integers: a host
    decision that sets a collective's shape or trip count must agree, or
    the collectives of the ranks no longer match and the run hangs."""
    mine = torch.as_tensor(list(values), dtype=torch.int64,
                           device=mesh.device)
    got = all_gather(mine, mesh)
    if not bool((got == got[0]).all()):
        raise RuntimeError(f"ranks disagree: {got.tolist()}")


def _pack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors of one leading size M -> one float64 [M, W] buffer (float32,
    bool and integers below 2^53 round-trip exactly)."""
    m = xs[0].shape[0]
    return torch.cat([x.reshape(m, -1).to(torch.float64) for x in xs], 1)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]):
    out, lo = [], 0
    for x in like:
        width = math.prod(x.shape[1:])
        a = buf[:, lo:lo + width].reshape((buf.shape[0],) + x.shape[1:])
        lo += width
        out.append(a > 0.5 if x.dtype == torch.bool else a.to(x.dtype))
    return out


def _leaves(rec) -> List[torch.Tensor]:
    """The tensors of a record in field order, nested records flattened."""
    out = []
    for f in dataclasses.fields(rec):
        x = getattr(rec, f.name)
        out.extend(_leaves(x) if dataclasses.is_dataclass(x) else [x])
    return out


def _rebuild(rec, leaves):
    """``rec``'s structure with its tensors taken in turn from ``leaves``
    (an iterator)."""
    return type(rec)(**{
        f.name: (_rebuild(x, leaves) if dataclasses.is_dataclass(x)
                 else next(leaves))
        for f in dataclasses.fields(rec) for x in [getattr(rec, f.name)]})


def gather_record(rec, mesh: Mesh):
    """A record of [M, ...] tensors (nested records included) from every
    rank, concatenated in rank order on the leading axis ([size * M, ...]),
    by one collective."""
    xs = _leaves(rec)
    got = all_gather(_pack(xs), mesh)
    return _rebuild(rec, iter(_unpack(got.reshape(-1, got.shape[-1]), xs)))


def broadcast_record(rec, mesh: Mesh, src: int = 0):
    """Rank ``src``'s record of [M, ...] tensors on every rank, by one
    collective."""
    xs = _leaves(rec)
    return _rebuild(rec, iter(_unpack(broadcast(_pack(xs), mesh, src), xs)))
