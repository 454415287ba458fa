"""The CFEAR cells' statistics: CUDA kernel wrapper.

The kernel is ``csrc/cells.cu``: ``compute_cells`` after the top-C voxel
selection (``ops/features.py``, steps 3-4) in one launch.  Up to
:data:`STAGE_MAX` points a block of 8 warps takes 4 cells: it stages the
cloud's positions and mask in shared memory, gates them once into a
bitmap a cell and walks each bitmap in point order (a warp a cell); above
it a warp a cell reads the points from global memory, so a cloud of any
size runs.
Its plain version is ``ops/features.py::_cell_stats_reference``.  Dispatch is by tensor device:
a CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (inside :func:`plain_on_card` it runs the plain version, the
kernel's yardstick in tests and ``chip_smoke.py``).  ``LAUNCHES`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.config import FeatureConfig

#: number of kernel launches made by :func:`cell_stats`
LAUNCHES = 0

_PLAIN_ON_CARD = False

#: the largest cloud the kernel's weight-sum tree holds (csrc/cells.cu
#: kLevels: 32^5 points)
MAX_POINTS = 32 ** 5
#: the largest cloud the staged design takes (csrc/cells.cu kStageMax)
STAGE_MAX = 24000


@contextlib.contextmanager
def plain_on_card():
    """Inside the block ``cell_stats`` runs its plain version on CUDA
    tensors too."""
    global _PLAIN_ON_CARD
    was, _PLAIN_ON_CARD = _PLAIN_ON_CARD, True
    try:
        yield
    finally:
        _PLAIN_ON_CARD = was


def plain_on_card_enabled() -> bool:
    return _PLAIN_ON_CARD


def _f32(x: float) -> float:
    """A Python float as torch rounds it against a float32 tensor."""
    return float(np.float32(x))


def cell_stats(xy: torch.Tensor, intensity: torch.Tensor, mask: torch.Tensor,
               centroid: torch.Tensor, occupied: torch.Tensor,
               cfg: FeatureConfig, origin=(0.0, 0.0)):
    """The cells' fields (mean [C, 2], cov [C, 2, 2], normal [C, 2],
    nsamples, planarity, avg_intensity [C], valid [C]) of the cloud (xy
    [P, 2], intensity [P], mask [P]) around the selected voxels' centroids
    [C, 2] (``occupied`` [C]), zero where invalid."""
    global LAUNCHES
    dev = xy.device
    if dev.type == "cpu" or (dev.type == "cuda" and _PLAIN_ON_CARD):
        from ..ops.features import _cell_stats_reference

        return _cell_stats_reference(xy, intensity, mask, centroid, occupied,
                                     cfg, origin)
    if dev.type != "cuda":
        raise RuntimeError(f"cell_stats: no kernel for device {dev}")
    p, c = xy.shape[0], centroid.shape[0]
    if xy.shape != (p, 2) or intensity.shape != (p,) or mask.shape != (p,) \
            or centroid.shape != (c, 2) or occupied.shape != (c,):
        raise ValueError(f"cell_stats: shapes {tuple(xy.shape)}, "
                         f"{tuple(intensity.shape)}, {tuple(mask.shape)}, "
                         f"{tuple(centroid.shape)}, {tuple(occupied.shape)}")
    if any(t.dtype != torch.float32 for t in (xy, intensity, centroid)) or \
            mask.dtype != torch.bool or occupied.dtype != torch.bool or \
            any(t.device != dev for t in (intensity, mask, centroid,
                                          occupied)):
        raise TypeError(f"cell_stats: float32 tensors and bool masks on {dev}")
    if p > MAX_POINTS:
        raise ValueError(f"cell_stats: a cloud of {p} points, more than "
                         f"{MAX_POINTS}")
    xy, intensity, mask, centroid, occupied = (
        t.contiguous() for t in (xy, intensity, mask, centroid, occupied))
    if xy.data_ptr() % 8:  # the kernel reads a point's x, y as one float2
        xy = xy.clone()
    f = dict(dtype=torch.float32, device=dev)
    mean, normal = torch.empty((c, 2), **f), torch.empty((c, 2), **f)
    cov = torch.empty((c, 2, 2), **f)
    nsamples, planarity, avg = (torch.empty(c, **f) for _ in range(3))
    valid = torch.empty(c, dtype=torch.bool, device=dev)
    if c == 0:
        return mean, cov, normal, nsamples, planarity, avg, valid
    from .build import library
    from .refmath import _launch_on

    err = _launch_on(
        dev, library().cells_launch, xy.data_ptr(), intensity.data_ptr(),
        mask.data_ptr(), centroid.data_ptr(), occupied.data_ptr(),
        mean.data_ptr(), cov.data_ptr(), normal.data_ptr(),
        nsamples.data_ptr(), planarity.data_ptr(), avg.data_ptr(),
        valid.data_ptr(), p, c, _f32(cfg.resolution * cfg.resolution),
        int(bool(cfg.weight_intensity)), _f32(cfg.intensity_floor),
        int(cfg.min_neighbors), _f32(cfg.max_cond), _f32(cfg.min_det),
        _f32(origin[0]), _f32(origin[1]))
    if err != 0:
        raise RuntimeError(f"cells_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return mean, cov, normal, nsamples, planarity, avg, valid
