"""NumPy <-> tensor conversion of the port's records.

Each ``*_from_numpy`` takes a mapping of field name -> array (for instance a
reference pytree's fields passed through ``np.asarray``) and returns the
port's dataclass on ``device``; integer index fields become int64.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.types import Cells, GraphEdges, PointCloud
from ..kernels import refmath
from ..ops.logistic import LogisticModel, from_values


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.bool if a.dtype == bool else torch.float32
    return torch.as_tensor(a, device=device).to(dtype)


def cloud_from_numpy(d: Mapping, device=None) -> PointCloud:
    return PointCloud(xy=_t(d["xy"], device), intensity=_t(d["intensity"],
                                                           device),
                      mask=_t(d["mask"], device, torch.bool))


def cells_from_numpy(d: Mapping, device=None) -> Cells:
    return Cells(mean=_t(d["mean"], device), cov=_t(d["cov"], device),
                 normal=_t(d["normal"], device),
                 nsamples=_t(d["nsamples"], device),
                 planarity=_t(d["planarity"], device),
                 avg_intensity=_t(d["avg_intensity"], device),
                 valid=_t(d["valid"], device, torch.bool))


def edges_from_numpy(d: Mapping, device=None) -> GraphEdges:
    """Edges from arrays, the whitening's subnormal entries flushed as
    ``ops/posegraph.py::make_edges`` flushes them."""
    return GraphEdges(idx=_t(d["idx"], device, torch.long),
                      meas=_t(d["meas"], device),
                      sqrt_info=refmath.ftz(_t(d["sqrt_info"], device)),
                      etype=_t(d["etype"], device, torch.long),
                      mask=_t(d["mask"], device, torch.bool))


def logistic_from_numpy(intercept, coef, device=None) -> LogisticModel:
    return from_values(float(np.asarray(intercept)), np.asarray(coef),
                       device=device)


def training_data_from_numpy(learner, x, y) -> None:
    """Load accumulated alignment-training samples (x [S, 6], y [S], for
    instance the reference learner's concatenated ``_x`` / ``_y``) into a
    models.verification.AlignmentLearner, replacing what it holds."""
    learner._x = [np.asarray(x, np.float32).reshape(-1, 6)]
    learner._y = [np.asarray(y, np.float32).reshape(-1)]


def full_graph_from_numpy(poses, edges, cfg, stamps=None, gt=None,
                          loop_log=None, device=None):
    """A models.slam.PoseGraph from the reference's host form: ``poses``
    [N, 3], ``edges`` a list of records with ``idx``, ``meas``, ``etype`` and
    optional ``cov`` (the reference PoseGraph's ``edges``).  Returns
    (graph, loop_log) with the log's rows copied as plain dicts."""
    from ..models.slam import PoseGraph

    g = PoseGraph(cfg, device=device)
    for i, p in enumerate(np.asarray(poses, np.float32)):
        g.add_node(p, 0.0 if stamps is None else float(stamps[i]),
                   gt=None if gt is None else gt[i])
    for ed in edges:
        cov = ed.get("cov")
        g.edges.append(dict(
            idx=(int(ed["idx"][0]), int(ed["idx"][1])),
            meas=np.asarray(ed["meas"], np.float32), etype=int(ed["etype"]),
            cov=None if cov is None else np.asarray(cov, np.float32)))
    return g, [dict(r) for r in (loop_log or [])]
