"""Checkpoints: the simple_graph (odometry stage) and full_graph archives.

Port of ``tbv_slam_public_tpu.io.checkpoint`` with the same ``.npz`` keys and
dtypes, so checkpoints cross between the two packages in both directions.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from ..core.types import Cells, PointCloud


@dataclasses.dataclass
class SimpleGraph:
    """Odometry-stage checkpoint contents (keyframes + odometry constraints),
    all host NumPy arrays."""

    kf_poses: np.ndarray  # [N, 3]
    kf_stamps: np.ndarray  # [N]
    kf_gt: Optional[np.ndarray]  # [N, 3] or None
    clouds: PointCloud  # stacked [N, P, ...] (numpy fields)
    peaks: PointCloud
    cells: Cells  # stacked [N, C, ...]
    constraints_idx: np.ndarray  # [E, 2]
    constraints_meas: np.ndarray  # [E, 3]
    constraints_cov: np.ndarray  # [E, 3, 3]

    @property
    def num_keyframes(self) -> int:
        return len(self.kf_poses)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stack(leaves: List) -> np.ndarray:
    return np.stack([_np(x) for x in leaves])


def _stack_records(recs):
    return type(recs[0])(**{f.name: _stack([getattr(r, f.name) for r in recs])
                            for f in dataclasses.fields(recs[0])})


def from_odometry(pipe) -> SimpleGraph:
    """Build the checkpoint from a finished OdometryPipeline."""
    cons = pipe.kf_constraints
    gt = getattr(pipe, "kf_gt", None)
    return SimpleGraph(
        kf_poses=_stack(pipe.kf_poses),
        kf_stamps=np.asarray(pipe.kf_stamps, np.float64),
        kf_gt=None if not gt else _stack(gt),
        clouds=_stack_records(pipe.kf_clouds),
        peaks=_stack_records(pipe.kf_peaks),
        cells=_stack_records(pipe.kf_cells),
        constraints_idx=np.asarray(
            [[c["id_begin"], c["id_end"]] for c in cons],
            np.int32).reshape(-1, 2),
        constraints_meas=np.asarray([c["t_be"] for c in cons],
                                    np.float32).reshape(-1, 3),
        constraints_cov=np.asarray([c["cov"] for c in cons],
                                   np.float32).reshape(-1, 3, 3),
    )


def save_simple_graph(path: str, g: SimpleGraph) -> None:
    data = dict(
        kf_poses=g.kf_poses, kf_stamps=g.kf_stamps,
        cloud_xy=_np(g.clouds.xy), cloud_intensity=_np(g.clouds.intensity),
        cloud_mask=_np(g.clouds.mask),
        peaks_xy=_np(g.peaks.xy), peaks_intensity=_np(g.peaks.intensity),
        peaks_mask=_np(g.peaks.mask),
        cells_mean=_np(g.cells.mean), cells_cov=_np(g.cells.cov),
        cells_normal=_np(g.cells.normal),
        cells_nsamples=_np(g.cells.nsamples),
        cells_planarity=_np(g.cells.planarity),
        cells_avg_intensity=_np(g.cells.avg_intensity),
        cells_valid=_np(g.cells.valid),
        constraints_idx=g.constraints_idx,
        constraints_meas=g.constraints_meas,
        constraints_cov=g.constraints_cov,
    )
    if g.kf_gt is not None:
        data["kf_gt"] = g.kf_gt
    np.savez_compressed(path, **data)


def load_simple_graph(path: str) -> SimpleGraph:
    z = np.load(path)
    clouds = PointCloud(xy=z["cloud_xy"], intensity=z["cloud_intensity"],
                        mask=z["cloud_mask"])
    peaks = PointCloud(xy=z["peaks_xy"], intensity=z["peaks_intensity"],
                       mask=z["peaks_mask"])
    cells = Cells(mean=z["cells_mean"], cov=z["cells_cov"],
                  normal=z["cells_normal"], nsamples=z["cells_nsamples"],
                  planarity=z["cells_planarity"],
                  avg_intensity=z["cells_avg_intensity"],
                  valid=z["cells_valid"])
    return SimpleGraph(
        kf_poses=z["kf_poses"], kf_stamps=z["kf_stamps"],
        kf_gt=z["kf_gt"] if "kf_gt" in z.files else None,
        clouds=clouds, peaks=peaks, cells=cells,
        constraints_idx=z["constraints_idx"],
        constraints_meas=z["constraints_meas"],
        constraints_cov=z["constraints_cov"],
    )


def save_full_graph(path: str, graph, loop_log: Optional[List[dict]] = None,
                    slam=None) -> None:
    """The full pose graph incl. loop constraints (full_graph.pgh).  With
    ``slam`` (a models.slam.TBVSLAM) the loop closer's keyframe payloads are
    stored too, so loop closure and re-verification can resume from the
    checkpoint; ``loop_log`` (default: the slam's candidate log) is stored as
    one JSON string, a key the reference's loader does not read."""
    e = graph.edges
    eye = np.eye(3, dtype=np.float32)
    data = dict(
        poses=np.stack(graph.poses) if graph.poses else np.zeros((0, 3)),
        stamps=np.asarray(graph.stamps, np.float64),
        edge_idx=np.asarray([ed["idx"] for ed in e], np.int32).reshape(-1, 2),
        edge_meas=np.asarray([ed["meas"] for ed in e],
                             np.float32).reshape(-1, 3),
        edge_type=np.asarray([ed["etype"] for ed in e], np.int32),
        edge_cov=np.asarray([eye if ed.get("cov") is None else ed["cov"]
                             for ed in e], np.float32).reshape(-1, 3, 3),
        edge_has_cov=np.asarray([ed.get("cov") is not None for ed in e],
                                bool),
    )
    gt = graph.gt_array()
    if gt is not None:
        data["gt"] = gt
    if loop_log is None and slam is not None:
        loop_log = slam.loops.candidate_log
    if loop_log:
        data["loop_log"] = np.asarray(json.dumps(loop_log))
    if slam is not None and slam.loops.kf_peaks:
        lp = slam.loops
        peaks, cells = _stack_records(lp.kf_peaks), _stack_records(lp.kf_cells)
        data.update(
            peaks_xy=peaks.xy, peaks_intensity=peaks.intensity,
            peaks_mask=peaks.mask, cells_mean=cells.mean,
            cells_cov=cells.cov, cells_normal=cells.normal,
            cells_nsamples=cells.nsamples, cells_planarity=cells.planarity,
            cells_avg_intensity=cells.avg_intensity, cells_valid=cells.valid,
            kf_odom=_stack(lp.kf_odom))
    np.savez_compressed(path, **data)


def load_full_graph(path: str, cfg, device=None):
    """Rebuild a models.slam.PoseGraph from a full-graph checkpoint written
    by either package."""
    from ..models.slam import PoseGraph

    g = PoseGraph(cfg, device=device)
    z = np.load(path)
    gt = z["gt"] if "gt" in z.files else None
    has_cov = z["edge_has_cov"] if "edge_has_cov" in z.files else None
    covs = z["edge_cov"] if "edge_cov" in z.files else None
    for i, p in enumerate(z["poses"]):
        g.add_node(p, float(z["stamps"][i]), gt=None if gt is None else gt[i])
    for k, (idx, meas, et) in enumerate(zip(z["edge_idx"], z["edge_meas"],
                                            z["edge_type"])):
        cov = covs[k] if covs is not None and has_cov is not None \
            and has_cov[k] else None
        g.edges.append(dict(idx=(int(idx[0]), int(idx[1])),
                            meas=np.asarray(meas, np.float32),
                            etype=int(et), cov=cov))
    return g


def load_loop_log(path: str) -> List[dict]:
    """The candidate log of a full-graph checkpoint ([] where it has none)."""
    z = np.load(path)
    return json.loads(str(z["loop_log"])) if "loop_log" in z.files else []


def load_full_graph_slam(path: str, cfg, device=None):
    """Rebuild a full TBVSLAM, pose graph AND loop-closer keyframe payloads,
    from a full-graph checkpoint saved with ``slam=``.  Loop closure is
    resumable (processed pointer at the end): add more keyframes and call
    loops.process_pending(), or re-verify existing constraints."""
    from ..models.slam import TBVSLAM

    z = np.load(path)
    if "peaks_xy" not in z.files:
        raise ValueError(f"{path} was saved without scan payloads "
                         "(save_full_graph(..., slam=...))")
    slam = TBVSLAM(cfg, device=device)
    slam.graph = load_full_graph(path, cfg, device=slam.device)
    n = slam.graph.num_nodes
    for i in range(n):
        peaks = PointCloud(xy=z["peaks_xy"][i],
                           intensity=z["peaks_intensity"][i],
                           mask=z["peaks_mask"][i])
        cells = Cells(mean=z["cells_mean"][i], cov=z["cells_cov"][i],
                      normal=z["cells_normal"][i],
                      nsamples=z["cells_nsamples"][i],
                      planarity=z["cells_planarity"][i],
                      avg_intensity=z["cells_avg_intensity"][i],
                      valid=z["cells_valid"][i])
        slam.loops.add_keyframe(peaks, cells, z["kf_odom"][i])
    slam.loops._processed = n
    slam.loops.candidate_log = load_loop_log(path)
    slam._kf_to_node = list(range(n))
    return slam
