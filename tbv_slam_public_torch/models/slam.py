"""TBV SLAM facade: odometry + loop closure + pose-graph optimization.

Port of ``tbv_slam_public_tpu.models.slam``: ``PoseGraph``, ``TBVSLAM`` (the
online per-frame mode with periodic PGO epochs and in-run alignment
training) and ``run_offline_slam`` (the checkpoint path, a thin user of
``TBVSLAM``).  The graph is a host list of keyframe poses and edge records;
the optimizer gets exactly-sized tensors (no capacity padding).  Given a
``parallel.multihost.Mesh``, loop-candidate waves shard over its ranks and
the graph gains ``solver="distributed"`` (``parallel.pgo``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import TBVConfig
from ..core.device import resolve
from ..core.timing import timing
from ..core.types import LOOP_APPEARANCE, MINI_LOOP, ODOMETRY
from ..eval import trajectory as traj_eval
from ..ops import posegraph
from ..parallel import multihost
from .loopclosure import LoopCloser, LoopConstraint
from .odometry import OdometryOutput, OdometryPipeline
from .strategies import ProximityCloser
from .verification import AlignmentLearner


class PoseGraph:
    """Host-side SoA pose graph over keyframes (posegraph.h).  ``mesh``
    enables ``solver="distributed"``; the device defaults to the mesh's."""

    def __init__(self, cfg: TBVConfig, device=None,
                 mesh: Optional[multihost.Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve(device if device is not None or mesh is None
                              else mesh.device)
        self.last_solver: Optional[str] = None  # what "auto" resolved to
        self.poses: List[np.ndarray] = []  # current (optimized) estimate
        self.stamps: List[float] = []
        self.gt: List[Optional[np.ndarray]] = []
        self.edges: List[dict] = []

    def add_node(self, pose: np.ndarray, stamp: float = 0.0,
                 gt: Optional[np.ndarray] = None) -> int:
        self.poses.append(np.asarray(pose, np.float32))
        self.stamps.append(stamp)
        self.gt.append(None if gt is None else np.asarray(gt, np.float32))
        return len(self.poses) - 1

    def add_odometry_constraint(self, id_begin: int, id_end: int,
                                t_be: np.ndarray,
                                cov: Optional[np.ndarray] = None) -> None:
        """Odometry edge; rebases the end node on the begin node's current
        estimate (AddNode, posegraph.cpp:52-73)."""
        self.edges.append(dict(idx=(id_begin, id_end),
                               meas=np.asarray(t_be, np.float32),
                               etype=ODOMETRY,
                               cov=None if cov is None
                               else np.asarray(cov, np.float32)))
        self.poses[id_end] = se2.compose_np(self.poses[id_begin],
                                            np.asarray(t_be, np.float32))

    def add_loop_constraint(self, c: LoopConstraint,
                            etype: int = LOOP_APPEARANCE) -> None:
        self.edges.append(dict(idx=(c.id_from, c.id_to),
                               meas=np.asarray(c.t_be, np.float32),
                               etype=etype,
                               cov=None if c.cov is None
                               else np.asarray(c.cov, np.float32)))

    @property
    def num_nodes(self) -> int:
        return len(self.poses)

    def num_loops(self) -> int:
        return sum(1 for e in self.edges
                   if e["etype"] in (LOOP_APPEARANCE, MINI_LOOP))

    def traveled_distance(self) -> float:
        return float(sum(np.linalg.norm(e["meas"][:2]) for e in self.edges
                         if e["etype"] == ODOMETRY))

    def _padded(self):
        """(poses [N, 3], node_mask [N], GraphEdges [E]) on the device; the
        name follows the reference, whose capacity padding served its
        compile cache and is not needed here."""
        e = len(self.edges)
        idx = np.asarray([ed["idx"] for ed in self.edges],
                         np.int64).reshape(e, 2)
        meas = np.asarray([ed["meas"] for ed in self.edges],
                          np.float32).reshape(e, 3)
        etype = np.asarray([ed["etype"] for ed in self.edges], np.int64)
        covs = np.tile(np.eye(3, dtype=np.float32), (e, 1, 1))
        has_cov = np.zeros((e,), bool)
        for i, ed in enumerate(self.edges):
            c = ed.get("cov")
            if c is not None and np.all(np.isfinite(c)):
                covs[i], has_cov[i] = c, True
        et = torch.as_tensor(etype, device=self.device)
        default = torch.diag_embed(posegraph.default_sqrt_info(et,
                                                               self.cfg.pgo))
        if self.cfg.pgo.replace_cov_by_identity or not has_cov.any():
            sqrt_info = default
        else:
            meas_si = posegraph.measured_sqrt_info(
                torch.as_tensor(covs, device=self.device), et, self.cfg.pgo)
            sqrt_info = torch.where(
                torch.as_tensor(has_cov, device=self.device)[:, None, None],
                meas_si, default)
        edges = posegraph.make_edges(idx, meas, sqrt_info, et,
                                     np.ones(e, bool), self.device)
        poses = torch.as_tensor(np.stack(self.poses), device=self.device)
        node_mask = torch.ones(len(self.poses), dtype=torch.bool,
                               device=self.device)
        return poses, node_mask, edges

    def optimize(self, solver: str = "auto") -> posegraph.PGOResult:
        """ForceOptimize: one full robust LM solve, poses updated in place.

        ``solver="auto"`` picks the structured chain + Woodbury solver
        (``schur``) when the odometry edges form the keyframe chain and loops
        are sparse, the normal SLAM case, and the dense ``cholesky``
        otherwise; ``schur``, ``cholesky`` and ``cg`` select one directly.
        ``solver="distributed"`` runs the edge-sharded CG LM over the mesh
        passed to the constructor (``parallel.pgo.optimize_distributed``)."""
        if solver == "distributed":
            if self.mesh is None:
                raise ValueError("solver='distributed' requires a mesh "
                                 "(PoseGraph(cfg, mesh=...))")
            from ..parallel import pgo as par_pgo

            run = functools.partial(par_pgo.optimize_distributed, self.mesh)
        else:
            n_chain = sum(1 for e in self.edges if e["etype"] == ODOMETRY
                          and e["idx"][1] == e["idx"][0] + 1)
            n_other = len(self.edges) - n_chain
            if solver == "auto":
                sparse_chain = n_chain >= max(4, len(self.poses) // 2) \
                    and n_other * 6 < 3 * len(self.poses)
                solver = "schur" if sparse_chain else "cholesky"
            run = functools.partial(
                posegraph.optimize, solver=solver,
                loop_cap=max(n_other, 1) if solver == "schur" else None)
        poses, node_mask, edges = self._padded()
        with timing.timer("pose_graph_optimization"):
            res = run(poses, node_mask, edges, self.cfg.pgo)
            out = res.poses.cpu().numpy()
        for i in range(len(self.poses)):
            self.poses[i] = out[i]
        self.last_solver = solver
        return res

    def poses_array(self) -> np.ndarray:
        return np.stack(self.poses) if self.poses else np.zeros((0, 3))

    def gt_array(self) -> Optional[np.ndarray]:
        if not self.gt or any(g is None for g in self.gt):
            return None
        return np.stack(self.gt)

    def align_to_gt(self) -> Optional[Dict[str, float]]:
        """SVD best-fit to GT + ATE metrics (Align, posegraph.cpp:235-263)."""
        gt = self.gt_array()
        if gt is None:
            return None
        est = self.poses_array()
        return dict(ate_rmse=traj_eval.ate_rmse(est, gt),
                    ate_mean=traj_eval.ate_mean(est, gt))


@dataclass
class SLAMSummary:
    num_frames: int
    num_keyframes: int
    num_loops: int
    traveled_distance: float
    pgo_cost0: float
    pgo_cost: float
    metrics: Optional[Dict[str, float]]


class TBVSLAM:
    """Full pipeline on one sequence on a deterministic single-stream
    schedule: per-frame odometry, loop closure over completed keyframes and
    explicit PGO epochs (tbv_slam_offline / tbv_slam_online)."""

    def __init__(self, cfg: TBVConfig, train_alignment: bool = False,
                 device=None, mesh: Optional[multihost.Mesh] = None):
        # ``mesh``: loop-candidate waves shard over its ranks and the graph
        # gains solver="distributed"; the device defaults to the mesh's
        self.cfg = cfg
        self.device = resolve(device if device is not None or mesh is None
                              else mesh.device)
        self.odometry = OdometryPipeline(cfg, device=self.device)
        self.loops = LoopCloser(cfg, device=self.device, mesh=mesh)
        self.graph = PoseGraph(cfg, device=self.device, mesh=mesh)
        self._frames = 0
        self._kf_to_node: List[int] = []
        self._kf_since_opt = 0
        self.pgo_epochs = 0
        self.summary: Optional[SLAMSummary] = None
        # in-run alignment-classifier training (tbv_slam_online.cpp:185-188):
        # every keyframe feeds the learner; finish() refits and swaps the
        # loop verifier's alignment model
        self.alignment_learner = AlignmentLearner(
            cfg.verification, device=self.device) if train_alignment else None
        lc = cfg.loopclosure
        self.mini_closure = ProximityCloser(cfg, self.loops) \
            if lc.miniclosure_enabled else None
        self.gt_vicinity = ProximityCloser(cfg, self.loops, gt_vicinity=True) \
            if lc.gt_vicinity_enabled else None

    def process_frame(self, image: np.ndarray, stamp: float = 0.0,
                      gt_pose: Optional[np.ndarray] = None,
                      search_loops: bool = True) -> OdometryOutput:
        """Odometry step; on a keyframe fuse, feed the graph, the loop closer
        (which processes the keyframes whose context is complete) and the
        learner, then run a PGO epoch every ``pgo.optimize_every``
        keyframes."""
        self._frames += 1
        kf_before = len(self.odometry.kf_poses)
        out = self.odometry.process(image, stamp, gt_pose=gt_pose)
        if len(self.odometry.kf_poses) > kf_before:
            self._sync_new_keyframes(kf_before)
            if search_loops:
                for lc in self.loops.process_pending():
                    self.graph.add_loop_constraint(lc)
            # periodic optimization epoch (OptimizerThread semantics): the
            # optimize() rebases all poses, and the next odometry constraint
            # composes off the corrected pose
            self._kf_since_opt += 1
            every = self.cfg.pgo.optimize_every
            if every > 0 and self._kf_since_opt >= every \
                    and self.graph.num_loops() > 0:
                self.graph.optimize(solver="auto")
                self._kf_since_opt = 0
                self.pgo_epochs += 1
        return out

    def process_frames_chunked(self, images, stamps=None, gt_poses=None,
                               chunk: int = 16,
                               search_loops: bool = False) -> int:
        """Feed a whole sequence in device-resident chunks
        (OdometryPipeline.process_chunk).  Keyframe and graph bookkeeping is
        that of ``process_frame``; loop search, if requested, runs between
        chunks.  Returns the total keyframe count."""
        n = len(images)
        stamps = [0.0] * n if stamps is None else list(stamps)
        gts = [None] * n if gt_poses is None else list(gt_poses)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            kf_before = len(self._kf_to_node)
            self._frames += hi - lo
            self.odometry.process_chunk(images[lo:hi], stamps[lo:hi],
                                        gts[lo:hi])
            self._sync_new_keyframes(kf_before)
            if search_loops:
                for lc in self.loops.process_pending():
                    self.graph.add_loop_constraint(lc)
        return len(self._kf_to_node)

    def _sync_new_keyframes(self, kf_before: int) -> None:
        """Graph, loop-closer and learner bookkeeping for the keyframes fused
        since ``kf_before``."""
        od = self.odometry
        by_end = {c["id_end"]: c for c in od.kf_constraints
                  if c["id_end"] >= kf_before}
        for kf_idx in range(kf_before, len(od.kf_poses)):
            pose = od.kf_poses[kf_idx]
            gt = od.kf_gt[kf_idx] if len(od.kf_gt) > kf_idx else None
            node = self.graph.add_node(pose, od.kf_stamps[kf_idx], gt=gt)
            self._kf_to_node.append(node)
            c = by_end.get(kf_idx)
            if c is not None:
                self.graph.add_odometry_constraint(
                    c["id_begin"], c["id_end"], c["t_be"], cov=c.get("cov"))
            self.loops.add_keyframe(od.kf_peaks[kf_idx], od.kf_cells[kf_idx],
                                    pose)
            if self.alignment_learner is not None:
                self.alignment_learner.add_training_pair(
                    od.kf_peaks[kf_idx], od.kf_cells[kf_idx], pose)

    def finish(self, optimize: bool = True,
               solver: str = "cholesky") -> SLAMSummary:
        """Refit the verifier from the in-run training data, drain pending
        loop closures, run the proximity strategies, the final optimization
        and the GT alignment (RunBasicEvaluation + Align)."""
        if self.alignment_learner is not None \
                and self.alignment_learner.num_samples >= 26:
            self.alignment_learner.fit()
            self.loops.align_model = self.alignment_learner.model
        for lc in self.loops.finish():
            self.graph.add_loop_constraint(lc)
        if self.mini_closure is not None:
            for lc in self.mini_closure.search(self.graph.poses_array()):
                self.graph.add_loop_constraint(lc, etype=MINI_LOOP)
        if self.gt_vicinity is not None:
            for lc in self.gt_vicinity.search(self.graph.poses_array(),
                                              gt_poses=self.graph.gt_array()):
                self.graph.add_loop_constraint(lc)
        if optimize and self.graph.num_nodes > 1:
            res = self.graph.optimize(solver=solver)
            cost0, cost = float(res.cost0), float(res.cost)
        else:
            cost0 = cost = 0.0
        self.summary = SLAMSummary(
            num_frames=self._frames, num_keyframes=self.graph.num_nodes,
            num_loops=self.graph.num_loops(),
            traveled_distance=self.graph.traveled_distance(),
            pgo_cost0=cost0, pgo_cost=cost, metrics=self.graph.align_to_gt())
        return self.summary


def run_offline_slam(cfg: TBVConfig, simple_graph, solver: str = "cholesky",
                     batched: bool = True, device=None,
                     mesh: Optional[multihost.Mesh] = None) -> TBVSLAM:
    """SLAM from an odometry-stage checkpoint (tbv_slam_offline): load the
    keyframes, loop closure to exhaustion, one optimization.  ``batched``
    runs loop closure as waves over all keyframes (process_all_batched)
    instead of the per-keyframe loop: the same constraints, far fewer
    launches.  ``mesh`` goes to ``TBVSLAM``.  Read ``.summary`` of the
    returned object."""
    slam = TBVSLAM(cfg, device=device, mesh=mesh)
    g = simple_graph
    for i in range(g.num_keyframes):
        gt = None if g.kf_gt is None else g.kf_gt[i]
        slam.graph.add_node(g.kf_poses[i], float(g.kf_stamps[i]), gt=gt)
        slam.loops.add_keyframe(g.peaks.map(lambda x: x[i]),
                                g.cells.map(lambda x: x[i]), g.kf_poses[i])
    covs = g.constraints_cov
    for k, (idx, meas) in enumerate(zip(g.constraints_idx,
                                        g.constraints_meas)):
        cov = None if covs is None or k >= len(covs) else covs[k]
        slam.graph.add_odometry_constraint(int(idx[0]), int(idx[1]), meas,
                                           cov=cov)
    if batched:
        with timing.timer("loop_wave_batched"):
            for lc in slam.loops.process_all_batched():
                slam.graph.add_loop_constraint(lc)
    slam.finish(optimize=True, solver=solver)
    return slam
