"""Proximity-based loop-closure strategies: MiniClosure and GTVicinityClosure.

Port of ``tbv_slam_public_tpu.models.strategies`` (the reference system's
non-ScanContext strategies, loopclosure.cpp:393-555):

- **MiniClosure**: for every origin keyframe, among the later keyframes whose
  odometry travel distance lies in [min_d_travel, max_d_travel] and whose
  current-estimate euclidean distance is <= max_d_close, pick the one that
  minimises eucl / travel; register from an identity relative guess and
  verify.
- **GTVicinityClosure**: the debug oracle: the same selection on the ground
  truth poses and, with ``gt_loop``, the constraint taken directly from the
  ground-truth relative pose when it is within 5 m.

The selection is one [N, N] masked ratio matrix with a per-row argmin;
registration and verification of the selected pairs reuse the pair wave
(``models.loopclosure.register_and_verify_pairs``).  VerifyByOdometry is in
closed form from the odometry keyframe poses.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import TBVConfig
from ..core.device import constant
from ..core.timing import timing
from ..core.types import stack_records
from ..kernels import refmath
from .loopclosure import (LoopCloser, LoopConstraint, _fetch,
                          register_and_verify_pairs)


def proximity_candidates(poses: torch.Tensor, node_mask: torch.Tensor,
                         travel_cum: torch.Tensor, min_d_travel: float,
                         max_d_travel: float, max_d_close: float):
    """Per-origin best revisit candidate (MiniClosure selection).

    poses [N, 3] current estimates, node_mask [N], travel_cum [N] cumulative
    odometry travel.  Returns (best [N] int64, valid [N] bool): for each
    origin i the candidate j > i minimising eucl(i, j) / travel(i, j) subject
    to min_d_travel <= travel <= max_d_travel and eucl <= max_d_close."""
    xy = poses[:, :2]
    sq = (xy * xy).sum(1)
    eucl = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :]
                                  - 2.0 * xy @ xy.T, min=0.0))
    travel = travel_cum[None, :] - travel_cum[:, None]  # [i, j] = cum_j - cum_i
    idx = torch.arange(poses.shape[0], device=poses.device)
    ok = ((idx[None, :] > idx[:, None]) & node_mask[:, None]
          & node_mask[None, :] & (travel >= min_d_travel)
          & (travel <= max_d_travel) & (eucl <= max_d_close))
    ratio = torch.where(ok, eucl / torch.clamp(travel, min=1e-9),
                        torch.full_like(eucl, float("inf")))
    low, best = ratio.min(1)  # the first minimum of a row, as the reference
    return best, torch.isfinite(low)


def verify_by_odometry(odom_poses: torch.Tensor, travel_cum: torch.Tensor,
                       id_from: torch.Tensor, id_to: torch.Tensor,
                       sigma: float,
                       nearby_margin: float = 5.0) -> torch.Tensor:
    """Odometry-consistency dissimilarity (VerifyByOdometry):
    1 - exp(-rel_err^2 / (2 sigma^2)) with
    rel_err = max(|p_from - p_to| - 5, 0) / traveled(from, to)."""
    est = refmath.norm2(odom_poses[id_from, :2] - odom_poses[id_to, :2])
    trav = (travel_cum[id_from] - travel_cum[id_to]).abs()
    rel = torch.clamp(est - nearby_margin, min=0.0) / torch.clamp(trav,
                                                                  min=1e-9)
    # sigma is an operand of the reference's jitted function, not a
    # constant: 2 sigma sigma in float32 at run time, then a true division
    # (by a tensor: torch on the card divides by a number as a product by
    # its reciprocal)
    f = np.float32
    den = f(f(2.0 * f(sigma)) * f(sigma))
    return 1.0 - refmath.exp((-rel * rel) / constant(float(den), rel.dtype,
                                                     rel.device))


def odometry_travel_cumsum(odom_poses: np.ndarray) -> np.ndarray:
    """Cumulative travel distance from consecutive odometry keyframe
    poses."""
    if len(odom_poses) == 0:
        return np.zeros((0,), np.float32)
    xy = np.asarray(odom_poses)[:, :2]
    step = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(step)]).astype(np.float32)


class ProximityCloser:
    """Host-side runner of MiniClosure / GTVicinityClosure over an existing
    LoopCloser's keyframe store: scans, models, device and candidate log are
    shared with the ScanContext strategy."""

    def __init__(self, cfg: TBVConfig, loops: LoopCloser,
                 gt_vicinity: bool = False):
        self.cfg = cfg
        self.loops = loops
        self.gt_vicinity = gt_vicinity
        self._origin_attempted: set = set()

    def search(self, graph_poses: np.ndarray,
               gt_poses: Optional[np.ndarray] = None,
               pair_chunk: int = 64) -> List[LoopConstraint]:
        """One exhaustive search pass over the origins not searched before;
        returns the accepted constraints."""
        lc = self.cfg.loopclosure
        dev = self.loops.device
        n = len(self.loops.kf_odom)
        if n < 2:
            return []
        ref_poses = gt_poses if (self.gt_vicinity and gt_poses is not None) \
            else graph_poses
        ref_poses = np.asarray(ref_poses, np.float32)[:n]
        odom = np.stack(self.loops.kf_odom)
        travel = odometry_travel_cumsum(odom)
        node_mask = np.ones((n,), bool)
        node_mask[[i for i in self._origin_attempted if i < n]] = False

        t = lambda a: torch.as_tensor(a, device=dev)
        best, valid = proximity_candidates(
            t(ref_poses), t(node_mask), t(travel), lc.min_d_travel,
            lc.max_d_travel, lc.max_d_close)
        best = best.cpu().numpy()
        valid = valid.cpu().numpy() & node_mask
        pairs = [(int(max(i, best[i])), int(min(i, best[i])))
                 for i in range(n) if valid[i]]
        self._origin_attempted.update(range(n))
        if not pairs:
            return []
        if self.gt_vicinity and lc.gt_loop and gt_poses is not None:
            return self._gt_constraints(pairs, np.asarray(gt_poses))
        return self._register_verify(pairs, odom, travel, pair_chunk)

    def _gt_constraints(self, pairs, gt_poses) -> List[LoopConstraint]:
        """The gt_loop oracle: constraints from the ground truth."""
        out = []
        for a, b in pairs:  # a = from > b = to
            rel = se2.relative_np(gt_poses[a], gt_poses[b])
            if np.linalg.norm(rel[:2]) < 5.0:
                c = LoopConstraint(id_from=a, id_to=b, t_be=rel, prob=1.0,
                                   quality=dict(gt_loop=1.0))
                self.loops.constraints.append(c)
                out.append(c)
        return out

    def _register_verify(self, pairs, odom, travel,
                         pair_chunk) -> List[LoopConstraint]:
        """Registered + verified mini loops."""
        cfg = self.cfg
        loops = self.loops
        dev = loops.device
        t = lambda a: torch.as_tensor(a, device=dev)
        id_from = np.asarray([a for a, _ in pairs])
        id_to = np.asarray([b for _, b in pairs])
        odom_b = verify_by_odometry(
            t(odom), t(travel), t(id_from), t(id_to),
            cfg.verification.odom_sigma_error)
        if not cfg.verification.verify_via_odometry:
            odom_b = torch.ones_like(odom_b)  # VerifyByOdometry's early-out

        accepted: List[LoopConstraint] = []
        with timing.timer("mini_loop_register_verify"):
            for lo in range(0, len(pairs), pair_chunk):
                sel = range(lo, min(lo + pair_chunk, len(pairs)))
                src = [loops._payload(int(id_from[i])) for i in sel]
                dst = [loops._payload(int(id_to[i])) for i in sel]
                m = len(sel)
                zeros = torch.zeros(m, dtype=torch.float32, device=dev)
                res = _fetch(register_and_verify_pairs(
                    stack_records([c for c, _ in src]),
                    stack_records([p for _, p in src]),
                    stack_records([c for c, _ in dst]),
                    stack_records([p for _, p in dst]),
                    torch.zeros((m, 3), dtype=torch.float32, device=dev),
                    zeros,  # identity guess
                    zeros,  # sc_sim = 0 (CreateMiniloopConstraint)
                    odom_b[lo:lo + m],
                    torch.ones(m, dtype=torch.bool, device=dev),
                    loops.align_model, loops.loop_model, cfg))
                for k, i in enumerate(sel):
                    quality = dict(
                        sc_sim=0.0, odom_bounds=float(res["odom_bounds"][k]),
                        alignment_quality=float(res["align_quality"][k]))
                    loops.candidate_log.append(dict(
                        id_from=int(id_from[i]), id_to=int(id_to[i]),
                        prob=float(res["prob"][k]), **quality,
                        x6=res["x6"][k].tolist(),
                        t_be=res["t_be"][k].tolist(), guess_nr=-1,
                        reg_ok=bool(res["reg_ok"][k])))
                    if res["valid"][k] and float(res["prob"][k]) > \
                            cfg.verification.model_threshold:
                        c = LoopConstraint(
                            id_from=int(id_from[i]), id_to=int(id_to[i]),
                            t_be=res["t_be"][k].copy(),
                            prob=float(res["prob"][k]),
                            quality=dict(quality, mini_loop=1.0))
                        loops.constraints.append(c)
                        accepted.append(c)
        return accepted
