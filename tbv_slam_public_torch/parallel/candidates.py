"""Loop-candidate waves sharded over the ranks of a mesh.

Port of ``tbv_slam_public_tpu.parallel.candidates``.  A wave of (query,
candidate) pairs has no communication between pairs: each rank registers
and verifies its contiguous share of the pair (or candidate) axis with the
single-device code, through its own CorAl kernel launch, and the
``CandidateResult`` rows are gathered in rank order, so every rank returns
the whole wave.

Also the data-parallel alignment-classifier training step: the
13-perturbation features are computed on the rank's share of the scan
pairs, gathered, and the IRLS logistic fit runs on every rank on the whole
[13B, 6] matrix (alignmentinterface.cpp:296-347 semantics).

The shared axis (K candidates, M pairs, B scan pairs) must divide by the
mesh size, as in the reference; callers pad.
"""
from __future__ import annotations

import torch

from ..core.config import TBVConfig
from ..core.types import Cells, PointCloud
from ..models import loopclosure as lc
from ..models import verification as verif
from ..ops import logistic
from .multihost import Mesh, all_gather, gather_record, make_mesh, rows

__all__ = ["make_mesh", "sharded_register_and_verify",
           "sharded_register_and_verify_pairs", "alignment_training_step"]


def sharded_register_and_verify(
    mesh: Mesh,
    q_cells: Cells, q_peaks: PointCloud,  # replicated query
    c_cells: Cells, c_peaks: PointCloud,  # [K, ...] candidate batch
    taug: torch.Tensor, yaw: torch.Tensor, sc_sim: torch.Tensor,
    odom_bounds: torch.Tensor, cand_valid: torch.Tensor,
    align_model: logistic.LogisticModel,
    loop_model: logistic.LogisticModel,
    cfg: TBVConfig,
) -> lc.CandidateResult:
    """The K candidates of one query, sharded on the candidate axis; K must
    divide by the mesh size."""
    lo, hi = rows(yaw.shape[0], mesh)
    sl = lambda x: x[lo:hi]
    return gather_record(lc.register_and_verify(
        q_cells, q_peaks, c_cells.map(sl), c_peaks.map(sl), sl(taug),
        sl(yaw), sl(sc_sim), sl(odom_bounds), sl(cand_valid), align_model,
        loop_model, cfg), mesh)


def sharded_register_and_verify_pairs(
    mesh: Mesh,
    q_cells: Cells, q_peaks: PointCloud,  # [M, ...] per-pair queries
    c_cells: Cells, c_peaks: PointCloud,  # [M, ...] candidates
    taug: torch.Tensor, yaw: torch.Tensor, sc_sim: torch.Tensor,
    odom_bounds: torch.Tensor, pair_valid: torch.Tensor,
    align_model: logistic.LogisticModel,
    loop_model: logistic.LogisticModel,
    cfg: TBVConfig,
) -> lc.CandidateResult:
    """A flat pair wave (every row has its own query: the offline wave form
    of ``LoopCloser.process_all_batched``) sharded on the pair axis; M must
    divide by the mesh size."""
    lo, hi = rows(yaw.shape[0], mesh)
    sl = lambda x: x[lo:hi]
    return gather_record(lc.register_and_verify_pairs(
        q_cells.map(sl), q_peaks.map(sl), c_cells.map(sl), c_peaks.map(sl),
        sl(taug), sl(yaw), sl(sc_sim), sl(odom_bounds), sl(pair_valid),
        align_model, loop_model, cfg), mesh)


def alignment_training_step(
    mesh: Mesh,
    cur_peaks: PointCloud, cur_cells: Cells, cur_poses: torch.Tensor,
    prev_peaks: PointCloud, prev_cells: Cells, prev_poses: torch.Tensor,
    cfg: TBVConfig,
):
    """Data-parallel alignment-model training step over B scan pairs
    ([B, ...] records, [B, 3] poses); B must divide by the mesh size.
    Returns (model, x [13B, 6], y [13B]) on every rank, rows in pair
    order."""
    lo, hi = rows(cur_poses.shape[0], mesh)
    sl = lambda x: x[lo:hi]
    perts = torch.as_tensor(verif.make_perturbations(cfg.verification),
                            device=cur_poses.device)
    x, y = verif.batched_training_features(
        cur_peaks.map(sl), cur_cells.map(sl), sl(cur_poses),
        prev_peaks.map(sl), prev_cells.map(sl), sl(prev_poses), perts,
        cfg.verification)
    x = all_gather(x, mesh).reshape(-1, x.shape[-1])
    y = all_gather(y, mesh).reshape(-1)
    return logistic.fit(x, y, balanced=True), x, y
