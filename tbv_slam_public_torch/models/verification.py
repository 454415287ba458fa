"""Alignment verification: CorAl + CFEAR features, learned classifiers.

Port of ``tbv_slam_public_tpu.models.verification``:

- ``alignment_features``: the 6-feature vector [CorAl(joint, sep, overlap),
  CFEAR(score, n_residuals, mean feature count)], batched over a leading
  pair axis M;
- ``AlignmentLearner``: 13-perturbation training data per keyframe pair
  (aligned + 4 small / medium / large offsets), IRLS logistic fit, linear
  alignment score.  The 13 perturbations ride the pair axis, so one keyframe
  pair costs one CorAl kernel launch at M=13;
- ``verification_probability``: sigmoid over [odom-bounds, sc-sim,
  alignment_quality] with the published coefficients as default.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..core import se2
from ..core.config import RegistrationConfig, VerificationConfig
from ..core.device import resolve
from ..core.types import Cells, PointCloud
from ..kernels import refmath
from ..ops import coral, logistic, registration


def _apply(k, pose, xy):
    """A cloud moved by its pair's pose (``se2.apply``)."""
    return k.site("apply", pose, xy)


refmath.register_chain("alignment_apply", [(_apply, (0, 1)), (_apply, (2, 3))],
                       ((3,), (2,), (3,), (2,)))


def _cfear_eval_cfg(cfg: VerificationConfig) -> RegistrationConfig:
    # CFEARQuality: P2L, Huber(cfear_loss_limit), uniform weights, radius 2
    return RegistrationConfig(cost="P2L", loss="huber",
                              loss_limit=cfg.cfear_loss_limit, weight_option=0)


def alignment_features(src_peaks: PointCloud, src_cells: Cells,
                       src_pose: torch.Tensor, ref_peaks: PointCloud,
                       ref_cells: Cells, ref_pose: torch.Tensor,
                       cfg: VerificationConfig) -> torch.Tensor:
    """[M, 6] feature vectors X_CorAl ++ X_CFEAR for M scan pairs; ``src``
    is the moved (current) scan, ``ref`` the fixed one."""
    # both clouds moved into the world frame, one chain of two segments
    # (one launch on the card)
    src_xy, ref_xy = refmath.chain("alignment_apply", src_pose[:, None],
                                   src_peaks.xy, ref_pose[:, None],
                                   ref_peaks.xy)
    src_w, ref_w = src_peaks.replace(xy=src_xy), ref_peaks.replace(xy=ref_xy)
    cres = coral.coral_quality(src_w, ref_w, radius=cfg.coral_radius,
                               eps=cfg.coral_entropy_eps, mode=cfg.coral_mode)
    m = src_pose.shape[0]
    cost, n_res = registration.evaluate_cost(
        src_cells, src_pose, ref_cells.map(lambda x: x[:, None]),
        ref_pose[:, None], torch.ones((m, 1), dtype=torch.bool,
                                      device=src_pose.device),
        _cfear_eval_cfg(cfg))
    tot_size = (src_cells.valid.sum(-1) + ref_cells.valid.sum(-1)) / 2.0
    return torch.stack([cres.joint, cres.sep, cres.overlap, cost,
                        n_res.to(cost.dtype), tot_size.to(cost.dtype)], -1)


def default_loop_model(cfg: VerificationConfig,
                       device=None) -> logistic.LogisticModel:
    return logistic.from_values(cfg.loop_coefs[0], cfg.loop_coefs[1:],
                                device=device)


def make_perturbations(cfg: VerificationConfig) -> np.ndarray:
    """[13, 3] training perturbations (alignmentinterface.cpp:479-495)."""
    r = cfg.range_error
    out = [[0.0, 0.0, 0.0]]
    for scale, th in ((1, math.radians(0.5)), (2, math.radians(2.0)),
                      (4, math.radians(15.0))):
        d = scale * r
        out += [[d, 0, th], [0, d, th], [-d, 0, th], [0, -d, th]]
    return np.asarray(out, np.float32)


def batched_training_features(cur_peaks: PointCloud, cur_cells: Cells,
                              cur_poses: torch.Tensor,
                              prev_peaks: PointCloud, prev_cells: Cells,
                              prev_poses: torch.Tensor,
                              perturbations: torch.Tensor,
                              cfg: VerificationConfig):
    """Perturbed training features of B stacked scan pairs ([B, ...] records,
    [B, 3] poses) under K perturbations, as one batch of M = B*K pairs:
    (x [B*K, 6], y [B*K]); y = 1 for the unperturbed pose."""
    b, k = cur_poses.shape[0], perturbations.shape[0]
    rep = lambda t: t[:, None].expand((b, k) + t.shape[1:]).reshape(
        (b * k,) + t.shape[1:])
    pose = se2.compose(cur_poses[:, None], perturbations[None]).reshape(-1, 3)
    x = alignment_features(cur_peaks.map(rep), cur_cells.map(rep), pose,
                           prev_peaks.map(rep), prev_cells.map(rep),
                           rep(prev_poses), cfg)
    y = (perturbations.abs().sum(1) < 1e-4).to(torch.float32)
    return x, y[None].expand(b, k).reshape(-1)


def perturbed_training_features(cur_peaks: PointCloud, cur_cells: Cells,
                                cur_pose: torch.Tensor,
                                prev_peaks: PointCloud, prev_cells: Cells,
                                prev_pose: torch.Tensor,
                                perturbations: torch.Tensor,
                                cfg: VerificationConfig):
    """Features of one scan pair for every perturbation of the current scan:
    (x [K, 6], y [K])."""
    one = lambda t: t[None]
    return batched_training_features(
        cur_peaks.map(one), cur_cells.map(one), cur_pose[None],
        prev_peaks.map(one), prev_cells.map(one), prev_pose[None],
        perturbations, cfg)


class AlignmentLearner:
    """Host-side trainer of the combined 6-feature alignment classifier
    (ScanLearningInterface): accumulate perturbed training pairs, fit, expose
    the linear alignment score.  Starts from the published coefficients, so
    inference works untrained."""

    def __init__(self, cfg: VerificationConfig, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = logistic.from_values(cfg.alignment_coefs[0],
                                          cfg.alignment_coefs[1:],
                                          device=self.device)
        self._perts = torch.as_tensor(make_perturbations(cfg),
                                      device=self.device)
        self._x: List[np.ndarray] = []
        self._y: List[np.ndarray] = []
        self._prev = None
        self._frames = 0

    def add_training_pair(self, peaks: PointCloud, cells: Cells,
                          pose: np.ndarray) -> bool:
        """Feed a new keyframe; returns True when a pair was generated (at
        least ``min_dist_btw_scans`` from the previous one)."""
        self._frames += 1
        up = lambda t: torch.as_tensor(t, device=self.device)
        pose = np.asarray(pose, np.float32)
        cur = (peaks.map(up), cells.map(up), pose)
        if self._prev is None:
            self._prev = cur
            return False
        if float(np.linalg.norm(pose[:2] - self._prev[2][:2])) < \
                self.cfg.min_dist_btw_scans:
            return False
        x, y = perturbed_training_features(
            cur[0], cur[1], up(pose), self._prev[0], self._prev[1],
            up(self._prev[2]), self._perts, self.cfg)
        self._x.append(x.cpu().numpy())
        self._y.append(y.cpu().numpy())
        self._prev = cur
        return True

    @property
    def num_samples(self) -> int:
        return sum(len(y) for y in self._y)

    def training_data(self):
        """The accumulated (x [S, 6], y [S]) as NumPy arrays."""
        return np.concatenate(self._x), np.concatenate(self._y)

    def fit(self) -> None:
        x, y = self.training_data()
        self.model = logistic.fit(torch.as_tensor(x, device=self.device),
                                  torch.as_tensor(y, device=self.device),
                                  balanced=True)

    def alignment_quality(self, x6: torch.Tensor) -> torch.Tensor:
        """COMBINED_COST: the raw linear score."""
        return logistic.predict_linear(self.model, x6)

    def save(self, path: str) -> None:
        logistic.save_coefficients(self.model, path)

    def load(self, path: str) -> None:
        self.model = logistic.load_coefficients(path, device=self.device)


def verification_probability(model: logistic.LogisticModel, odom_bounds,
                             sc_sim, alignment_quality) -> torch.Tensor:
    """Loop acceptance probability (VerificationModel)."""
    dev = model.coef.device
    f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    return logistic.predict_proba(
        model, torch.stack([f(odom_bounds), f(sc_sim), f(alignment_quality)],
                           -1))


def train_loop_model_from_file(path: str,
                               device=None) -> logistic.LogisticModel:
    """Fit the loop classifier from a training-data file with rows
    ``y, odom, sc, align`` (the tbv_model_8.txt format), with balanced class
    weights as the reference's sklearn fit."""
    dev = resolve(device)
    data = np.loadtxt(path, delimiter=",")
    return logistic.fit(
        torch.as_tensor(data[:, 1:4].astype(np.float32), device=dev),
        torch.as_tensor(data[:, 0].astype(np.float32), device=dev),
        balanced=True)


def odometry_consistency(kf_positions: np.ndarray, id_from: int, id_to: int,
                         sigma: float) -> float:
    """VerifyByOdometry: accumulated odometry between the two keyframes
    against the estimated loop distance.  Returns the ODOM_BOUNDS similarity
    (0 = consistent loop, 1 = unlikely)."""
    lo, hi = sorted((id_from, id_to))
    seg = np.diff(kf_positions[lo:hi + 1], axis=0)
    trav = float(np.sum(np.linalg.norm(seg, axis=1)))
    est = float(np.linalg.norm(kf_positions[hi] - kf_positions[lo]))
    rel = max(est - 5.0, 0.0) / max(trav, 1e-9)
    return 1.0 - math.exp(-rel * rel / (2.0 * sigma * sigma))
