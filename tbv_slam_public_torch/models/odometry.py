"""CFEAR radar odometry: the keyframe fuser as one frame step on tensors.

Port of ``tbv_slam_public_tpu.models.odometry`` (``init_state``,
``first_frame``, ``odometry_step`` and ``OdometryPipeline.process``): motion
compensation -> features -> window registration -> sanity check ->
keyframe gate -> window roll, with the keyframe decision applied as a masked
update so a frame never waits on the device.  The pipeline reads the frame's
scalars back once per frame; keyframe payloads stay on the device until a
consumer (checkpoint, loop closer) asks for them.  ``process_chunk`` stands
for the reference's ``odometry_scan``: K frames go up in one copy, the K steps
run back to back with no host read between them, and one read brings the K
frames' scalars back.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import TBVConfig
from ..core.device import constant, resolve
from ..core.timing import timing
from ..core.types import Cells, PointCloud, make_cells
from ..ops import features, radar, registration


@dataclass
class OdometryState:
    kf_cells: Cells  # [S, C, ...] keyframe window, oldest..newest
    kf_poses: torch.Tensor  # [S, 3]
    kf_mask: torch.Tensor  # [S] bool
    T_prev: torch.Tensor  # [3] pose of the previous frame
    Tmot: torch.Tensor  # [3] previous frame-to-frame motion (local)
    frame_idx: int


@dataclass
class OdometryOutput:
    pose: torch.Tensor  # [3] current frame pose (world)
    fused: torch.Tensor  # [] bool, became a keyframe
    success: torch.Tensor  # [] bool
    constraint: torch.Tensor  # [3] last keyframe -> current
    cov: torch.Tensor  # [3, 3]
    score: torch.Tensor  # []
    num_residuals: torch.Tensor  # []
    cells: Cells
    cloud: PointCloud  # filtered cloud (motion compensated)
    peaks: PointCloud  # peaks cloud (motion compensated)


def init_state(cfg: TBVConfig, device=None) -> OdometryState:
    s = cfg.odometry.submap_scan_size
    one = make_cells(cfg.features.cell_capacity, device=device)
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=device)
    return OdometryState(
        kf_cells=one.map(lambda x: torch.stack([x] * s)),
        kf_poses=z(s, 3), kf_mask=torch.zeros(s, dtype=torch.bool,
                                              device=device),
        T_prev=z(3), Tmot=z(3), frame_idx=0)


def _push_keyframe(state: OdometryState, cells: Cells, pose: torch.Tensor,
                   fuse: torch.Tensor) -> OdometryState:
    """Roll the keyframe window where ``fuse`` (a device bool) holds."""
    roll = lambda buf, new: torch.where(
        fuse, torch.cat([buf[1:], new[None]]), buf)
    kf_cells = Cells(**{f.name: roll(getattr(state.kf_cells, f.name),
                                     getattr(cells, f.name))
                        for f in dataclasses.fields(Cells)})
    return dataclasses.replace(
        state, kf_cells=kf_cells, kf_poses=roll(state.kf_poses, pose),
        kf_mask=roll(state.kf_mask, torch.ones((), dtype=torch.bool,
                                               device=pose.device)))


def first_frame(state: OdometryState, image: torch.Tensor, cfg: TBVConfig):
    """Frame 0 seeds the keyframe window at the origin."""
    dev = image.device
    cloud, peaks = radar.filter_scan(image, cfg.radar)
    cells = features.compute_cells(cloud, cfg.features)
    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    state = _push_keyframe(state, cells, zero3, yes)
    state = dataclasses.replace(state, frame_idx=state.frame_idx + 1)
    out = OdometryOutput(
        pose=zero3, fused=yes, success=yes, constraint=zero3,
        cov=torch.eye(3, dtype=torch.float32, device=dev),
        score=torch.zeros((), device=dev),
        num_residuals=torch.zeros((), dtype=torch.long, device=dev),
        cells=cells, cloud=cloud, peaks=peaks)
    return state, out


def odometry_step(state: OdometryState, image: torch.Tensor, cfg: TBVConfig):
    """One odometry frame (odometrykeyframefuser.cpp:143-260)."""
    ocfg = cfg.odometry
    if ocfg.time_continuous or ocfg.cov_source == "ceres":
        raise NotImplementedError(
            "time-continuous registration and ceres covariance are not "
            "ported yet (see ROADMAP.md)")
    cloud, peaks = radar.filter_scan(image, cfg.radar)
    if ocfg.compensate:
        cloud = radar.motion_compensate(cloud, state.Tmot, ocfg.radar_ccw)
        peaks = radar.motion_compensate(peaks, state.Tmot, ocfg.radar_ccw)
    cells = features.compute_cells(cloud, cfg.features)
    dev = image.device

    Tguess = se2.compose(state.T_prev, state.Tmot) if ocfg.use_guess \
        else state.T_prev
    prior = None
    if ocfg.soft_constraint:
        prior = torch.diag(constant((10.0, 10.0, 31.6), torch.float32, dev))
    batch = lambda x: x[None]
    res = registration.register_window(
        cells.map(batch), batch(Tguess), state.kf_cells.map(batch),
        batch(state.kf_poses), batch(state.kf_mask), cfg.registration,
        guess=batch(Tguess) if prior is not None else None,
        guess_sqrt_info=prior)
    res = res.map(lambda x: x[0])
    Tcurrent = torch.where(res.success, res.pose, Tguess)

    # velocity / acceleration sanity check (odometrykeyframefuser.cpp:76-94)
    Tmot_curr = se2.relative(state.T_prev, Tcurrent)
    dt = ocfg.sensor_period
    vel = torch.linalg.norm(Tmot_curr[:2]) / dt
    acc = torch.linalg.norm(Tmot_curr[:2] - state.Tmot[:2]) / (dt * dt)
    sane = (vel <= ocfg.vel_limit) & (acc <= ocfg.acc_limit)
    Tcurrent = torch.where(sane, Tcurrent, Tguess)
    Tmot = se2.relative(state.T_prev, Tcurrent)

    # keyframe gate against the newest keyframe
    last_kf = state.kf_poses[-1]
    diff = se2.relative(last_kf, Tcurrent)
    if ocfg.use_keyframe:
        fuse = (torch.linalg.norm(diff[:2]) > ocfg.min_keyframe_dist) | \
            (torch.abs(diff[2]) > math.radians(ocfg.min_keyframe_rot_deg))
    else:
        fuse = torch.ones((), dtype=torch.bool, device=dev)
    fuse = fuse & res.success

    kf_cells0, kf_poses0, kf_mask0 = (state.kf_cells, state.kf_poses,
                                      state.kf_mask)
    state = _push_keyframe(state, cells, Tcurrent, fuse)
    state = dataclasses.replace(state, T_prev=Tcurrent, Tmot=Tmot,
                                frame_idx=state.frame_idx + 1)

    # constraint covariance rotated into the last keyframe's frame
    rot = se2.rotmat(-last_kf[2])
    cov = res.cov
    if ocfg.use_sampled_covariance or ocfg.cov_source == "sampled":
        cov_s, ok = registration.sampled_covariance(
            cells.map(batch), batch(Tcurrent), kf_cells0.map(batch),
            batch(kf_poses0), batch(kf_mask0), cfg.registration,
            batch(res.score), batch(res.num_residuals),
            xy_range=ocfg.cov_sampling_xy_range,
            yaw_range=ocfg.cov_sampling_yaw_range,
            steps=ocfg.cov_sampling_samples_per_axis,
            cov_scaler=ocfg.cov_sampling_scaler)
        cov = torch.where(ok[0], cov_s[0], cov)
    cov_rot = cov.clone()
    cov_rot[:2, :2] = rot @ cov[:2, :2] @ rot.T

    out = OdometryOutput(
        pose=Tcurrent, fused=fuse, success=res.success, constraint=diff,
        cov=cov_rot, score=res.score, num_residuals=res.num_residuals,
        cells=cells, cloud=cloud, peaks=peaks)
    return state, out


def _frame_scalars(out: OdometryOutput) -> torch.Tensor:
    """[16] pose, cov, fused, constraint of one frame: what the host needs
    of it, packed for one device->host read."""
    return torch.cat([out.pose, out.cov.reshape(-1),
                      out.fused.reshape(1).float(), out.constraint])


class OdometryPipeline:
    """Host-side driver: feeds images, collects keyframes and constraints
    (the offline_odometry node).  Frame records are NumPy; keyframe payloads
    (cells, peaks, cloud) are kept as device tensors."""

    def __init__(self, cfg: TBVConfig, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.state = init_state(cfg, self.device)
        self.frame_poses: List[np.ndarray] = []
        self.frame_stamps: List[float] = []
        self.frame_covs: List[np.ndarray] = []
        self.kf_poses: List[np.ndarray] = []
        self.kf_stamps: List[float] = []
        self.kf_cells: List[Cells] = []
        self.kf_peaks: List[PointCloud] = []
        self.kf_clouds: List[PointCloud] = []
        self.kf_gt: List[np.ndarray] = []
        self.kf_constraints: List[dict] = []
        self._last_kf_idx: Optional[int] = None

    def process(self, image: np.ndarray, stamp: float = 0.0,
                gt_pose: Optional[np.ndarray] = None) -> OdometryOutput:
        image = torch.as_tensor(np.asarray(image), device=self.device)
        if self.state.frame_idx == 0:
            with timing.timer("odometry_first_frame"):
                self.state, out = first_frame(self.state, image, self.cfg)
        else:
            with timing.timer("odometry_step"):
                self.state, out = odometry_step(self.state, image, self.cfg)
        self._record_frame(_frame_scalars(out).cpu().numpy(), out, stamp,
                           gt_pose)
        return out

    def _record_frame(self, host: np.ndarray, out: OdometryOutput, stamp,
                      gt_pose) -> None:
        """Per-frame bookkeeping from the frame's scalars on the host
        (``_frame_scalars`` layout); the payload of a fused frame is kept as
        device tensors."""
        pose_h, cov_h = host[:3], host[3:12].reshape(3, 3)
        fused, constraint_h = bool(host[12] > 0.5), host[13:16]
        self.frame_poses.append(pose_h)
        self.frame_stamps.append(stamp)
        self.frame_covs.append(cov_h)
        if fused:
            kf_idx = len(self.kf_poses)
            self.kf_poses.append(pose_h)
            self.kf_stamps.append(stamp)
            if gt_pose is not None:
                self.kf_gt.append(np.asarray(gt_pose, np.float32))
            self.kf_cells.append(out.cells)
            self.kf_peaks.append(out.peaks)
            self.kf_clouds.append(out.cloud)
            if self._last_kf_idx is not None:
                self.kf_constraints.append(dict(
                    id_begin=self._last_kf_idx, id_end=kf_idx,
                    t_be=constraint_h, cov=cov_h))
            self._last_kf_idx = kf_idx

    def process_chunk(self, images: np.ndarray, stamps=None,
                      gt_poses=None) -> int:
        """Run a chunk of K frames on the device: one [K, A, R] upload, K
        frame steps with no host read between them, then one read of the K
        frames' scalars.  Frame 0 of a sequence (window seeding) goes through
        ``process``.  Returns the number of keyframes fused."""
        images = np.asarray(images)
        k = images.shape[0]
        if k == 0:
            return 0
        stamps = [0.0] * k if stamps is None else list(stamps)
        gts = [None] * k if gt_poses is None else list(gt_poses)
        n_kf0 = len(self.kf_poses)
        start = 0
        if self.state.frame_idx == 0:
            self.process(images[0], stamps[0], gt_pose=gts[0])
            start = 1
            if k == 1:
                return len(self.kf_poses) - n_kf0
        with timing.timer("odometry_scan_chunk"):
            dev_images = torch.as_tensor(images[start:], device=self.device)
            outs = []
            for img in dev_images:
                self.state, out = odometry_step(self.state, img, self.cfg)
                outs.append(out)
            host = torch.stack([_frame_scalars(o) for o in outs]).cpu().numpy()
        for i, out in enumerate(outs):
            self._record_frame(host[i], out, stamps[start + i],
                               gts[start + i])
        return len(self.kf_poses) - n_kf0
