"""CFEAR radar odometry: the keyframe fuser as one frame step on tensors.

Port of ``tbv_slam_public_tpu.models.odometry``: motion compensation ->
features -> window registration (P2P/P2L/P2D, or time-continuous) -> sanity
check -> keyframe gate -> window roll, with the keyframe decision applied as
a masked update so a frame never waits on the device.  The pipeline reads the
frame's scalars back once per frame; keyframe payloads stay on the device
until a consumer (checkpoint, loop closer) asks for them.  ``process_chunk``
stands for the reference's ``odometry_scan``: K frames go up in one copy, the
K steps run back to back with no host read between them, and one read brings
the K frames' scalars back.

``batched_first_frame`` / ``batched_odometry_step`` run B sequences at once
(the reference ``vmap``s the frame step): each row's detector and features
run one row at a time, and everything from registration on rides the
registration's leading batch axis.  ``odometry_step`` is the same code at
B = 1.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import TBVConfig
from ..core.device import constant, resolve
from ..core.refmath import recip
from ..core.timing import timing
from ..core.types import Cells, PointCloud, _Record, make_cells, \
    stack_records
from ..kernels import refmath
from ..ops import features, radar, registration


@dataclass
class OdometryState:
    kf_cells: Cells  # [(B,) S, C, ...] keyframe window, oldest..newest
    kf_poses: torch.Tensor  # [(B,) S, 3]
    kf_mask: torch.Tensor  # [(B,) S] bool
    T_prev: torch.Tensor  # [(B,) 3] pose of the previous frame
    Tmot: torch.Tensor  # [(B,) 3] previous frame-to-frame motion (local)
    frame_idx: int

    def map(self, fn: Callable) -> "OdometryState":
        """``fn`` applied to every tensor of the state."""
        return OdometryState(self.kf_cells.map(fn), fn(self.kf_poses),
                             fn(self.kf_mask), fn(self.T_prev),
                             fn(self.Tmot), self.frame_idx)


@dataclass
class OdometryOutput(_Record):
    pose: torch.Tensor  # [(B,) 3] current frame pose (world)
    fused: torch.Tensor  # [(B,)] bool, became a keyframe
    success: torch.Tensor  # [(B,)] bool
    constraint: torch.Tensor  # [(B,) 3] last keyframe -> current
    cov: torch.Tensor  # [(B,) 3, 3]
    score: torch.Tensor  # [(B,)]
    num_residuals: torch.Tensor  # [(B,)]
    cells: Cells  # keyframe features (velocity-corrected when time-continuous)
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


def init_batched_state(cfg: TBVConfig, batch: int,
                       device=None) -> OdometryState:
    """The state of ``batch`` sequences, on the card unless ``device`` says
    otherwise."""
    return init_state(cfg, resolve(device)).map(
        lambda x: torch.stack([x] * batch))


def _push_keyframe(state: OdometryState, cells: Cells, pose: torch.Tensor,
                   fuse: torch.Tensor) -> OdometryState:
    """Roll each row's keyframe window where ``fuse`` [B] (a device bool)
    holds."""
    def roll(buf, new):
        keep = fuse.reshape(fuse.shape + (1,) * (buf.ndim - 1))
        return torch.where(keep, torch.cat([buf[:, 1:], new[:, None]], 1),
                           buf)
    kf_cells = Cells(**{f.name: roll(getattr(state.kf_cells, f.name),
                                     getattr(cells, f.name))
                        for f in dataclasses.fields(Cells)})
    return dataclasses.replace(
        state, kf_cells=kf_cells, kf_poses=roll(state.kf_poses, pose),
        kf_mask=roll(state.kf_mask, torch.ones_like(fuse)))


def _detect(images: torch.Tensor, motion: Optional[torch.Tensor],
            cfg: TBVConfig):
    """Detector, motion compensation (where ``motion`` [B, 3] is given) and
    features of each image [B, A, R], one row at a time -> stacked (cells,
    cloud, peaks)."""
    rows = []
    for b in range(images.shape[0]):
        cloud, peaks = radar.filter_scan(images[b], cfg.radar)
        if motion is not None:
            cloud, peaks = radar.motion_compensate_pair(
                cloud, peaks, motion[b], cfg.odometry.radar_ccw)
        rows.append((features.compute_cells(cloud, cfg.features), cloud,
                     peaks))
    return tuple(stack_records(list(x)) for x in zip(*rows))


def batched_first_frame(state: OdometryState, images: torch.Tensor,
                        cfg: TBVConfig):
    """Frame 0 of B sequences: seed each keyframe window at the origin."""
    cells, cloud, peaks = _detect(images, None, cfg)
    bsz, dev = images.shape[0], images.device
    zero3 = torch.zeros((bsz, 3), dtype=torch.float32, device=dev)
    yes = torch.ones(bsz, dtype=torch.bool, device=dev)
    state = _push_keyframe(state, cells, zero3, yes)
    state = dataclasses.replace(state, frame_idx=state.frame_idx + 1)
    out = OdometryOutput(
        pose=zero3, fused=yes, success=yes, constraint=zero3,
        cov=torch.eye(3, dtype=torch.float32, device=dev).expand(bsz, 3, 3),
        score=torch.zeros(bsz, device=dev),
        num_residuals=torch.zeros(bsz, dtype=torch.long, device=dev),
        cells=cells, cloud=cloud, peaks=peaks)
    return state, out


def motion_rates(tmot: torch.Tensor, tmot_prev: torch.Tensor, dt: float):
    """(speed, acceleration) [B] of the frame's motion [B, 3] against the
    previous one, as the reference's program computes its sanity check:
    each norm ``refmath.norm2``, the divisions by the constants dt and dt^2
    products by their float32 reciprocals."""
    return _rates(refmath, tmot, tmot_prev, recip(dt), recip(dt * dt))


def _rates(k, tmot, tmot_prev, rdt, rdt2):
    """The rates' arithmetic, ``k`` the refmath module or a chain body's
    operations."""
    vel = k.norm2(tmot[..., :2]) * rdt
    acc = k.norm2(tmot[..., :2] - tmot_prev[..., :2]) * rdt2
    return vel, acc


def _pose_tail(k, pose, success, guess, t_prev, tmot_prev, last_kf, *, rdt,
               rdt2, vel_limit, acc_limit, kf_dist, kf_rot):
    """The frame's pose tail after registration
    (odometrykeyframefuser.cpp:76-94 and the keyframe gate), one chain:
    the registered pose where it succeeded, the velocity / acceleration
    sanity check, the motion, the constraint to the newest keyframe and
    its gate, the keyframe's rotation -> (Tcurrent, Tmot, diff, fuse,
    rot)."""
    tcur = k.where(success, pose, guess)
    vel, acc = _rates(k, k.site("relative", t_prev, tcur), tmot_prev, rdt,
                      rdt2)
    sane = (vel <= vel_limit) & (acc <= acc_limit)
    tcur = k.where(sane, tcur, guess)
    tmot = k.site("relative", t_prev, tcur)
    diff = k.site("relative", last_kf, tcur)
    fuse = ((k.site("norm2", diff[..., :2]) > kf_dist)
            | (abs(diff[..., 2]) > kf_rot)) & success
    return tcur, tmot, diff, fuse, k.site("rotmat", -last_kf[..., 2])


refmath.register_chain("odometry_pose_tail", [(_pose_tail, range(6))],
                       ((3,), (), (3,), (3,), (3,), (3,)), bools=(1,))


def pose_tail_options(ocfg) -> dict:
    """The pose tail's constants from the odometry configuration: the
    reciprocals of dt and dt^2, the sanity limits and the keyframe gate."""
    dt = ocfg.sensor_period
    return dict(rdt=recip(dt), rdt2=recip(dt * dt), vel_limit=ocfg.vel_limit,
                acc_limit=ocfg.acc_limit, kf_dist=ocfg.min_keyframe_dist,
                kf_rot=math.radians(ocfg.min_keyframe_rot_deg))


def batched_odometry_step(state: OdometryState, images: torch.Tensor,
                          cfg: TBVConfig, one_sequence: bool = False):
    """One odometry frame of B sequences (odometrykeyframefuser.cpp:
    143-260); ``images`` [B, A, R].  ``one_sequence``: B = 1 standing for
    the reference's unbatched step (its LM step rounds otherwise)."""
    ocfg = cfg.odometry
    compensate = ocfg.compensate and not ocfg.time_continuous
    cells, cloud, peaks = _detect(images, state.Tmot if compensate else None,
                                  cfg)
    dev = images.device

    Tguess = se2.compose(state.T_prev, state.Tmot) if ocfg.use_guess \
        else state.T_prev
    prior = None
    if ocfg.soft_constraint:
        prior = torch.diag(constant((10.0, 10.0, 31.6), torch.float32, dev))
    window = (state.kf_cells, state.kf_poses, state.kf_mask)
    guess = Tguess if prior is not None else None
    if ocfg.time_continuous:
        # per-cell velocity correction inside the P2P solve, velocity = the
        # previous motion (RegisterTimeContinuous)
        res = registration.register_time_continuous(
            cells, Tguess, *window, cfg.registration, state.Tmot,
            ccw=ocfg.radar_ccw, guess=guess, guess_sqrt_info=prior,
            one_system=one_sequence)
    else:
        res = registration.register_window(
            cells, Tguess, *window, cfg.registration, guess=guess,
            guess_sqrt_info=prior, one_system=one_sequence)
    last_kf = state.kf_poses[:, -1]
    if ocfg.use_keyframe:
        # the pose tail as one chain (one launch on the card)
        Tcurrent, Tmot, diff, fuse, rot = refmath.chain(
            "odometry_pose_tail", res.pose, res.success, Tguess,
            state.T_prev, state.Tmot, last_kf, **pose_tail_options(ocfg))
    else:
        Tcurrent = torch.where(res.success[:, None], res.pose, Tguess)
        # velocity / acceleration sanity check
        # (odometrykeyframefuser.cpp:76-94)
        Tmot_curr = se2.relative(state.T_prev, Tcurrent)
        vel, acc = motion_rates(Tmot_curr, state.Tmot, ocfg.sensor_period)
        sane = (vel <= ocfg.vel_limit) & (acc <= ocfg.acc_limit)
        Tcurrent = torch.where(sane[:, None], Tcurrent, Tguess)
        Tmot = se2.relative(state.T_prev, Tcurrent)
        diff = se2.relative(last_kf, Tcurrent)
        fuse = torch.ones(images.shape[0], dtype=torch.bool, device=dev)
        fuse = fuse & res.success
        rot = se2.rotmat(-last_kf[:, 2])

    store_cells = cells
    if ocfg.time_continuous:
        # the window keeps the undistorted (velocity-corrected) features
        store_cells = registration.motion_correct_cells(cells, state.Tmot,
                                                        ocfg.radar_ccw)
    new_state = _push_keyframe(state, store_cells, Tcurrent, fuse)
    new_state = dataclasses.replace(new_state, T_prev=Tcurrent, Tmot=Tmot,
                                    frame_idx=state.frame_idx + 1)

    # constraint covariance rotated into the last keyframe's frame
    cov = res.cov
    cov_args = (store_cells, Tcurrent, *window, cfg.registration, res.score,
                res.num_residuals)
    if ocfg.use_sampled_covariance or ocfg.cov_source == "sampled":
        cov_s, ok = registration.sampled_covariance(
            *cov_args, xy_range=ocfg.cov_sampling_xy_range,
            yaw_range=ocfg.cov_sampling_yaw_range,
            steps=ocfg.cov_sampling_samples_per_axis,
            cov_scaler=ocfg.cov_sampling_scaler)
        cov = torch.where(ok[:, None, None], cov_s, cov)
    elif ocfg.cov_source == "ceres":
        cov_c, ok = registration.ceres_covariance(*cov_args)
        cov = torch.where(ok[:, None, None], cov_c, cov)
    cov_rot = cov.clone()
    cov_rot[:, :2, :2] = rot @ cov[:, :2, :2] @ rot.transpose(-1, -2)

    out = OdometryOutput(
        pose=Tcurrent, fused=fuse, success=res.success, constraint=diff,
        cov=cov_rot, score=res.score, num_residuals=res.num_residuals,
        cells=store_cells, cloud=cloud, peaks=peaks)
    return new_state, out


def _as_batch(state: OdometryState, image: torch.Tensor):
    return state.map(lambda x: x[None]), image[None]


def _as_row(state: OdometryState, out: OdometryOutput):
    return state.map(lambda x: x[0]), out.map(lambda x: x[0])


def first_frame(state: OdometryState, image: torch.Tensor, cfg: TBVConfig):
    """Frame 0 of one sequence seeds its keyframe window at the origin."""
    return _as_row(*batched_first_frame(*_as_batch(state, image), cfg))


def odometry_step(state: OdometryState, image: torch.Tensor, cfg: TBVConfig):
    """One odometry frame of one sequence: ``batched_odometry_step`` at
    B = 1."""
    return _as_row(*batched_odometry_step(*_as_batch(state, image), cfg,
                                          one_sequence=True))


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
