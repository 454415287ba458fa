"""Port parity of the odometry variants: time-continuous registration, the
P2D cost, the Ceres-style covariance, the CA-CFAR detector, and the batched
multi-sequence step.

A short simulated sequence at ``tests/test_odometry.py``'s small config goes
through both packages.  The port's frame step is fed the reference's own
detector output; from there on the tolerances are: keyframe flags equal,
trajectory mean < 0.2 mm and max < 0.5 mm from JAX; the batched step at
B = 2 equal to two B = 1 runs of the port's batched step within 1e-5 and
to the reference's ``batched_odometry_step`` within the same bounds.

With each package's own detector the same bounds hold, on both
sequences (``tests/test_torch_odometry_variants_own_detector.py``, a file
of its own so that the test runner can place it on another worker): the detector's points are the reference's bit for bit
(``tests/test_torch_parity_faults.py``) and the CFEAR cells round as the
reference's but for the voxel sums' order and the eigen-decomposition's
sqrt.  The registration's per-term arithmetic (sin, cos, sqrt, the fused
products, the robust loss, the P2D whitening, the LM step) is the
reference's; its sums over the cells add in another order, and an
association or an outer-loop guard may flip on such a last-bit
difference (ROADMAP.md section 3).  Measured (mean / max, sequence 0;
sequence 1): default 0.014 / 0.074 mm; 0.015 / 0.092, time-continuous
0.104 / 0.307; 0.034 / 0.113, P2D 0.020 / 0.096; 0.031 / 0.098, CA-CFAR
0.010 / 0.044; 0.010 / 0.050 (before the sqrt, loss, whitening and LM
step repairs: 0.003 / 0.025, 0.071 / 0.240, 0.042 / 0.148 and 0.009 /
0.123 on sequence 0, P2D 0.484 / 1.877 on sequence 1; before the
reference's math: 0.028 / 0.112 and 0.273 / 1.981 mm, held to 1 mm / 2
mm; before the detector and cell repairs 0.344 / 2.030 and 2.578 / 7.290
mm, held to 1 cm).
"""
import dataclasses
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import config as jcfg
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import odometry as jodo
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.core import config as tcfg
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.models import odometry as todo
from tbv_slam_public_torch.ops import radar as tradar

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_odometry import small_config  # noqa: E402

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

N_FRAMES = 14
MEAN_TOL, MAX_TOL = 2e-4, 5e-4

VARIANTS = {
    "time_continuous": {"odometry.time_continuous": "true"},
    "p2d": {"registration.cost": "P2D"},
    "ceres": {"odometry.cov_source": "ceres"},
    "cacfar": {"radar.filter_type": "cacfar", "radar.cfar_guard_cells": "2",
               "radar.cfar_window_size": "6",
               "radar.cfar_false_alarm_rate": "0.05"},
}


def _configs(overrides):
    """The same overrides applied by each package's copy of the config."""
    j = jcfg.apply_overrides(small_config(), overrides)
    t = tcfg.apply_overrides(tcfg.TBVConfig(**{
        f.name: getattr(tcfg, type(getattr(j, f.name)).__name__)(
            **dataclasses.asdict(getattr(small_config(), f.name)))
        for f in dataclasses.fields(j)}), overrides)
    assert tcfg.to_pars_text(t) == jcfg.to_pars_text(j)
    return j, t


@functools.lru_cache(maxsize=None)
def _sequences():
    kw = dict(num_azimuths=200, num_range_bins=256, range_res=0.3)
    return (simulate.make_sequence(
        num_frames=N_FRAMES, seed=0, **kw,
        traj_kwargs=dict(radius=40.0, step=0.7, laps=0.12)),
        simulate.make_sequence(
        num_frames=N_FRAMES, seed=9, **kw,
        traj_kwargs=dict(radius=35.0, step=0.6, laps=0.1)))


@pytest.fixture
def same_detector(monkeypatch):
    """The port's frame step gets the reference's detector output."""
    def reference_output(image, cfg):
        return tuple(TCloud(*(torch.as_tensor(np.array(getattr(c, f)))
                              for f in ("xy", "intensity", "mask")))
                     for c in jradar.filter_scan(jnp.asarray(image.numpy()),
                                                 cfg))
    monkeypatch.setattr(tradar, "filter_scan", reference_output)


@functools.lru_cache(maxsize=None)
def _reference(name, seq=0):
    """The reference pipeline's (poses, covariances, keyframe flags) of a
    sequence under a variant."""
    jc, _ = _configs(VARIANTS.get(name, {}))
    return _run(jodo.OdometryPipeline(jc), _sequences()[seq].images)


def _run(pipe, images):
    """(frame poses, frame covariances, keyframe flags)."""
    fused = [bool(np.asarray(pipe.process(im, stamp=0.25 * i).fused))
             for i, im in enumerate(images)]
    return np.asarray(pipe.frame_poses), np.asarray(pipe.frame_covs), fused


def _assert_trajectory(got, want, mean_tol=MEAN_TOL, max_tol=MAX_TOL):
    d = np.linalg.norm(got[:, :2] - want[:, :2], axis=1)
    assert d.mean() < mean_tol and d.max() < max_tol, d
    assert np.abs(got[:, 2] - want[:, 2]).max() < max_tol


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches(same_detector, name):
    _, tc = _configs(VARIANTS[name])
    jpose, jcov, jflags = _reference(name)
    tpose, tcov, tflags = _run(todo.OdometryPipeline(tc, device="cpu"),
                               _sequences()[0].images)
    assert tflags == jflags
    assert sum(tflags) > 3
    _assert_trajectory(tpose, jpose)
    if name == "ceres":
        # the covariance of each frame, at each package's own pose: a
        # millimetre of pose moves an association or two, so relative to
        # the covariance's scale
        assert not np.allclose(jcov[1:], np.eye(3)), "no covariance computed"
        np.testing.assert_allclose(tcov, jcov, rtol=0,
                                   atol=1e-2 * np.abs(jcov).max())


@pytest.mark.parametrize("name", ["default", "time_continuous"])
def test_batched_step_matches(same_detector, name):
    jc, tc = _configs(VARIANTS.get(name, {}))
    imgs = np.stack([s.images for s in _sequences()], 1)  # [N, 2, A, R]
    # the port's batched step, one sequence at a time (B = 1) and both at
    # once (the unbatched step rounds its LM step as the reference's
    # unbatched program, whose rows differ from its batched ones by up to
    # 1.2e-4 on these sequences)
    singles = []
    for b in range(2):
        st = todo.init_batched_state(tc, 1, device="cpu")
        st, _ = todo.batched_first_frame(st, torch.as_tensor(imgs[0, b:b + 1]),
                                         tc)
        poses = [np.zeros(3, np.float32)]
        for k in range(1, N_FRAMES):
            st, out = todo.batched_odometry_step(
                st, torch.as_tensor(imgs[k, b:b + 1]), tc)
            poses.append(out.pose[0].numpy())
        singles.append(np.stack(poses))
    bst = todo.init_batched_state(tc, 2, device="cpu")
    bst, out = todo.batched_first_frame(bst, torch.as_tensor(imgs[0]), tc)
    bposes, bfused = [out.pose.numpy()], [out.fused.numpy()]
    for k in range(1, N_FRAMES):
        bst, out = todo.batched_odometry_step(bst, torch.as_tensor(imgs[k]),
                                              tc)
        bposes.append(out.pose.numpy())
        bfused.append(out.fused.numpy())
    bposes = np.stack(bposes, 1)  # [2, N, 3]
    for b in range(2):
        np.testing.assert_allclose(bposes[b], singles[b], rtol=0, atol=1e-5)
    # the reference's vmapped step
    jst = jodo.init_batched_state(jc, 2)
    jst, _ = jodo.batched_first_frame(jst, jnp.asarray(imgs[0]), jc)
    jposes, jfused = [np.zeros((2, 3))], [np.ones(2, bool)]
    for k in range(1, N_FRAMES):
        jst, jout = jodo.batched_odometry_step(jst, jnp.asarray(imgs[k]), jc)
        jposes.append(np.asarray(jout.pose))
        jfused.append(np.asarray(jout.fused))
    jposes = np.stack(jposes, 1)
    np.testing.assert_array_equal(np.stack(bfused), np.stack(jfused))
    for b in range(2):
        _assert_trajectory(bposes[b], jposes[b])
