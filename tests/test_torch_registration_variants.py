"""Port parity: P2D, time-continuous and joint registration and the
Ceres-style covariance, on the inputs of ``tests/test_registration.py``.

Tolerances: poses within 1e-4 m and 1e-5 rad (LM accept tests flip on
last-bit differences between the two float32 programs); velocity-corrected
cells within 5e-5; P2D sqrt-information within rtol 1e-5; the Ceres
covariance within rtol 1e-3 (an inverse of a float32 Hessian summed in
another order) with ``ok`` equal.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.core.config import RegistrationConfig
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.ops import registration as treg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_registration import scan_cells, stack_targets  # noqa: E402

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

POS_TOL, YAW_TOL = 1e-4, 1e-5
CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")


def _t(cells, lead=1):
    """A reference Cells record as the port's, with ``lead`` batch axes."""
    c = cells_from_numpy({f: np.array(getattr(cells, f))
                          for f in CELL_FIELDS})
    return c.map(lambda x: x[(None,) * lead]) if lead else c


def _assert_pose(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got[..., :2] - want[..., :2]).max() < POS_TOL, (got, want)
    assert np.abs(got[..., 2] - want[..., 2]).max() < YAW_TOL, (got, want)


@pytest.fixture(scope="module")
def pair():
    """test_pairwise_recovery's scene: two noisy views of one world."""
    rng = np.random.default_rng(1)
    world = simulate.make_world(rng, num_walls=50, extent=60.0)
    a = scan_cells(world, np.zeros(3), np.random.default_rng(2))
    b = scan_cells(world, np.array([1.2, 0.6, 0.05]),
                   np.random.default_rng(3))
    return a, b


def _window(a):
    return (stack_targets([a]), jnp.zeros((1, 3), jnp.float32),
            jnp.ones(1, bool), _t(a, 2), torch.zeros(1, 1, 3),
            torch.ones(1, 1, dtype=torch.bool))


def test_p2d_registration_matches(pair):
    a, b = pair
    jt, jp, jm, tt, tp, tm = _window(a)
    cfg = RegistrationConfig(cost="P2D", weight_option=4)
    want = jreg.register_window(b, jnp.zeros(3, jnp.float32), jt, jp, jm,
                                cfg)
    got = treg.register_window(_t(b), torch.zeros(1, 3), tt, tp, tm, cfg)
    _assert_pose(got.pose[0], want.pose)
    np.testing.assert_allclose(float(got.score[0]), float(want.score),
                               rtol=1e-4)
    assert int(got.num_residuals[0]) == int(want.num_residuals)
    assert bool(got.success[0]) and bool(want.success)


def test_p2d_sqrtinfo_matches(pair):
    """P2D associations at one pose: same mask, whitening within rtol 1e-5,
    and the cost of the whitened residuals."""
    a, b = pair
    cfg = RegistrationConfig(cost="P2D", weight_option=4,
                             regularization=0.05, cov_scale=2.0)
    pose = np.asarray([1.1, 0.5, 0.04], np.float32)
    tgt_pose = np.asarray([[0.2, -0.1, 0.03]], np.float32)
    rot = jse2.rotmat(jnp.asarray(tgt_pose[:, 2]))
    want = jreg.associate(
        b, jnp.asarray(pose), jax.vmap(jse2.apply)(tgt_pose, a.mean[None]),
        jax.vmap(jse2.rotate)(tgt_pose, a.normal[None]),
        jnp.einsum("tab,tcbd,ted->tcae", rot, a.cov[None], rot),
        a.nsamples[None], a.planarity[None], a.valid[None], 2.0,
        weight_option=4, cost=jreg.COST_P2D, regularization=0.05,
        cov_scale=2.0, angle_gate_cos=np.cos(np.radians(30.0)))
    got = treg._associator(_t(b), _t(a, 2), torch.as_tensor(tgt_pose)[None],
                           torch.ones(1, 1, dtype=torch.bool), cfg)(
        torch.as_tensor(pose)[None], 2.0)
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask[0].numpy(), m)
    assert m.sum() > 50
    np.testing.assert_allclose(got.tgt_sqrtinfo[0].numpy()[m],
                               np.asarray(want.tgt_sqrtinfo)[m], rtol=1e-5,
                               atol=0)
    for name in ("P2D", "P2P", "P2L"):
        code = jreg.cost_code(name)
        jc = jreg._cost_only(jnp.asarray(pose), b, want, cost=code,
                             loss=jreg.LOSS_HUBER, delta=0.1)
        tc = treg._cost_only(torch.as_tensor(pose)[None], _t(b), got,
                             cost=code, loss=treg.LOSS_HUBER, delta=0.1)
        np.testing.assert_allclose(float(tc[0]), float(jc), rtol=1e-5)


VEL = np.asarray([0.9, -0.25, 0.04], np.float32)


@pytest.mark.parametrize("ccw", [False, True])
def test_motion_correct_cells_matches(pair, ccw):
    _, b = pair
    want = jreg.motion_correct_cells(b, jnp.asarray(VEL), ccw)
    got = treg.motion_correct_cells(_t(b), torch.as_tensor(VEL)[None], ccw)
    v = np.asarray(b.valid)
    for f in ("mean", "normal"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy()[v],
                                   np.asarray(getattr(want, f))[v],
                                   rtol=0, atol=5e-5)
    np.testing.assert_allclose(
        treg.cell_rel_timestamps(_t(b).mean, ccw)[0].numpy()[v],
        np.asarray(jreg.cell_rel_timestamps(b.mean, ccw))[v], atol=1e-6)


@pytest.mark.parametrize("cost", ["P2L", "P2D"])
def test_time_continuous_registration_matches(pair, cost):
    """The JAX suite has no time-continuous test: the same scene, with a
    nonzero per-sweep velocity; ``cost`` is overridden to P2P inside."""
    a, b = pair
    jt, jp, jm, tt, tp, tm = _window(a)
    cfg = RegistrationConfig(cost=cost, weight_option=4)
    want = jreg.register_time_continuous(
        b, jnp.zeros(3, jnp.float32), jt, jp, jm, cfg, jnp.asarray(VEL))
    got = treg.register_time_continuous(
        _t(b), torch.zeros(1, 3), tt, tp, tm, cfg,
        torch.as_tensor(VEL)[None])
    _assert_pose(got.pose[0], want.pose)
    assert int(got.num_residuals[0]) == int(want.num_residuals)
    assert int(got.iterations[0]) == int(want.iterations)


@pytest.fixture(scope="module")
def joint_window():
    """test_register_joint_many_to_many's window."""
    rng = np.random.default_rng(1)
    world = simulate.make_world(rng, num_walls=40, extent=60.0)
    true_poses = np.asarray([[0.0, 0.0, 0.0], [2.0, 0.3, 0.05],
                             [4.0, 0.8, 0.1]], np.float32)
    cells = [scan_cells(world, p, np.random.default_rng(10 + i))
             for i, p in enumerate(true_poses)]
    init = true_poses.copy()
    init[1] += [0.5, -0.3, 0.03]
    init[2] += [-0.4, 0.4, -0.04]
    return jax.tree.map(lambda *x: jnp.stack(x), *cells), init


@pytest.mark.parametrize("fixed,mask", [
    ((False, False, False), (True, True, True)),
    ((False, True, False), (True, True, True)),
    ((False, False, False), (False, True, True))])
def test_register_joint_matches(joint_window, fixed, mask):
    """Gauge rule: no fixed scan -> the first valid one is held; a fixed
    scan holds itself; an invalid scan is neither moved nor a target."""
    scans, init = joint_window
    cfg = RegistrationConfig(cost="P2L", weight_option=4)
    fixed, mask = np.asarray(fixed), np.asarray(mask)
    want = jreg.register_joint(scans, jnp.asarray(init), jnp.asarray(mask),
                               jnp.asarray(fixed), cfg)
    got = treg.register_joint(_t(scans, 0), torch.as_tensor(init),
                              torch.as_tensor(mask), torch.as_tensor(fixed),
                              cfg)
    _assert_pose(got.pose, want.pose)
    held = ~mask | fixed if fixed.any() else \
        ~mask | (np.arange(3) == np.argmax(mask))
    np.testing.assert_array_equal(got.pose.numpy()[held], init[held])
    np.testing.assert_allclose(float(got.score), float(want.score),
                               rtol=1e-4)
    assert int(got.num_residuals) == int(want.num_residuals)
    assert bool(got.success) == bool(want.success)


@pytest.fixture(scope="module")
def ceres_scene():
    """test_ceres_covariance_output's scene, registered by the reference."""
    rng = np.random.default_rng(2)
    world = simulate.make_world(rng, num_walls=40, extent=60.0)
    src = scan_cells(world, np.array([1.0, 0.2, 0.02]),
                     np.random.default_rng(4))
    tgt = scan_cells(world, np.zeros(3), np.random.default_rng(5))
    return src, tgt


@pytest.mark.parametrize("cost", ["P2L", "P2P", "P2D"])
def test_ceres_covariance_matches(ceres_scene, cost):
    """At the reference's own optimum, so only the covariance is compared."""
    src, tgt = ceres_scene
    jt, jp, jm, tt, tp, tm = _window(tgt)
    cfg = RegistrationConfig(cost=cost, weight_option=4)
    res = jreg.register_window(src, jnp.zeros(3, jnp.float32), jt, jp, jm,
                               cfg)
    want, ok_w = jreg.ceres_covariance(src, res.pose, jt, jp, jm, cfg,
                                       res.score, res.num_residuals)
    got, ok_g = treg.ceres_covariance(
        _t(src), torch.as_tensor(np.array(res.pose))[None], tt, tp, tm,
        cfg, torch.as_tensor(np.array(res.score))[None],
        torch.as_tensor(np.array(res.num_residuals)).long()[None])
    assert bool(ok_g[0]) == bool(ok_w) and bool(ok_w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-3,
                               atol=0)


def test_ceres_covariance_falls_back(ceres_scene):
    """Too few residuals for the scaling (denominator <= 0): ok is False and
    the covariance is the default diagonal, as in the reference."""
    src, tgt = ceres_scene
    jt, jp, jm, tt, tp, tm = _window(tgt)
    cfg = RegistrationConfig(cost="P2L", weight_option=4)
    pose = np.asarray([1.0, 0.2, 0.02], np.float32)
    want, ok_w = jreg.ceres_covariance(src, jnp.asarray(pose), jt, jp, jm,
                                       cfg, jnp.asarray(1.5), jnp.asarray(2))
    got, ok_g = treg.ceres_covariance(
        _t(src), torch.as_tensor(pose)[None], tt, tp, tm, cfg,
        torch.tensor([1.5]), torch.tensor([2]))
    assert not bool(ok_w) and not bool(ok_g[0])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got[0].numpy(), np.diag(np.float32([0.1 ** 2, 0.1 ** 2, 0.01 ** 2])))
