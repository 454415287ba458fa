"""Port parity: window registration, covariance and cost evaluation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig,
                                             RegistrationConfig)
from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.ops import features as jfeat
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.ops import registration as treg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")
TGT_POSES = np.asarray([[0.7 * i, 0.0, 0.01 * i] for i in range(4)],
                       np.float32)
POSE0 = np.asarray([2.9, 0.1, 0.03], np.float32)
# LM accept tests (cand < cur) flip on last-bit differences between the two
# float32 programs, so poses agree to solver tolerance, not bit for bit
POS_TOL, YAW_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def cells():
    seq = simulate.make_sequence(
        num_frames=5, seed=1, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7, laps=0.12))
    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    jc = [jfeat.compute_cells(jradar.kstrongest_filter(jnp.asarray(im),
                                                       rc)[0], fc)
          for im in seq.images]
    src = jc[4]
    tgt = jax.tree.map(lambda *x: jnp.stack(x), *jc[:4])
    to_t = lambda c: cells_from_numpy(
        {f: np.array(getattr(c, f)) for f in CELL_FIELDS})
    return src, tgt, to_t(src).map(lambda x: x[None]), \
        to_t(tgt).map(lambda x: x[None])


def _window(cells):
    _, _, ts, tt = cells
    return ts, tt, torch.as_tensor(TGT_POSES)[None], torch.ones(
        1, 4, dtype=torch.bool)


@pytest.mark.parametrize("loss", ["none", "huber", "cauchy", "softlone",
                                  "tukey", "combined"])
def test_rho_and_weight(rng, loss):
    s = rng.uniform(0, 3, 500).astype(np.float32) ** 2
    code = jreg.loss_code(loss)
    for g, w in zip(treg._rho_and_weight(torch.as_tensor(s), code, 0.3),
                    jreg._rho_and_weight(jnp.asarray(s), code, 0.3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-7)


def test_associate(cells):
    src, tgt, ts, tt = cells
    pose = jnp.asarray(POSE0)
    tmw = jax.vmap(jse2.apply)(jnp.asarray(TGT_POSES), tgt.mean)
    tnw = jax.vmap(jse2.rotate)(jnp.asarray(TGT_POSES), tgt.normal)
    want = jreg.associate(src, pose, tmw, tnw, tgt.cov, tgt.nsamples,
                          tgt.planarity, tgt.valid, 2.0, weight_option=4,
                          cost=jreg.COST_P2L, regularization=0.01,
                          cov_scale=1.0, angle_gate_cos=np.cos(np.pi / 6))
    make = treg._associator(ts, tt, torch.as_tensor(TGT_POSES)[None],
                            torch.ones(1, 4, dtype=torch.bool),
                            RegistrationConfig(weight_option=4))
    got = make(torch.as_tensor(POSE0)[None], 2.0)
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))
    assert int(got.mask.sum()) > 100
    np.testing.assert_allclose(got.weight[0].numpy(), np.asarray(want.weight),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.tgt_mean_w[0].numpy(),
                               np.asarray(want.tgt_mean_w), atol=1e-5)


@pytest.mark.parametrize("cost,loss", [("P2P", "huber"), ("P2L", "huber"),
                                       ("P2P", "cauchy"),
                                       ("P2L", "combined")])
def test_register_window(cells, cost, loss):
    src, tgt, *_ = cells
    ts, tt, tposes, tmask = _window(cells)
    cfg = RegistrationConfig(cost=cost, loss=loss, weight_option=4)
    want = jreg.register_window(src, jnp.asarray(POSE0), tgt,
                                jnp.asarray(TGT_POSES), jnp.ones(4, bool),
                                cfg)
    got = treg.register_window(ts, torch.as_tensor(POSE0)[None], tt, tposes,
                               tmask, cfg)
    p, q = got.pose[0].numpy(), np.asarray(want.pose)
    assert np.abs(p[:2] - q[:2]).max() < POS_TOL, (p, q)
    assert abs(p[2] - q[2]) < YAW_TOL, (p, q)
    np.testing.assert_allclose(float(got.score[0]), float(want.score),
                               rtol=1e-4)
    assert int(got.num_residuals[0]) == int(want.num_residuals)
    assert int(got.iterations[0]) == int(want.iterations)
    assert bool(got.success[0]) and bool(want.success)


@pytest.mark.parametrize("cost", ["P2P", "P2L"])
def test_sampled_covariance_and_evaluate_cost(cells, cost):
    """Both at the reference's optimum, so only the covariance math and the
    cost evaluation are compared."""
    src, tgt, *_ = cells
    ts, tt, tposes, tmask = _window(cells)
    cfg = RegistrationConfig(cost=cost, weight_option=4)
    res = jreg.register_window(src, jnp.asarray(POSE0), tgt,
                               jnp.asarray(TGT_POSES), jnp.ones(4, bool), cfg)
    cj, okj = jreg.sampled_covariance(src, res.pose, tgt,
                                      jnp.asarray(TGT_POSES),
                                      jnp.ones(4, bool), cfg, res.score,
                                      res.num_residuals)
    ct, okt = treg.sampled_covariance(
        ts, torch.as_tensor(np.asarray(res.pose))[None], tt, tposes, tmask,
        cfg, torch.as_tensor(np.asarray(res.score))[None],
        torch.as_tensor(np.asarray(res.num_residuals)).long()[None])
    assert bool(okt[0]) == bool(okj)
    cj = np.asarray(cj)
    # quadratic fit of float32 costs: relative to the covariance's scale
    np.testing.assert_allclose(ct[0].numpy(), cj, rtol=0,
                               atol=1e-3 * np.abs(cj).max())
    ej, nj = jreg.evaluate_cost(src, jnp.asarray(POSE0), tgt,
                                jnp.asarray(TGT_POSES), jnp.ones(4, bool),
                                cfg)
    et, nt = treg.evaluate_cost(ts, torch.as_tensor(POSE0)[None], tt, tposes,
                                tmask, cfg)
    np.testing.assert_allclose(float(et[0]), float(ej), rtol=1e-5)
    assert int(nt[0]) == int(nj)


def test_batched_rows_equal_single_rows(cells):
    """The pair axis is a plain batch: each row equals its own solve."""
    _, _, ts, tt = cells
    cfg = RegistrationConfig(cost="P2L", max_outer_iterations=4,
                             min_outer_iterations=1, max_inner_iterations=10)
    poses = torch.as_tensor(np.stack([POSE0, POSE0 + [0.3, -0.2, 0.02]]),
                            dtype=torch.float32)
    two = lambda c: c.map(lambda x: torch.cat([x, x]))
    tposes = torch.as_tensor(TGT_POSES)[None].expand(2, -1, -1)
    tmask = torch.ones(2, 4, dtype=torch.bool)
    batch = treg.register_window(two(ts), poses, two(tt), tposes, tmask, cfg)
    for i in range(2):
        one = treg.register_window(ts, poses[i:i + 1], tt, tposes[:1],
                                   tmask[:1], cfg)
        torch.testing.assert_close(batch.pose[i], one.pose[0], rtol=0,
                                   atol=1e-5)
