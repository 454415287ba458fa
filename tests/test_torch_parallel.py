"""Parity of the port's ``parallel/`` with the JAX package's: one process
(a mesh of size 1) against the JAX single-device functions, two gloo ranks
(``torchrun``, see ``tests/test_torch_parallel_ranks.py``) against the JAX
functions and the JAX mesh-sharded ones on a 2-device sub-mesh of the
8-device CPU mesh, the multihost helpers, ``PoseGraph(mesh)`` and the
``sweep`` subcommand.  Inputs are made from seeds with numpy and the
reference's own filter and features; tolerances are those of the JAX
package's own tests (``tests/test_parallel.py``)."""
import collections
import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import __graft_entry__ as jentry
import test_torch_odometry_variants as odo_variants
import test_torch_parallel_ranks as ranks_mod
from test_posegraph import _build_edges, _simulated_loop_graph
from test_torch_parallel_ranks import (COV_ATOL, COV_RTOL, DIST_ATOL, DRYRUN,
                                       DRYRUN_SIZES, ODO,
                                       PAIR_ATOL, TINY, run_ranks)
from tbv_slam_public_tpu.core import config as jconfig
from tbv_slam_public_tpu.core.types import ODOMETRY
from tbv_slam_public_tpu.core.types import Cells as JCells
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.harness import sweep as jsweep
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import loopclosure as jlc
from tbv_slam_public_tpu.models import odometry as jodo
from tbv_slam_public_tpu.ops import features as jfeatures
from tbv_slam_public_tpu.ops import logistic as jlogistic
from tbv_slam_public_tpu.ops import posegraph as jpg
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_tpu.ops import scancontext as jsc
from tbv_slam_public_tpu.parallel import candidates as jpar_cand
from tbv_slam_public_tpu.parallel import multihost as jmultihost
from tbv_slam_public_tpu.parallel import pgo as jpgo
from tbv_slam_public_tpu.parallel import retrieval as jpar_ret
from tbv_slam_public_torch.core.types import GraphEdges
from tbv_slam_public_torch.harness import cli, dryrun, sweep
from tbv_slam_public_torch.models import loopclosure as tlc
from tbv_slam_public_torch.ops import logistic as tlogistic
from tbv_slam_public_torch.models import slam as tslam
from tbv_slam_public_torch.parallel import candidates as tpar_cand
from tbv_slam_public_torch.parallel import multihost
from tbv_slam_public_torch.parallel import pgo as tpar_pgo
from tbv_slam_public_torch.parallel import retrieval as tpar_ret

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

PGO_XY_ATOL = 0.05  # distributed PGO against another solve of the graph
# the dry run's pair wave registers uniform random clouds, whose cost is
# nearly flat: its t_be ends 1.49e-4 from the reference's with torch's own
# row sums, the pairwise tree of ops/registration.py::_row_sums and an
# emulation of the reference's windowed sum alike (measured on the CPU)
DRYRUN_T_BE_ATOL = 2e-4

# The pair waves held to the reference use scans of ~345 peaks (the
# configuration of tests/test_torch_verification.py).  On the tiny
# configuration's ~75-peak scans the CorAl entropies sit on the determinant
# gate and differ between the packages by up to 10 % (ROADMAP.md, section
# 3), which moves a mid-range probability by ~1e-3; here the probability
# agrees to the JAX tests' 1e-4.
DENSE = ["radar.num_azimuths=200", "radar.num_range_bins=256",
         "radar.range_res=0.3", "radar.k_strongest=12",
         "radar.min_distance=1.0", "radar.max_distance=70.0",
         "features.resolution=3.0", "features.cell_capacity=256",
         "features.grid_extent=80.0", "verification.peaks_capacity=1024"]


def jax_config(overrides):
    return jconfig.apply_overrides(
        jconfig.TBVConfig(), jconfig.parse_cli_overrides(list(overrides)))


def _jscans(cfg, poses, world, rng):
    """(peaks, cells) [len(poses), ...] by the reference's filter and
    features, as numpy records."""
    out = []
    for p in poses:
        img = simulate.render_scan(
            world, np.asarray(p), num_azimuths=cfg.radar.num_azimuths,
            num_range_bins=cfg.radar.num_range_bins,
            range_res=cfg.radar.range_res, rng=rng)
        cloud, peaks = jradar.kstrongest_filter(jnp.asarray(img), cfg.radar)
        out.append((peaks, jfeatures.compute_cells(cloud, cfg.features)))
    return jax.tree.map(lambda *x: np.stack(x), *[o[0] for o in out]), \
        jax.tree.map(lambda *x: np.stack(x), *[o[1] for o in out])


def _jmodels(cfg):
    v = cfg.verification
    return (jlogistic.from_values(v.alignment_coefs[0], v.alignment_coefs[1:]),
            jlogistic.from_values(v.loop_coefs[0], v.loop_coefs[1:]))


def _pair_wave(d, cfg, m=6):
    """A wave of ``m`` pairs along a simulated street, each candidate 0.3 m
    and 0.1 m off its query; the last pair masked.  Made by the reference's
    filter and features."""
    rng = np.random.default_rng(2)
    world = simulate.make_world(rng, num_walls=40, extent=40.0)
    qpose = [np.array([0.4 * i, 0.1 * i, 0.01 * i]) for i in range(m)]
    q_peaks, q_cells = _jscans(cfg, qpose, world, rng)
    c_peaks, c_cells = _jscans(cfg, [p + np.array([0.3, 0.1, 0.0])
                                     for p in qpose], world, rng)
    for name, rec in (("q_cells", q_cells), ("q_peaks", q_peaks),
                      ("c_cells", c_cells), ("c_peaks", c_peaks)):
        ranks_mod.put(d, f"pairs/{name}", rec)
    d["pairs/taug"] = np.zeros((m, 3), np.float32)
    d["pairs/yaw"] = np.zeros(m, np.float32)
    d["pairs/sc_sim"] = np.full(m, 0.2, np.float32)
    d["pairs/odom_bounds"] = np.full(m, 0.1, np.float32)
    d["pairs/valid"] = np.arange(m) != m - 1


def _jrec(d, key, cls):
    """The JAX record ``cls`` of ``d``'s ``key.<field>`` arrays."""
    return cls(**{f.name: jnp.asarray(d[f"{key}.{f.name}"])
                  for f in dataclasses.fields(cls)})


def _jwave(d, cfg):
    """The reference's register_and_verify_pairs of ``pairs/``."""
    rec = lambda key, cls: _jrec(d, f"pairs/{key}", cls)
    res = jlc.register_and_verify_pairs(
        rec("q_cells", JCells), rec("q_peaks", JPointCloud),
        rec("c_cells", JCells), rec("c_peaks", JPointCloud),
        *(jnp.asarray(d[f"pairs/{n}"]) for n in
          ("taug", "yaw", "sc_sim", "odom_bounds", "valid")),
        *_jmodels(cfg), cfg)
    return jax.tree.map(np.asarray, res)


def _training_pairs(d, cfg, key="train", walls=(10, 20, 30, 40)):
    """``<key>/``: one scan pair in each of ``len(walls)`` simulated
    streets, the i-th of ``walls[i]`` walls (``None``: every pair in one
    40-wall street), each current scan 1 m, 0.3 m and 0.05 rad on from its
    previous one (the pairs of tests/test_parallel.py's training step), by
    the reference's filter and features.  Streets of different densities
    give pairs of different sizes, as a training set has."""
    rng = np.random.default_rng(1)
    b = 4 if walls is None else len(walls)
    base = [np.array([3.0 * i, 1.0 * i, 0.1 * i]) for i in range(b)]
    step = np.array([1.0, 0.3, 0.05])
    if walls is None:
        world = simulate.make_world(rng, num_walls=40, extent=40.0)
        scans = [_jscans(cfg, [p + step for p in base], world, rng),
                 _jscans(cfg, base, world, rng)]
    else:
        pairs = []
        for w, p in zip(walls, base):
            world = simulate.make_world(rng, num_walls=w, extent=40.0)
            pairs.append([_jscans(cfg, [q], world, rng) for q in (p + step, p)])
        scans = [jax.tree.map(lambda *x: np.concatenate(x),
                              *[pr[k] for pr in pairs]) for k in (0, 1)]
    for name, (peaks, cells) in zip(("cur", "prev"), scans):
        ranks_mod.put(d, f"{key}/{name}_peaks", peaks)
        ranks_mod.put(d, f"{key}/{name}_cells", cells)
    d[f"{key}/cur_poses"] = np.tile(step.astype(np.float32), (b, 1))
    d[f"{key}/prev_poses"] = np.zeros((b, 3), np.float32)


def _detect_inputs(d, cfg):
    """A 96-slot database of random descriptors along 1.5 laps, and two
    queries: noisy augmentation stacks of slots 3 and 40."""
    rng = np.random.default_rng(1)
    sc = cfg.scancontext
    cap = 96
    desc = rng.uniform(0, 2, (cap, sc.num_ring, sc.num_sector)).astype(
        np.float32)
    d["detect/desc"] = desc
    d["detect/ring"] = desc.mean(-1)
    d["detect/odom"] = simulate.loop_trajectory(
        cap, radius=14.0, step=2.0, laps=1.5).astype(np.float32)
    a = 1 + (len(sc.augment_offsets) if sc.augment_sc else 0)
    descs = np.stack([np.stack([desc[s] + np.float32(0.02 * k)
                                for k in range(a)]) for s in (3, 40)])
    d["detect/descs"] = descs
    d["detect/rings"] = descs.mean(-1)
    d["detect/cur"] = np.asarray([cap - 1, 70])


def _loop_graph():
    cfg = jconfig.PGOConfig()
    gt, poses, rels = _simulated_loop_graph(np.random.default_rng(0))
    n = len(poses)
    edges = _build_edges(rels, gt, n, cfg, loop_pairs=[(0, n - 1),
                                                       (3, n - 4)])
    return gt, poses.astype(np.float32), edges


def _pgo_inputs(d, edges, poses, max_iterations):
    """``pgo/`` from JAX edges, with the masked capacity slots dropped:
    an odd edge count (41), which the ranks pad."""
    m = np.asarray(edges.mask)
    for name in ("idx", "meas", "sqrt_info", "etype"):
        d[f"pgo/{name}"] = np.asarray(getattr(edges, name))[m]
    d["pgo/idx"] = d["pgo/idx"].astype(np.int64)
    d["pgo/etype"] = d["pgo/etype"].astype(np.int64)
    d["pgo/mask"] = m[m]
    d["pgo/poses"] = poses
    d["pgo/node_mask"] = np.ones(len(poses), bool)
    d["pgo/max_iterations"] = np.asarray(max_iterations)


def _tedges(d):
    t = lambda n: torch.as_tensor(d[f"pgo/{n}"])
    return GraphEdges(idx=t("idx"), meas=t("meas"), sqrt_info=t("sqrt_info"),
                      etype=t("etype"), mask=t("mask"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX-made inputs and the port's two-rank outputs: the pair wave, the
    retrieval case, sharded detection, the loop graph's distributed PGO
    at every preconditioner (64 LM iterations), the training step on 4
    scan pairs of four streets and on 4 pairs of one street, and batched odometry of two 14-frame sequences, one a
    rank."""
    cfg = jax_config(TINY)
    d = {}
    _pair_wave(d, jax_config(DENSE))
    _training_pairs(d, jax_config(DENSE))
    _training_pairs(d, jax_config(DENSE), "street", None)
    ranks_mod.retrieval_inputs(d, cfg, np.random.default_rng(0), 96)
    _detect_inputs(d, cfg)
    _, poses, edges = _loop_graph()
    _pgo_inputs(d, edges, poses, jconfig.PGOConfig().max_iterations)
    for key in ("ret", "detect", "pgo"):
        d[f"{key}/cfg"] = np.asarray(TINY)
    d["pairs/cfg"] = d["train/cfg"] = d["street/cfg"] = np.asarray(DENSE)
    d["odo/images"] = _odometry_images()
    d["odo/cfg"] = np.asarray(ODO)
    return d, run_ranks(d, tmp_path_factory.mktemp("jax_ranks"))


def _odometry_images():
    """[N, 2, A, R]: tests/test_torch_odometry_variants.py's two simulated
    sequences (200 x 256 bins, 14 frames), one a row."""
    return np.stack([s.images for s in odo_variants._sequences()], 1)


def test_two_ranks_sharded_odometry_matches_jax(two_ranks):
    """Batched odometry at B = 2, one sequence a rank: the gathered poses
    and keyframe flags equal on both ranks, bit-equal to the port's own
    B = 1 run of each sequence in one process (a rank runs exactly that),
    within 1e-5 of the port's B = 2 batch in one process
    (tests/test_torch_odometry_variants.py's bound), and within 1 mm mean /
    2 mm max of the reference's vmapped ``batched_odometry_step``."""
    d, outs = two_ranks
    imgs = d["odo/images"]
    n = imgs.shape[0]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["odo.poses"], outs[0]["odo.poses"])
    got, got_fused = outs[0]["odo.poses"], outs[0]["odo.fused"]
    assert got.shape == (n, 2, 3)
    tcfg = ranks_mod.config(ODO)
    mesh = multihost.make_mesh("cpu")
    for b in range(2):
        one, _ = ranks_mod.sharded_odometry(
            mesh, torch.as_tensor(imgs[:, b:b + 1]), tcfg)
        np.testing.assert_array_equal(got[:, b], one[:, 0])
    both, both_fused = ranks_mod.sharded_odometry(mesh, torch.as_tensor(imgs),
                                                  tcfg)
    np.testing.assert_array_equal(got_fused, both_fused)
    np.testing.assert_allclose(got, both, rtol=0, atol=1e-5)
    jc = jax_config(ODO)
    jst = jodo.init_batched_state(jc, 2)
    jst, _ = jodo.batched_first_frame(jst, jnp.asarray(imgs[0]), jc)
    want, want_fused = [np.zeros((2, 3))], [np.ones(2, bool)]
    for k in range(1, n):
        jst, jout = jodo.batched_odometry_step(jst, jnp.asarray(imgs[k]), jc)
        want.append(np.asarray(jout.pose))
        want_fused.append(np.asarray(jout.fused))
    np.testing.assert_array_equal(got_fused, np.stack(want_fused))
    want = np.stack(want)
    assert got_fused[1:].any()
    for b in range(2):
        odo_variants._assert_trajectory(got[:, b], want[:, b])


def test_two_ranks_pair_wave_matches_jax(two_ranks):
    d, outs = two_ranks
    want = _jwave(d, jax_config(DENSE))
    for out in outs:
        np.testing.assert_allclose(out["pairs.t_be"], want.t_be,
                                   atol=PAIR_ATOL)
        np.testing.assert_allclose(out["pairs.prob"], want.prob,
                                   atol=PAIR_ATOL)
        np.testing.assert_allclose(out["pairs.cov"], want.cov, rtol=COV_RTOL,
                                   atol=COV_ATOL)
        np.testing.assert_array_equal(out["pairs.valid"], want.valid)


def test_two_ranks_retrieve_matches_jax(two_ranks):
    d, outs = two_ranks
    sc = jax_config(TINY).scancontext
    for q in range(d["ret/qdesc"].shape[0]):
        want = jsc.retrieve(
            jnp.asarray(d["ret/qdesc"][q]), jnp.asarray(d["ret/qkey"][q]),
            jnp.asarray(d["ret/desc"]), jnp.asarray(d["ret/ring"]),
            jnp.asarray(d["ret/mask"]), jnp.asarray(d["ret/osim"][q]),
            num_candidates=sc.num_candidates_from_tree,
            search_ratio=sc.search_ratio, odometry_coupled=True)
        for out in outs:
            for f in ("index", "shift", "valid"):
                np.testing.assert_array_equal(out[f"ret.{f}"][q],
                                              np.asarray(getattr(want, f)))
            for f in ("dist", "dist_sc"):
                np.testing.assert_allclose(out[f"ret.{f}"][q],
                                           np.asarray(getattr(want, f)),
                                           atol=DIST_ATOL)


def test_two_ranks_detect_matches_jax(two_ranks):
    """detect over a database sharded on two ranks against the reference's
    single-device detect."""
    d, outs = two_ranks
    cfg = jax_config(TINY)
    db = jlc.make_db(d["detect/odom"].shape[0], cfg)
    for i in range(d["detect/odom"].shape[0]):
        db = jlc.db_insert(db, jnp.asarray(i),
                           jnp.asarray(d["detect/desc"][i]),
                           jnp.asarray(d["detect/ring"][i]),
                           jnp.asarray(d["detect/odom"][i]))
    for b, cur in enumerate(d["detect/cur"]):
        want = jlc.detect(db, jnp.asarray(d["detect/descs"][b]),
                          jnp.asarray(d["detect/rings"][b]),
                          jnp.asarray(cur), cfg)
        for out in outs:
            for f in ("index", "valid", "aug"):
                np.testing.assert_array_equal(out[f"detect.{f}"][b],
                                              np.asarray(getattr(want, f)))
            for f in ("dist", "yaw"):
                np.testing.assert_allclose(out[f"detect.{f}"][b],
                                           np.asarray(getattr(want, f)),
                                           atol=DIST_ATOL)


@pytest.mark.parametrize("pc", ["chain", "chain_sharded", "jacobi"])
def test_two_ranks_distributed_pgo_matches_jax(two_ranks, pc):
    """Two ranks against the reference's optimize_distributed on a 2-device
    sub-mesh and its cg solver: xy within 5 cm, the drift halved."""
    d, outs = two_ranks
    gt, poses, edges = _loop_graph()
    n = len(poses)
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("graph",))
    cfg = jconfig.PGOConfig()
    want = jpgo.optimize_distributed(mesh, jnp.asarray(poses),
                                     jnp.ones((n,), bool), edges, cfg,
                                     preconditioner=pc)
    cg = jpg.optimize(jnp.asarray(poses), jnp.ones((n,), bool), edges, cfg,
                      solver="cg")
    got = outs[0][f"pgo.{pc}.poses"]
    np.testing.assert_array_equal(got, outs[1][f"pgo.{pc}.poses"])
    np.testing.assert_allclose(got[:, :2], np.asarray(want.poses)[:, :2],
                               atol=PGO_XY_ATOL)
    np.testing.assert_allclose(got[:, :2], np.asarray(cg.poses)[:, :2],
                               atol=PGO_XY_ATOL)
    err0 = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1).mean()
    err1 = np.linalg.norm(got[:, :2] - gt[:, :2], axis=1).mean()
    assert err1 < 0.5 * err0


def _jax_training_step(d, key):
    """The reference's training step on a 2-device sub-mesh: (model, x, y)."""
    rec = lambda name, cls: _jrec(d, f"{key}/{name}", cls)
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("dp",))
    return jax.tree.map(np.asarray, jpar_cand.alignment_training_step(
        mesh, rec("cur_peaks", JPointCloud), rec("cur_cells", JCells),
        jnp.asarray(d[f"{key}/cur_poses"]), rec("prev_peaks", JPointCloud),
        rec("prev_cells", JCells), jnp.asarray(d[f"{key}/prev_poses"]),
        jax_config(DENSE)))


def _assert_training_x(d, key, out, x, y, max_flips, coral_atol=None):
    """The ranks' x and y against the reference step's (see
    test_two_ranks_alignment_training_step_matches_jax)."""
    merged = np.repeat(d[f"{key}/cur_peaks.mask"].sum(1)
                       + d[f"{key}/prev_peaks.mask"].sum(1), 13)
    n_valid = np.rint(x[:, 2] * merged)
    xt = out[f"{key}.x"]
    assert xt.shape == x.shape == (len(merged), 6)
    np.testing.assert_array_equal(out[f"{key}.y"], y)
    np.testing.assert_allclose(xt[:, 3:], x[:, 3:], rtol=1e-5)
    flips = np.abs(np.rint(xt[:, 2] * merged) - n_valid)
    assert np.all(flips <= max_flips), flips
    # a row with no overlap in the reference has the same CorAl columns
    bound = np.where(n_valid > 0, 10.0 * (1 + flips)
                     / np.maximum(n_valid, 1), 0.0)
    assert np.all(np.abs(xt[:, :2] - x[:, :2]) <= bound[:, None])
    if coral_atol is not None:
        np.testing.assert_allclose(xt[:, :2], x[:, :2], rtol=0,
                                   atol=coral_atol)


def test_two_ranks_alignment_training_step_matches_jax(two_ranks):
    """The data-parallel training step on two ranks against the reference's
    on a 2-device sub-mesh, the same 4 scan pairs (one in each of four
    streets of 10-40 walls) split 2 + 2.

    y is equal and the CFEAR columns agree to float32 rounding (each pair has
    its own cost and size, so they also hold the gather's row order).  The
    CorAl columns are means over the points that pass the determinant gate.
    k-strongest peaks lie on azimuth rays, so many points have three
    collinear neighbours: their covariance determinant is rounding noise
    (~1e-10 against eps 1e-8).  The port rounds the moments and the
    determinant as the reference does, and since the world-frame clouds
    take the reference's cos and sin and its fused products, and the
    entropies its log, no point is dropped in one package and kept in the
    other: the overlap counts are equal (measured; on the one-street pairs
    1 point on 3 of 52 rows and 0.105 nats before, 3 points and 0.39 nats
    before the moments and determinants rounded as the reference's), each
    entropy mean agrees to 10 nats per point counted otherwise over the
    row's valid points, and every CorAl column to 5e-7 nats (measured
    2.4e-7 here, 4.8e-7 on the one-street pairs; the rows' sums over their
    points still add in another order; 0.020 nats before the log was the
    reference's).  The ranks' model is held against the
    reference's fit of the ranks' own x at the tolerance of
    tests/test_torch_verification.py, and it classifies every row of the
    reference's x as the reference step's model does."""
    d, outs = two_ranks
    model, x, y = _jax_training_step(d, "train")
    want_p = jlogistic.predict_proba(model, jnp.asarray(x))
    for out in outs:
        _assert_training_x(d, "train", out, x, y, 0, coral_atol=5e-7)
        fit = jlogistic.fit(jnp.asarray(out["train.x"]), jnp.asarray(y),
                            balanced=True)
        np.testing.assert_allclose(
            np.r_[out["train.intercept"], out["train.coef"]],
            np.r_[float(fit.intercept), np.asarray(fit.coef)],
            rtol=1e-3, atol=1e-4)
        got_p = jlogistic.predict_proba(
            jlogistic.from_values(float(out["train.intercept"]),
                                  out["train.coef"]), jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(got_p) > 0.5,
                                      np.asarray(want_p) > 0.5)


def test_two_ranks_alignment_training_step_one_street_matches_jax(two_ranks):
    """The training step on 4 pairs of one 40-wall street: x and y as in
    test_two_ranks_alignment_training_step_matches_jax (no point counted
    otherwise, CorAl columns within 5e-7 nats).  Here the pairs'
    tot_size column is near constant (234-246 cells), so it and the
    unpenalised intercept are near collinear, and the 50 clipped Newton
    steps of both packages' IRLS (the reference's on its own x too) end in
    a period-2 cycle that depends on the last bits of each solve.  Since
    the gradient's sum and the solve round as the reference's, the port's
    fit of the ranks' uncentred x is the reference's fit of it, bit for bit
    (before: intercept 20 against 40).  The fit is also held with that
    column centred, where it converges: the port's fit of the ranks' x
    against the reference's, and the ranks' model is the port's fit of
    their gathered x."""
    d, outs = two_ranks
    _, x, y = _jax_training_step(d, "street")
    for out in outs:
        _assert_training_x(d, "street", out, x, y, 0, coral_atol=5e-7)
        xt = np.array(out["street.x"])
        own = tlogistic.fit(torch.as_tensor(xt), torch.as_tensor(y),
                            balanced=True)
        np.testing.assert_array_equal(out["street.coef"], own.coef.numpy())
        ref = jlogistic.fit(jnp.asarray(xt), jnp.asarray(y), balanced=True)
        np.testing.assert_array_equal(
            np.r_[own.intercept.numpy(), own.coef.numpy()],
            np.r_[np.asarray(ref.intercept), np.asarray(ref.coef)])
        xc = np.array(xt)
        xc[:, 5] -= xc[:, 5].mean()
        fit = jlogistic.fit(jnp.asarray(xc), jnp.asarray(y), balanced=True)
        mine = tlogistic.fit(torch.as_tensor(xc), torch.as_tensor(y),
                             balanced=True)
        np.testing.assert_allclose(
            np.r_[float(mine.intercept), mine.coef.numpy()],
            np.r_[float(fit.intercept), np.asarray(fit.coef)],
            rtol=1e-3, atol=1e-4)


def test_mesh_of_one_pair_wave_matches_jax():
    """A mesh of size 1 (no process group): the sharded wave is the
    single-device wave, held to the reference's."""
    cfg = jax_config(DENSE)
    d = {}
    _pair_wave(d, cfg)
    want = _jwave(d, cfg)
    tcfg = ranks_mod.config(DENSE)
    got = tpar_cand.sharded_register_and_verify_pairs(
        multihost.make_mesh("cpu"), *ranks_mod._wave_args(d, "pairs"),
        *ranks_mod.models(tcfg), tcfg)
    single = tlc.register_and_verify_pairs(
        *ranks_mod._wave_args(d, "pairs"), *ranks_mod.models(tcfg), tcfg)
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(single, f.name))
    np.testing.assert_allclose(got.t_be.numpy(), want.t_be, atol=PAIR_ATOL)
    np.testing.assert_allclose(got.prob.numpy(), want.prob, atol=PAIR_ATOL)
    np.testing.assert_allclose(got.cov.numpy(), want.cov, rtol=COV_RTOL,
                               atol=COV_ATOL)


def test_mesh_of_one_retrieve_matches_jax():
    cfg = jax_config(TINY)
    sc = cfg.scancontext
    d = {}
    ranks_mod.retrieval_inputs(d, cfg, np.random.default_rng(5), 64)
    t = lambda n: torch.as_tensor(d[f"ret/{n}"])
    got = tpar_ret.sharded_retrieve(
        multihost.make_mesh("cpu"), t("qdesc"), t("qkey"), t("desc"),
        t("ring"), t("mask"), t("osim"),
        num_candidates=sc.num_candidates_from_tree,
        search_ratio=sc.search_ratio, odometry_coupled=True)
    for q in range(3):
        want = jsc.retrieve(
            jnp.asarray(d["ret/qdesc"][q]), jnp.asarray(d["ret/qkey"][q]),
            jnp.asarray(d["ret/desc"]), jnp.asarray(d["ret/ring"]),
            jnp.asarray(d["ret/mask"]), jnp.asarray(d["ret/osim"][q]),
            num_candidates=sc.num_candidates_from_tree,
            search_ratio=sc.search_ratio, odometry_coupled=True)
        for f in ("index", "shift", "valid"):
            np.testing.assert_array_equal(getattr(got, f)[q].numpy(),
                                          np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.dist[q].numpy(), np.asarray(want.dist),
                                   atol=DIST_ATOL)


def test_dryrun_inputs_are_the_references(monkeypatch):
    """``harness/dryrun.py::draw_inputs`` at the dry run's own sizes and
    configuration, two ranks, is bit for bit what the JAX package's
    multi-device dry run (``dryrun_multichip(2)``) feeds its steps: its
    steps are replaced by stubs that keep their inputs."""
    got = {}
    keep = lambda name, ret: lambda *a, **k: (got.setdefault(name, a), ret)[1]
    b, sc = 2, jconfig.TBVConfig().scancontext
    monkeypatch.setattr(jodo, "batched_odometry_step", keep(
        "odometry", (None, ODOMETRY_STUB(pose=jnp.zeros((b, 3))))))
    monkeypatch.setattr(jpar_cand, "alignment_training_step",
                        keep("training", (jnp.zeros(()),) * 3))
    monkeypatch.setattr(jpar_cand, "sharded_register_and_verify_pairs",
                        keep("pair_wave", WAVE_STUB(cov=jnp.zeros((b, 3, 3)))))
    monkeypatch.setattr(jpgo, "optimize_distributed", keep(
        "pgo", PGO_STUB(cost=jnp.zeros(()), cost0=jnp.ones(()))))
    insert = jlc.db_insert_batch
    monkeypatch.setattr(jlc, "db_insert_batch", lambda *a: (
        got.setdefault("db", a), insert(*a))[1])
    monkeypatch.setattr(jlc, "detect", keep(
        "detect", DETECT_STUB(index=jnp.zeros(sc.n_candidates))))
    jentry.dryrun_multichip(b)
    want = dryrun.draw_inputs(dryrun.dryrun_config(), b)
    same = lambda a, w: np.testing.assert_array_equal(np.asarray(a), w)
    same(got["odometry"][1], want["images"])
    train, wave = got["training"], got["pair_wave"]
    for rec, arrays in zip((train[1], train[2], train[4], train[5],
                            wave[1], wave[2], wave[3], wave[4]),
                           want["training"] + want["pair_wave"]):
        for k, v in arrays.items():
            same(getattr(rec, k), v)
    poses, (idx, meas, sqrt_info, etype, mask) = want["graph"]
    same(got["pgo"][1], poses)
    edges = jpg.make_edges(idx.astype(np.int32), meas, sqrt_info,
                           etype.astype(np.int32), mask)
    for k in ("idx", "meas", "sqrt_info", "etype", "mask"):
        same(getattr(got["pgo"][3], k), np.asarray(getattr(edges, k)))
    same(got["db"][2], want["descs"])
    same(got["db"][4], want["traj"])


ODOMETRY_STUB = collections.namedtuple("Odometry", "pose")
WAVE_STUB = collections.namedtuple("Wave", "cov")
PGO_STUB = collections.namedtuple("Pgo", "cost cost0")
DETECT_STUB = collections.namedtuple("Detect", "index")


@pytest.fixture(scope="module")
def port_dryrun():
    """The port's dry run at tiny sizes in one process, two sequences and
    pairs (what two ranks run, test_dryrun_on_two_ranks_against_one_process),
    and its inputs."""
    cfg = ranks_mod.config(DRYRUN)
    rec = dryrun.dryrun(multihost.make_mesh("cpu"), cfg, batch=2,
                        **DRYRUN_SIZES)
    return rec, dryrun.draw_inputs(cfg, 2, **DRYRUN_SIZES)


def _jrecord(cls, arrays):
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_dryrun_matches_jax(port_dryrun):
    """The dry run's odometry frame, training step, pair wave and retrieval
    at tiny sizes against the JAX package's functions fed the same arrays
    on a 2-device sub-mesh: the frame's poses and flags equal, the training
    step's x as in test_two_ranks_alignment_training_step_matches_jax (the
    clouds are uniform in 160 m x 160 m, so no point has a neighbour and
    the CorAl columns are 0 in both) and its model the reference's fit of
    the port's x, the wave (fed the port's model) at the JAX package's
    sharded-wave tolerances but for t_be (``DRYRUN_T_BE_ATOL``), and the
    retrieved candidates equal."""
    rec, inp = port_dryrun
    out, jc = rec["out"], jax_config(DRYRUN)
    b = inp["images"].shape[0]
    _, jodo_out = jodo.batched_odometry_step(
        jodo.init_batched_state(jc, b), jnp.asarray(inp["images"]), jc)
    for f in ("pose", "fused", "success"):
        np.testing.assert_array_equal(getattr(out["odometry"], f).numpy(),
                                      np.asarray(getattr(jodo_out, f)))

    mesh = JMesh(np.asarray(jax.devices()[:b]), ("dp",))
    cur_p, cur_c, prev_p, prev_c = inp["training"]
    zeros = jnp.zeros((b, 3))
    jmodel, x, y = jax.tree.map(np.asarray, jpar_cand.alignment_training_step(
        mesh, _jrecord(JPointCloud, cur_p), _jrecord(JCells, cur_c), zeros,
        _jrecord(JPointCloud, prev_p), _jrecord(JCells, prev_c), zeros, jc))
    model, xt, yt = out["training"]
    _assert_training_x({"dry/cur_peaks.mask": cur_p["mask"],
                        "dry/prev_peaks.mask": prev_p["mask"]}, "dry",
                       {"dry.x": xt.numpy(), "dry.y": yt.numpy()}, x, y, 0)
    fit = jlogistic.fit(jnp.asarray(xt.numpy()), jnp.asarray(y),
                        balanced=True)
    np.testing.assert_allclose(
        np.r_[float(model.intercept), model.coef.numpy()],
        np.r_[float(fit.intercept), np.asarray(fit.coef)],
        rtol=1e-3, atol=1e-4)
    mine = jlogistic.from_values(float(model.intercept), model.coef.numpy())
    np.testing.assert_array_equal(
        np.asarray(jlogistic.predict_proba(mine, jnp.asarray(x))) > 0.5,
        np.asarray(jlogistic.predict_proba(jmodel, jnp.asarray(x))) > 0.5)

    v = jc.verification
    q_c, q_p, c_c, c_p = inp["pair_wave"]
    want = jpar_cand.sharded_register_and_verify_pairs(
        mesh, _jrecord(JCells, q_c), _jrecord(JPointCloud, q_p),
        _jrecord(JCells, c_c), _jrecord(JPointCloud, c_p), zeros,
        jnp.zeros((b,)), 0.2 * jnp.ones((b,)), 0.1 * jnp.ones((b,)),
        jnp.ones((b,), bool), mine,
        jlogistic.from_values(v.loop_coefs[0], v.loop_coefs[1:]), jc)
    wave = out["pair_wave"]
    np.testing.assert_allclose(wave.t_be.numpy(), np.asarray(want.t_be),
                               atol=DRYRUN_T_BE_ATOL)
    np.testing.assert_allclose(wave.prob.numpy(), np.asarray(want.prob),
                               atol=PAIR_ATOL)
    np.testing.assert_allclose(wave.cov.numpy(), np.asarray(want.cov),
                               rtol=COV_RTOL, atol=COV_ATOL)
    np.testing.assert_array_equal(wave.valid.numpy(), np.asarray(want.valid))

    sc = jc.scancontext
    descs = jnp.asarray(inp["descs"])
    cap = descs.shape[0]
    db = jlc.db_insert_batch(jlc.make_db(cap, jc), jnp.arange(cap), descs,
                             descs.mean(-1), jnp.asarray(inp["traj"]))
    db = jpar_ret.shard_db(jpar_ret.make_db_mesh(jax.devices()[:b]), db)
    a = 1 + (len(sc.augment_offsets) if sc.augment_sc else 0)
    q = jnp.stack([descs[3] + 0.01 * k for k in range(a)])
    det = jlc.detect(db, q, q.mean(-1), jnp.asarray(cap - 1), jc,
                     mesh=jpar_ret.make_db_mesh(jax.devices()[:b]))
    np.testing.assert_array_equal(out["retrieval"].index.numpy()[0],
                                  np.asarray(det.index))


@pytest.mark.parametrize("pc", ["chain", "chain_sharded"])
def test_dryrun_graph_pgo_matches_jax(port_dryrun, pc):
    """The dry run's seeded two-lap graph (``harness/dryrun.py::loop_graph``
    at 64 nodes and 8 loops, the reference's construction, drawn in the dry
    run's order) through the reference's ``optimize_distributed`` on a
    2-device sub-mesh: both lower the cost and the port's dry run lands
    within 5 cm of it."""
    rec, inp = port_dryrun
    poses, (idx, meas, sqrt_info, etype, mask) = inp["graph"]
    n = len(poses)
    want = jpgo.optimize_distributed(
        JMesh(np.asarray(jax.devices()[:2]), ("graph",)), jnp.asarray(poses),
        jnp.ones((n,), bool), jpg.make_edges(idx.astype(np.int32), meas,
                                             sqrt_info,
                                             etype.astype(np.int32), mask),
        jconfig.PGOConfig(max_iterations=2, cg_iterations=8),
        preconditioner=pc)
    got = rec["out"][f"pgo_{pc}"]
    assert float(got.cost) <= float(got.cost0)
    assert float(want.cost) <= float(want.cost0)
    np.testing.assert_allclose(got.poses[:, :2].numpy(),
                               np.asarray(want.poses)[:, :2],
                               atol=PGO_XY_ATOL)


@pytest.mark.parametrize("pc", ["chain", "chain_sharded"])
def test_mesh_of_one_distributed_pgo_matches_jax(pc):
    """One process against the reference on its 2-device sub-mesh; the
    segment-sharded preconditioner lands where the replicated one does
    (the bounds of tests/test_parallel.py:368-395)."""
    gt, poses, edges = _loop_graph()
    n = len(poses)
    d = {}
    _pgo_inputs(d, edges, poses, 64)
    cfg = jconfig.PGOConfig()
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("graph",))
    want = jpgo.optimize_distributed(mesh, jnp.asarray(poses),
                                     jnp.ones((n,), bool), edges, cfg,
                                     preconditioner=pc)
    got = {p: tpar_pgo.optimize_distributed(
        multihost.make_mesh("cpu"), torch.as_tensor(poses),
        torch.ones(n, dtype=torch.bool), _tedges(d), cfg, preconditioner=p)
        for p in ("chain", pc)}
    np.testing.assert_allclose(got[pc].poses[:, :2].numpy(),
                               np.asarray(want.poses)[:, :2],
                               atol=PGO_XY_ATOL)
    assert int(got[pc].iterations) > 0
    assert float(got[pc].cost) < 1e-6 * float(got[pc].cost0)
    err = {p: np.linalg.norm(r.poses[:, :2].numpy() - gt[:, :2],
                             axis=1).mean() for p, r in got.items()}
    assert abs(err[pc] - err["chain"]) < 0.1 * max(err["chain"], 1e-3) + 5e-3


def test_pose_graph_distributed_solver():
    """PoseGraph(mesh).optimize("distributed") lands on the schur solution
    of the same graph (tests/test_parallel.py's check); without a mesh it
    raises ValueError."""
    from tbv_slam_public_torch.core.config import PGOConfig, TBVConfig

    cfg = TBVConfig(pgo=dataclasses.replace(PGOConfig(), cg_iterations=512))
    inst = simulate.make_pgo_instance(128, seed=0)
    graphs = [tslam.PoseGraph(cfg, device="cpu",
                              mesh=multihost.make_mesh("cpu")),
              tslam.PoseGraph(cfg, device="cpu")]
    for g in graphs:
        for p in inst.poses:
            g.add_node(p)
        for k in range(int(inst.mask.sum())):
            a, b = int(inst.idx[k, 0]), int(inst.idx[k, 1])
            if inst.etype[k] == ODOMETRY and b == a + 1:
                g.add_odometry_constraint(a, b, inst.meas[k])
            else:
                g.add_loop_constraint(tlc.LoopConstraint(
                    id_from=a, id_to=b, t_be=inst.meas[k], prob=1.0))
    res = graphs[0].optimize(solver="distributed")
    ref = graphs[1].optimize(solver="schur")
    assert graphs[0].last_solver == "distributed"
    assert float(res.cost) < float(res.cost0)
    np.testing.assert_allclose(graphs[0].poses_array()[:, :2],
                               graphs[1].poses_array()[:, :2],
                               atol=PGO_XY_ATOL)
    assert abs(float(res.cost) - float(ref.cost)) < \
        0.05 * float(ref.cost) + 1e-6
    with pytest.raises(ValueError, match="requires a mesh"):
        graphs[1].optimize(solver="distributed")


def test_multihost_helpers_single_process():
    """One process: the port's helpers give what the reference's give."""
    assert multihost.process_info() == jmultihost.process_info() == (0, 1)
    items = list(range(7))
    assert multihost.my_jobs(items) == jmultihost.my_jobs(items) == items
    assert multihost.all_hosts_sum(3.5) == jmultihost.all_hosts_sum(3.5)
    mesh = multihost.global_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    got = multihost.scaling_report(100, 10.0)
    want = jmultihost.scaling_report(100, 10.0)
    assert got.keys() == want.keys()
    assert got["frames_per_s"] == pytest.approx(10.0)
    assert (got["hosts"], got["frames"]) == (want["hosts"], want["frames"])


def test_sweep_runs_on_the_cpu(tmp_path, capsys):
    """``sweep --device cpu`` in this process: a two-job parameter file over
    simulated frames gives two job directories, two merged.csv rows and the
    report; the file reads as the reference reads it."""
    par = tmp_path / "pars.csv"
    par.write_text("# k-strongest sweep\nradar.k_strongest,4,5\n"
                   "registration.cost,P2L\n")
    assert sweep.read_par_file(str(par)) == jsweep.read_par_file(str(par))
    out = tmp_path / "sweep"
    rc = cli.main(["sweep", "--par-file", str(par), "--dataset", "sim:8:1",
                   "--output", str(out), "--mode", "odometry", "--device",
                   "cpu", "features.cell_capacity=128",
                   "features.grid_extent=60.0"])
    assert rc == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["job"] for r in results] == [0, 1]
    with open(out / "merged.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["pars"] for r in rows] == [
        "radar.k_strongest=4 registration.cost=P2L",
        "radar.k_strongest=5 registration.cost=P2L"]
    assert all(int(r["frames"]) == 8 for r in rows)
    for k in (0, 1):
        assert (out / f"job_{k}" / "simple_graph.npz").exists()
    report = json.loads((out / "sweep_report.json").read_text())
    assert report["total_jobs"] == 2 and report["my_jobs"] == [0, 1]
    assert report["hosts"] == 1 and report["frames"] == 2
