"""Port parity of the per-keyframe (online) loop closure, the proximity
strategies and the full-graph checkpoint against the JAX package.  Both
packages are fed the same keyframe store, made by the reference's own filter
and features from a numpy-seeded simulated loop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_slam import slam_config
from tbv_slam_public_tpu.io import checkpoint as jckpt
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import loopclosure as jlc
from tbv_slam_public_tpu.models import slam as jslam
from tbv_slam_public_tpu.models import strategies as jstrat
from tbv_slam_public_tpu.ops import features as jfeatures
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.io import checkpoint as tckpt
from tbv_slam_public_torch.io import convert
from tbv_slam_public_torch.models import loopclosure as tlc
from tbv_slam_public_torch.models import slam as tslam
from tbv_slam_public_torch.models import strategies as tstrat

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.asarray(a))
N_SCANS = 70


def _fields(rec):
    return {k: np.asarray(getattr(rec, k)) for k in rec.__dataclass_fields__}


@pytest.fixture(scope="module")
def store():
    """Keyframes along 1.4 laps of a 15 m circle, 2 m apart: (peaks, cells)
    as the reference computes them, and the trajectory."""
    cfg = slam_config()
    rng = np.random.default_rng(5)
    world = simulate.make_world(rng, num_walls=60, extent=60.0)
    traj = simulate.loop_trajectory(N_SCANS, radius=15.0, step=2.0, laps=1.4)
    cap = cfg.verification.peaks_capacity
    scans = []
    for p in traj:
        img = simulate.render_scan(
            world, p, num_azimuths=cfg.radar.num_azimuths,
            num_range_bins=cfg.radar.num_range_bins,
            range_res=cfg.radar.range_res, rng=rng)
        cloud, peaks = jradar.kstrongest_filter(jnp.asarray(img), cfg.radar)
        cells = jfeatures.compute_cells(cloud, cfg.features)
        scans.append((jax.tree.map(lambda x: x[:cap], peaks), cells))
    return cfg, scans, np.asarray(traj, np.float32)


def _closers(cfg, scans, traj):
    jl = jlc.LoopCloser(cfg)
    tl = tlc.LoopCloser(cfg, device="cpu")
    for (peaks, cells), p in zip(scans, traj):
        jl.add_keyframe(peaks, cells, p)
        tl.add_keyframe(convert.cloud_from_numpy(_fields(peaks)),
                        convert.cells_from_numpy(_fields(cells)), p)
    return jl, tl


@pytest.fixture(scope="module")
def online_closers(store):
    """Both loop closers after process_pending() + finish() over the store.
    The port bins its local maps with the reference's ``context_descriptors``
    here: a point one ulp from a bin border lands in the neighbouring bin in
    one of the two libraries, which on these sparse scans moves a ScanContext
    distance by 1e-2 and reorders candidates (the port's own descriptors are
    held against the reference's in test_torch_scancontext.py)."""
    cfg, scans, traj = store
    jl, tl = _closers(cfg, scans, traj)
    j_out = jl.process_pending() + jl.finish()

    def reference_descriptors(local_map, cfg):
        from tbv_slam_public_tpu.core.types import PointCloud
        one = PointCloud(**{k: jnp.asarray(v[0])
                            for k, v in _fields(local_map).items()})
        d, r, _ = jlc.context_descriptors(one, cfg)
        return T(d)[None], T(r)[None]

    own = tlc.context_descriptors
    tlc.context_descriptors = reference_descriptors
    try:
        t_pending = tl.process_pending()
        n_pending = tl._processed
        t_out = t_pending + tl.finish()
    finally:
        tlc.context_descriptors = own
    return cfg, traj, jl, tl, j_out, t_out, n_pending


def test_process_pending_candidate_log_matches(online_closers):
    """Every candidate the per-keyframe path evaluates against the
    reference's log row: the same candidates in the same order, then sc_sim,
    odom_bounds, t_be, x6 and prob, each where it is well posed."""
    cfg, traj, jl, tl, _, _, n_pending = online_closers
    # process_pending stops n_aggregate keyframes short; finish drains them
    assert n_pending == N_SCANS - cfg.loopclosure.n_aggregate
    assert tl._processed == jl._processed == N_SCANS
    key = lambda r: (r["id_from"], r["id_to"], r["guess_nr"])
    assert [key(r) for r in tl.candidate_log] == \
        [key(r) for r in jl.candidate_log] and len(jl.candidate_log) >= 100
    f = lambda log, name: np.asarray([r[name] for r in log], np.float32)
    got, want = tl.candidate_log, jl.candidate_log
    np.testing.assert_allclose(f(got, "sc_sim"), f(want, "sc_sim"),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f(got, "odom_bounds"), f(want, "odom_bounds"),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(f(got, "reg_ok"), f(want, "reg_ok"))
    # registration is well posed at a true revisit (the trajectory is the
    # ground truth here): there t_be agrees to 1 cm (one outer iteration more
    # or less moves it by millimetres); elsewhere the cost is multimodal
    ids = np.asarray([key(r) for r in want])
    near = np.linalg.norm(traj[ids[:, 0], :2] - traj[ids[:, 1], :2],
                          axis=1) < 6.0
    assert near.sum() >= 50
    np.testing.assert_allclose(f(got, "t_be")[near], f(want, "t_be")[near],
                               atol=1e-2)
    # x6: the CFEAR features (score, residuals, cell count) to 3 % (t_be a
    # millimetre apart flips one cell association at its radius gate: one
    # residual of ~100, 2 % of the score); overlap
    # to five points of the merged cloud.  These 8-peak scans leave ~170
    # points a cloud, whose near-collinear neighbourhoods sit on CorAl's
    # determinant gate: the entropies, and with them the alignment score and
    # the probability, are held against the reference on dense scans in
    # test_torch_verification.py and test_torch_slice.py, and here only by
    # the decisions they lead to
    gx, wx = f(got, "x6")[near], f(want, "x6")[near]
    np.testing.assert_allclose(gx[:, 3:], wx[:, 3:], rtol=3e-2, atol=1e-2)
    merged = np.asarray([tl.kf_peaks[a].mask.sum() + tl.kf_peaks[b].mask.sum()
                         for a, b, _ in ids[near]], np.float32)
    assert np.all(np.abs(gx[:, 2] - wx[:, 2]) * merged <= 5.0 + 1e-3)
    clear = np.abs(f(want, "prob") - cfg.verification.model_threshold) > 0.1
    np.testing.assert_array_equal(
        (f(got, "prob") > cfg.verification.model_threshold)[clear],
        (f(want, "prob") > cfg.verification.model_threshold)[clear])


def test_online_accepts_the_reference_loops(online_closers):
    """Accepted constraints of the per-keyframe path: every loop the
    reference accepts with a probability clear of the threshold (by 0.1), and
    none it rejects as clearly; t_be within 1 cm and a covariance where the
    reference has one."""
    cfg, traj, jl, tl, j_out, t_out, _ = online_closers
    th = cfg.verification.model_threshold
    pairs = lambda out: {(c.id_from, c.id_to): c for c in out}
    jp, tp = pairs(j_out), pairs(t_out)
    clear = [k for k, c in jp.items() if c.prob > th + 0.1]
    assert len(clear) >= 3 and set(clear) <= set(tp)
    jprob = {(r["id_from"], r["id_to"]): r["prob"] for r in jl.candidate_log}
    assert all(jprob[k] > th - 0.1 for k in tp)
    for k in clear:
        np.testing.assert_allclose(tp[k].t_be, jp[k].t_be, atol=1e-2)
        assert (tp[k].cov is None) == (jp[k].cov is None)
        if tp[k].cov is not None:
            np.testing.assert_allclose(tp[k].cov, jp[k].cov, rtol=0.2,
                                       atol=1e-6)  # a fit to sampled costs
    assert tl.constraints == t_out


def test_db_insert_matches(store, rng):
    cfg, _, _ = store
    sc = cfg.scancontext
    desc = rng.uniform(size=(sc.num_ring, sc.num_sector)).astype(np.float32)
    ring = desc.mean(1)
    pose = np.asarray([1.0, 2.0, 0.3], np.float32)
    jdb = jlc.db_insert(jlc.make_db(8, cfg), jnp.asarray(5), jnp.asarray(desc),
                        jnp.asarray(ring), jnp.asarray(pose))
    tdb = tlc.make_db(8, cfg)
    tlc.db_insert(tdb, 5, T(desc), T(ring), T(pose))
    for name in ("desc", "ring", "odom_pose", "mask"):
        np.testing.assert_array_equal(getattr(tdb, name).numpy(),
                                      np.asarray(getattr(jdb, name)))


@pytest.mark.parametrize("seed", [0, 1])
def test_proximity_candidates_and_odometry_check_match(seed):
    """The MiniClosure selection and VerifyByOdometry on a random walk that
    returns on itself: indices exact, dissimilarity to 1e-5."""
    r = np.random.default_rng(seed)
    n = 80
    th = np.linspace(0, 2.6 * np.pi, n)
    poses = np.stack([20 * np.cos(th), 20 * np.sin(th), th], 1) \
        + r.normal(scale=0.3, size=(n, 3))
    poses = poses.astype(np.float32)
    mask = r.uniform(size=n) < 0.9
    travel = jstrat.odometry_travel_cumsum(poses)
    np.testing.assert_array_equal(tstrat.odometry_travel_cumsum(poses), travel)
    jb, jv = jstrat.proximity_candidates(
        jnp.asarray(poses), jnp.asarray(mask), jnp.asarray(travel), 25.0,
        500.0, 15.0)
    tb, tv = tstrat.proximity_candidates(T(poses), T(mask), T(travel), 25.0,
                                         500.0, 15.0)
    jv = np.asarray(jv)
    assert jv.sum() >= 10
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tb.numpy()[jv], np.asarray(jb)[jv])
    id_from, id_to = np.nonzero(jv)[0], np.asarray(jb)[jv]
    np.testing.assert_allclose(
        tstrat.verify_by_odometry(T(poses), T(travel), T(id_from), T(id_to),
                                  0.05).numpy(),
        np.asarray(jstrat.verify_by_odometry(
            jnp.asarray(poses), jnp.asarray(travel), jnp.asarray(id_from),
            jnp.asarray(id_to), 0.05)), rtol=1e-4, atol=1e-5)


def test_proximity_closer_matches(store):
    """MiniClosure over the shared store: the same pairs are selected and
    registered from the identity guess, and the log rows carry x6; the
    gt_loop oracle gives the ground truth's relative poses."""
    cfg, scans, traj = store
    cfg = dataclasses.replace(cfg, loopclosure=dataclasses.replace(
        cfg.loopclosure, min_d_travel=60.0, max_d_close=3.0))
    jl, tl = _closers(cfg, scans, traj)
    j_out = jstrat.ProximityCloser(cfg, jl).search(traj)
    tp = tstrat.ProximityCloser(cfg, tl)
    t_out = tp.search(traj)
    key = lambda r: (r["id_from"], r["id_to"])
    assert [key(r) for r in tl.candidate_log] == \
        [key(r) for r in jl.candidate_log] and len(jl.candidate_log) >= 5
    assert all(r["guess_nr"] == -1 and len(r["x6"]) == 6
               for r in tl.candidate_log)
    f = lambda log, name: np.asarray([r[name] for r in log], np.float32)
    np.testing.assert_allclose(f(tl.candidate_log, "odom_bounds"),
                               f(jl.candidate_log, "odom_bounds"), atol=1e-5)
    # pairs at most 3 m apart, identity guess: well posed, 1 cm
    np.testing.assert_allclose(f(tl.candidate_log, "t_be"),
                               f(jl.candidate_log, "t_be"), atol=1e-2)
    # the probability by its decision where it is clear of the threshold
    # (sparse scans: see test_process_pending_candidate_log_matches)
    th = cfg.verification.model_threshold
    jprob = f(jl.candidate_log, "prob")
    clear = np.abs(jprob - th) > 0.2
    np.testing.assert_array_equal(
        (f(tl.candidate_log, "prob") > th)[clear], (jprob > th)[clear])
    jacc = {(c.id_from, c.id_to) for c in j_out if abs(c.prob - th) > 0.2}
    assert jacc and jacc <= {(c.id_from, c.id_to) for c in t_out}
    assert tp.search(traj) == []  # every origin was attempted

    ocfg = dataclasses.replace(cfg, loopclosure=dataclasses.replace(
        cfg.loopclosure, gt_loop=True))
    j_gt = jstrat.ProximityCloser(ocfg, jl, gt_vicinity=True).search(
        traj, gt_poses=traj)
    t_gt = tstrat.ProximityCloser(ocfg, tl, gt_vicinity=True).search(
        traj, gt_poses=traj)
    assert len(t_gt) == len(j_gt) >= 5
    for a, b in zip(t_gt, j_gt):
        assert (a.id_from, a.id_to, a.prob) == (b.id_from, b.id_to, b.prob)
        np.testing.assert_allclose(a.t_be, b.t_be, atol=1e-5)


def _graph_arrays(g):
    return (g.poses_array(), np.asarray(g.stamps), g.gt_array(),
            [(e["idx"], e["etype"], e["meas"], e["cov"]) for e in g.edges])


def _assert_same_graph(a, b):
    pa, sa, ga, ea = _graph_arrays(a)
    pb, sb, gb, eb = _graph_arrays(b)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(ga, gb)
    assert len(ea) == len(eb)
    for (ia, ta, ma, ca), (ib, tb_, mb, cb) in zip(ea, eb):
        assert tuple(ia) == tuple(ib) and ta == tb_
        np.testing.assert_array_equal(ma, mb)
        assert (ca is None) == (cb is None)
        if ca is not None:
            np.testing.assert_array_equal(ca, cb)


def test_full_graph_crosses_both_ways(online_closers, tmp_path):
    """A full graph (poses, edges with covariances, keyframe payloads, loop
    log) written by either package loads in the other, bit for bit, and
    ``convert.full_graph_from_numpy`` builds the same graph from the
    reference's host form."""
    cfg, traj, jl, tl, j_out, t_out, _ = online_closers

    def fill(slam, loops, out):
        slam.loops = loops
        for i, p in enumerate(traj):
            slam.graph.add_node(p, 0.25 * i, gt=traj[i])
            if i:
                rel = np.asarray([2.0, 0.0, 0.01 * i], np.float32)
                slam.graph.add_odometry_constraint(
                    i - 1, i, rel, cov=np.eye(3, dtype=np.float32) * 1e-3)
        for c in out:
            slam.graph.add_loop_constraint(c)
        return slam

    js = fill(jslam.TBVSLAM(cfg), jl, j_out)
    ts = fill(tslam.TBVSLAM(cfg, device="cpu"), tl, t_out)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_full_graph(jpath, js.graph, slam=js)
    tckpt.save_full_graph(tpath, ts.graph, slam=ts)

    # reference -> port
    _assert_same_graph(tckpt.load_full_graph(jpath, cfg, device="cpu"),
                       js.graph)
    t2 = tckpt.load_full_graph_slam(jpath, cfg, device="cpu")
    assert t2.loops._processed == N_SCANS and t2.loops.candidate_log == []
    for i in (0, N_SCANS - 1):
        for name, v in _fields(jl.kf_peaks[i]).items():
            np.testing.assert_array_equal(getattr(t2.loops.kf_peaks[i], name),
                                          v)
        for name, v in _fields(jl.kf_cells[i]).items():
            np.testing.assert_array_equal(getattr(t2.loops.kf_cells[i], name),
                                          v)
    np.testing.assert_array_equal(np.stack(t2.loops.kf_odom),
                                  np.stack(jl.kf_odom))
    # port -> reference (the loop_log key is one the reference skips)
    _assert_same_graph(jckpt.load_full_graph(tpath, cfg), ts.graph)
    j2 = jckpt.load_full_graph_slam(tpath, cfg)
    assert j2.loops._processed == N_SCANS
    np.testing.assert_array_equal(np.asarray(j2.loops.kf_peaks[3].xy),
                                  tl.kf_peaks[3].xy)
    np.testing.assert_array_equal(np.asarray(j2.loops.kf_cells[3].mean),
                                  tl.kf_cells[3].mean)
    # port -> port keeps the candidate log
    t3 = tckpt.load_full_graph_slam(tpath, cfg, device="cpu")
    assert t3.loops.candidate_log == tckpt.load_loop_log(tpath)
    assert len(t3.loops.candidate_log) == len(tl.candidate_log)
    row, ref = t3.loops.candidate_log[0], tl.candidate_log[0]
    assert row["id_from"] == ref["id_from"] and row["x6"] == ref["x6"]
    # the reference's host form through io.convert
    g, log = convert.full_graph_from_numpy(
        js.graph.poses_array(), js.graph.edges, cfg, stamps=js.graph.stamps,
        gt=js.graph.gt_array(), loop_log=jl.candidate_log, device="cpu")
    _assert_same_graph(g, js.graph)
    assert len(log) == len(jl.candidate_log)
    # and the reloaded graph optimizes with the default solver
    g.optimize()
    assert g.last_solver == "schur"
