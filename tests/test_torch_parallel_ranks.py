"""The port's rank-parallel paths (``tbv_slam_public_torch.parallel``) in two
gloo ranks on the CPU, held to the port's own single-process results.

The file imports nothing of JAX, and it is also the ranks' program:

    torchrun --standalone --nproc-per-node=2 \\
        tests/test_torch_parallel_ranks.py <inputs.npz> <out_dir>

runs every case whose inputs ``inputs.npz`` holds (a ``case/`` key prefix;
``case/cfg`` holds the case's configuration as overrides of the defaults)
in each rank and writes ``out_dir/rank<r>.npz``.  :func:`run_ranks` launches
that; ``tests/test_torch_parallel.py`` uses it to hold two ranks to the JAX
package.  The tests here check ranks against one process, ranks against
each other (distributed PGO ends on bit-equal poses), and the padding of
uneven pair waves and edge counts.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tbv_slam_public_torch.core.config import (PGOConfig, TBVConfig,
                                               apply_overrides,
                                               parse_cli_overrides)
from tbv_slam_public_torch.core.types import Cells, GraphEdges, PointCloud
from tbv_slam_public_torch.eval.trajectory import ate_rmse
from tbv_slam_public_torch.harness import dryrun
from tbv_slam_public_torch.io import simulate
from tbv_slam_public_torch.models import loopclosure as lc
from tbv_slam_public_torch.ops import features, logistic, posegraph, radar
from tbv_slam_public_torch.ops import scancontext
from tbv_slam_public_torch.parallel import candidates as par_cand
from tbv_slam_public_torch.parallel import multihost
from tbv_slam_public_torch.parallel import odometry as par_odo
from tbv_slam_public_torch.parallel import pgo as par_pgo
from tbv_slam_public_torch.parallel import retrieval as par_ret

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2

# the JAX package's own tolerances for a sharded wave (tests/test_parallel.py)
PAIR_ATOL = 1e-4  # t_be, prob
COV_RTOL, COV_ATOL = 1e-3, 1e-6
DIST_ATOL = 1e-6  # retrieval distances; index, shift and valid are equal

# the configurations of tests/test_parallel.py (tiny_cfg) and
# tests/test_slam.py (slam_config), as overrides of the defaults
TINY = ["radar.num_azimuths=60", "radar.num_range_bins=100",
        "radar.range_res=0.5", "radar.k_strongest=6",
        "radar.min_distance=1.0", "radar.max_distance=45.0",
        "features.cell_capacity=128", "features.grid_extent=50.0",
        "verification.peaks_capacity=512"]
SLAM = ["radar.num_azimuths=120", "radar.num_range_bins=200",
        "radar.range_res=0.35", "radar.k_strongest=8",
        "radar.min_distance=1.0", "radar.max_distance=65.0",
        "features.resolution=3.0", "features.cell_capacity=256",
        "features.grid_extent=60.0", "registration.cost=P2L",
        "registration.weight_option=4", "odometry.submap_scan_size=3",
        "odometry.compensate=false", "scancontext.max_radius=60.0",
        "scancontext.n_candidates=3", "scancontext.num_candidates_from_tree=6",
        "scancontext.db_chunk=128", "verification.model_threshold=0.5",
        "verification.peaks_capacity=2048", "loopclosure.n_aggregate=1",
        "loopclosure.local_map_capacity=2048"]
# the loop closers' database grows in steps of 16 slots: a sharded database
# is gathered, grown and sharded again
CLOSER = SLAM + ["scancontext.db_chunk=16"]
# tests/test_odometry.py's small_config
ODO = ["radar.num_azimuths=200", "radar.num_range_bins=256",
       "radar.range_res=0.3", "radar.k_strongest=12",
       "radar.min_distance=1.0", "radar.max_distance=75.0",
       "features.resolution=3.0", "features.cell_capacity=256",
       "features.grid_extent=80.0", "registration.cost=P2L",
       "registration.weight_option=4", "odometry.submap_scan_size=3",
       "odometry.compensate=false"]
# the dry run's configuration (harness/dryrun.py) on the tiny radar
DRYRUN = TINY + ["registration.cost=P2L", "registration.weight_option=4",
                 "pgo.max_iterations=2", "pgo.cg_iterations=8"]
DRYRUN_SIZES = dict(n_nodes=64, n_loops=8, keyframes_per_rank=16)


def config(overrides) -> TBVConfig:
    return apply_overrides(TBVConfig(), parse_cli_overrides(list(overrides)))


# -- record <-> npz ----------------------------------------------------------

def put(d, key, rec):
    """Every field of ``rec`` into ``d`` as ``key.<field>`` numpy arrays."""
    for f in dataclasses.fields(rec):
        d[f"{key}.{f.name}"] = np.asarray(getattr(rec, f.name))


def get(z, key, cls):
    return cls(**{f.name: torch.as_tensor(z[f"{key}.{f.name}"])
                  for f in dataclasses.fields(cls)})


def scans(cfg, poses, world, rng):
    """(peaks, cells) records [len(poses), ...] of simulated scans, by the
    port's filter and features."""
    out = []
    for p in poses:
        img = simulate.render_scan(
            world, np.asarray(p), num_azimuths=cfg.radar.num_azimuths,
            num_range_bins=cfg.radar.num_range_bins,
            range_res=cfg.radar.range_res, rng=rng)
        cloud, peaks = radar.kstrongest_filter(torch.as_tensor(img),
                                               cfg.radar)
        out.append((peaks, features.compute_cells(cloud, cfg.features)))
    stack = lambda recs: type(recs[0])(**{
        f.name: torch.stack([getattr(r, f.name) for r in recs])
        for f in dataclasses.fields(recs[0])})
    return stack([p for p, _ in out]), stack([c for _, c in out])


def models(cfg):
    v = cfg.verification
    return (logistic.from_values(v.alignment_coefs[0], v.alignment_coefs[1:]),
            logistic.from_values(v.loop_coefs[0], v.loop_coefs[1:]))


# -- the cases each rank runs: (mesh, inputs, cfg) -> outputs -----------------

def _wave_args(z, key):
    return (get(z, f"{key}/q_cells", Cells), get(z, f"{key}/q_peaks",
                                                 PointCloud),
            get(z, f"{key}/c_cells", Cells), get(z, f"{key}/c_peaks",
                                                 PointCloud),
            *(torch.as_tensor(z[f"{key}/{n}"]) for n in
              ("taug", "yaw", "sc_sim", "odom_bounds", "valid")))


def case_pairs(mesh, z, cfg):
    """A flat pair wave split over the ranks."""
    res = par_cand.sharded_register_and_verify_pairs(
        mesh, *_wave_args(z, "pairs"), *models(cfg), cfg)
    out = {}
    put(out, "pairs", res)
    return out


def case_cands(mesh, z, cfg):
    """One query's candidates split over the ranks."""
    res = par_cand.sharded_register_and_verify(
        mesh, *_wave_args(z, "cands"), *models(cfg), cfg)
    out = {}
    put(out, "cands", res)
    return out


def case_ret(mesh, z, cfg):
    """Retrieval over this rank's block of a sharded database."""
    t = lambda n: torch.as_tensor(z[f"ret/{n}"])
    db = par_ret.shard_db(mesh, lc.LoopDB(
        desc=t("desc"), ring=t("ring"), odom_pose=torch.zeros(
            t("mask").shape[0], 3), mask=t("mask")))
    sc = cfg.scancontext
    res = par_ret.sharded_retrieve(
        mesh, t("qdesc"), t("qkey"), db.desc, db.ring, db.mask, t("osim"),
        num_candidates=sc.num_candidates_from_tree,
        search_ratio=sc.search_ratio, odometry_coupled=True)
    return {f"ret.{k}": v.numpy() for k, v in res._asdict().items()}


def case_detect(mesh, z, cfg):
    """Candidate detection over a database sharded over the ranks."""
    t = lambda n: torch.as_tensor(z[f"detect/{n}"])
    n = t("odom").shape[0]
    db = par_ret.shard_db(mesh, lc.LoopDB(
        desc=t("desc"), ring=t("ring"), odom_pose=t("odom"),
        mask=torch.ones(n, dtype=torch.bool)))
    res = lc.detect(db, t("descs"), t("rings"), t("cur"), cfg, mesh=mesh)
    out = {}
    put(out, "detect", res)
    return out


def case_pgo(mesh, z, cfg):
    """Distributed PGO at every preconditioner; the all-reduces of each."""
    t = lambda n: torch.as_tensor(z[f"pgo/{n}"])
    edges = GraphEdges(idx=t("idx"), meas=t("meas"),
                       sqrt_info=t("sqrt_info"), etype=t("etype"),
                       mask=t("mask"))
    pcfg = dataclasses.replace(PGOConfig(),
                               max_iterations=int(z["pgo/max_iterations"]))
    out = {}
    for pc in par_pgo.PRECONDITIONERS:
        before = mesh.all_reduces
        res = par_pgo.optimize_distributed(mesh, t("poses"), t("node_mask"),
                                           edges, pcfg, preconditioner=pc)
        for k, v in res._asdict().items():
            out[f"pgo.{pc}.{k}"] = v.numpy()
        out[f"pgo.{pc}.all_reduces"] = np.asarray(mesh.all_reduces - before)
    return out


def case_train(mesh, z, cfg, key="train"):
    """The data-parallel alignment training step on ``<key>/``."""
    model, x, y = par_cand.alignment_training_step(
        mesh, get(z, f"{key}/cur_peaks", PointCloud),
        get(z, f"{key}/cur_cells", Cells),
        torch.as_tensor(z[f"{key}/cur_poses"]),
        get(z, f"{key}/prev_peaks", PointCloud),
        get(z, f"{key}/prev_cells", Cells),
        torch.as_tensor(z[f"{key}/prev_poses"]), cfg)
    return {f"{key}.x": x.numpy(), f"{key}.y": y.numpy(),
            f"{key}.intercept": model.intercept.numpy(),
            f"{key}.coef": model.coef.numpy()}


def case_street(mesh, z, cfg):
    return case_train(mesh, z, cfg, "street")


def closers(cfg, z, mesh=None):
    """Two loop closers fed the keyframes of ``closer/``: the offline waves
    (pair_chunk 5, rounded up to a multiple of the mesh size) and the online
    per-keyframe schedule; their constraints as arrays."""
    peaks = get(z, "closer/peaks", PointCloud)
    cells = get(z, "closer/cells", Cells)
    odom = z["closer/odom"]
    out = {}
    for mode in ("waves", "online"):
        closer = lc.LoopCloser(cfg, device="cpu", mesh=mesh)
        for i in range(len(odom)):
            closer.add_keyframe(peaks.map(lambda x: x[i]),
                                cells.map(lambda x: x[i]), odom[i])
        got = closer.process_all_batched(pair_chunk=5) if mode == "waves" \
            else closer.process_pending() + closer.finish()
        out[f"closer.{mode}.ids"] = np.asarray(
            [(c.id_from, c.id_to) for c in got], np.int64).reshape(-1, 2)
        out[f"closer.{mode}.t_be"] = np.asarray(
            [c.t_be for c in got], np.float32).reshape(-1, 3)
        out[f"closer.{mode}.prob"] = np.asarray([c.prob for c in got])
        out[f"closer.{mode}.candidates"] = np.asarray(
            len(closer.candidate_log))
    return out


def case_closer(mesh, z, cfg):
    return closers(cfg, z, mesh)


def sharded_odometry(mesh, images, cfg):
    """Poses [N, B, 3] and keyframe flags [N, B] of B sequences of N frames
    ([N, B, A, R] images), split over the mesh's ranks, as arrays."""
    poses, fused = par_odo.run_sequences(mesh, images, cfg)
    return poses.numpy(), fused.numpy()


def case_odo(mesh, z, cfg):
    """Batched odometry, one sequence a rank."""
    poses, fused = sharded_odometry(mesh, torch.as_tensor(z["odo/images"]),
                                    cfg)
    return {"odo.poses": poses, "odo.fused": fused}


def dryrun_outputs(rec):
    """The dry run's results as arrays."""
    out = rec["out"]
    model, x, y = out["training"]
    return {"dryrun.pose": out["odometry"].pose.numpy(),
            "dryrun.x": x.numpy(), "dryrun.y": y.numpy(),
            "dryrun.coef": model.coef.numpy(),
            "dryrun.t_be": out["pair_wave"].t_be.numpy(),
            "dryrun.cov": out["pair_wave"].cov.numpy(),
            **{f"dryrun.{pc}.{k}": getattr(out[pc], k).numpy()
               for pc in ("pgo_chain", "pgo_chain_sharded")
               for k in ("poses", "cost", "cost0")},
            "dryrun.index": out["retrieval"].index.numpy(),
            "dryrun.launches": np.asarray([rec[s]["launches"]
                                           for s in dryrun.STEPS])}


def case_dryrun(mesh, z, cfg):
    """The multi-rank dry run at tiny sizes (it asserts as it goes)."""
    return dryrun_outputs(dryrun.dryrun(mesh, cfg, **DRYRUN_SIZES))


def case_mh(mesh, z, cfg):
    """The multihost helpers across processes."""
    rep = multihost.scaling_report(10 * (mesh.rank + 1), 2.0)
    return {"mh.jobs": np.asarray(multihost.my_jobs(list(range(7)))),
            "mh.sum": np.asarray(multihost.all_hosts_sum(mesh.rank + 1.5)),
            "mh.info": np.asarray(multihost.process_info()),
            "mh.frames": np.asarray(rep["frames"]),
            "mh.hosts": np.asarray(rep["hosts"])}


CASES = dict(pairs=case_pairs, cands=case_cands, ret=case_ret,
             detect=case_detect, pgo=case_pgo, train=case_train,
             street=case_street,
             closer=case_closer, mh=case_mh, odo=case_odo,
             dryrun=case_dryrun)


def main(inputs: str, out_dir: str) -> None:
    multihost.initialize(device="cpu")
    mesh = multihost.global_mesh("cpu")
    z = dict(np.load(inputs))
    out = {}
    for name, case in CASES.items():
        if f"{name}/cfg" in z:
            out.update(case(mesh, z, config(z[f"{name}/cfg"].tolist())))
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    dist.destroy_process_group()


def run_ranks(inputs: dict, tmp_path, nproc: int = RANKS):
    """Run the cases of ``inputs`` in ``nproc`` gloo ranks launched by
    ``torchrun``; their outputs, one dict per rank."""
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", os.path.abspath(__file__), path,
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    return [dict(np.load(str(tmp_path / f"rank{r}.npz")))
            for r in range(nproc)]


# -- the inputs -------------------------------------------------------------

def wave_inputs(d, key, cfg, rng, m, one_query=False):
    """A wave of ``m`` (query, candidate) pairs along a simulated street:
    each candidate 0.3 m and 0.1 m off its query."""
    world = simulate.make_world(rng, num_walls=40, extent=40.0)
    qpose = [np.array([0.4 * i, 0.1 * i, 0.01 * i]) for i in range(m)]
    q_peaks, q_cells = scans(cfg, qpose[:1] if one_query else qpose, world,
                             rng)
    if one_query:
        q_peaks, q_cells = q_peaks.map(lambda x: x[0]), \
            q_cells.map(lambda x: x[0])
    c_peaks, c_cells = scans(cfg, [p + np.array([0.3, 0.1, 0.0])
                                   for p in qpose], world, rng)
    for name, rec in (("q_cells", q_cells), ("q_peaks", q_peaks),
                      ("c_cells", c_cells), ("c_peaks", c_peaks)):
        put(d, f"{key}/{name}", rec)
    d[f"{key}/taug"] = np.zeros((m, 3), np.float32)
    d[f"{key}/yaw"] = np.zeros(m, np.float32)
    d[f"{key}/sc_sim"] = np.full(m, 0.2, np.float32)
    d[f"{key}/odom_bounds"] = np.full(m, 0.1, np.float32)
    d[f"{key}/valid"] = np.arange(m) != m - 1  # the last one masked


def retrieval_inputs(d, cfg, rng, n):
    sc = cfg.scancontext
    desc = rng.uniform(0, 2, (n, sc.num_ring, sc.num_sector)).astype(
        np.float32)
    d["ret/desc"] = desc
    d["ret/ring"] = desc.mean(-1)
    d["ret/mask"] = rng.uniform(size=n) > 0.2
    d["ret/osim"] = rng.uniform(size=(3, n)).astype(np.float32)
    # three queries: noisy copies of slots 7, 20 and the last one
    q = desc[[7, 20, n - 1]] + np.float32(0.01)
    d["ret/qdesc"] = q
    d["ret/qkey"] = q.mean(-1)


def oxford_pgo_inputs(d, max_iterations):
    """The 4470-node Oxford real-odometry instance (4880 edges)."""
    z = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    m = inst.mask
    et = torch.as_tensor(inst.etype[m].astype(np.int64))
    d["pgo/idx"] = inst.idx[m].astype(np.int64)
    d["pgo/meas"] = inst.meas[m].astype(np.float32)
    d["pgo/sqrt_info"] = torch.diag_embed(posegraph.default_sqrt_info(
        et, PGOConfig())).numpy()
    d["pgo/etype"] = et.numpy()
    d["pgo/mask"] = m[m]
    d["pgo/poses"] = inst.poses.astype(np.float32)
    d["pgo/node_mask"] = np.ones(len(inst.poses), bool)
    d["pgo/max_iterations"] = np.asarray(max_iterations)
    return inst


def training_inputs(d, cfg, rng, b):
    world = simulate.make_world(rng, num_walls=40, extent=40.0)
    base = [np.array([3.0 * i, 1.0 * i, 0.1 * i]) for i in range(b)]
    step = np.array([1.0, 0.3, 0.05])
    cur = scans(cfg, [p + step for p in base], world, rng)
    prev = scans(cfg, base, world, rng)
    put(d, "train/cur_peaks", cur[0])
    put(d, "train/cur_cells", cur[1])
    put(d, "train/prev_peaks", prev[0])
    put(d, "train/prev_cells", prev[1])
    d["train/cur_poses"] = np.tile(step.astype(np.float32), (b, 1))
    d["train/prev_poses"] = np.zeros((b, 3), np.float32)


def closer_inputs(d, cfg, rng, n):
    """``n`` keyframes 2 m apart around 1.5 laps of a 16 m circle."""
    world = simulate.make_world(rng, num_walls=60, extent=60.0)
    traj = simulate.loop_trajectory(n, radius=16.0, step=2.0, laps=1.5)
    peaks, cells = scans(cfg, traj, world, rng)
    put(d, "closer/peaks", peaks)
    put(d, "closer/cells", cells)
    d["closer/odom"] = np.asarray(traj, np.float32)


# -- the tests --------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, per-rank outputs) of one two-rank run of every case: the
    pair and candidate waves and the training step in the tiny configuration
    (6 pairs and 4 candidates, the last one masked; 4 scan pairs),
    retrieval of 3 queries over 96 slots,
    the Oxford PGO instance at 8 LM iterations, both loop-closer schedules
    over 64 keyframes (9 loops), and the dry run at tiny sizes."""
    tiny, slam = config(TINY), config(SLAM)
    d = {}
    wave_inputs(d, "pairs", tiny, np.random.default_rng(2), 6)
    wave_inputs(d, "cands", tiny, np.random.default_rng(4), 4,
                one_query=True)
    retrieval_inputs(d, tiny, np.random.default_rng(0), 96)
    oxford_pgo_inputs(d, 8)
    training_inputs(d, tiny, np.random.default_rng(1), 4)
    closer_inputs(d, slam, np.random.default_rng(3), 64)
    d["mh/cfg"] = d["pairs/cfg"] = d["cands/cfg"] = d["ret/cfg"] = \
        d["pgo/cfg"] = d["train/cfg"] = np.asarray(TINY)
    d["closer/cfg"] = np.asarray(CLOSER)
    d["dryrun/cfg"] = np.asarray(DRYRUN)
    return d, run_ranks(d, tmp_path_factory.mktemp("ranks"))


def test_ranks_return_the_same_results(ranks):
    """Every output of rank 1 equals rank 0's bit for bit: the collectives
    hand every rank the same sums and gathers."""
    _, (r0, r1) = ranks
    assert sorted(r0) == sorted(r1)
    for k in r0:
        if k.startswith("mh."):
            continue
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("key", ["pairs", "cands"])
def test_sharded_wave_matches_one_process(ranks, key):
    """A wave split over two ranks against the same wave in one process."""
    d, (r0, _) = ranks
    cfg = config(TINY)
    fn = lc.register_and_verify_pairs if key == "pairs" \
        else lc.register_and_verify
    want = fn(*_wave_args(d, key), *models(cfg), cfg)
    m = d[f"{key}/yaw"].shape[0]
    assert r0[f"{key}.t_be"].shape == (m, 3)
    for f in ("t_be", "prob"):
        np.testing.assert_allclose(r0[f"{key}.{f}"],
                                   getattr(want, f).numpy(), atol=PAIR_ATOL)
    np.testing.assert_allclose(r0[f"{key}.cov"], want.cov.numpy(),
                               rtol=COV_RTOL, atol=COV_ATOL)
    for f in ("valid", "reg_ok", "cov_ok"):
        np.testing.assert_array_equal(r0[f"{key}.{f}"],
                                      getattr(want, f).numpy())
    assert not r0[f"{key}.valid"][-1]  # the masked row stays masked


def test_sharded_retrieve_matches_one_process(ranks):
    d, (r0, _) = ranks
    t = lambda n: torch.as_tensor(d[f"ret/{n}"])
    sc = config(TINY).scancontext
    want = scancontext.retrieve(
        t("qdesc"), t("qkey"), t("desc"), t("ring"), t("mask"), t("osim"),
        num_candidates=sc.num_candidates_from_tree,
        search_ratio=sc.search_ratio, odometry_coupled=True)
    for f in ("index", "shift", "valid"):
        np.testing.assert_array_equal(r0[f"ret.{f}"],
                                      getattr(want, f).numpy(), err_msg=f)
    for f in ("dist", "dist_sc", "dist_odom"):
        np.testing.assert_allclose(r0[f"ret.{f}"], getattr(want, f).numpy(),
                                   atol=DIST_ATOL, err_msg=f)


@pytest.mark.parametrize("pc", ["chain", "chain_sharded", "jacobi"])
def test_distributed_pgo_ranks_against_one_process(ranks, pc):
    """The 4470-node Oxford instance at 8 LM iterations: two ranks (4880
    edges, 2440 each) and one process both correct the real drift (the
    reference's bounds: ATE < 0.7 ATE0, cost < 0.2 cost0 for the chain
    preconditioners) and land within 1 cm of each other's ATE; the ranks'
    poses are bit-equal (test_ranks_return_the_same_results)."""
    d, (r0, _) = ranks
    t = lambda n: torch.as_tensor(d[f"pgo/{n}"])
    edges = GraphEdges(idx=t("idx"), meas=t("meas"),
                       sqrt_info=t("sqrt_info"), etype=t("etype"),
                       mask=t("mask"))
    cfg = dataclasses.replace(PGOConfig(), max_iterations=8)
    one = par_pgo.optimize_distributed(multihost.make_mesh("cpu"), t("poses"),
                                       t("node_mask"), edges, cfg,
                                       preconditioner=pc)
    gt = np.load(os.path.join(ROOT, "tests", "fixtures",
                              "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(gt["odom"], gt["gt"],
                                                    seed=0)
    ate0 = ate_rmse(inst.poses, inst.gt)
    ate_r = ate_rmse(r0[f"pgo.{pc}.poses"], inst.gt)
    ate_1 = ate_rmse(one.poses.numpy(), inst.gt)
    assert abs(ate_r - ate_1) < 1e-2, (ate_r, ate_1)
    assert r0[f"pgo.{pc}.cost"] < r0[f"pgo.{pc}.cost0"]
    if pc != "jacobi":
        assert ate_r < 0.7 * ate0, (ate_r, ate0)
        assert r0[f"pgo.{pc}.cost"] < 0.2 * r0[f"pgo.{pc}.cost0"]
    # one for (g, diag, D, O), one per Hessian-vector product and one for
    # the cost, per LM iteration; the start's cost, the size check and the
    # final comparison of the poses
    assert r0[f"pgo.{pc}.all_reduces"] > 8 * 3


def test_alignment_training_step_matches_one_process(ranks):
    """Two ranks' training step: x [13B, 6] in pair order, equal to each
    rank's share run in one process, and the fit on it.  Against the whole
    batch in one process the CFEAR columns agree to float32 rounding and
    the CorAl columns bit for bit: each pair's plain moments are summed over
    its own live points alone."""
    d, (r0, _) = ranks
    cfg = config(TINY)
    mesh = multihost.make_mesh("cpu")
    args = [get(d, "train/cur_peaks", PointCloud),
            get(d, "train/cur_cells", Cells),
            torch.as_tensor(d["train/cur_poses"]),
            get(d, "train/prev_peaks", PointCloud),
            get(d, "train/prev_cells", Cells),
            torch.as_tensor(d["train/prev_poses"])]
    share = lambda lo, hi: [a.map(lambda x: x[lo:hi]) if hasattr(a, "map")
                            else a[lo:hi] for a in args]
    parts = [par_cand.alignment_training_step(mesh, *share(lo, lo + 2), cfg)
             for lo in (0, 2)]
    x = torch.cat([p[1] for p in parts])
    y = torch.cat([p[2] for p in parts])
    assert r0["train.x"].shape == (13 * 4, 6)
    np.testing.assert_array_equal(r0["train.y"], y.numpy())
    np.testing.assert_array_equal(r0["train.x"], x.numpy())
    model = logistic.fit(x, y, balanced=True)
    np.testing.assert_array_equal(r0["train.coef"], model.coef.numpy())
    _, x_one, y_one = par_cand.alignment_training_step(mesh, *args, cfg)
    np.testing.assert_array_equal(r0["train.y"], y_one.numpy())
    np.testing.assert_allclose(r0["train.x"][:, 3:], x_one[:, 3:].numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(r0["train.x"][:, :3], x_one[:, :3].numpy())
    # the fitted model separates aligned from perturbed pairs
    p = logistic.predict_proba(
        logistic.LogisticModel(torch.as_tensor(r0["train.intercept"]),
                               torch.as_tensor(r0["train.coef"])),
        torch.as_tensor(r0["train.x"])).numpy()
    assert p[r0["train.y"] == 1].mean() > p[r0["train.y"] == 0].mean()


@pytest.mark.parametrize("mode", ["waves", "online"])
def test_loop_closer_on_two_ranks_accepts_the_same_loops(ranks, mode):
    """LoopCloser with a two-rank mesh against one without: the same
    accepted (id_from, id_to) and t_be within the wave tolerance.  The
    waves of 5 pairs become 6 (the last one padded with masked pairs), the
    online schedule's 3 candidates 4, and the online schedule grows the
    sharded database three times."""
    d, (r0, _) = ranks
    want = closers(config(CLOSER), d)
    assert len(want[f"closer.{mode}.ids"]) > 0, "no loops accepted"
    assert r0[f"closer.{mode}.candidates"] == want[f"closer.{mode}.candidates"]
    np.testing.assert_array_equal(r0[f"closer.{mode}.ids"],
                                  want[f"closer.{mode}.ids"])
    np.testing.assert_allclose(r0[f"closer.{mode}.t_be"],
                               want[f"closer.{mode}.t_be"], atol=PAIR_ATOL)


def test_dryrun_on_two_ranks_against_one_process(ranks):
    """The dry run's five steps at tiny sizes (64 nodes, 8 loops, 16
    keyframes a rank) ran on both ranks with every assert of the
    reference's (their results are bit-equal across the ranks,
    test_ranks_return_the_same_results), one sequence and one scan pair a
    rank, and on the CPU no CorAl kernel launched.  Against the same dry
    run in one process (both sequences and pairs, the same inputs): the
    frame's poses, y and the training step's CorAl columns bit-equal, its
    CFEAR columns to float32 rounding and its model at the fit's tolerance
    (test_alignment_training_step_matches_one_process), the pair wave at
    the sharded wave's tolerances, distributed PGO within 1 cm (each rank
    sums its own edges first) and the candidates equal."""
    _, (r0, _) = ranks
    cfg = config(DRYRUN)
    assert r0["dryrun.x"].shape == (13 * RANKS, 6)
    assert r0["dryrun.pose"].shape == (RANKS, 3)
    assert r0["dryrun.index"].shape == (1, cfg.scancontext.n_candidates)
    for pc in ("pgo_chain", "pgo_chain_sharded"):
        assert r0[f"dryrun.{pc}.cost"] < r0[f"dryrun.{pc}.cost0"]
    assert r0["dryrun.launches"].tolist() == [0] * len(dryrun.STEPS)
    one = dryrun_outputs(dryrun.dryrun(multihost.make_mesh("cpu"), cfg,
                                       batch=RANKS, **DRYRUN_SIZES))
    for k in ("pose", "y", "index"):
        np.testing.assert_array_equal(r0[f"dryrun.{k}"], one[f"dryrun.{k}"])
    np.testing.assert_array_equal(r0["dryrun.x"][:, :3],
                                  one["dryrun.x"][:, :3])
    np.testing.assert_allclose(r0["dryrun.x"][:, 3:], one["dryrun.x"][:, 3:],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["dryrun.coef"], one["dryrun.coef"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(r0["dryrun.t_be"], one["dryrun.t_be"],
                               atol=PAIR_ATOL)
    np.testing.assert_allclose(r0["dryrun.cov"], one["dryrun.cov"],
                               rtol=COV_RTOL, atol=COV_ATOL)
    for pc in ("pgo_chain", "pgo_chain_sharded"):
        assert one[f"dryrun.{pc}.cost"] < one[f"dryrun.{pc}.cost0"]
        np.testing.assert_allclose(r0[f"dryrun.{pc}.poses"][:, :2],
                                   one[f"dryrun.{pc}.poses"][:, :2],
                                   atol=1e-2)


def test_multihost_helpers_across_ranks(ranks):
    _, outs = ranks
    for r, o in enumerate(outs):
        assert o["mh.info"].tolist() == [r, RANKS]
        assert o["mh.jobs"].tolist() == list(range(r, 7, RANKS))
        assert float(o["mh.sum"]) == 1.5 + 2.5
        assert int(o["mh.frames"]) == 10 + 20
        assert int(o["mh.hosts"]) == RANKS


def test_edge_shards_pad_uneven_counts():
    """Five edges over two ranks: 3 + 3 rows, the sixth a masked 0 -> 0
    edge of zero weight; over one rank the edges unchanged."""
    e = 5
    edges = GraphEdges(idx=torch.arange(2 * e).reshape(e, 2),
                       meas=torch.ones(e, 3),
                       sqrt_info=torch.eye(3).expand(e, 3, 3) * 2,
                       etype=torch.ones(e, dtype=torch.long),
                       mask=torch.ones(e, dtype=torch.bool))
    shards = [par_pgo._edge_shard(edges, multihost.Mesh(None, r, 2, "cpu"))
              for r in range(2)]
    assert [s.mask.tolist() for s in shards] == [[True] * 3,
                                                 [True, True, False]]
    assert shards[1].idx[-1].tolist() == [0, 0]
    r, _ = posegraph._edge_residuals(torch.zeros(10, 3), shards[1])
    rho, w = posegraph._cauchy_weights(r, shards[1], PGOConfig())
    assert rho[-1] == 0 and w[-1] == 0
    one = par_pgo._edge_shard(edges, multihost.Mesh(None, 0, 1, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(
        dataclasses.astuple(one), dataclasses.astuple(edges)))


def test_rows_need_an_axis_that_divides():
    mesh = multihost.Mesh(None, 1, 2, "cpu")
    assert multihost.rows(6, mesh) == (3, 6)
    with pytest.raises(ValueError, match="divide"):
        multihost.rows(5, mesh)


def test_single_process_collectives_are_the_identity():
    """Without a process group a mesh has size 1 and every collective
    hands its input back; records round-trip their types exactly."""
    mesh = multihost.global_mesh("cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    x = torch.tensor([[1.5, -0.0, float("inf")]])
    assert torch.equal(multihost.psum(x, mesh), x)
    assert torch.equal(multihost.all_gather(x, mesh), x[None])
    assert torch.equal(multihost.broadcast(x, mesh), x)
    rec = lc.DetectResult(
        index=torch.tensor([[3, 2 ** 40]]), aug=torch.tensor([[1, 0]]),
        dist=torch.tensor([[0.1, float("inf")]]),
        dist_sc=torch.tensor([[0.2, 0.3]]), dist_odom=torch.zeros(1, 2),
        yaw=torch.tensor([[1e-7, -2.0]]), valid=torch.tensor([[True, False]]))
    for got in (multihost.gather_record(rec, mesh),
                multihost.broadcast_record(rec, mesh)):
        for a, b in zip(dataclasses.astuple(got), dataclasses.astuple(rec)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    multihost.agree((3, 4), mesh)
    assert mesh.all_reduces == 0


def test_resolve_under_torchrun(monkeypatch):
    """Under torchrun the card is the local rank's, modulo the cards."""
    from tbv_slam_public_torch.core import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert device.resolve(None) == torch.device("cuda", 1)
    assert device.resolve("cpu") == torch.device("cpu")


def test_initialize_without_torchrun_is_a_no_op(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.process_info() == (0, 1)


if __name__ == "__main__":
    main(*sys.argv[1:])
