"""One odometry frame at the sensor's size, and the multi-rank dry run.

Counterparts of the JAX package's ``__graft_entry__.py``: :func:`entry`
returns one CFEAR odometry frame step at Oxford's 400 x 3768 and its
arguments, on the card; :func:`dryrun` runs the five steps of the JAX
package's multi-device dry run (``dryrun_multichip``) over a mesh of ranks,
at its shapes, with its configuration and its seeded inputs:

0. one batched odometry frame on full-size uint8 polar images from a
   fresh state, one sequence a rank (``parallel.odometry``; as in the
   reference, the frame meets an empty keyframe window, so it runs the
   detector and the features and registers against nothing);
1. the data-parallel alignment-classifier training step;
2. a loop-candidate pair wave with the sampled covariance, one pair a rank;
3. edge-sharded distributed PGO on a two-lap 1024-node, 64-loop graph, with
   the ``chain`` and the ``chain_sharded`` preconditioner;
4. candidate detection over a keyframe database of 128 slots a rank,
   sharded over the ranks.

Each step asserts what the reference's asserts.  :func:`draw_inputs`
makes the seeded inputs alone, so that both packages can be fed them.  Run it on every rank
under ``torchrun`` (one rank a card with NCCL; ``--backend gloo`` lets
ranks share a card):

    torchrun --standalone --nproc-per-node=2 \\
        -m tbv_slam_public_torch.harness.dryrun [--backend gloo]

which prints one JSON line per rank with each step's seconds and CorAl
kernel launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from ..core.config import (FeatureConfig, PGOConfig, RadarConfig,
                           RegistrationConfig, TBVConfig, VerificationConfig)
from ..core.device import resolve
from ..core.types import LOOP_APPEARANCE, ODOMETRY, Cells, PointCloud
from ..kernels import coral_moments
from ..models import loopclosure as lc
from ..models import odometry
from ..ops import logistic, posegraph
from ..parallel import candidates as par_cand
from ..parallel import multihost
from ..parallel import odometry as par_odo
from ..parallel import pgo as par_pgo
from ..parallel import retrieval as par_ret

STEPS = ("odometry", "training", "pair_wave", "pgo_chain",
         "pgo_chain_sharded", "retrieval")


def oxford_config() -> TBVConfig:
    """The configuration of ``entry``: the Oxford radar (400 x 3768), 512
    cells, P2L with weight option 4."""
    return TBVConfig(
        radar=RadarConfig(),
        features=FeatureConfig(cell_capacity=512),
        registration=RegistrationConfig(cost="P2L", weight_option=4))


def dryrun_config() -> TBVConfig:
    """The dry run's configuration: ``oxford_config`` with 1024 verification
    peaks and two LM steps of 8 CG iterations."""
    return dataclasses.replace(
        oxford_config(), verification=VerificationConfig(peaks_capacity=1024),
        pgo=PGOConfig(max_iterations=2, cg_iterations=8))


def entry(device=None):
    """(fn, args): one odometry frame ``fn(state, image) -> (state, out)`` of
    ``oxford_config`` and its arguments, an initial state and a zero image,
    on the card unless ``device`` says otherwise."""
    cfg = oxford_config()
    dev = resolve(device)
    state = odometry.init_state(cfg, dev)
    image = torch.zeros((cfg.radar.num_azimuths, cfg.radar.num_range_bins),
                        dtype=torch.uint8, device=dev)

    def step(state, image):
        return odometry.odometry_step(state, image, cfg)

    return step, (state, image)


# -- the reference's seeded inputs, drawn in its order -----------------------

def rand_cloud(rng: np.random.Generator, cap: int) -> dict:
    """A fully live cloud of ``cap`` points, uniform in 160 m x 160 m, as the
    reference's ``rand_cloud`` draws it (numpy arrays by field)."""
    return dict(xy=rng.uniform(-80, 80, (cap, 2)).astype(np.float32),
                intensity=rng.uniform(60, 200, (cap,)).astype(np.float32),
                mask=np.ones((cap,), bool))


def rand_cells(rng: np.random.Generator, cap: int) -> dict:
    """``cap`` valid cells with random unit normals and means, as the
    reference's ``rand_cells`` draws them."""
    nrm = rng.normal(size=(cap, 2))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return dict(
        mean=rng.uniform(-80, 80, (cap, 2)).astype(np.float32),
        cov=np.broadcast_to(0.1 * np.eye(2, dtype=np.float32),
                            (cap, 2, 2)).copy(),
        normal=nrm.astype(np.float32),
        nsamples=np.full((cap,), 10.0, np.float32),
        planarity=np.ones((cap,), np.float32),
        avg_intensity=np.full((cap,), 100.0, np.float32),
        valid=np.ones((cap,), bool))


def stacked(make, n: int) -> dict:
    """``n`` draws of ``make()`` stacked field by field."""
    draws = [make() for _ in range(n)]
    return {k: np.stack([d[k] for d in draws]) for k in draws[0]}


def loop_graph(rng: np.random.Generator, n_nodes: int, n_loops: int,
               n_ranks: int, cfg: PGOConfig):
    """The reference's two-lap graph: a chain of ``n_nodes`` plus
    ``n_loops`` loop edges between the laps, edges padded with masked slots
    to a multiple of 8 a rank; the poses are the truth plus 5 cm of noise,
    the first pose exact.  Returns (poses [N, 3], edge arrays)."""
    e = n_nodes - 1 + n_loops
    e_cap = -(-e // (8 * n_ranks)) * (8 * n_ranks)
    gt = np.zeros((n_nodes, 3), np.float32)
    a = 2 * np.pi * np.arange(n_nodes) / (n_nodes / 2)
    r_c = n_nodes * 1.5 / (4 * np.pi)
    gt[:, 0] = r_c * np.cos(a)
    gt[:, 1] = r_c * np.sin(a)
    gt[:, 2] = np.arctan2(np.cos(a), -np.sin(a))
    poses = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    poses[0] = gt[0]
    idx = np.zeros((e_cap, 2), np.int64)
    meas = np.zeros((e_cap, 3), np.float32)
    etype = np.zeros((e_cap,), np.int64)
    mask = np.zeros((e_cap,), bool)

    def rel(p, q):
        c, s = np.cos(p[2]), np.sin(p[2])
        d = q[:2] - p[:2]
        th = (q[2] - p[2] + np.pi) % (2 * np.pi) - np.pi
        return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1], th],
                          np.float32)

    for i in range(n_nodes - 1):
        idx[i], meas[i], etype[i], mask[i] = (i, i + 1), \
            rel(gt[i], gt[i + 1]), ODOMETRY, True
    half = n_nodes // 2
    for k in range(n_loops):
        j = n_nodes - 1 + k
        a_, b_ = half + k * (half // n_loops), k * (half // n_loops)
        idx[j], meas[j], etype[j], mask[j] = (a_, b_), \
            rel(gt[a_], gt[b_]), LOOP_APPEARANCE, True
    sqrt_info = posegraph.default_sqrt_info(torch.as_tensor(etype),
                                            cfg).numpy()
    return poses, (idx, meas, sqrt_info, etype, mask)


def draw_inputs(cfg: TBVConfig, b: int, n_nodes: int = 1024,
                n_loops: int = 64, keyframes_per_rank: int = 128,
                seed: int = 0) -> dict:
    """The dry run's inputs for ``b`` sequences, scan pairs and candidate
    pairs, as NumPy arrays drawn from ``np.random.default_rng(seed)`` in the
    order the JAX package's dry run draws them: the [b, A, R] images, the
    training step's (cur peaks, cur cells, prev peaks, prev cells), the pair
    wave's (query cells, query peaks, candidate cells, candidate peaks), the
    graph (``loop_graph``), the database's descriptors and trajectory."""
    rng = np.random.default_rng(seed)
    cap_p, cap_c = cfg.verification.peaks_capacity, cfg.features.cell_capacity
    cloud = lambda: stacked(lambda: rand_cloud(rng, cap_p), b)
    cells = lambda: stacked(lambda: rand_cells(rng, cap_c), b)
    sc = cfg.scancontext
    cap_db = keyframes_per_rank * b
    inp = {"images": rng.integers(0, 255, (b, cfg.radar.num_azimuths,
                                           cfg.radar.num_range_bins),
                                  dtype=np.uint8)}
    inp["training"] = (cloud(), cells(), cloud(), cells())
    inp["pair_wave"] = (cells(), cloud(), cells(), cloud())
    inp["graph"] = loop_graph(rng, n_nodes, n_loops, b, cfg.pgo)
    inp["descs"] = rng.uniform(0, 2, (cap_db, sc.num_ring, sc.num_sector)
                               ).astype(np.float32)
    inp["traj"] = np.cumsum(rng.uniform(1.0, 2.0, (cap_db, 3)),
                            0).astype(np.float32)
    return inp


# -- the dry run -------------------------------------------------------------

def _timed(mesh, record, name, fn):
    """Run ``fn`` and record its seconds (after a device synchronisation)
    and the CorAl kernel launches it made."""
    launches = coral_moments.LAUNCHES
    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    record[name] = dict(s=time.perf_counter() - t0,
                        launches=coral_moments.LAUNCHES - launches)
    return out


def dryrun(mesh: multihost.Mesh, cfg: Optional[TBVConfig] = None,
           n_nodes: int = 1024, n_loops: int = 64,
           keyframes_per_rank: int = 128, seed: int = 0,
           batch: Optional[int] = None) -> dict:
    """The five steps of the multi-device dry run on ``mesh``, on
    ``draw_inputs``' arrays for ``batch`` sequences, scan pairs and
    candidate pairs (by default the mesh size: one a rank, as the
    reference; a multiple of it).  Every rank passes the same inputs.
    Returns {step: {"s": seconds, "launches": CorAl launches}} and, under
    "out", each step's result, the same on every rank."""
    cfg = cfg or dryrun_config()
    dev = mesh.device
    b = batch or mesh.size
    inp = draw_inputs(cfg, b, n_nodes, n_loops, keyframes_per_rank, seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    rec = lambda cls, arrays: cls(**{k: t(v) for k, v in arrays.items()})
    record, out = {}, {}

    # 0) one batched odometry frame on full-size polar images from a fresh
    # state, one sequence a rank
    imgs = t(inp["images"])

    def odo():
        state = par_odo.init_state(cfg, b, mesh)
        return par_odo.batched_odometry_step(mesh, state, imgs, cfg)[1]

    res = _timed(mesh, record, "odometry", odo)
    assert res.pose.shape == (b, 3) and bool(torch.isfinite(res.pose).all())
    out["odometry"] = res

    # 1) data-parallel alignment-classifier training step
    zeros = torch.zeros((b, 3), device=dev)
    cur_p, cur_c, prev_p, prev_c = inp["training"]
    args = (rec(PointCloud, cur_p), rec(Cells, cur_c), zeros,
            rec(PointCloud, prev_p), rec(Cells, prev_c), zeros)
    model, x, y = _timed(mesh, record, "training",
                         lambda: par_cand.alignment_training_step(
                             mesh, *args, cfg))
    assert x.shape == (13 * b, 6) and bool(torch.isfinite(x).all())
    out["training"] = (model, x, y)

    # 2) a loop-candidate pair wave with the sampled per-pair covariance
    v = cfg.verification
    loop_model = logistic.from_values(v.loop_coefs[0], v.loop_coefs[1:],
                                      device=dev)
    q_c, q_p, c_c, c_p = inp["pair_wave"]
    pair_args = (rec(Cells, q_c), rec(PointCloud, q_p), rec(Cells, c_c),
                 rec(PointCloud, c_p), zeros, torch.zeros(b, device=dev),
                 torch.full((b,), 0.2, device=dev),
                 torch.full((b,), 0.1, device=dev),
                 torch.ones(b, dtype=torch.bool, device=dev))
    wave = _timed(mesh, record, "pair_wave",
                  lambda: par_cand.sharded_register_and_verify_pairs(
                      mesh, *pair_args, model, loop_model, cfg))
    assert wave.cov.shape == (b, 3, 3)
    out["pair_wave"] = wave

    # 3) edge-sharded distributed PGO, chain and segment-sharded chain
    poses, arrays = inp["graph"]
    edges = posegraph.make_edges(*arrays, device=dev)
    poses_t = t(poses)
    node_mask = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    for pc in ("chain", "chain_sharded"):
        res = _timed(mesh, record, f"pgo_{pc}",
                     lambda: par_pgo.optimize_distributed(
                         mesh, poses_t, node_mask, edges, cfg.pgo,
                         preconditioner=pc))
        assert float(res.cost) <= float(res.cost0), (pc, res.cost, res.cost0)
        out[f"pgo_{pc}"] = res

    # 4) detection over a keyframe database sharded over the ranks
    sc = cfg.scancontext
    descs, traj = t(inp["descs"]), t(inp["traj"])
    cap_db = descs.shape[0]

    def retrieval():
        db = lc.db_insert_batch(lc.make_db(cap_db, cfg, device=dev),
                                torch.arange(cap_db, device=dev), descs,
                                descs.mean(-1), traj)
        db = par_ret.shard_db(mesh, db)
        a = 1 + (len(sc.augment_offsets) if sc.augment_sc else 0)
        q = torch.stack([descs[3] + 0.01 * k for k in range(a)])
        return lc.detect(db, q[None], q.mean(-1)[None],
                         torch.tensor([cap_db - 1], device=dev), cfg,
                         mesh=mesh)

    det = _timed(mesh, record, "retrieval", retrieval)
    assert det.index.shape == (1, sc.n_candidates)
    out["retrieval"] = det
    record["out"] = out
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", default=None,
                   help="process-group backend (default: nccl on the card)")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    multihost.initialize(backend=a.backend, device=a.device)
    mesh = multihost.global_mesh(a.device)
    rec = dryrun(mesh)
    print(json.dumps({"rank": mesh.rank, "size": mesh.size,
                      "device": str(mesh.device),
                      **{k: rec[k] for k in STEPS}}))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
