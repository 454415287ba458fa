#!/usr/bin/env python3
"""Trees of the port on one card, in turns: odometry frames/s, kernel
launches of one odometry step, the loop stage's seconds, ms per
distributed-PGO LM step and schur seconds.

Each run is a fresh process on one tree: 29 timed odometry frames at the
sensor's size (400 x 3768, default configuration, after two warm-up
frames), the launches of one more frame (``torch.profiler``), the
offline loop stage (``run_offline_slam``: loop closure and cholesky PGO) on
the checkpoint of a 60-frame sequence that revisits its start (phase 4's
trajectory of ``chip_smoke.py`` at N = 60), ``optimize_distributed`` on a mesh of one over the 4470-node
Oxford instance (64 LM steps, after a 2-step warm-up), and the ``schur``
solver on it.  The order is the other trees, this tree twice, the other
trees backwards, so that drift of the card shows; ``--rounds N`` repeats
that order N times, so that the two trees alternate in repeated pairs.
One JSON line a run, then one with all runs and the card's name and power
limit:

    python3 scripts/ab_torch_trees.py [--rounds N] <other tree> [...]
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ap = argparse.ArgumentParser()
_ap.add_argument("--rounds", type=int, default=1)
_ap.add_argument("trees", nargs="+")
_args = _ap.parse_args()
OTHERS = [os.path.abspath(a) for a in _args.trees]

CHILD = r'''
import json, os, sys, time, dataclasses
import numpy as np, torch
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(1, sys.argv[2])
import torch_workload as wl
import tbv_slam_public_torch
from tbv_slam_public_torch.core.config import PGOConfig
from tbv_slam_public_torch.io import simulate
from tbv_slam_public_torch.models.odometry import OdometryPipeline
from tbv_slam_public_torch.ops import posegraph
from tbv_slam_public_torch.parallel import multihost, pgo
dev = torch.device("cuda")
res = {"tree": root}
seq = wl.revisiting_sequence(31, circle_frames=200)
cfg = wl.sensor_config()
pipe = OdometryPipeline(cfg, device=dev)
pipe.process(seq.images[0]); pipe.process(seq.images[1]); torch.cuda.synchronize()
t0 = time.perf_counter()
for im in seq.images[2:]:
    pipe.process(im)
torch.cuda.synchronize()
res["odometry_frames_per_s"] = (len(seq.images) - 2) / (time.perf_counter() - t0)
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU]) as prof:
    pipe.process(seq.images[-1])
    torch.cuda.synchronize()
res["launches_per_step"] = sum(e.count for e in prof.key_averages() if e.key in (
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
loop_seq = wl.revisiting_sequence(60)
pipe = OdometryPipeline(cfg, device=dev)
for i, im in enumerate(loop_seq.images):
    pipe.process(im, stamp=0.25 * i)
res["loop_stage_s"], slam = wl.loop_stage(cfg, wl.checkpoint_graph(pipe), dev)
res["loop_candidates"] = len(slam.loops.candidate_log)
res["loops"] = int(slam.summary.num_loops)
z = np.load(os.path.join(root, "tests", "fixtures", "oxford_10-12-32_real_odometry.npz"))
inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"], seed=0)
pc = PGOConfig()
m = inst.mask
et = torch.as_tensor(inst.etype[m].astype(np.int64), device=dev)
edges = posegraph.make_edges(inst.idx[m], inst.meas[m], posegraph.default_sqrt_info(et, pc), et, m[m], device=dev)
poses = torch.as_tensor(inst.poses, device=dev)
nodes = torch.ones(len(inst.poses), dtype=torch.bool, device=dev)
mesh = multihost.make_mesh(dev)
pgo.optimize_distributed(mesh, poses, nodes, edges, dataclasses.replace(pc, max_iterations=2))
torch.cuda.synchronize()
t0 = time.perf_counter()
r = pgo.optimize_distributed(mesh, poses, nodes, edges, pc)
torch.cuda.synchronize()
res["pgo_ms_per_lm_step"] = 1e3 * (time.perf_counter() - t0) / pc.max_iterations
res["pgo_iterations"] = int(r.iterations)
t0 = time.perf_counter()
n_loop = int((edges.mask & ~posegraph._is_chain(edges)).sum())
r = posegraph.optimize(poses, nodes, edges, pc, solver="schur", loop_cap=n_loop)
torch.cuda.synchronize()
res["schur_s"] = time.perf_counter() - t0
print("RESULT " + json.dumps(res))
'''

out = []
for tree in (OTHERS + [ROOT, ROOT] + OTHERS[::-1]) * _args.rounds:
    p = subprocess.run([sys.executable, "-c", CHILD, tree,
                        os.path.join(ROOT, "scripts")],
                       capture_output=True, text=True, timeout=600)
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT ")]
    if p.returncode or not line:
        print(p.stdout[-2000:], p.stderr[-4000:])
        raise SystemExit(1)
    out.append(json.loads(line[0][7:]))
    print(line[0], flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print(json.dumps(dict(card=smi, runs=out)))
