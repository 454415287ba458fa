#!/usr/bin/env python3
"""Where a ``register_window`` launch spends its cycles, link by link.

Builds the package's kernel library with ``-DTBV_STAGE_CLOCKS`` into its
own directory (``build/tbv_torch_kernels_clocks/``; the package never loads
that build), in which thread 0 of the launch's first CTA adds the SM cycles
(``clock64``) between its stamps to one counter a stage of
``csrc/lm_solve.cu``'s ``Stage``: the association's staging and search,
the candidates' step, the barrier that publishes them, the sine and cosine,
the leaves, the warp reduction, the tree over the warps, the cluster
barrier, the top of the tree, the finish and accept, the outer guards.
Then it runs ``register_window`` at the odometry's shape (B = 1 and 4,
T = 4, C = 512, P2P, 20 inner iterations) and at an offline loop wave's
(B = 64, T = 1, C = 512, P2L, 10 inner), ``kernels/checks.py::
window_problem`` from seed 17, 8 outer iterations, and prints one JSON line
a shape (cycles a call and a pass over the records by stage, passes,
candidates and associations a call, the call's device time by CUDA events)
and the card's name, power limit and SM clock.  Thread 0 waits at every
barrier, so a barrier's cycles are its own plus the slowest thread's work
before it.

A tree other than this one (``--tree build/<name>``, its package first on
``sys.path``) must carry the same stamps and ``lm_stage_clocks`` entry.

    python3 scripts/lm_stage_clocks.py [--reps 20] [--cluster K]
        [--shapes odometry,odometry_b4,loop_wave] [--tree DIR]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = ["assoc_stage", "assoc_search", "candidate", "candidate_sync",
          "sincos", "leaves", "shuffle", "cta_tree", "cluster_sync",
          "top_tree", "finish", "guards"]
COUNTERS = {28: "passes", 29: "candidates", 30: "associations", 31: "calls"}
SHAPES = {"odometry": (1, 4, 512, "P2P", 20),
          "odometry_b4": (4, 4, 512, "P2P", 20),
          "loop_wave": (64, 1, 512, "P2L", 10)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cluster", type=int, default=0,
                    help="force the CTAs a row (default: the chooser's)")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--tree", default=ROOT,
                    help="the package tree to measure (default: this one)")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import numpy as np
    import torch

    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.core.types import Cells
    from tbv_slam_public_torch.kernels import build
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    if not torch.cuda.is_available():
        raise SystemExit("lm_stage_clocks: no CUDA card")
    build.BUILD_DIR = os.path.join(ROOT, "build", "tbv_torch_kernels_clocks")
    build.NVCC_FLAGS = build.NVCC_FLAGS + ["-DTBV_STAGE_CLOCKS"]
    lib = build.library()
    lib.lm_stage_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.lm_stage_clocks.restype = ctypes.c_int
    counters = (ctypes.c_ulonglong * 32)()

    def read():
        torch.cuda.synchronize()
        err = lib.lm_stage_clocks(counters)
        if err != 0:
            raise RuntimeError(f"lm_stage_clocks: CUDA error {err}")
        return list(counters)

    if a.cluster:
        lk.cluster_size = lambda *args, **kw: a.cluster
    dev = torch.device("cuda")
    for name in a.shapes.split(","):
        b, t, c, cost, inner = SHAPES[name]
        prob = window_problem(np.random.default_rng(17), b, t, c, c)
        f = lambda k: torch.as_tensor(prob[k], device=dev)

        def cells(side):
            g = lambda k: f(f"{side}_{k}")
            return Cells(mean=g("mean"), cov=g("cov"), normal=g("normal"),
                         nsamples=g("nsamples"), planarity=g("planarity"),
                         avg_intensity=torch.zeros_like(g("nsamples")),
                         valid=g("valid"))

        cfg = RegistrationConfig(cost=cost, max_inner_iterations=inner,
                                 max_outer_iterations=8)
        args = (cells("src"), f("pose0"), cells("tgt"), f("tgt_poses"),
                f("scan_mask"), cfg)
        res = treg.register_window(*args)  # builds, warms up
        read()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(a.reps):
            treg.register_window(*args)
        t1.record()
        got = read()
        calls = max(got[31], 1)
        passes = max(got[28], 1)
        out = dict(tree=a.tree, shape=name, B=b, T=t, C=c, cost=cost,
                   inner=inner,
                   K=a.cluster or lk.cluster_size(
                       b, t, c, c, treg.cost_code(cost), True),
                   iterations=res.iterations.tolist()[:8],
                   events_ms=t0.elapsed_time(t1) / a.reps,
                   cycles_a_call={s: got[i] / calls
                                  for i, s in enumerate(STAGES)},
                   cycles_a_pass={s: got[i] / passes
                                  for i, s in enumerate(STAGES)},
                   **{v: got[k] / calls for k, v in COUNTERS.items()
                      if k != 31},
                   total_cycles_a_call=sum(got[:len(STAGES)]) / calls)
        print(json.dumps(out), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}))


if __name__ == "__main__":
    main()
