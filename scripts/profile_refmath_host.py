#!/usr/bin/env python3
"""Host time of one refmath op call and one ``coral_tail`` call on the card.

For ``kernels/refmath.py``'s ``exp`` (4,096 values; also ``fma`` with a
broadcast operand and ``sincos``) and ``torch.exp`` on the same tensor: the
microseconds the host spends a call over ``--calls`` calls, then the same
calls under ``cProfile``, whose heaviest functions by own time are printed;
then ``coral_tail`` at an online loop closure's shape (12 pairs of
4,096-slot clouds).  The device's queue is drained every 500 calls, so the
host's enqueue is what is timed.  One JSON line at the end, beside the
card's name and power limit:

    python3 scripts/profile_refmath_host.py [--calls 10000]
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_call_us(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(0, calls, 500):
        t0 = time.perf_counter()
        for _ in range(min(500, calls - i)):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / calls * 1e6


def top(fn, calls: int, rows: int = 12) -> str:
    import torch

    prof = cProfile.Profile()
    prof.enable()
    for i in range(calls):
        fn()
        if i % 500 == 499:
            torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(rows)
    return out.getvalue()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10000)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.ops import coral

    dev = torch.device("cuda")
    x = torch.empty(4096, device=dev).uniform_(-10, 10)
    y = torch.empty(1, device=dev).uniform_(-10, 10)
    calls = {"refmath.exp": lambda: rm.exp(x), "torch.exp": lambda: torch.exp(x),
             "refmath.fma_broadcast": lambda: rm.fma(x, y, y),
             "torch.addcmul_broadcast": lambda: torch.addcmul(y, x, y),
             "refmath.sincos": lambda: rm.sincos(x)}
    rng = np.random.default_rng(31)
    t = lambda v: torch.as_tensor(v, device=dev)
    sm, rm_ = (t(rng.uniform(size=(12, 4096)) < 0.8) for _ in range(2))
    xy = rng.uniform(-15, 15, (12, 4096, 2)).astype(np.float32)
    moments = cm.pair_moments(t(xy), sm, t(xy + 0.1), rm_, 1.0)
    calls["coral_tail"] = lambda: coral.coral_tail(*moments, sm, rm_, 1e-8,
                                                   "entropy")
    result = {}
    for name, fn in calls.items():
        n = a.calls if name != "coral_tail" else a.calls // 10
        result[name] = per_call_us(fn, n)
        print(f"{name}: {result[name]:.2f} us a call (host)", flush=True)
        if name in ("refmath.exp", "coral_tail"):
            print(top(fn, n), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "host_us": result}))


if __name__ == "__main__":
    main()
