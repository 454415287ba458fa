"""How often a ``torch.profiler`` window on the card comes back without the
device time of the kernel it profiled.

A run is a fresh process on one tree (its package and its ``chip_smoke.py``
first on ``sys.path``): the registration kernel's evaluation entry, a
sampled covariance at ``chip_smoke.py``'s ``training`` shape (13 rows, 512
cells, the CFEAR feature's configuration), then ``--windows`` profiled
windows of 10 calls each, taken as ``chip_smoke.py``'s
``device_us_by_kernel`` takes one.  A window is ``full`` (the evaluation
kernel's device time seen), ``partial`` (device time of other kernels
only) or ``empty`` (no device time).  ``TREE:chains`` first runs
``chip_smoke.py``'s phase of the refmath chains (each chain's description
uploaded once from pinned host memory by a non-blocking copy), which runs
before the evaluation phase in ``chip_smoke.py``; ``TREE:plain`` first times
the plain sampled covariance on the card, as the phase does just before it
profiles the kernel; ``TREE:profiled-plain`` profiles one window first, then
times the plain version (as ``chip_smoke.py`` does between two of its
profiled windows); ``TREE:profiled-launches`` profiles one window, then
makes 70,000 one-element launches outside the profiler;
``TREE:sync-debug`` makes one call under
``torch.cuda.set_sync_debug_mode("error")`` first (as the evaluation phase
does before it times a shape); ``TREE:registration`` first runs
``chip_smoke.py``'s registration phase (2b's window and solve entries,
with their own profiled windows), which precedes the evaluation phase.
The runs go in the order given, then backwards.  One
JSON line a run, then one with all runs and the card's name and power
limit:

    python3 scripts/probe_profiler.py [--windows 40] TREE[:PRELUDE] ...
"""
import argparse
import json
import os
import subprocess
import sys


def worker(tree: str, prelude: str, windows: int) -> dict:
    sys.path[:0] = [tree, os.path.join(tree, "scripts")]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import torch_workload as wl
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    dev = torch.device("cuda")
    cs.phase_build()
    if prelude == "chains":
        cs.phase_chains(wl.sensor_config())
    if prelude == "registration":
        cs.phase_registration()
    rng = np.random.default_rng(23)
    prob = window_problem(rng, 13, 1, 512, 512)
    cfg = cs._eval_cfg("cfear")
    args = cs._window_case(prob, dev, cfg)[0][:5]
    cost, n_res = treg.evaluate_cost(*args, cfg)
    score = cost.clone()
    call = lambda: treg.sampled_covariance(*args, cfg, score, n_res)

    def plain():
        with lk.plain_on_card():
            return call()

    if prelude.startswith("profiled"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            call()
            torch.cuda.synchronize()
    if prelude.endswith("plain"):
        cs.cuda_ms(plain, 2)
    if prelude == "sync-debug":
        call()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if prelude.endswith("launches"):
        x = torch.zeros(1, device=dev)
        for _ in range(70_000):
            x.add_(1.0)
        torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    counts = dict(full=0, partial=0, empty=0)
    sequence = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_time_total > 0]
        kind = "full" if any("evaluation_kernel" in k for k in names) \
            else "partial" if names else "empty"
        counts[kind] += 1
        sequence.append(kind[0])
    return dict(tree=tree, prelude=prelude, windows=windows,
                torch=torch.__version__, sequence="".join(sequence),
                **counts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("runs", nargs="+", metavar="TREE[:PRELUDE]")
    a = ap.parse_args()
    if a.worker:
        tree, _, prelude = a.runs[0].partition(":")
        print(json.dumps(worker(os.path.abspath(tree), prelude, a.windows)),
              flush=True)
        return 0
    results = []
    for run in a.runs + a.runs[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", "--windows", str(a.windows), run],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-3000:] + out.stderr[-3000:])
            raise SystemExit(f"{run}: exit {out.returncode}")
        results.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps(dict(card=smi, runs=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
