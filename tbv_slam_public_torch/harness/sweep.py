"""Parameter-sweep job farm + result aggregation.

Rebuild of the reference experiment harness (tbv_slam/python/eval.py:1-60 and
merge_eval.py): a parameter file lists one flag per row with one or more
values; jobs are the cartesian product; each job runs the pipeline into its
own ``job_<k>`` directory; results are merged into one CSV table.

Parameter-file format (the reference's script/pars/*.csv convention):

    radar.k_strongest,12,40
    registration.cost,P2L,P2P

-> 4 jobs.  Lines starting with '#' are comments.

Port of ``tbv_slam_public_tpu.harness.sweep``.  Jobs run in worker
subprocesses (``python -m tbv_slam_public_torch.harness.cli``), the analogue
of the reference's multiprocessing Pool of rosrun invocations; with
``workers=1`` they run in this process, one after the other, sharing its
loaded kernel library.  ``device`` is passed on to every job as
``--device`` (the card when it is None).
"""
from __future__ import annotations

import csv
import itertools
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple


def read_par_file(path: str) -> List[List[str]]:
    """Parameter rows -> list of ``key=value`` token lists (one per job)."""
    keys: List[str] = []
    values: List[List[str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",") if p.strip()]
            if len(parts) < 2:
                continue
            keys.append(parts[0])
            values.append(parts[1:])
    jobs = []
    for combo in itertools.product(*values):
        jobs.append([f"{k}={v}" for k, v in zip(keys, combo)])
    return jobs


def _job_argv(mode: str, dataset: str, outdir: str, overrides: List[str],
              max_frames: int, device: Optional[str]) -> List[str]:
    argv = [mode, "--dataset", dataset, "--output", outdir]
    if max_frames:
        argv += ["--max-frames", str(max_frames)]
    if device:
        argv += ["--device", str(device)]
    return argv + overrides


def _run_job_inprocess(*job) -> Dict:
    from . import cli

    argv = _job_argv(*job)
    import contextlib
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def _run_job_subprocess(*job) -> Dict:
    argv = [sys.executable, "-m", "tbv_slam_public_torch.harness.cli"] \
        + _job_argv(*job)
    out = subprocess.run(argv, capture_output=True, text=True, check=True)
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def run_sweep(par_file: str, dataset: str, output: str,
              base_overrides: Optional[List[str]] = None, workers: int = 1,
              max_frames: int = 0, mode: str = "online",
              device: Optional[str] = None) -> List[Dict]:
    """Run the cartesian sweep; returns per-job summary dicts and writes
    ``merged.csv`` (merge_eval.py analogue) plus ``sweep_report.json``.

    Multi-host (SURVEY §2.6 P6): when launched under ``torchrun`` (one
    process per host) with a process group initialised
    (:func:`parallel.multihost.initialize`), the job list is round-robin
    partitioned across processes via :func:`parallel.multihost.my_jobs` —
    each process runs and merges only its share, the eval.py job farm spread
    over machines instead of local processes.  Single-process runs take
    every job.
    """
    import time as _time

    from ..parallel import multihost

    jobs = read_par_file(par_file)
    os.makedirs(output, exist_ok=True)
    results: List[Dict] = []
    my_job_ids = multihost.my_jobs(list(range(len(jobs))))
    t0 = _time.perf_counter()

    def job_args(k: int) -> Tuple[str, str, str, List[str], int,
                                  Optional[str]]:
        outdir = os.path.join(output, f"job_{k}")
        overrides = (base_overrides or []) + jobs[k]
        return (mode, dataset, outdir, overrides, max_frames, device)

    if workers <= 1:
        for k in my_job_ids:
            res = _run_job_inprocess(*job_args(k))
            res["job"] = k
            res["pars"] = " ".join(jobs[k])
            results.append(res)
    else:
        from concurrent.futures import ProcessPoolExecutor
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            futs = {k: ex.submit(_run_job_subprocess, *job_args(k))
                    for k in my_job_ids}
            for k, fut in futs.items():
                res = fut.result()
                res["job"] = k
                res["pars"] = " ".join(jobs[k])
                results.append(res)

    # cross-host throughput bookkeeping (scaling_report aggregates the
    # per-host job counts; single-process: hosts=1, all jobs local)
    report = multihost.scaling_report(len(results),
                                      _time.perf_counter() - t0)
    report["total_jobs"] = len(jobs)
    report["my_jobs"] = list(my_job_ids)
    with open(os.path.join(output, "sweep_report.json"), "w") as f:
        json.dump(report, f)

    # merged.csv: union of keys over all jobs
    keys = sorted({k for r in results for k in r.keys()})
    with open(os.path.join(output, "merged.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for r in results:
            w.writerow(r)
    return results
