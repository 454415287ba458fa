#!/usr/bin/env python3
"""Where the port's time goes on the card: one profiled window of odometry
frames, of the offline loop stage and of the online run at the sensor's
size.

Odometry: ``scripts/torch_workload.py``'s sequence (phase 4 of
``chip_smoke.py`` at N = 60 frames), default configuration; after
``--warm`` frames, ``--frames`` frames run under ``torch.profiler`` (CPU
and CUDA activities).  Loop stage: ``run_offline_slam``
(loop closure and cholesky PGO) on that run's checkpoint, once to warm up,
once profiled.  Online: ``TBVSLAM(train_alignment=True)`` over the same
60 frames with a PGO epoch every 5 keyframes, then ``finish`` (``auto``),
once to warm up, once timed without the profiler (frames a second of the
frame loop, host clock after ``synchronize``), once profiled.  For each
window: the profiled wall time, the kernels' device time (the sum of their
self device times), the device's busy share (device time over wall time;
kernels that overlap would count twice, and the port launches on one
stream), the kernel launches and the eight kernels with the most device
time.  One JSON line, then the card's name and power
limit:

    python3 scripts/profile_torch_step.py [--frames 5] [--warm 10]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "scripts"))

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def window(fn):
    """Profile fn(); returns wall s, device ms, busy share, launches and
    the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "self_device_time_total", 0)
               and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        wall_s=wall, device_ms=device_us / 1e3,
        busy_share=device_us / 1e6 / wall,
        launches=sum(e.count for e in events if e.key in LAUNCH_CALLS),
        top=[dict(kernel=e.key[:80], calls=e.count,
                  device_ms=e.self_device_time_total / 1e3) for e in top])


def online_window(seq, cfg, dev) -> dict:
    """The online run over ``seq``: one warm-up run, the frame loop's
    frames a second in a run without the profiler, and a profiled run."""
    import dataclasses

    from tbv_slam_public_torch.models.slam import TBVSLAM

    cfg = dataclasses.replace(
        cfg, pgo=dataclasses.replace(cfg.pgo, optimize_every=5))
    n = len(seq.images)

    def run(timed=None):
        slam = TBVSLAM(cfg, train_alignment=True, device=dev)
        slam.process_frame(seq.images[0], stamp=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n):
            slam.process_frame(seq.images[i], stamp=0.25 * i)
        torch.cuda.synchronize()
        if timed is not None:
            timed.append((n - 1) / (time.perf_counter() - t0))
        slam.finish(optimize=True, solver="auto")
        return slam

    run()
    rate = []
    slam = run(rate)
    res = window(run)
    res.update(frames=n, frames_per_s=rate[0], loops=len(
        slam.loops.constraints), keyframes=len(slam.odometry.kf_poses))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--warm", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    import torch_workload as wl
    from tbv_slam_public_torch.models.odometry import OdometryPipeline
    from tbv_slam_public_torch.models.slam import run_offline_slam

    dev = torch.device("cuda")
    n = 60
    seq = wl.revisiting_sequence(n)
    cfg = wl.sensor_config()
    pipe = OdometryPipeline(cfg, device=dev)
    stop = a.warm + a.frames
    for i in range(a.warm):
        pipe.process(seq.images[i], stamp=0.25 * i)

    def frames():
        for i in range(a.warm, stop):
            pipe.process(seq.images[i], stamp=0.25 * i)

    res = dict(odometry=window(frames))
    res["odometry"]["frames"] = a.frames
    for i in range(stop, n):
        pipe.process(seq.images[i], stamp=0.25 * i)
    g = wl.checkpoint_graph(pipe)
    run_offline_slam(cfg, g, solver="cholesky", device=dev)
    res["loop_stage"] = window(
        lambda: run_offline_slam(cfg, g, solver="cholesky", device=dev))
    res["loop_stage"]["keyframes"] = len(g.kf_poses)
    res["online"] = online_window(seq, cfg, dev)
    print(json.dumps(res))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
