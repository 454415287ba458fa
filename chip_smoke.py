#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``tbv_slam_public_torch``).

Needs one CUDA card.  Phases, each of which raises on failure:

1. device and kernel build (nvcc, sm_90a);
2. every kernel of the main path against its plain PyTorch version on the
   card, at the main path's shapes and at the edges of its tiling, two
   launches bit-equal, with the times of the kernel, of its plain version
   and of the host around a call; the refmath kernel (the reference's exp,
   log, log1p, sigmoid, sincos, atan2, angle wrap, fma, sqrt, ordered
   dot, the logistic gradient's loop-ordered sum, the LM step and the
   logistic fit's solve in LAPACK's order) bit-equal to its plain version
   on 2^22 values an op (the solve on 3000 systems at each size), timed at
   1, 4096 and 2^19 values (the solve at one 7 x 7 system) beside its
   plain version and the torch call it replaces; ``ceres_covariance``
   (the Ceres-style covariance after its Hessian: the reference's 3 x 3
   eigenvalues and guarded inverse, a thread a row) bit-equal to its plain
   version on the CPU on 2^16 Hessians of every kind with no host
   synchronisation, timed at 1 and 4,096 rows beside its plain version and
   the ``torch.linalg`` path it replaced; its site entries (se2's
   compose, inverse, relative, apply, rotate, interpolate and rotmat,
   ``norm2``, registration's world-frame targets, the motion compensation:
   one launch a site) and ``cumsum`` (``detect``'s travelled distance in
   the reference's blocked order) bit-equal to their plain versions on the
   CPU on 2^20 elements a site with special values, each timed at its
   path's shape beside its op-by-op body on the card and the host's time a
   call; its chains (the odometry frame's pose tail, the frame's two motion
   compensations, the loop pairs' guess, the local map's relative pose and
   apply, the verification pairs' two applies: one launch a chain of
   sites) bit-equal to their plain versions on the CPU on about 2^18
   elements a chain with special values, one launch a call, each timed at
   its path's shape in turns against its sites one launch each, with the
   host's time a call for both, its plain version on the card and its
   bound; and on every path below that runs in this process (and on
   each rank of 10(b)), its count set to 0 just before the path and read
   just after, then the first operands and result of each op, site and
   shapes that the path gave it held bit for bit to the plain version (a
   chain at each shape and stride); the
   registration kernel (phase 2b): its window entry (``register_window``,
   one launch a call: association, LM solve and outer guards) bit-equal
   to the plain ``register_window`` on the card over every cost x loss x
   prior (one_system and the weight option 0-4 in turn) at the paths'
   shapes (odometry at B = 1 and 4, an online and an offline loop wave,
   cell_capacity 2048 with P2D), at forced cluster sizes 1, 2, 4 and 8 and
   forced candidates a pass 1-4 (a run of LM rejections evaluated in one
   pass), 10 and 20 inner iterations, a row of NaN costs among them, one
   window launch and no refmath launch a call at 1 and 8 outer iterations
   (the targets placed in the world inside it), its passes over the
   records against the serial loop's, timed in turns against the plain
   path beside its bound; its solve entry (``register_joint``'s LM solves)
   bit-equal to the plain solve over every cost x loss x prior x
   one_system, and on rows that stress the schedule (every candidate
   rejected, accepts at a pass's last slot, NaN costs; 7, 10 and 20
   iterations, 1-4 candidates a pass); its evaluation
   entry (``evaluate_cost`` and ``sampled_covariance``, one launch a call:
   one association, the cost at all S poses over it in one pass, the
   sampled covariance's fit, its 3 x 3 covariance and convexity) bit-equal
   to the plain versions over every cost x loss, the CFEAR feature's and
   the loop registration's configurations at the paths' shapes (an offline
   and an online loop wave, a training pair, an evaluate-scans pair, the
   odometry window) and at forced cluster sizes, a sampled covariance
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   synchronisation, no launch but the entry's), timed in turns against the
   plain path beside its bound; no ``world_targets`` site launch on the
   paths whose registration is these entries';
   ``coral_tail`` (phase 2c: CorAl's per-point terms and the pairs' sums
   after the moments, one launch a ``coral_quality``) bit-equal to its
   plain version given the same moments in both modes at the paths'
   shapes, timed in turns against the plain tail beside its bound; and on
   every path below, as refmath, counted and held at each shape the path
   gave it;
3. the port's CLI: ``odometry`` then ``slam`` (default solver, and again
   with ``--solver cholesky``) on a small simulated sequence, then
   ``evaluate-scans`` on that checkpoint (in this process, with its kernel
   launch count) and ``baseline`` over the two ``slam`` runs;
4. the offline slice at the sensor's size (400 azimuths x 3768 bins at
   0.0438 m, default config): odometry per frame -> simple_graph save/load
   -> loop closure with CorAl verification -> cholesky PGO, with the kernel
   launch count of that run; its first 20 frames again with the
   registration kernel and with the plain registration on the card,
   bit-equal; then the
   kernel's time on that run's keyframe clouds; then (4c) the cell_stats
   kernel (``compute_cells`` after the top-C selection, one launch a
   cloud) bit-equal to its plain version on the card on phase 4's
   k-strongest clouds, the CA-CFAR and BFAR clouds, MulRan's shapes, the
   cfear3_oxford preset's 16,000-point clouds, clouds of 32,000 points
   (beyond the staged design's shared memory: the global-memory design)
   and clouds with a point within an ulp of each cell's radius, the cells
   that differ from the CPU's plain version counted on phase 4's clouds,
   and its time at phase 4's, the preset's and the large clouds' shapes
   beside the plain version and its bound; on
   every path, as refmath,
   its launches counted and its first call at each shape held;
5. cholesky PGO on the 4470-node Oxford real-odometry instance;
6. the ``schur`` and ``cg`` solvers on that instance beside ``cholesky``
   (``schur`` twice, bit-equal: the edge sums add in index order), and one
   ``_schur_solve`` step against a float64 dense solve of the same damped
   system;
7. the online path at the sensor's size: ``TBVSLAM`` with in-run alignment
   training and periodic PGO epochs over the phase-4 frames, with the kernel
   launch counts of the training route and of the per-keyframe loop closure;
   the kernel against its plain version, and its time, on that run's last
   training cloud; then the ``online`` and ``reoptimize`` CLIs and ``odometry --chunk 16``
   against the unchunked run of phase 3;
8. the odometry variants at the sensor's size on phase 4's first 40 images:
   the default beside P2D, time-continuous, the Ceres-style covariance,
   CA-CFAR and BFAR, and the default at MulRan's shapes (3360 bins of
   0.05952 m, 40 simulator images), each with its first 5 frames run again
   on the CPU and held to the card's; the Ceres-style covariance of the
   run's newest keyframe again under ``torch.cuda.set_sync_debug_mode(
   "error")`` (one ``ceres_covariance`` launch for its tail, no library
   call, no host synchronisation), its covariance and flag held bit for
   bit to the CPU's, and the variant's frames/s at least ``CERES_PACE`` of
   the default variant's;
9. the rest of the slice: ``batched_odometry_step`` at B = 4 (four
   simulator seeds, each row held to its own B = 1 run, timed against three
   of those runs, one of them run twice and held bit-equal, kernel launches
   per step at B = 1 and 4; and at B = 2 over the first two, for phase
   10(b)), a max-mode ScanContext retrieval over phase 4's
   keyframes, the Cen 2018 detector on the card and Cen 2019 on the host,
   the four quality metrics on phase 4's consecutive keyframe pairs, and
   ``register_joint`` over its last 5 keyframes;
10. ``parallel/`` over ``torch.distributed``: (a) one NCCL rank in this
    process: ``run_offline_slam`` with the mesh on phase 4's checkpoint
    against phase 4's constraints, ``PoseGraph(mesh)`` with the
    ``distributed`` solver on phase 5's instance, then
    ``harness/dryrun.py``'s ``entry()`` frame and its multi-rank dry run at
    mesh size 1; (b) two gloo ranks on the one card, launched by
    ``torchrun`` running this script with ``--ranks-worker``: the sharded
    pair waves of ``LoopCloser(mesh)`` over phase 4's keyframes, sharded
    retrieval over a 4608-slot database, ``optimize_distributed`` at the
    ``chain`` and ``chain_sharded`` preconditioners and
    ``alignment_training_step`` on 8 keyframe pairs, each held to the
    single-process result (the training fit bit for bit to this process's
    CPU fit of the same x and y); batched odometry of phase 9's two sequences, one
    a rank (``parallel/odometry.py``), held to phase 9's B = 2 run; and the
    dry run at two ranks, the kernel held to its plain version at the dry
    run's own shapes; (c) the ``sweep`` subcommand, two jobs on the card.

Prints the card's name and power limit, one JSON line with the kernels
(their launches by path, the dry run's among them) and each phase's
seconds, and last ``{"ok": true, "device": {...}}``.  Run from the
repository root:

    python3 chip_smoke.py [--frames N]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SIM = "sim:60:5"
SMALL = ["radar.k_strongest=4", "features.cell_capacity=192",
         "features.grid_extent=60.0", "registration.cost=P2L"]
RTOL, ATOL = 1e-5, 1e-4  # CorAl moments: float sums in another order
SCHUR_STEP_RTOL = 1e-2  # float32 Woodbury step vs float64 dense, 4470 nodes
# chunked vs per-frame trajectory file (rotation entries and metres): the
# same arithmetic, two processes
CHUNK_ATOL = 2e-3
# the card's odometry against the CPU's on the same frames (phase 8: sin/cos
# and float sums in another order) and a row of the B = 4 batch against its
# own B = 1 run (phase 9: reductions and products whose kernels depend on
# the batch size): a last bit may flip an association, which later frames
# carry forward
POSE_ATOL_M, POSE_ATOL_RAD = 1e-2, 1e-3

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, spin: bool = True) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call.  With ``spin`` the device first spins for a few
    milliseconds while the host enqueues the calls, so a kernel shorter than
    the host's time per call is still timed back to back; without it the
    calls run as fast as the host hands them over, and the time is the
    larger of the kernel's and the host's."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if spin:
        torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_us(fn, reps: int = 50) -> float:
    """Mean microseconds the host spends inside one call of ``fn`` (the
    enqueue, not the kernel), each call made on an idle device."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / reps * 1e6


def phase_build():
    from tbv_slam_public_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}, {smi}, max SM clock "
        f"{clock} MHz")
    t0 = time.perf_counter()
    build.library()
    log(f"[1] kernel library built in {time.perf_counter() - t0:.2f} s: "
        f"{build.BUILD_INFO['path']}")
    for line in build.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[1] ptxas: {line.strip()}")
    report = build.BUILD_INFO.get("ptxas", "")
    if "stack frame" not in report:  # a library built earlier: compile the
        report = ptxas_report(build)  # frameless kernels' sources again
    frames = stack_frames(report)
    held = {k: v for k, v in frames.items() if any(
        tag in k for tag in FRAMELESS)}
    bad = {k: v for k, v in held.items() if any(v)}
    log(f"[1] stack frame and spills of the {len(held)} site, chain and "
        f"ScanContext kernels: {'none' if not bad else bad}")
    if not held or bad:
        raise AssertionError(f"[1] site, chain or ScanContext kernels with a "
                             f"stack frame or spills (or none reported): "
                             f"{bad or held}")
    STACK_FRAMES.update(held)
    return smi, float(clock) * 1e6


# the kernels that must keep every value in registers: ptxas reports no
# stack frame and no spill for them (mangled names contain these)
FRAMELESS = ("site_kernel", "chain_", "sc_key_kernel",
             "sc_ring_distance_kernel", "sc_distance_kernel")
STACK_FRAMES = {}


def ptxas_report(build) -> str:
    """nvcc's ``-Xptxas -v`` report of the sources that hold the frameless
    kernels, compiled again into a temporary directory (one process a
    source, started together)."""
    srcs = [os.path.join(build.CSRC, f) for f in (
        "refmath_sites.cu", "refmath_chains.cu", "scancontext.cu",
        "refmath.cu")]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, f"{i}.o"), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i, src in enumerate(srcs)]
        return "".join(p.communicate()[0] for p in procs)


def stack_frames(report: str) -> dict:
    """{kernel: (stack frame, spill stores, spill loads) bytes} from nvcc's
    ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name] = tuple(int(g) for g in m.groups())
            name = None
    return out


def device_us_by_kernel(fn, reps: int = 10, tries: int = 3,
                        want: str = ""):
    """(mean device microseconds per launch of each kernel that ``fn``
    launches, from ``torch.profiler``; the profiled windows it took):
    a window that shows no device time (of a kernel whose name holds
    ``want``) is taken again, up to ``tries`` windows, and each such window
    is logged; the times are empty if every window was.  On the card's
    machine a window now and then comes back without the device activity
    (``scripts/probe_profiler.py`` counts how often)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    name = lambda key: key.replace("(anonymous namespace)::", "").split("(")[0]
    for k in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {name(e.key): e.device_time_total / e.count
               for e in prof.key_averages() if e.device_time_total > 0}
        if any(want in key for key in out):
            return out, k
        log(f"[profiler] window {k} of {tries} showed no device time of "
            f"{want or 'any kernel'} ({len(out)} kernels seen)")
    return {}, tries


def _kernel_ms(prof_us, want, k1, k2, tag):
    """(ms, source) of a call that is one launch of the kernel ``want``:
    its device time from the profiler, or, where every profiled window
    came back without device activity, the lower of the call's two times
    by CUDA events behind the spin (the call launches nothing else)."""
    kernel_us = [us for name, us in prof_us.items() if want in name]
    if kernel_us:
        return kernel_us[0] / 1e3, "profiler"
    log(f"[profiler] {tag}: no window showed device time; the call's time "
        f"by CUDA events stands in ({min(k1, k2):.4f} ms)")
    return min(k1, k2), "events"


def _moment_bound(args, count, sm_hz):
    """Least time the card could take for one ``neighbor_moments`` call on
    these inputs: the larger of its bytes (inputs read once, outputs written
    once) over the memory rate and its float32 operations over the rate at
    which the card issues them.  Per unmasked (query, point) pair the radius
    gate costs 6 operations (2 sub, 2 mul, 1 add, 1 compare); per pair
    inside the radius 6 more accumulate count, sums and second moments.
    None of them is a fused multiply-add, which the data sheet's FLOP/s
    counts twice, so single operations issue at half that rate.  Also
    returns the same count taken over ALL M*Q*P pairs at 12 operations each
    and 132 SMs x 128 lanes x the card's maximum SM clock: the work of a
    kernel that gates and accumulates every pair, masked or not."""
    qs, qm, ps, pm = args
    m, q = qm.shape
    p = pm.shape[1]
    nbytes = qs.numel() * 4 + qm.numel() + ps.numel() * 4 + pm.numel() \
        + m * q * (1 + 2 + 4) * 4
    live = float((qm.sum(-1).double() * pm.sum(-1).double()).sum())
    inside = float(count.double().sum())
    instr = 6.0 * live + 6.0 * inside
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = instr / (PEAK_F32_FLOPS / 2) * 1e3
    all_pairs = 12.0 * m * q * p / (132 * 128 * sm_hz) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                all_pairs_bound_ms=all_pairs)


def _moment_inputs(rng, m, q, p, dev, frac=0.8, extent=60.0, packed=False):
    """Random clouds; ``packed`` puts the live slots first, as the pipeline's
    clouds are, about ``frac`` of each row."""
    t = lambda a: torch.as_tensor(a, device=dev)

    def mask(n):
        if packed:
            live = rng.uniform(0.8, 1.2, (m, 1)) * frac * n
            return np.arange(n)[None] < live
        return rng.uniform(size=(m, n)) < frac

    return (t(rng.uniform(-extent, extent, (m, q, 2)).astype(np.float32)),
            t(mask(q)),
            t(rng.uniform(-extent, extent, (m, p, 2)).astype(np.float32)),
            t(mask(p)))


def _four(cm, sx, sm, rx, rm, radius):
    """``pair_moments``' outputs from four ``neighbor_moments`` calls."""
    own = zip(cm.neighbor_moments(sx, sm, sx, sm, radius),
              cm.neighbor_moments(rx, rm, rx, rm, radius))
    other = zip(cm.neighbor_moments(sx, sm, rx, rm, radius),
                cm.neighbor_moments(rx, rm, sx, sm, radius))
    return tuple(torch.stack([torch.cat(a, 1), torch.cat(b, 1)])
                 for a, b in zip(own, other))


def _pair_bound(sx, sm, rx, rm, count, sm_hz):
    """``_moment_bound`` of one ``pair_moments`` call: the sum over its four
    (query cloud, point cloud) combinations."""
    s = sm.shape[1]
    src, ref = (sx, sm), (rx, rm)
    parts = [_moment_bound(q + p, n, sm_hz) for q, p, n in (
        (src, src, count[0][:, :s]), (src, ref, count[1][:, :s]),
        (ref, ref, count[0][:, s:]), (ref, src, count[1][:, s:]))]
    return sum(b["bound_ms"] for b in parts)


def _share(tag, bound_ms, ms):
    """The share of the bound a time reaches; more than all of it means the
    count or the kernel is wrong."""
    share = bound_ms / ms
    if share > 1.0:
        raise AssertionError(f"{tag}: {ms} ms is under its bound of "
                             f"{bound_ms} ms")
    return share


def _check_moments(tag, got, want, again):
    """Counts bit-equal to the plain version's, sums within tolerance, and a
    second launch bit-equal to the first.  Returns the largest error."""
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"coral count differs: {tag}")
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        if not torch.equal(g, a):
            raise AssertionError(f"two launches differ: {tag}")
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) \
        if got[0].numel() else 0.0


def phase_kernels(sm_hz):
    from tbv_slam_public_torch.kernels import coral_moments as cm

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    radius = 1.0
    # (M, Q, P, live share, extent, live first): the main path's shapes,
    # ragged tiles and query blocks, an all-dead launch, dense clouds
    cases = [(1, 50, 70, 0.8, 60, False), (1, 128, 512, 0.8, 60, False),
             (1, 200, 600, 0.8, 60, False), (1, 4096, 4096, 0.8, 60, False),
             (64, 4096, 4096, 0.8, 60, False),
             (13, 4096, 4096, 0.8, 60, False),
             (12, 4096, 4096, 0.8, 60, False), (3, 300, 700, 0.0, 60, False),
             (2, 513, 1025, 0.8, 20, False), (3, 1500, 1537, 0.5, 20, False),
             (5, 700, 3000, 0.9, 10, False), (4, 4096, 4096, 0.25, 20, True)]
    inputs = [(f"M={m} Q={q} P={p} live={frac}{' first' if packed else ''}",
               _moment_inputs(rng, m, q, p, dev, frac, extent, packed))
              for m, q, p, frac, extent, packed in cases]
    # a stretch of dead slots longer than a tile between two live ones
    a = list(_moment_inputs(rng, 2, 1100, 1600, dev, 1.0, 15))
    a[3] = torch.zeros_like(a[3])
    a[3][:, :300] = True
    a[3][:, 1100:1300] = True
    inputs.append(("a dead tile between live ones", tuple(a)))
    # clouds live only in their last slot; the query sits on the point
    a = [x.clone() for x in a]
    for k in (1, 3):
        a[k] = torch.zeros_like(a[k])
        a[k][:, -1] = True
    a[0][:, -1] = a[2][:, -1]
    inputs.append(("live only in the last slot", tuple(a)))
    worst = 0.0
    for tag, args in inputs:
        m, q = args[1].shape
        got = cm.neighbor_moments(*args, radius)
        again = cm.neighbor_moments(*args, radius)
        torch.cuda.synchronize()
        want = cm.neighbor_moments_reference(*args, radius)
        err = _check_moments(tag, got, want, again)
        worst = max(worst, err)
        log(f"[2] coral_moments {tag}: ok, max_abs_err={err:.3g}, "
            f"neighbours/query="
            f"{float(want[0].float().mean()) if want[0].numel() else 0:.2f}")
    if float(got[0].sum()) != 2.0:  # the last case: one neighbour per row
        raise AssertionError("the last slot's query missed its point")

    # pair_moments: src and ref of different capacity, one row, the
    # pipeline's shapes with the live slots first (loop closure: 12 rows of
    # 4096 slots; in-run training: 13 rows of 4800 slots, which end in half a
    # query block and a short second compaction pass), a broadcast src
    pairs = [(3, 700, 1300, 0.8, 15, False), (2, 130, 50, 0.9, 5, False),
             (1, 4096, 4096, 0.8, 30, False),
             (12, 4096, 4096, 0.25, 30, True),
             (13, 4800, 4800, 0.1, 30, True),
             (13, 4800, 4800, 0.8, 60, False),
             (64, 4096, 4096, 0.8, 60, False)]
    pair_inputs = [(f"M={m} S={s} R={r} live={frac}"
                    f"{' first' if packed else ''}",
                    _moment_inputs(rng, m, s, r, dev, frac, extent, packed))
                   for m, s, r, frac, extent, packed in pairs]
    sx, sm, rx, rm = _moment_inputs(rng, 12, 4096, 4096, dev, 0.8, 30)
    pair_inputs.append(("M=12 S=R=4096, one src for all rows",
                        (sx[0][None].expand(12, -1, -1),
                         sm[0][None].expand(12, -1), rx, rm)))
    for tag, args in pair_inputs:
        got = cm.pair_moments(*args, radius)
        again = cm.pair_moments(*args, radius)
        four = _four(cm, *args, radius)
        torch.cuda.synchronize()
        want = cm.pair_moments_reference(*args, radius)
        err = _check_moments(f"pair {tag}", got, want, again)
        worst = max(worst, err)
        for g, f in zip(got, four):  # the same device code: equal bits
            if not torch.equal(g, f):
                raise AssertionError(f"pair_moments differs from four "
                                     f"launches: {tag}")
        log(f"[2] pair_moments {tag}: ok against four plain calls and four "
            f"launches, max_abs_err={err:.3g}")

    args = _moment_inputs(rng, 64, 4096, 4096, dev)
    ms = cuda_ms(lambda: cm.neighbor_moments(*args, radius), 20)
    plain_ms = cuda_ms(lambda: cm.neighbor_moments_reference(*args, radius), 3)
    bound = _moment_bound(args, cm.neighbor_moments(*args, radius)[0], sm_hz)
    share = _share("coral_moments at M=64", bound["bound_ms"], ms)
    log(f"[2] coral_moments at M=64 Q=P=4096: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']} ({share:.1%} reached), all-pairs bound "
        f"{bound['all_pairs_bound_ms']:.4f} ms; no single PyTorch call "
        f"computes this function")
    times = dict(ms=ms, share=share)
    # 80 % live at the widths of an offline wave, of in-run training and of
    # one online query; the training route's own capacity is the next loop
    for m in (64, 13, 12):
        a = args if m == 64 else _moment_inputs(rng, m, 4096, 4096, dev)
        one = lambda: cm.neighbor_moments(*a, radius)
        pair = lambda: cm.pair_moments(*a, radius)
        four = lambda: _four(cm, *a, radius)
        b1 = _moment_bound(a, one()[0], sm_hz)["bound_ms"]
        b4 = _pair_bound(*a, pair()[0], sm_hz)
        t = dict(one_ms=cuda_ms(one, 20),
                 one_ms_host_paced=cuda_ms(one, 20, spin=False),
                 pair_ms=cuda_ms(pair, 10),
                 four_ms=cuda_ms(four, 10), pair_host_us=host_us(pair),
                 four_host_us=host_us(four))
        log(f"[2] at M={m} Q=P=4096: neighbor_moments {t['one_ms']:.4f} ms "
            f"(bound {b1:.4f}, {_share('one', b1, t['one_ms']):.1%}; "
            f"{t['one_ms_host_paced']:.4f} ms when the host paces the "
            f"calls); "
            f"pair_moments {t['pair_ms']:.4f} ms (bound {b4:.4f}, "
            f"{_share('pair', b4, t['pair_ms']):.1%}) against four "
            f"launches {t['four_ms']:.4f} ms; host per call "
            f"{t['pair_host_us']:.1f} us against {t['four_host_us']:.1f} us")
        t["pair_kernels_us"], t["profiler_windows"] = \
            device_us_by_kernel(pair)
        log(f"[2] at M={m}: device us of a pair_moments call by kernel "
            f"{json.dumps(t['pair_kernels_us'])}")
        times[f"M{m}"] = t
    # the training route's launch: 13 rows of 4800 slots
    for frac in (0.1, 0.8):
        a = _moment_inputs(rng, 13, 4800, 4800, dev, frac, 30, frac < 0.5)
        pair = lambda: cm.pair_moments(*a, radius)
        b4 = _pair_bound(*a, pair()[0], sm_hz)
        t = dict(pair_ms=cuda_ms(pair, 10), bound_ms=b4,
                 pair_host_us=host_us(pair))
        t["share"] = _share("pair at 4800 slots", b4, t["pair_ms"])
        log(f"[2] at M=13 S=R=4800, {frac:.0%} live: pair_moments "
            f"{t['pair_ms']:.4f} ms (bound {b4:.4f}, {t['share']:.1%}), "
            f"host per call {t['pair_host_us']:.1f} us")
        times[f"M13_4800_live{round(frac * 100)}"] = t
    return dict(max_abs_err=worst, plain_ms=plain_ms, times=times, **bound)


# float32 operations a value of each refmath op, for the bound, counted from
# refmath.cuh (a fused multiply-add as two; an IEEE division as 10, its
# reciprocal, Newton steps and fix-up; a double operation as two, the
# card's float64 rate being half its float32 rate): sincos's reduction,
# sin_poly and cos_poly are 19 double operations (9 of them fused) and 8
# float32 ones; atan2's three divisions, atanf's two polynomials (19
# products and adds) and about 13 more; wrap_angle is both
REFMATH_FLOPS = {"exp": 20, "log": 25, "log1p": 40, "sigmoid": 32,
                 "sincos": 64, "wrap_angle": 126, "atan2": 62, "sqrt": 12,
                 "ftz": 2, "fma": 2, "mul": 2}
# the torch call that computes the same function as each op (None: none)
REFMATH_LIBRARY = {
    "exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
    "sigmoid": torch.sigmoid, "sincos": lambda v: (torch.sin(v),
                                                   torch.cos(v)),
    "wrap_angle": lambda v: torch.atan2(torch.sin(v), torch.cos(v)),
    "atan2": torch.atan2, "sqrt": torch.sqrt, "ftz": None,
    "fma": lambda a, b, c: torch.addcmul(c, a, b), "mul": torch.mul}
# the refmath kernels' launches by path, and the (op, shapes) held there
REFMATH_LAUNCHES = {}
REFMATH_HELD = {}
# operands of op calls that took the strided path, by path and op
REFMATH_STRIDED = {}
# the paths that run PGO, whose weighted residual is one refmath mul a
# Gauss-Newton step
MUL_PATHS = ("offline", "online")


@contextlib.contextmanager
def refmath_inputs():
    """For each op, operand shapes and options that the refmath kernel is
    given inside the block, the first call's operands and result, copied on
    the card (no sync, no launch of the kernel): ``{(op, *shapes, options):
    (args, outs, options)}``."""
    from tbv_slam_public_torch.kernels import refmath as rm

    kept, real, real_op, real_chain = {}, rm._call, rm._op, rm.chain
    clone = lambda t: None if t is None else t.detach().clone()

    def keeper(fn, tag):
        def keep(op, *ts, **options):
            out = fn(op, *ts, **options)
            if ts[0].device.type == "cuda":
                key = (tag, op) + tuple(
                    None if t is None else (tuple(t.shape), t.stride())
                    for t in ts) + tuple(sorted(options.items()))
                if key not in kept:
                    outs = out if isinstance(out, tuple) else (out,)
                    kept[key] = ([clone(t) for t in ts],
                                 [clone(o) for o in outs], options)
            return out
        return keep

    rm._call, rm._op, rm.chain = keeper(real, "op"), keeper(real_op, "op"), \
        keeper(real_chain, "chain")
    try:
        yield kept
    finally:
        rm._call, rm._op, rm.chain = real, real_op, real_chain


def hold_refmath(tag, kept) -> int:
    """Each kept result against the plain version on its operands, bit for
    bit (NaN payloads aside); returns the number of (op, shapes) held."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import bits_differ

    for key, (args, outs, options) in kept.items():
        plain = rm.chain_plain if key[0] == "chain" else \
            (lambda op, *a, **o: rm._PLAIN[op](*a, **o))
        want = plain(key[1], *(None if a is None else a.cpu()
                               for a in args), **options)
        want = want if isinstance(want, tuple) else (want,)
        if [o is None for o in outs] != [w is None for w in want]:
            raise AssertionError(f"{tag} refmath {key[1]}: the kernel's and "
                                 f"the plain version's outputs differ")
        bad = sum(bits_differ(o, w) for o, w in zip(outs, want)
                  if o is not None)
        if bad:
            raise AssertionError(f"{tag} refmath {key[1]} at shapes "
                                 f"{key[2:]}: {bad} values differ from the "
                                 f"plain version")
    return len(kept)


def abs_err(got, want) -> float:
    """Largest |got - want| over two arrays' values, as measured: NaN
    against NaN and equal infinities count 0, a NaN or an infinity against
    any other value inf."""
    g, w = (torch.as_tensor(np.asarray(x.cpu() if hasattr(x, "cpu") else x))
            .double() for x in (got, want))
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    d = torch.nan_to_num(torch.where(same, torch.zeros_like(g),
                                     (g - w).abs()), nan=math.inf)
    return float(d.max()) if d.numel() else 0.0


def path_operands(shapes, dev, seed):
    """Operands of the shapes a site or chain is given on its main path
    (``SITE_SHAPES``, ``_chain_shapes``), made from ``seed``: None stays
    None, a bool operand "b(shape)" is 80 % true, a float one uniform in
    [-60, 60), its angle (the last of 3) in [-3.2, 3.2).  The timings here
    and ``scripts/time_cells.py``'s ``sites`` and ``chains`` sets take
    their operands from it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for sh in shapes:
        if sh is None:
            out.append(None)
        elif isinstance(sh, str):
            out.append((torch.rand(eval(sh[1:]), generator=g) < 0.8).to(dev))
        else:
            x = torch.rand(sh, generator=g) * 120 - 60
            if sh[-1] == 3:
                x[..., 2] = torch.rand(sh[:-1], generator=g) * 6.4 - 3.2
            out.append(x.to(dev))
    return out


def frame_motions(ts):
    """The pose tail's operands (``_chain_shapes``) set to a frame's: a
    registration that succeeded, its guess near the pose, the last pose
    0.8 behind, the last motion within 1."""
    ts[1].fill_(True)
    ts[2].copy_(ts[0] + 0.05)
    ts[3].copy_(ts[0] - 0.8)
    ts[4].uniform_(-1, 1)


# float32 operations an element of each refmath site, for the bound (the
# double ones of sinf/cosf counted at the float32 rate): sincos 26, the
# angle wrap 60, atan2 35, a fused multiply-add or other operation 1
SITE_OPS = {"compose": 95, "relative": 125, "inverse": 32, "apply": 32,
            "rotate": 30, "interpolate": 126, "rotmat": 26, "norm2": 4,
            "world_targets": 40, "world_targets_p2d": 64,
            "motion_compensate": 70, "cumsum": 2}


def _site_cases(rng, dev, n):
    """{name: (site, operands, options)} of every refmath site on about n
    random elements, special values among them (angles, coordinates)."""
    from tbv_slam_public_torch.kernels.checks import REFMATH_SPECIAL

    sp = REFMATH_SPECIAL
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(m, extent=60.0):
        p = np.stack([rng.uniform(-extent, extent, m),
                      rng.uniform(-extent, extent, m),
                      rng.uniform(-7.0, 7.0, m)], -1).astype(np.float32)
        p[:len(sp), 2] = sp
        p[len(sp):2 * len(sp), 0] = sp
        return p

    k = 1024
    pts = rng.uniform(-80, 80, (k, n // k, 2)).astype(np.float32)
    pts[0, :len(sp), 0] = sp
    b, tt, c = 4, 16, n // 64
    cov = (rng.normal(size=(b, tt, c, 2, 2)) * np.exp(rng.uniform(
        -6, 3, (b, tt, c, 1, 1)))).astype(np.float32)
    cov[:, :, ::9] = 0.0
    world = (t(poses(b * tt).reshape(b, tt, 3)),
             t(rng.uniform(-80, 80, (b, tt, c, 2))),
             t(rng.uniform(-1, 1, (b, tt, c, 2))), t(cov),
             torch.as_tensor(rng.uniform(size=(b, tt, c)) < 0.8, device=dev),
             torch.as_tensor(rng.uniform(size=(b, tt)) < 0.7, device=dev))
    xy = rng.uniform(-80, 80, (n, 2)).astype(np.float32)
    xy[:len(sp) ** 2] = np.stack(np.meshgrid(sp, sp), -1).reshape(-1, 2)
    motion = t([0.7, -0.05, 0.02])
    cases = {"compose": ("compose", (t(poses(n)), t(poses(n, 3.0))), {}),
             "relative": ("relative", (t(poses(n)), t(poses(n))), {}),
             "inverse": ("inverse", (t(poses(n)),), {}),
             "apply": ("apply", (t(poses(k)), t(pts)), {}),
             "rotate": ("rotate", (t(poses(k)), t(pts)), {}),
             "interpolate": ("interpolate", (t(poses(n)), t(poses(n)),
                                             t(rng.uniform(0, 1, n))), {}),
             "rotmat": ("rotmat", (t(poses(n)[:, 2]),), {}),
             "norm2": ("norm2", (t(xy),), {}),
             "world_targets": ("world_targets",
                               world[:3] + (None,) + world[4:], {}),
             "world_targets_p2d": ("world_targets", world, {}),
             "motion_compensate": ("motion_compensate", (t(xy), motion),
                                   dict(ccw=False)),
             "motion_compensate_ccw": ("motion_compensate", (t(xy), motion),
                                       dict(ccw=True))}
    return cases


# each site at the shape its main path gives it: (site, operand shapes,
# options); the torch call that computes the same function, where one does
SITE_SHAPES = {
    "compose": ("compose", ((1, 3), (1, 3)), {}),
    "relative": ("relative", ((1, 3), (1, 3)), {}),
    "inverse": ("inverse", ((1, 3),), {}),
    "apply": ("apply", ((12, 3), (12, 4096, 2)), {}),
    "rotate": ("rotate", ((1, 3), (1, 512, 2)), {}),
    "interpolate": ("interpolate", ((1, 3), (1, 3), (1,)), {}),
    "rotmat": ("rotmat", ((1,),), {}),
    "norm2": ("norm2", ((4608, 2),), {}),
    "world_targets": ("world_targets", ((1, 4, 3), (1, 4, 512, 2),
                                        (1, 4, 512, 2), None, "b(1, 4, 512)",
                                        "b(1, 4)"), {}),
    "world_targets_p2d": ("world_targets", ((1, 4, 3), (1, 4, 512, 2),
                                            (1, 4, 512, 2), (1, 4, 512, 2, 2),
                                            "b(1, 4, 512)", "b(1, 4)"), {}),
    "motion_compensate": ("motion_compensate", ((4800, 2), (3,)),
                          dict(ccw=False)),
}
SITE_LIBRARY = {"norm2": lambda v: torch.linalg.vector_norm(v, dim=-1)}
# cumsum: the lengths held bit for bit (every level count of the one-block
# path, its switch to the device-memory path at 16,384, 2^20), and the
# keyframe capacities detect gives it, timed
CUMSUM_HELD = (1, 15, 16, 17, 128, 1000, 4608, 16 ** 3 + 1, 16384, 16385,
               1 << 20)
CUMSUM_CAPACITIES = (128, 256, 1152, 4608)


def phase_refmath_sites():
    """The refmath kernel's site entries against their plain versions on
    the CPU, bit for bit, on 2^20 elements a site with special values, and
    ``cumsum`` at the paths' capacities; then each site's time at its main
    path's shape (CUDA events behind the device-side spin) beside its plain
    version (the op-by-op body on the card, the path before this slice),
    the host's time a call for both, and its bound."""
    from tbv_slam_public_torch.kernels import refmath as rm
    # the sites' owners register them (registration imports core/se2.py)
    from tbv_slam_public_torch.ops import radar, registration  # noqa: F401
    from tbv_slam_public_torch.kernels.checks import bits_differ

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    cases = _site_cases(rng, dev, 1 << 20)
    errs = {}
    for name, (site, ts, opts) in cases.items():
        rm.LAUNCHES_BY_OP.clear()
        got = rm.site(site, *ts, **opts)
        if dict(rm.LAUNCHES_BY_OP) != {site: 1}:
            raise AssertionError(f"[2] site {name}: launches "
                                 f"{dict(rm.LAUNCHES_BY_OP)}, not one")
        want = rm._PLAIN[site](*(None if x is None else x.cpu() for x in ts),
                               **opts)
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        bad = sum(bits_differ(g, w) for g, w in zip(got, want)
                  if g is not None)
        errs[site] = max([errs.get(site, 0.0)] + [
            abs_err(g, w) for g, w in zip(got, want) if g is not None])
        log(f"[2] refmath site {name}: {got[0].numel()} values, {bad} "
            f"differ from the plain version")
        if bad:
            raise AssertionError(f"refmath site {name}: {bad} values differ")
    for n in CUMSUM_HELD:
        x = torch.as_tensor(rng.uniform(0, 3, n).astype(np.float32))
        got, want = rm.cumsum(x.to(dev)), rm._PLAIN["cumsum"](x)
        bad = bits_differ(got, want)
        errs["cumsum"] = max(errs.get("cumsum", 0.0), abs_err(got, want))
        if bad:
            raise AssertionError(f"refmath cumsum at {n}: {bad} differ")
    log(f"[2] refmath cumsum: bit-equal at n = {CUMSUM_HELD}")

    times = {}
    for name, (site, shapes, opts) in list(SITE_SHAPES.items()) + [
            ("cumsum", ("cumsum", ((4608,),), {}))]:
        ts = path_operands(shapes, dev, 5)
        if name == "cumsum":
            ts[0].uniform_(0, 3)
        call = lambda: rm._call(site, *ts, **opts)
        plain = lambda: rm._PLAIN[site](*ts, **opts)
        outs = call()
        outs = outs if isinstance(outs, tuple) else (outs,)
        nbytes = sum(x.numel() * x.element_size() for x in ts
                     if x is not None) + sum(
            o.numel() * o.element_size() for o in outs if o is not None)
        n = outs[0].shape[:outs[0].dim() - {"norm2": 0, "cumsum": 0,
                                            "rotmat": 2}.get(site, 1)].numel()
        ops = SITE_OPS[name] * n
        t = dict(ms=cuda_ms(call, 50), plain_ms=cuda_ms(plain, 10),
                 host_us=host_us(call), plain_host_us=host_us(plain, 20),
                 bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                              ops / PEAK_F32_FLOPS) * 1e3,
                 bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >=
                 ops / PEAK_F32_FLOPS else "operations", elements=n,
                 library_ms=None, max_abs_err=errs[site])
        lib = SITE_LIBRARY.get(name) if name != "cumsum" else \
            (lambda v: torch.cumsum(v, 0))
        if lib is not None:
            t["library_ms"] = cuda_ms(lambda: lib(*ts), 50)
        times[name] = t
        log(f"[2] refmath site {name} at {n} elements: {t['ms']:.4f} ms "
            f"(bound {t['bound_ms']:.6f} ms), plain {t['plain_ms']:.4f} ms; "
            f"host {t['host_us']:.1f} us a call (plain "
            f"{t['plain_host_us']:.1f}); library {t['library_ms']}")
    # cumsum at the capacities detect gives it, in turns against
    # torch.cumsum (which adds in another order)
    for n in CUMSUM_CAPACITIES:
        x = torch.empty(n, device=dev).uniform_(0, 3)
        call = lambda: rm.cumsum(x)
        lib = lambda: torch.cumsum(x, 0)
        k1, l1, l2, k2 = (cuda_ms(call, 50), cuda_ms(lib, 50),
                          cuda_ms(lib, 50), cuda_ms(call, 50))
        by_bytes, by_ops = 8 * n / PEAK_BYTES_PER_S, \
            2 * n / PEAK_F32_FLOPS  # an add a value, its row's shift
        t = dict(ms=min(k1, k2), ms_turns=[k1, k2], library_ms=min(l1, l2),
                 library_ms_turns=[l1, l2],
                 plain_ms=cuda_ms(lambda: rm._PLAIN["cumsum"](x), 5),
                 host_us=host_us(call), bound_ms=max(by_bytes, by_ops) * 1e3,
                 bound_by="bytes" if by_bytes >= by_ops else "operations",
                 elements=n)
        times[f"cumsum_n{n}"] = t
        log(f"[2] refmath cumsum at {n} values: {k1:.4f} / {k2:.4f} ms "
            f"(bound {t['bound_ms']:.6f} ms), torch.cumsum {l1:.4f} / "
            f"{l2:.4f} ms, plain {t['plain_ms']:.4f} ms, host "
            f"{t['host_us']:.1f} us a call")
    return times


# float32 operations an element of each chain (its sites' SITE_OPS and
# about one a glue operation), and the elements that carry them: the pose
# tail's 3 relative poses, 3 norms, the rotation and 20 gates, selections
# and products; the local map's relative pose counted once a keyframe (the
# kernel recomputes it for each point), its apply once a point
CHAIN_NAMES = ("odometry_pose_tail", "motion_compensate_pair", "loop_guess",
               "local_map", "alignment_apply")
CHAIN_OPS = {"odometry_pose_tail": 3 * 125 + 3 * 4 + 26 + 20,
             "motion_compensate_pair": 70, "loop_guess": 32 + 95 + 3,
             "alignment_apply": 32}


def _chain_shapes(cfg):
    """Each chain at the shape its main path gives it: (operand shapes, a
    bool operand as "b(shape)", options)."""
    from tbv_slam_public_torch.models.odometry import pose_tail_options

    k = 2 * cfg.loopclosure.n_aggregate + 1
    cloud = cfg.radar.num_azimuths * cfg.radar.k_strongest
    peaks = cfg.verification.peaks_capacity
    return {
        "odometry_pose_tail": (((1, 3), "b(1,)", (1, 3), (1, 3), (1, 3),
                                (1, 3)), pose_tail_options(cfg.odometry)),
        "motion_compensate_pair": (((cloud, 2), (cloud, 2), (3,)),
                                   dict(ccw=cfg.odometry.radar_ccw)),
        "loop_guess": (((64, 3), (64,)), {}),
        "local_map": (((1, 1, 1, 3), (1, k, 1, 3), (1, k, cloud, 2)), {}),
        "alignment_apply": (((12, 1, 3), (12, peaks, 2), (12, 1, 3),
                             (12, peaks, 2)), {}),
    }


def _chain_sites(name, ts, opts, cfg):
    """The chain's work as the path ran it before this slice: its sites one
    launch each, the glue between them torch's ops."""
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.models import odometry
    from tbv_slam_public_torch.ops import radar

    if name == "odometry_pose_tail":
        pose, success, guess, t_prev, tmot_prev, last_kf = ts
        oc = cfg.odometry
        tcur = torch.where(success[:, None], pose, guess)
        vel, acc = odometry.motion_rates(se2.relative(t_prev, tcur),
                                         tmot_prev, oc.sensor_period)
        sane = (vel <= oc.vel_limit) & (acc <= oc.acc_limit)
        tcur = torch.where(sane[:, None], tcur, guess)
        diff = se2.relative(last_kf, tcur)
        fuse = ((rm.norm2(diff[:, :2]) > oc.min_keyframe_dist)
                | (torch.abs(diff[:, 2])
                   > math.radians(oc.min_keyframe_rot_deg))) & success
        return (tcur, se2.relative(t_prev, tcur), diff, fuse,
                se2.rotmat(-last_kf[:, 2]))
    if name == "motion_compensate_pair":
        xy, pxy, motion = ts
        return (rm.site("motion_compensate", xy, motion, **opts),
                rm.site("motion_compensate", pxy, motion, **opts))
    if name == "loop_guess":
        taug, yaw = ts
        rot = torch.stack([torch.zeros_like(yaw), torch.zeros_like(yaw),
                           yaw], -1)
        return se2.compose(se2.inverse(taug), rot)
    if name == "local_map":
        q, kf, xy = ts
        return se2.apply(se2.relative(q[:, :, 0], kf[:, :, 0]), xy)
    sp, sxy, rp, rxy = ts
    return se2.apply(sp[:, 0], sxy), se2.apply(rp[:, 0], rxy)


def _chain_cases(rng, dev, n):
    """{chain: (operands, options)} on about n elements each, special
    values among their coordinates and angles, poses at and around +-pi."""
    from tbv_slam_public_torch.kernels.checks import REFMATH_SPECIAL
    from tbv_slam_public_torch.models.odometry import pose_tail_options
    from tbv_slam_public_torch.core.config import OdometryConfig

    sp = REFMATH_SPECIAL
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(m, extent=60.0):
        p = np.stack([rng.uniform(-extent, extent, m),
                      rng.uniform(-extent, extent, m),
                      rng.uniform(-3.3, 3.3, m)], -1).astype(np.float32)
        p[:len(sp), 2] = sp
        p[len(sp):2 * len(sp), 0] = sp
        p[-len(sp):, 2] = np.float32(np.pi) - np.abs(sp[::-1]) * 1e-7
        return p

    def points(*shape):
        x = rng.uniform(-80, 80, shape + (2,)).astype(np.float32)
        x.reshape(-1, 2)[:len(sp) ** 2] = np.stack(np.meshgrid(sp, sp),
                                                   -1).reshape(-1, 2)
        return x

    b = n // 64
    succ = torch.as_tensor(rng.uniform(size=n) < 0.8, device=dev)
    near = t(poses(n, 0.5))
    base = t(poses(n))
    window = t(poses(4 * n)).reshape(n, 4, 3)
    return {
        "odometry_pose_tail": ((base + near, succ, base + near * 0.5, base,
                                near, window[:, -1]),
                               pose_tail_options(OdometryConfig())),
        "motion_compensate_pair": ((t(points(n)), t(points(n // 3)),
                                    t([0.7, -0.05, 0.02])), dict(ccw=True)),
        "loop_guess": ((t(poses(n)), t(poses(n)[:, 2])), {}),
        "local_map": ((t(poses(b)).reshape(b, 1, 1, 3),
                       t(poses(3 * b)).reshape(b, 3, 1, 3),
                       t(points(b, 3, 64))), {}),
        "alignment_apply": ((t(poses(b)).reshape(b, 1, 3), t(points(b, 64)),
                             t(poses(b)).reshape(b, 1, 3), t(points(b, 64))),
                            {}),
    }


def phase_chains(cfg):
    """The refmath chains (one launch runs an ordered list of sites and
    their glue) against their plain versions on the CPU, bit for bit, on
    about 2^18 elements a chain with special values, one launch a call;
    then each chain at its main path's shape timed by CUDA events in turns
    against its sites one launch each (the path before this slice: chain,
    sites, sites, chain), with the host's time a call for both, its plain
    version on the card (op by op) and its bound."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import bits_differ
    # the chains' owners register them
    from tbv_slam_public_torch.models import (loopclosure, odometry,  # noqa
                                              verification)

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    errs = {}
    for name, (ts, opts) in _chain_cases(rng, dev, 1 << 18).items():
        rm.LAUNCHES_BY_OP.clear()
        got = rm.chain(name, *ts, **opts)
        if dict(rm.LAUNCHES_BY_OP) != {name: 1}:
            raise AssertionError(f"[2] chain {name}: launches "
                                 f"{dict(rm.LAUNCHES_BY_OP)}, not one")
        again = rm.chain(name, *ts, **opts)
        want = rm.chain_plain(name, *(x.cpu() for x in ts), **opts)
        got, again, want = ((x,) if isinstance(x, torch.Tensor) else x
                            for x in (got, again, want))
        bad = sum(bits_differ(g, w) for g, w in zip(got, want)) + sum(
            bits_differ(g, w) for g, w in zip(got, again))
        errs[name] = max(abs_err(g, w) for g, w in zip(got, want))
        log(f"[2] refmath chain {name}: {got[0].numel()} values, {bad} "
            f"differ from the plain version")
        if bad:
            raise AssertionError(f"refmath chain {name}: {bad} values differ")

    times = {}
    for name, (shapes, opts) in _chain_shapes(cfg).items():
        ts = path_operands(shapes, dev, 7)
        if name == "odometry_pose_tail":
            frame_motions(ts)
        call = lambda: rm.chain(name, *ts, **opts)
        sites = lambda: _chain_sites(name, ts, opts, cfg)
        got = call()
        got = got if isinstance(got, tuple) else (got,)
        ref = sites()
        ref = ref if isinstance(ref, tuple) else (ref,)
        bad = sum(bits_differ(g, w) for g, w in zip(got, ref))
        if bad:
            raise AssertionError(f"[2] chain {name}: {bad} values differ "
                                 f"from its sites one by one")
        rm.LAUNCHES = 0
        sites()
        site_launches = rm.LAUNCHES
        k1, s1, s2, k2 = (cuda_ms(call, 50), cuda_ms(sites, 50),
                          cuda_ms(sites, 50), cuda_ms(call, 50))
        nbytes = sum(x.numel() * x.element_size() for x in ts) + sum(
            o.numel() * o.element_size() for o in got)
        if name == "local_map":  # a relative pose a keyframe, apply a point
            ops = 125 * ts[1].shape[:2].numel() + 32 * ts[2].shape[:-1].numel()
        else:
            ops = CHAIN_OPS[name] * sum(
                o.shape[:1 if name == "odometry_pose_tail" else -1].numel()
                for o in got[:1 if name == "odometry_pose_tail" else None])
        t = dict(ms=min(k1, k2), ms_turns=[k1, k2], sites_ms=min(s1, s2),
                 sites_ms_turns=[s1, s2], site_launches=site_launches,
                 plain_ms=cuda_ms(lambda: rm.chain_plain(name, *ts, **opts),
                                  10),
                 host_us=host_us(call), sites_host_us=host_us(sites),
                 bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                              ops / PEAK_F32_FLOPS) * 1e3,
                 bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >=
                 ops / PEAK_F32_FLOPS else "operations",
                 shapes=[list(x.shape) for x in ts], library_ms=None,
                 max_abs_err=errs[name])
        times[name] = t
        log(f"[2] refmath chain {name}: {k1:.4f} / {k2:.4f} ms (bound "
            f"{t['bound_ms']:.6f} ms) against its {site_launches} sites' "
            f"launches {s1:.4f} / {s2:.4f} ms, plain {t['plain_ms']:.4f} ms; "
            f"host {t['host_us']:.1f} us a call against "
            f"{t['sites_host_us']:.1f}")
    return times


# float32 instructions of cell_stats, for the bound: the gate 6 a (cell,
# unmasked point) pair, 12 a neighbour (weight sum, normalised weight,
# centred point, six moments), about 80 a cell (covariance, eigen gates,
# log1p, normal)
CELL_GATE_OPS, CELL_NEIGHBOUR_OPS, CELL_OPS = 6, 12, 80


def _cell_bound(xy, mask, centroid, occupied, cfg):
    """Least time the card could take for one ``cell_stats`` call on these
    inputs: the larger of its bytes (inputs read once, outputs written
    once) over the memory rate and its instructions (counted from these
    inputs' live pairs and neighbours) over the card's rate for
    single float32 instructions (half the data sheet's FLOP/s, which counts
    a fused multiply-add twice)."""
    from tbv_slam_public_torch.ops import features as tf

    p, c = xy.shape[0], centroid.shape[0]
    nbytes = p * 13 + c * 9 + c * (8 + 16 + 8 + 12 + 1)
    r2 = float(np.float32(cfg.resolution * cfg.resolution))
    nbr = (tf._gate_sqdist(centroid, xy) <= r2) & mask[None] & \
        occupied[:, None]
    pairs = float(occupied.sum()) * float(mask.sum())
    instr = CELL_GATE_OPS * pairs + CELL_NEIGHBOUR_OPS * float(nbr.sum()) \
        + CELL_OPS * c
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = instr / (PEAK_F32_FLOPS / 2) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                neighbours=int(nbr.sum()))


CELLS_DESIGN = ("up to 24,000 points: a block of 8 warps takes 4 cells, "
                "stages the cloud's positions (cp.async) and mask in shared "
                "memory, "
                "gates them once into a bitmap a cell (ballots, point "
                "order) and walks each bitmap in order for the weight sum's "
                "tree and the moments (a warp a cell); above it a warp a "
                "cell, the cloud read from global memory, the gate twice")


def phase_cells(images, cfg):
    """The cell_stats kernel against its plain version on the card, bit for
    bit: on phase 4's k-strongest clouds, MulRan's shapes, the CA-CFAR and
    BFAR clouds, the cfear3_oxford preset's 16,000-point clouds, and clouds
    whose gate points lie within an ulp of the radius; the cells that
    differ from the CPU's plain version counted on phase 4's clouds; one
    launch and no host read a call; the time at phase 4's and the preset's
    shapes beside the plain version and the bound."""
    from tbv_slam_public_torch.core.config import (PRESETS, apply_overrides,
                                                   parse_cli_overrides)
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.kernels import cells as kc
    from tbv_slam_public_torch.kernels.checks import cell_gate_cloud
    from tbv_slam_public_torch.ops import features as tf
    from tbv_slam_public_torch.ops import radar

    dev = torch.device("cuda")
    fcfg = cfg.features
    sets = {}

    def clouds(rcfg, imgs, feat=fcfg):
        out = []
        for img in imgs:
            cloud = radar.filter_scan(torch.as_tensor(img, device=dev),
                                      rcfg)[0]
            out.append((cloud,) + tf.select_cells(cloud, feat) + (feat,))
        return out

    sets["phase4"] = clouds(cfg.radar, images[:8])
    for name in ("cacfar", "bfar"):
        sets[name] = clouds(apply_overrides(cfg, parse_cli_overrides(
            [f"radar.filter_type={name}"])).radar, images[:3])
    mulran = apply_overrides(cfg, parse_cli_overrides(
        "radar.num_range_bins=3360 radar.range_res=0.05952".split()))
    sets["mulran"] = clouds(mulran.radar, _mulran_images(3)[0])
    # the published presets' clouds: k_strongest 40 at 400 azimuths (16,000
    # points) and the 3 m radius
    oxford = PRESETS["cfear3_oxford"]()
    sets["cfear3_oxford"] = clouds(oxford.radar, images[:3], oxford.features)
    # clouds beyond the staged design's shared memory (kStageMax points):
    # the global-memory design
    big = apply_overrides(oxford, parse_cli_overrides(
        [f"radar.k_strongest={kc.STAGE_MAX // 400 + 20}"]))
    sets["beyond_stage"] = clouds(big.radar, images[:2], big.features)
    if sets["beyond_stage"][0][0].xy.shape[0] <= kc.STAGE_MAX:
        raise AssertionError("[4c] the large clouds fit the staged design")
    rng = np.random.default_rng(23)
    gate = []
    for _ in range(3):
        xy, inten, mask, cen, occ = (torch.as_tensor(a, device=dev) for a in
                                     cell_gate_cloud(rng, 512,
                                                     fcfg.resolution))
        gate.append((PointCloud(xy, inten, mask), cen, occ, fcfg))
    sets["on_gate"] = gate
    held, cpu_cells, cpu_differ = 0, 0, 0
    for name, items in sets.items():
        for cloud, cen, occ, feat in items:
            args = (cloud.xy, cloud.intensity, cloud.mask, cen, occ, feat)
            kc.LAUNCHES = 0
            got = kc.cell_stats(*args)
            if kc.LAUNCHES != 1:
                raise AssertionError(f"[4c] {name}: {kc.LAUNCHES} launches")
            again = kc.cell_stats(*args)
            with kc.plain_on_card():
                want = kc.cell_stats(*args)
            bad = cells_differ(got, want) + cells_differ(got, again)
            if bad:
                raise AssertionError(f"[4c] cell_stats {name}: {bad} cells "
                                     f"differ from the plain version")
            held += 1
            if name == "phase4":
                cpu = tf._cell_stats_reference(*(a.cpu() for a in args[:5]),
                                               fcfg)
                cpu_differ += cells_differ(got, cpu)
                cpu_cells += int(want[-1].sum())
        log(f"[4c] cell_stats {name}: {len(items)} clouds bit-equal to the "
            f"plain version on the card")
    def timed(name):
        cloud, cen, occ, feat = sets[name][0]
        args = (cloud.xy, cloud.intensity, cloud.mask, cen, occ, feat)
        call = lambda: kc.cell_stats(*args)

        def plain():
            with kc.plain_on_card():
                return kc.cell_stats(*args)

        t = dict(ms=cuda_ms(call, 50), plain_ms=cuda_ms(plain, 3, spin=False),
                 host_us=host_us(call), points=cloud.xy.shape[0],
                 cells=cen.shape[0],
                 **_cell_bound(cloud.xy, cloud.mask, cen, occ, feat))
        t["share_of_bound"] = _share(f"[4c] cell_stats {name}", t["bound_ms"],
                                     t["ms"])
        log(f"[4c] cell_stats {name} at P={t['points']}, C={t['cells']}: "
            f"{t['ms']:.4f} ms (bound {t['bound_ms']:.6f} ms, "
            f"{t['share_of_bound']:.1%}), plain {t['plain_ms']:.2f} ms, host "
            f"{t['host_us']:.1f} us")
        return t

    res = timed("phase4")
    res.update(clouds_held=held, phase4_cells_differing_from_cpu=cpu_differ,
               phase4_valid_cells=cpu_cells, library_ms=None,
               cfear3_oxford=timed("cfear3_oxford"),
               beyond_stage=timed("beyond_stage"),
               design=CELLS_DESIGN)
    log(f"[4c] {cpu_differ} of phase 4's {cpu_cells} valid cells differ from "
        f"the CPU's plain version")
    return res


# the registration kernel's launches by path (window and solve entries),
# and the solve entry's shapes held there
LM_LAUNCHES = {}
LM_HELD = {}
# the paths that run the registration kernel (besides the odometry
# variants); the PGO paths and evaluate-scans run none
LM_PATHS = ("offline", "online", "batched", "rest", "parallel_offline",
            "dryrun")


@contextlib.contextmanager
def lm_inputs():
    """For each (B, T, C, cost, loss, inner iterations, prior, one_system)
    that the kernel's solve entry is given inside the block, the first call's
    inputs and outputs, copied on the card: ``{key: (tensors, options,
    outputs)}``."""
    from tbv_slam_public_torch.kernels import lm_solve as lk

    kept, real = {}, lk.lm_solve

    def clone(x):
        return None if x is None else x.detach().clone()

    def keep(*ts, **kw):
        out = real(*ts, **kw)
        key = tuple(ts[4].shape) + (kw["cost"], kw["loss"], kw["max_iter"],
                                    kw.get("prior") is not None,
                                    bool(kw.get("one_system")))
        if key not in kept:
            opts = dict(kw)
            if opts.get("prior") is not None:
                opts["prior"] = tuple(map(clone, opts["prior"]))
            kept[key] = ([clone(t) for t in ts], opts,
                         [o.detach().clone() for o in out])
        return out

    lk.lm_solve = keep
    try:
        yield kept
    finally:
        lk.lm_solve = real


def plain_lm(ts, opts):
    """The plain ``_lm_solve`` on the card on the kernel's arguments."""
    from types import SimpleNamespace

    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.ops import registration as treg

    theta0, src, tm, tn, weight, mask, si = ts
    with lk.plain_on_card():
        return treg._lm_solve_reference(
            theta0, SimpleNamespace(mean=src),
            treg.Associations(tm, tn, weight, mask, si), **opts)


def hold_lm(tag, kept) -> int:
    """Each kept LM solve against the plain version on its inputs, bit for
    bit in theta, cost and rel_dec; returns the number of shapes held."""
    from tbv_slam_public_torch.kernels.checks import bits_differ

    for key, (ts, opts, outs) in kept.items():
        want = plain_lm(ts, opts)
        bad = sum(bits_differ(o, w) for o, w in zip(outs, want))
        if bad:
            raise AssertionError(f"{tag} lm_solve at {key}: {bad} values "
                                 f"differ from the plain version")
    return len(kept)


# the window entry's first calls on each path, and the shapes held there
WINDOW_HELD = {}


@contextlib.contextmanager
def window_inputs():
    """For each (B, T, C, Ct, cost, loss, inner and outer iterations, prior,
    one_system, weight option) that ``register_window`` is called with on
    CUDA tensors inside the block, the first call's arguments and result,
    copied on the card: ``{key: (args, kwargs, result)}``."""
    from tbv_slam_public_torch.ops import registration as treg

    kept, real = {}, treg.register_window

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        return x.map(lambda v: v.detach().clone()) if hasattr(x, "map") \
            else x

    def keep(src, pose0, tgt, tposes, smask, cfg, **kw):
        out = real(src, pose0, tgt, tposes, smask, cfg, **kw)
        if pose0.is_cuda:
            key = tuple(src.valid.shape) + tuple(tgt.valid.shape[1:]) + (
                cfg.cost, cfg.loss, cfg.max_inner_iterations,
                cfg.max_outer_iterations, kw.get("guess") is not None,
                bool(kw.get("one_system")), cfg.weight_option)
            if key not in kept:
                kept[key] = ([clone(a) for a in (src, pose0, tgt, tposes,
                                                 smask)] + [cfg],
                             {k: clone(v) for k, v in kw.items()},
                             clone(out))
        return out

    treg.register_window = keep
    try:
        yield kept
    finally:
        treg.register_window = real


def window_differ(got, want) -> int:
    """Values of two ``RegistrationResult``s that differ (pose and score in
    their bits, the counts and the success flag)."""
    from tbv_slam_public_torch.kernels.checks import bits_differ

    return sum(bits_differ(getattr(got, f), getattr(want, f))
               for f in ("pose", "score")) + sum(
        int((getattr(got, f) != getattr(want, f)).sum())
        for f in ("num_residuals", "iterations", "success"))


def hold_window(tag, kept) -> int:
    """Each kept ``register_window`` call against the plain version on its
    inputs on the card, bit for bit; returns the number of shapes held."""
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.ops import registration as treg

    for key, (args, kw, out) in kept.items():
        with lk.plain_on_card():
            want = treg.register_window(*args, **kw)
        bad = window_differ(out, want)
        if bad:
            raise AssertionError(f"{tag} register_window at {key}: {bad} "
                                 f"values differ from the plain version")
    return len(kept)


# the evaluation entry's first calls on each path (evaluate_cost and
# sampled_covariance), the shapes held there, and the paths that must
# launch it
EVAL_HELD = {}
EVAL_PATHS = ("offline", "online", "evaluate_scans", "parallel_offline",
              "dryrun")
# paths whose registration runs only through the window and evaluation
# entries, which place their targets in the world inside the launch: no
# world_targets site launch there
WORLD_FREE_PATHS = ("offline", "online", "evaluate_scans", "batched",
                    "parallel_offline", "dryrun")


@contextlib.contextmanager
def evaluate_inputs():
    """For each (function, M, T, C, Ct, cost, loss, weight option) that
    ``evaluate_cost`` or ``sampled_covariance`` is called with on CUDA
    tensors inside the block, the first call's arguments and result,
    copied on the card: ``{key: (function name, args, kwargs, result)}``."""
    from tbv_slam_public_torch.ops import registration as treg

    kept = {}
    real = {n: getattr(treg, n) for n in ("evaluate_cost",
                                          "sampled_covariance")}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, tuple):
            return tuple(clone(v) for v in x)
        return x.map(lambda v: v.detach().clone()) if hasattr(x, "map") \
            else x

    def wrap(name):
        def keep(src, pose, tgt, tposes, smask, cfg, *rest, **kw):
            out = real[name](src, pose, tgt, tposes, smask, cfg, *rest, **kw)
            if pose.is_cuda:
                key = (name,) + tuple(src.valid.shape) + \
                    tuple(tgt.valid.shape[1:]) + (cfg.cost, cfg.loss,
                                                  cfg.weight_option)
                if key not in kept:
                    kept[key] = (name, [clone(a) for a in (
                        src, pose, tgt, tposes, smask)] + [cfg] + [
                        clone(a) for a in rest],
                        {k: clone(v) for k, v in kw.items()}, clone(out))
            return out
        return keep

    for name in real:
        setattr(treg, name, wrap(name))
    try:
        yield kept
    finally:
        for name, fn in real.items():
            setattr(treg, name, fn)


def hold_evaluate(tag, kept) -> int:
    """Each kept evaluation call against the plain version on its inputs on
    the card, bit for bit; returns the number of shapes held."""
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import registration as treg

    for key, (name, args, kw, out) in kept.items():
        with lk.plain_on_card():
            want = getattr(treg, name)(*args, **kw)
        bad = sum(bits_differ(g, w) for g, w in zip(out, want))
        if bad:
            raise AssertionError(f"{tag} {name} at {key[1:]}: {bad} values "
                                 f"differ from the plain version")
    return len(kept)


# coral_tail's launches by path, the shapes held there, and the paths that
# verify pairs with CorAl in this process
TAIL_LAUNCHES = {}
TAIL_HELD = {}
TAIL_PATHS = ("offline", "online", "evaluate_scans", "parallel_offline",
              "dryrun")


@contextlib.contextmanager
def tail_inputs():
    """For each (M, S, R, mode) that ``ops/coral.py::coral_tail`` is called
    with on CUDA tensors inside the block, the first call's moments, masks
    and result, copied on the card: ``{key: (args, eps, mode, result)}``."""
    from tbv_slam_public_torch.ops import coral

    kept = {}
    real = coral.coral_tail

    def keep(n, s1, s2, src_mask, ref_mask, eps=1e-8, mode="entropy"):
        out = real(n, s1, s2, src_mask, ref_mask, eps, mode)
        if n.is_cuda:
            key = (src_mask.shape[0], src_mask.shape[1], ref_mask.shape[1],
                   mode)
            if key not in kept:
                kept[key] = ([x.detach().clone() for x in
                              (n, s1, s2, src_mask, ref_mask)], eps, mode,
                             tuple(x.clone() for x in out))
        return out

    coral.coral_tail = keep
    try:
        yield kept
    finally:
        coral.coral_tail = real


def hold_tail(tag, kept) -> int:
    """Each kept ``coral_tail`` call against the plain version on its
    moments on the card, bit for bit; returns the number of shapes held."""
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import coral

    for key, (args, eps, mode, out) in kept.items():
        want = coral.coral_tail_reference(*args, eps, mode)
        bad = sum(bits_differ(g, w) for g, w in zip(out, want))
        if bad:
            raise AssertionError(f"{tag} coral_tail at {key}: {bad} values "
                                 f"differ from the plain version")
    return len(kept)


# the cell_stats kernel's launches by path, the shapes held there, and the
# paths that compute cells in this process
CELLS_LAUNCHES = {}
CELLS_HELD = {}
CELLS_PATHS = ("offline", "online", "batched", "dryrun")


@contextlib.contextmanager
def cells_inputs():
    """For each (P, C, configuration) that ``cell_stats`` is given on CUDA
    tensors inside the block (through ``compute_cells``), the first call's
    arguments and result, copied on the card: ``{key: (args, kwargs,
    outs)}``."""
    from tbv_slam_public_torch.ops import features as tf

    kept, real = {}, tf.cell_stats

    def keep(*args, **kw):
        out = real(*args, **kw)
        if args[0].is_cuda:
            key = (args[0].shape[0], args[3].shape[0], args[5],
                   tuple(kw.get("origin", args[6] if len(args) > 6 else
                                (0.0, 0.0))))
            if key not in kept:
                kept[key] = ([a.detach().clone() if isinstance(
                    a, torch.Tensor) else a for a in args], dict(kw),
                    [o.detach().clone() for o in out])
        return out

    tf.cell_stats = keep
    try:
        yield kept
    finally:
        tf.cell_stats = real


def cells_differ(got, want) -> int:
    """Cells (rows) of two ``cell_stats`` results that differ in any
    field's bits."""
    rows = None
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        d = (g != w).reshape(g.shape[0], -1).any(1)
        rows = d if rows is None else rows | d
    return int(rows.sum())


def hold_cells(tag, kept) -> int:
    """Each kept ``cell_stats`` call against the plain version on its inputs
    on the card, bit for bit; returns the number of shapes held."""
    from tbv_slam_public_torch.kernels import cells as kc
    from tbv_slam_public_torch.ops import features as tf

    for key, (args, kw, outs) in kept.items():
        with kc.plain_on_card():
            want = tf._cell_stats_reference(*args, **kw)
        bad = cells_differ(outs, want)
        if bad:
            raise AssertionError(f"{tag} cell_stats at {key[:2]}: {bad} "
                                 f"cells differ from the plain version")
    return len(kept)


@contextlib.contextmanager
def kernel_path(path):
    """One path of the main run: the refmath, registration, cell_stats and
    coral_tail kernels' counts are set to 0 just before the block and read
    just after (``REFMATH_LAUNCHES[path]``: by op and site,
    ``LM_LAUNCHES[path]``: window, solve and evaluate launches,
    ``CELLS_LAUNCHES[path]``, ``TAIL_LAUNCHES[path]``), then each kernel is
    held to its plain version at every op, site or shape the path gave it
    (``REFMATH_HELD``, ``WINDOW_HELD``, ``LM_HELD``, ``EVAL_HELD``,
    ``CELLS_HELD``, ``TAIL_HELD``)."""
    from tbv_slam_public_torch.kernels import cells as kc
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm

    rm.LAUNCHES = 0
    rm.LAUNCHES_BY_OP.clear()
    rm.STRIDED_OPERANDS.clear()
    lk.LAUNCHES = 0
    lk.LAUNCHES_BY_ENTRY.clear()
    kc.LAUNCHES = 0
    cm.TAIL_LAUNCHES = 0
    with refmath_inputs() as kept, lm_inputs() as lm_kept, \
            window_inputs() as win_kept, cells_inputs() as cells_kept, \
            evaluate_inputs() as eval_kept, tail_inputs() as tail_kept:
        yield
    REFMATH_LAUNCHES[path] = dict(rm.LAUNCHES_BY_OP, total=rm.LAUNCHES)
    REFMATH_STRIDED[path] = dict(rm.STRIDED_OPERANDS)
    if path in MUL_PATHS and rm.LAUNCHES_BY_OP.get("mul", 0) <= 0:
        raise AssertionError(f"the {path} path launched no refmath mul")
    LM_LAUNCHES[path] = dict(lk.LAUNCHES_BY_ENTRY, total=lk.LAUNCHES)
    CELLS_LAUNCHES[path] = kc.LAUNCHES
    TAIL_LAUNCHES[path] = cm.TAIL_LAUNCHES
    if cm.TAIL_LAUNCHES <= 0 and path in TAIL_PATHS:
        raise AssertionError(f"the {path} path launched no coral_tail")
    if rm.LAUNCHES <= 0:
        raise AssertionError(f"the {path} path launched no refmath kernel")
    if lk.LAUNCHES <= 0 and (path in LM_PATHS or path.startswith("variant")):
        raise AssertionError(f"the {path} path launched no registration "
                             f"kernel")
    if kc.LAUNCHES <= 0 and (path in CELLS_PATHS or
                             path.startswith("variant")):
        raise AssertionError(f"the {path} path launched no cell_stats "
                             f"kernel")
    if LM_LAUNCHES[path].get("evaluate", 0) <= 0 and path in EVAL_PATHS:
        raise AssertionError(f"the {path} path launched no evaluation "
                             f"entry")
    if path in WORLD_FREE_PATHS and \
            rm.LAUNCHES_BY_OP.get("world_targets", 0) != 0:
        raise AssertionError(f"the {path} path launched the world_targets "
                             f"site {rm.LAUNCHES_BY_OP['world_targets']} "
                             f"times")
    REFMATH_HELD[path] = hold_refmath(f"[{path}]", kept)
    WINDOW_HELD[path] = hold_window(f"[{path}]", win_kept)
    LM_HELD[path] = hold_lm(f"[{path}]", lm_kept)
    CELLS_HELD[path] = hold_cells(f"[{path}]", cells_kept)
    EVAL_HELD[path] = hold_evaluate(f"[{path}]", eval_kept)
    TAIL_HELD[path] = hold_tail(f"[{path}]", tail_kept)
    log(f"[coral_tail] {path}: {TAIL_LAUNCHES[path]} launches, bit-equal to "
        f"the plain version at its {TAIL_HELD[path]} shapes")
    log(f"[refmath] {path}: {REFMATH_LAUNCHES[path]} launches, strided "
        f"operands (read in place; a copy each where operands are made "
        f"contiguous) {REFMATH_STRIDED[path]}, "
        f"bit-equal to the plain version at its {REFMATH_HELD[path]} (op or "
        f"site, shapes); [registration] {LM_LAUNCHES[path]} launches, window "
        f"bit-equal at its {WINDOW_HELD[path]} shapes, solve at its "
        f"{LM_HELD[path]}, evaluate at its {EVAL_HELD[path]}; [cells] "
        f"{kc.LAUNCHES} launches, bit-equal at its {CELLS_HELD[path]} "
        f"shapes")


def _op_call(rm, op, args):
    return getattr(rm, op)(*args)


def phase_refmath():
    """The refmath op kernels against their plain versions: every op (and
    ``mul``) on 2^22 values with the special values, then on offset,
    strided and broadcast operands (2^18 + 3), bit for bit, one launch a call;
    ``mul`` on products at the flush tie; each kernel's registers and
    occupancy; ``dot`` at the fits' shapes; then each op's time at 1, 4,096
    and 2^19 values beside its plain version on the card, the torch call
    for the same function, its bound and the host's us a call of both;
    ``lu_solve`` at every size and at the fit's one system."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (REFMATH_ARITY,
                                                      REFMATH_LAYOUTS,
                                                      REFMATH_OPS,
                                                      bits_differ,
                                                      lu_subnormal_systems,
                                                      lu_systems,
                                                      op_operands,
                                                      tie_products)

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)

    def held(op, args, card, tag):
        before = rm.LAUNCHES
        got = _op_call(rm, op, card)
        torch.cuda.synchronize()
        if rm.LAUNCHES != before + 1:
            raise AssertionError(f"refmath {op} {tag}: "
                                 f"{rm.LAUNCHES - before} launches")
        want = _op_call(plain, op, args)
        pairs = zip(got, want) if op == "sincos" else [(got, want)]
        bad = sum(bits_differ(g, w) for g, w in pairs)
        if bad:
            raise AssertionError(f"refmath {op} {tag}: {bad} values differ "
                                 f"from the plain version")

    for op in REFMATH_OPS:
        args = op_operands(rng, op, 1 << 22, "contiguous")
        held(op, args, [a.to(dev) for a in args], "2^22 values")
        n = (1 << 18) + 3
        for layout in REFMATH_LAYOUTS[1:]:
            args = op_operands(rng, op, n, layout)
            if layout == "offset":
                card = [torch.empty(n + 1, device=dev)[1:].copy_(a)
                        for a in args]
            elif layout == "strided":
                card = [torch.empty(2 * n, device=dev)[::2].copy_(a)
                        for a in args]
            elif len(args) == 1:
                card = [args[0][:1].to(dev).expand(n)]
            else:
                card = [a.to(dev) for a in args]
            held(op, args, card, f"{layout} operands")
        log(f"[2] refmath {op}: 2^22 contiguous values with the special "
            f"values, 2^18 + 3 offset, strided and broadcast: bit-equal to "
            f"the plain version, one launch a call")
    # fma, half the products nearly cancelling their addend
    n = 1 << 22
    a, b = (torch.as_tensor((rng.normal(size=n) * np.exp(rng.uniform(
        -20, 20, n))).astype(np.float32)) for _ in range(2))
    near = -(a.double() * b.double()).numpy() * (1 + 1e-7 * rng.normal(
        size=n))
    c = torch.as_tensor(np.where(rng.uniform(size=n) < 0.5, near,
                                 rng.normal(size=n)).astype(np.float32))
    held("fma", [a, b, c], [a.to(dev), b.to(dev), c.to(dev)],
         "products nearly cancelling their addend")
    a, b = tie_products(rng, 512)
    sign = np.where(rng.uniform(size=512) < 0.5, -1.0, 1.0).astype(np.float32)
    args = [torch.as_tensor(a * sign), torch.as_tensor(b)]
    held("mul", args, [t.to(dev) for t in args], "tie products")
    if bool(plain.mul(*args).ne(0).any()):
        raise AssertionError("refmath mul: a tie product was not flushed")
    log("[2] refmath mul: 512 products at the flush tie flushed, bit-equal "
        "to the plain version")
    kernels = {}
    for op in rm.OPS:
        for path in rm.OP_PATHS:
            regs, blocks = rm.op_info(op, path)
            kernels[f"{op}_{path}"] = dict(registers=regs,
                                           blocks_per_sm=blocks)
    log("[2] refmath op kernels (registers, blocks of 256 a "
        "multiprocessor): " + ", ".join(
            f"{k} {v['registers']}/{v['blocks_per_sm']}"
            for k, v in kernels.items()))
    j = rng.normal(size=(1 << 18, 6, 3)).astype(np.float32)
    a = torch.as_tensor(np.einsum("nki,nkj->nij", j, j).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(1 << 18, 3)).astype(np.float32))
    t = torch.as_tensor(rng.normal(size=(1 << 18, 3)).astype(np.float32))
    for one in (False, True):
        bad = bits_differ(rm.lm_update(t.to(dev), a.to(dev), b.to(dev),
                                       one_system=one),
                          plain.lm_update(t, a, b, one_system=one))
        log(f"[2] refmath lm_update (one_system={one}): {1 << 18} systems, "
            f"{bad} values differ")
        if bad:
            raise AssertionError(f"refmath lm_update: {bad} values differ")
    # dot at the sampled covariance's fit (waves of 64 pairs offline, 12
    # online) and the logistic fit's (xb @ w, the Hessian over n rows); the
    # paths' own shapes are held where they run (``refmath_path``)
    for (m, k), c in (((64, 27), 10), ((12, 27), 10), ((1000, 5), 1),
                      ((5, 1000), 5)):
        a = torch.as_tensor(rng.uniform(0, 100, (m, k)).astype(np.float32))
        b = torch.as_tensor(rng.normal(size=(c, k)).astype(np.float32))
        bad = bits_differ(rm.dot(a.to(dev), b.to(dev)), plain.dot(a, b))
        log(f"[2] refmath dot [{m}, {k}] x [{c}, {k}]: {bad} differ")
        if bad:
            raise AssertionError(f"refmath dot: {bad} values differ")
    # loop_dot (the logistic gradient's sum) at every loop shape: n = 1..128
    # and 13 rows a training pair up to 120 pairs, 7 outputs
    for n in list(range(1, 129)) + [130, 260, 520, 1040, 1287, 1560]:
        x = torch.as_tensor((rng.normal(size=(7, n)) * np.exp(rng.uniform(
            -4, 4, (1, n)))).astype(np.float32))
        v = torch.as_tensor(rng.normal(size=n).astype(np.float32))
        bad = bits_differ(rm.loop_dot(x.to(dev), v.to(dev)),
                          plain.loop_dot(x, v))
        if bad:
            raise AssertionError(f"refmath loop_dot at n={n}: {bad} differ")
    log("[2] refmath loop_dot: bit-equal at n = 1..128 and 130..1560")
    # lu_solve (the logistic fit's Newton step) at every size it takes
    for k in range(1, 8):
        for make in (lu_systems, lu_subnormal_systems):
            h, g = (torch.as_tensor(a) for a in make(rng, 3000, k))
            bad = bits_differ(rm.lu_solve(h.to(dev), g.to(dev)),
                              plain.lu_solve(h, g))
            if bad:
                raise AssertionError(f"refmath lu_solve at k={k} "
                                     f"({make.__name__}): {bad} differ")
    log("[2] refmath lu_solve: bit-equal on 3000 systems and 3000 that "
        "reach the subnormal range at k = 1..7")
    times = {}
    for op in REFMATH_OPS:
        k = REFMATH_ARITY.get(op, 1)
        n_out = 2 if op == "sincos" else 1
        for size in (1, 4096, 1 << 19):
            args = [t.to(dev) for t in op_operands(rng, op, size,
                                                   "contiguous")]
            bytes_ = 4 * size * (k + n_out)
            t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
            t_ops = REFMATH_FLOPS[op] * size / PEAK_F32_FLOPS * 1e3
            lib = REFMATH_LIBRARY[op]
            call = lambda: _op_call(rm, op, args)
            t = dict(ms=cuda_ms(call, 50),
                     plain_ms=cuda_ms(lambda: _op_call(plain, op, args), 10),
                     library_ms=cuda_ms(lambda: lib(*args), 50)
                     if lib else None,
                     bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
            if size == 4096:
                t["host_us"] = host_us(call, 200)
                t["library_host_us"] = host_us(lambda: lib(*args), 200) \
                    if lib else None
                wide = [args[0]] + [a[:1] for a in args[1:]] if k > 1 \
                    else [args[0][:1].expand(size)]
                t["broadcast_ms"] = cuda_ms(lambda: _op_call(rm, op, wide),
                                            50)
            times[f"{op}_n{size}"] = t
            log(f"[2] refmath {op} at {size} values: {t['ms']:.4f} ms "
                f"(bound {t['bound_ms']:.6f} ms by {t['bound_by']}), plain "
                f"{t['plain_ms']:.4f} ms, torch {t['library_ms']} ms"
                + (f"; host {t['host_us']:.1f} us a call (torch "
                   f"{t['library_host_us']}), a broadcast operand "
                   f"{t['broadcast_ms']:.4f} ms" if size == 4096 else ""))
    # lu_solve at the fit's one 7 x 7 system: 63 values read, 7 written;
    # about 2 k^3 / 3 + 2 k^2 = 327 operations
    h, g = (torch.as_tensor(a, device=dev) for a in lu_systems(rng, 3, 7))
    h, g = h[0], g[0]
    by_bytes, by_ops = 4 * (49 + 7 + 7) / PEAK_BYTES_PER_S, \
        327 / PEAK_F32_FLOPS
    t = dict(ms=cuda_ms(lambda: rm.lu_solve(h, g), 50),
             plain_ms=cuda_ms(lambda: plain.lu_solve(h, g), 10),
             library_ms=cuda_ms(lambda: torch.linalg.solve(h, g), 50),
             bound_ms=max(by_bytes, by_ops) * 1e3,
             bound_by="bytes" if by_bytes >= by_ops else "operations")
    times["lu_solve_k7"] = t
    log(f"[2] refmath lu_solve at one 7 x 7 system: {t['ms']:.4f} ms "
        f"(bound {t['bound_ms']:.6f} ms), plain {t['plain_ms']:.4f} ms, "
        f"torch.linalg.solve {t['library_ms']:.4f} ms")
    return dict(max_abs_err=0.0, times=times, kernels=kernels,
                ceres=phase_ceres(rng))


# float32 operations a row of ceres_covariance, for the bound: the
# symmetrisation 18, ssytd2's reflector about 40, ssteqr's sweeps about 30
# each (3 a row counted), the LU factor about 30, three columns' solves about
# 20 each, the scale and products 12
CERES_OPS = 250
# ceres_covariance's bytes a row: h, the score and the count read, the
# covariance and the flag written
CERES_BYTES = 36 + 4 + 8 + 36 + 1


def phase_ceres(rng):
    """``refmath.ceres_covariance`` (``ceres_covariance``'s tail after its
    Hessian) against its plain version on the CPU on 2^16 Hessians of
    every kind (``kernels/checks.py::ceres_hessians``) for both residual
    dimensions, bit for bit (NaN payloads aside), one launch a call and no
    host synchronisation; then its time at the odometry step's one row and
    at 4,096 rows beside its plain version on the card (elementwise torch,
    every eigen sweep run), the ``torch.linalg`` path it replaced
    (``eigvalsh``, ``inv``, ``where``) and its bound."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (bits_differ,
                                                      ceres_hessians)

    dev = torch.device("cuda")
    h, score, n_res = (torch.as_tensor(a) for a in ceres_hessians(
        rng, 1 << 16))
    card = (h.to(dev), score.to(dev), n_res.to(dev))
    for p2l in (True, False):
        rm.LAUNCHES_BY_OP.clear()
        rm.ceres_covariance(*card, p2l=p2l)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rm.ceres_covariance(*card, p2l=p2l)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = plain.ceres_covariance(h, score, n_res, p2l=p2l)
        bad = bits_differ(got[0], want[0]) + bits_differ(got[1], want[1])
        log(f"[2] refmath ceres_covariance (p2l={p2l}): {h.shape[0]} "
            f"Hessians, {bad} values differ from the plain version, "
            f"{int(want[1].sum())} ok; launches {dict(rm.LAUNCHES_BY_OP)}")
        if bad or dict(rm.LAUNCHES_BY_OP) != {"ceres_covariance": 2}:
            raise AssertionError(f"refmath ceres_covariance: {bad} values "
                                 f"differ, launches "
                                 f"{dict(rm.LAUNCHES_BY_OP)}")

    def linalg(hh, ss, nn):
        ok = torch.linalg.eigvalsh(hh)[:, 0] > 1e-9
        denom = (nn - 3).to(hh.dtype)
        ok = ok & (denom > 0)
        hinv = torch.linalg.inv(hh + (~ok).to(hh.dtype)[:, None, None]
                                * torch.eye(3, device=hh.device))
        cov = (30.0 * ss / torch.clamp(denom, min=1.0))[:, None, None] * hinv
        return torch.where(ok[:, None, None], cov, hh.new_tensor(
            (0.01, 0.01, 0.0001)).diag()), ok

    # timed on the finite convex, indefinite and near-singular Hessians
    # (cuSOLVER raises on a NaN row)
    kind = torch.arange(h.shape[0]) % 5
    finite = (torch.isfinite(h).all(-1).all(-1) & (kind < 3)).nonzero()[
        :, 0].to(dev)
    times = {}
    for rows in (1, 4096):
        args = tuple(a[finite[:rows]] for a in card)
        by_bytes = CERES_BYTES * rows / PEAK_BYTES_PER_S
        by_ops = CERES_OPS * rows / PEAK_F32_FLOPS
        k1 = cuda_ms(lambda: rm.ceres_covariance(*args), 50)
        p1 = cuda_ms(lambda: plain.ceres_covariance(*args), 2, spin=False)
        k2 = cuda_ms(lambda: rm.ceres_covariance(*args), 50)
        t = dict(ms=min(k1, k2), ms_turns=[k1, k2], plain_ms=p1,
                 library_ms=None,
                 linalg_ms=cuda_ms(lambda: linalg(*args), 20, spin=False),
                 host_us=host_us(lambda: rm.ceres_covariance(*args)),
                 plain_host_us=host_us(lambda: plain.ceres_covariance(*args),
                                       2),
                 bound_ms=max(by_bytes, by_ops) * 1e3,
                 bound_by="bytes" if by_bytes >= by_ops else "operations")
        times[f"rows{rows}"] = t
        log(f"[2] refmath ceres_covariance at {rows} rows: {k1:.4f} / "
            f"{k2:.4f} ms (bound {t['bound_ms']:.7f} ms by "
            f"{t['bound_by']}), plain on the card {p1:.2f} ms, torch.linalg "
            f"{t['linalg_ms']:.4f} ms, host {t['host_us']:.1f} us a call "
            f"(plain {t['plain_host_us']:.0f})")
    return dict(max_abs_err=0.0, held=2 * h.shape[0], times=times)


# the solve entry's shapes: (B, T, C, the path's cost, inner iterations):
# register_joint's, and the window's at its paths' shapes
LM_SHAPES = {"odometry": (1, 4, 512, "P2P", 20),
             "odometry_b4": (4, 4, 512, "P2P", 20),
             "loop_wave": (64, 1, 512, "P2L", 10),
             "joint": (5, 5, 512, "P2P", 20),
             # a cell_capacity of 2048: P2D's row spread over the cluster
             "p2d_2048": (2, 4, 2048, "P2D", 20)}
# the window entry's shapes: (B, T, C = Ct, the path's cost, inner and outer
# iterations): the odometry step at B = 1 and 4, an online wave of 12
# candidates, an offline wave of 64 pairs, and cell_capacity 2048 with P2D
WINDOW_SHAPES = {"odometry": (1, 4, 512, "P2P", 20, 8),
                 "odometry_b4": (4, 4, 512, "P2P", 20, 8),
                 "online_wave": (12, 1, 512, "P2L", 10, 8),
                 "loop_wave": (64, 1, 512, "P2L", 10, 8),
                 "p2d_2048": (2, 4, 2048, "P2D", 20, 8)}
# the sampled covariance's grid (``sampled_covariance``'s defaults)
EVAL_GRID = (0.4, 0.0043625, 3)
# forced cluster sizes, at shapes whose rows fit one CTA
FORCED_SHAPES = {"odometry": (1, 4, 512, "P2P"), "wave": (3, 1, 512, "P2L"),
                 "p2d": (2, 3, 256, "P2D")}
# float32 operations a leaf an evaluation, counted from csrc/lm_solve.cu's
# leaf() with the Huber loss, a fused multiply-add as two: the transformed
# point 16 (P2P; P2L 20, P2D 31), the loss 6, the weights 2, the 15
# products of J^T [J | r], the 13 sums' adds; for the bound
LM_OPS_PER_LEAF = {"P2L": 56, "P2P": 52, "P2D": 67}
# float32 operations an association: each (source, target) pair's distance
# (2 sub, 2 mul, 1 add, 1 compare), and once an association the moved
# source cell, the gates and the weights (about 40; P2D's whitening 20 more)
ASSOC_OPS_PER_PAIR = 6
ASSOC_OPS = {"P2L": 40, "P2P": 40, "P2D": 60}


def _lm_bytes(b, t, c, cost, prior):
    """Bytes the solve must move: each input read once, outputs written
    once."""
    per_row = 12 + 8 * c + t * c * (8 + 4 + 1) + 20
    if cost == "P2L":
        per_row += 8 * t * c
    if cost == "P2D":
        per_row += 16 * t * c
    return b * per_row + (36 + 16 * b if prior else 0)


def _window_bound(b, t, c, ct, cost, inner, iterations):
    """Least time of one window call on these inputs: the larger of its
    bytes (source cells, world-frame targets and outputs, each once) over
    the memory rate and its float32 operations over the float32 rate,
    counted from the outer iterations each row ran (``iterations``) with
    every solve's 1 + inner evaluations."""
    n = t * c * (1 if cost == "P2L" else 2)
    outer = float(iterations.sum())
    ops = outer * (t * c * ct * ASSOC_OPS_PER_PAIR + t * c * ASSOC_OPS[cost]
                   + (1 + inner) * n * LM_OPS_PER_LEAF[cost])
    nbytes = b * (12 + c * (8 + 8 + 4 + 4 + 1)
                  + t * ct * (8 + 8 + 1 + 4 + 4 + (16 if cost == "P2D"
                                                    else 0))
                  + 12 + 4 + 8 + 8)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _window_case(prob, dev, cfg):
    """``register_window``'s arguments on the card for a window problem."""
    from tbv_slam_public_torch.core.types import Cells

    t = lambda k: torch.as_tensor(prob[k], device=dev)

    def cells(side):
        f = lambda k: t(f"{side}_{k}")
        return Cells(mean=f("mean"), cov=f("cov"), normal=f("normal"),
                     nsamples=f("nsamples"), planarity=f("planarity"),
                     avg_intensity=torch.zeros_like(f("nsamples")),
                     valid=f("valid"))

    kw = dict(guess=t("guess"), guess_sqrt_info=t("sqrt_info")) \
        if "guess" in prob else {}
    return (cells("src"), t("pose0"), cells("tgt"), t("tgt_poses"),
            t("scan_mask"), cfg), kw


def phase_registration():
    """The registration kernel against its plain versions on the card.
    Window entry: ``register_window`` bit for bit (pose, score, residual
    count, iterations) over every cost x loss x prior, one_system and the
    weight option 0-4 in turn, at the paths' shapes; forced cluster sizes
    1, 2, 4, 8 and forced candidates a pass 1-4 bit-identical; one window
    launch a call, no solve launch and no refmath launch (the targets are
    placed in the world inside it) at 1 and 8 outer iterations; the passes
    over the records a call against the serial loop's 1 + max_inner an
    outer iteration; then one call's time at the odometry, B = 4 and
    loop-wave shapes in turns against the plain path (kernel, plain, plain,
    kernel), the kernel's device time from the profiler, beside the bound,
    and the host's microseconds a call.  Solve entry: bit for bit in
    theta, cost and rel_dec over every cost x loss x prior x one_system at
    its shapes, timed; and on rows that stress its schedule
    (``kernels/checks.py::schedule_problem``: rows that accept then reject,
    reject for long runs, or have every cost NaN) at 7, 10 and 20
    iterations and 1-4 candidates a pass, their serial accept / reject
    strings read from the plain version."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (bits_differ,
                                                      lm_problem,
                                                      window_problem)
    from tbv_slam_public_torch.ops import registration as treg
    from tbv_slam_public_torch.ops.registration import cost_code

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    losses = ("none", "huber", "cauchy", "softlone", "tukey", "combined")
    held, times = 0, {}
    for tag, (b, tt, c, path_cost, inner, outer) in WINDOW_SHAPES.items():
        probs = [window_problem(rng, b, tt, c, c, with_prior=p)
                 for p in (False, True)]
        i = 0
        for cost in ("P2L", "P2D", "P2P"):
            for loss in losses:
                for with_prior in (False, True):
                    cfg = RegistrationConfig(
                        cost=cost, loss=loss, weight_option=i % 5,
                        max_inner_iterations=inner,
                        max_outer_iterations=outer)
                    args, kw = _window_case(probs[with_prior], dev, cfg)
                    one = b == 1 and i % 2 == 0
                    lk.LAUNCHES_BY_ENTRY.clear()
                    got = treg.register_window(*args, one_system=one, **kw)
                    if dict(lk.LAUNCHES_BY_ENTRY) != {"window": 1}:
                        raise AssertionError(
                            f"[2b] register_window {tag}: launches "
                            f"{dict(lk.LAUNCHES_BY_ENTRY)}, not one window")
                    with lk.plain_on_card():
                        want = treg.register_window(*args, one_system=one,
                                                    **kw)
                    bad = window_differ(got, want)
                    if bad:
                        raise AssertionError(
                            f"[2b] register_window {tag} {cost} {loss} "
                            f"prior {with_prior} one_system {one} weight "
                            f"{i % 5}: {bad} values differ")
                    held += 1
                    i += 1
        # a call launches the window entry and nothing else, whatever its
        # outer iterations (no world_targets site: the targets are placed
        # inside the launch)
        per_call = []
        for n_outer in (1, 8):
            cfg = RegistrationConfig(cost=path_cost,
                                     max_outer_iterations=n_outer)
            args, kw = _window_case(probs[0], dev, cfg)
            rm.LAUNCHES = 0
            lk.LAUNCHES_BY_ENTRY.clear()
            treg.register_window(*args, **kw)
            per_call.append((rm.LAUNCHES, dict(lk.LAUNCHES_BY_ENTRY)))
        if any(c != (0, {"window": 1}) for c in per_call):
            raise AssertionError(f"[2b] register_window {tag}: launches at "
                                 f"1 and 8 outer iterations {per_call}")
        cfg = RegistrationConfig(cost=path_cost, max_inner_iterations=inner,
                                 max_outer_iterations=outer)
        args, kw = _window_case(probs[0], dev, cfg)
        call = lambda: treg.register_window(*args, **kw)

        def plain():
            with lk.plain_on_card():
                return call()

        res = call()
        bound = _window_bound(b, tt, c, c, path_cost, inner,
                              res.iterations.cpu().numpy())
        # passes over the records: the kernel's, and the serial loop's
        # 1 + max_inner an outer iteration (1 where a row's count is <= 1)
        passes = torch.zeros(b, dtype=torch.int32, device=dev)
        _window_kernel(args, kw, passes=passes)
        ran = (res.num_residuals > 1).cpu()
        serial = int(torch.where(ran, res.iterations.cpu() * (1 + inner),
                                 res.iterations.cpu()).sum())
        WINDOW_PASSES[tag] = dict(passes=int(passes.sum()), serial=serial,
                                  rows=b)
        log(f"[2b] register_window {tag}: {int(passes.sum())} passes over "
            f"the records for {b} rows against the serial loop's {serial}")
        if tag in ("odometry", "odometry_b4", "loop_wave"):
            # in turns, by CUDA events (a call's host time may exceed its
            # device time, so these can be paced by the host), and the
            # kernel's own device time from the profiler
            k1 = cuda_ms(call, 20)
            p1 = cuda_ms(plain, 2)
            p2 = cuda_ms(plain, 2)
            k2 = cuda_ms(call, 20)
            prof_us, windows = device_us_by_kernel(
                call, want="registration_kernel")
            ms, source = _kernel_ms(prof_us, "registration_kernel", k1, k2,
                                    f"register_window {tag}")
            times[tag] = dict(
                B=b, T=tt, C=c, cost=path_cost, inner=inner, outer=outer,
                K=lk.cluster_size(b, tt, c, c, cost_code(path_cost), True),
                iterations=res.iterations.tolist(), ms=ms, ms_source=source,
                profiler_windows=windows,
                events_ms_turns=[k1, k2], plain_ms=min(p1, p2),
                plain_ms_turns=[p1, p2], host_us=host_us(call, 20),
                refmath_launches_a_call=per_call[0][0],
                passes=WINDOW_PASSES[tag], **bound)
            _share(f"register_window {tag}", bound["bound_ms"],
                   times[tag]["ms"])
            log(f"[2b] register_window {tag} B={b} T={tt} C={c} "
                f"{path_cost} K={times[tag]['K']} iterations "
                f"{times[tag]['iterations'][:8]}: {times[tag]['ms']:.4f} ms "
                f"of device time, {k1:.4f} / {k2:.4f} ms by events "
                f"(bound {bound['bound_ms']:.6f} ms by {bound['bound_by']}),"
                f" plain {p1:.2f} / {p2:.2f} ms, host "
                f"{times[tag]['host_us']:.1f} us a call, "
                f"{per_call[0][0]} refmath launches a call")
    log(f"[2b] register_window: bit-equal to the plain version in {held} "
        f"calls ({len(WINDOW_SHAPES)} shapes); one window launch a call")
    forced = 0
    for tag, (b, tt, c, cost) in FORCED_SHAPES.items():
        prob = window_problem(rng, b, tt, c, c, with_prior=True)
        prob["src_nsamples"][-1] = np.nan  # weight option 1: NaN costs
        for inner in (10, 20):
            cfg = RegistrationConfig(cost=cost, weight_option=1,
                                     max_inner_iterations=inner)
            args, kw = _window_case(prob, dev, cfg)
            with lk.plain_on_card():
                want = treg.register_window(*args, **kw)
            runs = [dict(cluster=k) for k in (1, 2, 4, 8)] + [
                dict(batch=n) for n in (1, 2, 3, 4)]
            for extra in runs:
                pose, score, n_res, used = _window_kernel(args, kw, **extra)
                bad = bits_differ(pose, want.pose) + bits_differ(
                    score, want.score) + int(
                    (n_res != want.num_residuals).sum()) + int(
                    (used != want.iterations).sum())
                if bad:
                    raise AssertionError(f"[2b] register_window {tag} "
                                         f"{inner} inner at {extra}: {bad} "
                                         f"values differ")
                forced += 1
    log(f"[2b] register_window: bit-identical at cluster sizes 1, 2, 4, 8 "
        f"and 1-4 candidates a pass, 10 and 20 inner iterations, a row of "
        f"NaN costs in each ({forced} calls)")

    t = lambda x: None if x is None else torch.as_tensor(x, device=dev)

    def args(prob, cost, loss, it, one):
        theta0, src, tm, tn, weight, mask, si, prior = prob
        ts = [t(theta0), t(src), t(tm), t(tn), t(weight), t(mask), t(si)]
        opts = dict(cost=cost, loss=loss, delta=0.1, max_iter=it,
                    init_lambda=1e-4, one_system=one,
                    prior=None if prior is None else tuple(map(t, prior)))
        return ts, opts

    solves, solve_times = 0, {}
    for tag, (b, tt, c, path_cost, it) in LM_SHAPES.items():
        for name in ("P2L", "P2D", "P2P"):
            cost = cost_code(name)
            for with_prior in (False, True):
                prob = lm_problem(rng, b, tt, c, name, with_prior)
                for loss in range(6):
                    for one in (False, True):
                        ts, opts = args(prob, cost, loss, it, one)
                        got = lk.lm_solve(*ts, **opts)
                        want = plain_lm(ts, opts)
                        bad = sum(bits_differ(g, w)
                                  for g, w in zip(got, want))
                        if bad:
                            raise AssertionError(
                                f"lm_solve {tag} {name} loss {loss} prior "
                                f"{with_prior} one_system {one}: {bad} "
                                f"values differ")
                        solves += 1
        prob = lm_problem(rng, b, tt, c, path_cost, False)
        ts, opts = args(prob, cost_code(path_cost), 1, it, b == 1)
        n = tt * c * (1 if path_cost == "P2L" else 2)
        ops = b * (it + 1) * n * LM_OPS_PER_LEAF[path_cost]
        by_bytes = _lm_bytes(b, tt, c, path_cost, False) / PEAK_BYTES_PER_S
        by_ops = ops / PEAK_F32_FLOPS
        solve_times[tag] = dict(
            B=b, T=tt, C=c, cost=path_cost, inner=it,
            ms=cuda_ms(lambda: lk.lm_solve(*ts, **opts), 20),
            plain_ms=cuda_ms(lambda: plain_lm(ts, opts), 3),
            bound_ms=max(by_bytes, by_ops) * 1e3,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            host_us=host_us(lambda: lk.lm_solve(*ts, **opts), 20))
        log(f"[2b] lm_solve {tag} B={b} T={tt} C={c} {path_cost} {it} "
            f"inner: {solve_times[tag]['ms']:.4f} ms (bound "
            f"{solve_times[tag]['bound_ms']:.6f} ms by "
            f"{solve_times[tag]['bound_by']}), plain "
            f"{solve_times[tag]['plain_ms']:.2f} ms, host "
            f"{solve_times[tag]['host_us']:.1f} us a call")
    log(f"[2b] lm_solve: bit-equal to the plain version in {solves} solves "
        f"(every cost x loss x prior x one_system at {len(LM_SHAPES)} "
        f"shapes)")
    schedule = _schedule_cases(rng, dev, args)
    return dict(max_abs_err=0.0, held=held, forced=forced, times=times,
                solves=solves, solve_times=solve_times, schedule=schedule,
                passes=WINDOW_PASSES)


# the window entry's passes over the records a call at each shape
WINDOW_PASSES = {}


def _window_kernel(args, kw, **extra):
    """``kernels/lm_solve.py::register_window`` on ``register_window``'s
    arguments (``extra``: cluster, batch, passes)."""
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.ops import registration as treg

    src, pose0, tgt, tposes, smask, cfg = args
    return lk.register_window(
        pose0, src.mean, src.normal, src.nsamples, src.planarity, src.valid,
        tposes, tgt.mean, tgt.normal, tgt.cov, tgt.valid, smask,
        tgt.nsamples, tgt.planarity, cost=treg.cost_code(cfg.cost),
        loss=treg.loss_code(cfg.loss), delta=cfg.loss_limit,
        max_inner=cfg.max_inner_iterations, init_lambda=cfg.init_lambda,
        max_outer=cfg.max_outer_iterations,
        min_outer=cfg.min_outer_iterations, radius=cfg.radius,
        angle_gate_cos=math.cos(math.radians(cfg.angle_gate_deg)),
        weight_option=cfg.weight_option, regularization=cfg.regularization,
        cov_scale=cfg.cov_scale, score_tolerance=cfg.score_tolerance,
        guess=kw.get("guess"), sqrt_info=kw.get("guess_sqrt_info"),
        one_system=kw.get("one_system", False), **extra)


def _serial_patterns(ts, opts):
    """Each row's accept / reject string of the plain serial LM solve on
    the card ("A" accepted, "r" rejected, "n" a NaN candidate cost)."""
    from types import SimpleNamespace

    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.ops import registration as treg

    theta, src, tm, tn, weight, mask, si = ts
    src = SimpleNamespace(mean=src)
    assoc = treg.Associations(tm, tn, weight, mask, si)
    kw = dict(cost=opts["cost"], loss=opts["loss"], delta=opts["delta"])
    out = [""] * theta.shape[0]
    with lk.plain_on_card():
        cur, g, h = treg._cost_grad_hess(theta, src, assoc, **kw)
        lam = torch.full_like(cur, opts["init_lambda"])
        for _ in range(opts["max_iter"]):
            damp = torch.diag_embed(rm.fma(lam[:, None], torch.diagonal(
                h, dim1=-2, dim2=-1), torch.full_like(g, 1e-12)))
            cand = rm.lm_update(theta, h + damp, g,
                                one_system=opts["one_system"])
            cc, cg, ch = treg._cost_grad_hess(cand, src, assoc, **kw)
            acc = cc < cur
            for r, (a, nan) in enumerate(zip(acc.tolist(),
                                             torch.isnan(cc).tolist())):
                out[r] += "A" if a else "n" if nan else "r"
            theta = torch.where(acc[:, None], cand, theta)
            g = torch.where(acc[:, None], cg, g)
            h = torch.where(acc[:, None, None], ch, h)
            lam = torch.where(acc, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
            cur = torch.where(acc, cc, cur)
    return out


def _schedule_cases(rng, dev, args):
    """The solve entry on rows that stress its schedule
    (``kernels/checks.py::schedule_problem``) at the odometry's and a loop
    wave's shapes, three losses and starting lambdas, 7, 10 and 20
    iterations, the kernel's default and 1-4 candidates a pass, bit for bit
    against the plain version; the rows' serial accept / reject strings
    give the passes each pass size takes and where they accepted."""
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels.checks import (bits_differ,
                                                      pass_slots,
                                                      schedule_problem)
    from tbv_slam_public_torch.ops.registration import cost_code

    held, slots, rejected, nan = 0, collections.Counter(), 0, 0
    for b, tt, c, cost, base in ((8, 4, 512, "P2P", 20),
                                 (8, 1, 512, "P2L", 10)):
        prob = schedule_problem(rng, b, tt, c, cost)
        for loss, lam0 in ((1, 1e-4), (4, 1e-9), (2, 1e5)):
            for it in sorted({base, 7, 10}):
                ts, opts = args(prob + (None,), cost_code(cost), loss, it,
                                False)
                opts["init_lambda"] = lam0
                want = plain_lm(ts, opts)
                for n in (None, 1, 2, 3, 4):
                    got = lk.lm_solve(*ts, batch=n, **opts)
                    bad = sum(bits_differ(g, w) for g, w in zip(got, want))
                    if bad:
                        raise AssertionError(
                            f"[2b] lm_solve schedule {cost} loss {loss} "
                            f"lambda {lam0} {it} iterations batch {n}: "
                            f"{bad} values differ")
                    held += 1
                pats = _serial_patterns(ts, opts)
                rejected += sum("A" not in pt for pt in pats)
                nan += sum("n" in pt for pt in pats)
                for k in (2, 3, 4):
                    for pt in pats:
                        for nb, j in pass_slots(pt, k):
                            if j is not None:
                                slots[(k, nb, j)] += 1
    last = {k: sum(v for (kk, nb, j), v in slots.items()
                   if kk == k and nb == k and j == k - 1) for k in (2, 3, 4)}
    log(f"[2b] lm_solve schedule: bit-equal in {held} solves; over the "
        f"rows' serial strings {rejected} rows rejected every candidate, "
        f"{nan} met a NaN cost, accepts at a full pass's last slot by "
        f"candidates a pass {last}")
    if not rejected or not nan or not any(last.values()):
        raise AssertionError(f"[2b] lm_solve schedule: a stress case did "
                             f"not occur ({rejected}, {nan}, {last})")
    return dict(held=held, all_rejected_rows=rejected, nan_rows=nan,
                last_slot_accepts=last)


# the evaluation entry's shapes: (M rows, T, C = Ct, the path's
# configuration): an offline loop wave's sampled covariance and CFEAR
# features (64 pairs), an online loop closure's candidates (12), a training
# pair's perturbations (13), an evaluate-scans pair's at SMALL's 192 cells,
# and the odometry's sampled covariance (one row against its window)
EVAL_SHAPES = {"loop_wave": (64, 1, 512, "loop"),
               "online_wave": (12, 1, 512, "loop"),
               "training": (13, 1, 512, "cfear"),
               "scan_pairs": (13, 1, 192, "cfear"),
               "odometry": (1, 4, 512, "odometry")}
# float32 operations a leaf of a cost-only pass, counted from
# csrc/lm_solve.cu's leaf() with the Huber loss (a fused multiply-add as
# two): the transformed point 16 (P2P; P2L 20, P2D 31), the loss 6, the
# weight 1, the sum's add 1; for the bound
EVAL_OPS_PER_LEAF = {"P2L": 28, "P2P": 24, "P2D": 39}


def _evaluate_bound(b, t, c, ct, cost, s):
    """Least time of one evaluation call: the larger of its bytes (the
    source cells, the world-frame targets, the offsets and the fit's
    pseudo-inverse read once, with the fit the score and residual count
    read and the covariance and its flag written; the costs, counts and fit
    written once) over the memory rate and its float32 operations (one
    association, S cost-only passes, the fit's 10 fused multiply-adds a
    sample; the 3 x 3 covariance's few hundred are left out) over the
    float32 rate."""
    n = t * c * (1 if cost == "P2L" else 2)
    fit = s > 1
    ops = b * (t * c * ct * ASSOC_OPS_PER_PAIR + t * c * ASSOC_OPS[cost]
               + s * n * EVAL_OPS_PER_LEAF[cost] + (20 * s if fit else 0))
    nbytes = b * (12 + c * (8 + 8 + 4 + 4 + 1)
                  + t * ct * (8 + 8 + 1 + 4 + 4 + (16 if cost == "P2D"
                                                    else 0))
                  + 4 * s + 8 + (40 + 12 + 36 + 1 if fit else 0)) \
        + (12 * s + 40 * s if fit else 0)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _eval_cfg(kind):
    """The path's registration configuration for an EVAL_SHAPES row."""
    from tbv_slam_public_torch.core.config import TBVConfig
    from tbv_slam_public_torch.models import loopclosure, verification

    tbv = TBVConfig()
    if kind == "loop":
        return loopclosure._loop_registration_cfg(tbv)
    if kind == "cfear":
        return verification._cfear_eval_cfg(tbv.verification)
    return tbv.registration


def phase_evaluation():
    """The registration kernel's evaluation entry against its plain
    versions on the card.  ``evaluate_cost`` (the cost and the residual
    count) and ``sampled_covariance`` (its 27 costs, their fit, the
    covariance and its convexity, all from the one launch) bit for bit over
    every cost x loss with the weight option 0-4 in turn, the CFEAR
    feature's and the loop registration's configurations, at the paths'
    shapes; one evaluate launch a call (the targets placed in the world
    inside it: no ``world_targets`` site launch), no other launch, and a
    sampled covariance run under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation);
    forced cluster sizes 1, 2, 4, 8 bit-identical (the covariance too);
    then a call's time at each shape in turns against the plain path
    (kernel, plain, plain, kernel: CUDA events behind the device-side
    spin), the kernel's device time from the profiler, the bound and the
    host's us a call."""
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (bits_differ,
                                                      evaluation_configs,
                                                      window_problem)
    from tbv_slam_public_torch.ops import registration as treg
    from tbv_slam_public_torch.ops.registration import cost_code

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    pinv, offs = treg._quad_fit_pinv(*EVAL_GRID, dev)
    held, times = 0, {}
    for tag, (b, tt, c, kind) in EVAL_SHAPES.items():
        prob = window_problem(rng, b, tt, c, c)
        for cfg in evaluation_configs() + [_eval_cfg(kind)]:
            args = _window_case(prob, dev, cfg)[0][:5]
            lk.LAUNCHES_BY_ENTRY.clear()
            rm.LAUNCHES_BY_OP.clear()
            cost, n_res = treg.evaluate_cost(*args, cfg)
            cov, convex = treg.sampled_covariance(*args, cfg, cost, n_res)
            costs, count, q, _, _ = treg._evaluate_on_card(
                *args, cfg, offsets=offs, pinv=pinv)
            if dict(lk.LAUNCHES_BY_ENTRY) != {"evaluate": 3} or \
                    dict(rm.LAUNCHES_BY_OP):
                raise AssertionError(
                    f"[2b] evaluate {tag}: launches "
                    f"{dict(lk.LAUNCHES_BY_ENTRY)}, refmath "
                    f"{dict(rm.LAUNCHES_BY_OP)}, not one evaluate launch "
                    f"a call and nothing else")
            with lk.plain_on_card():
                want = treg.evaluate_cost(*args, cfg) + \
                    treg.sampled_covariance(*args, cfg, cost, n_res) + \
                    treg._sampled_fit_reference(*args, cfg, *EVAL_GRID)
            got = (cost, n_res, cov, convex, costs, q)
            bad = sum(bits_differ(g, w) for g, w in zip(got, want)) + \
                bits_differ(count, want[1])
            if bad:
                raise AssertionError(
                    f"[2b] evaluate {tag} {cfg.cost} {cfg.loss} weight "
                    f"{cfg.weight_option}: {bad} values differ")
            held += 1
        cfg = _eval_cfg(kind)
        args = _window_case(prob, dev, cfg)[0][:5]
        code = cost_code(cfg.cost)
        if tag in ("loop_wave", "training"):  # forced cluster sizes
            with lk.plain_on_card():
                want_costs, want_q = treg._sampled_fit_reference(
                    *args, cfg, *EVAL_GRID)
                score, n_res = treg.evaluate_cost(*args, cfg)
                want_cov = treg._covariance_from_fit(want_q, code, score,
                                                     n_res, 4.0)
            for k in (1, 2, 4, 8):
                costs, _, q, cov, convex = lk.evaluate(
                    args[1], args[0].mean, args[0].normal,
                    args[0].nsamples, args[0].planarity, args[0].valid,
                    args[3], args[2].mean, args[2].normal, args[2].cov,
                    args[2].valid, args[4], args[2].nsamples,
                    args[2].planarity, cost=code, loss=treg.loss_code(cfg.loss),
                    delta=cfg.loss_limit, radius=cfg.radius,
                    angle_gate_cos=math.cos(math.radians(
                        cfg.angle_gate_deg)),
                    weight_option=cfg.weight_option,
                    regularization=cfg.regularization,
                    cov_scale=cfg.cov_scale, offsets=offs, pinv=pinv,
                    covariance=(score, n_res, 4.0, treg.DEFAULT_COV_DIAG),
                    cluster=k)
                bad = bits_differ(costs, want_costs) + bits_differ(
                    q, want_q) + bits_differ(cov, want_cov[0]) + \
                    bits_differ(convex, want_cov[1])
                if bad:
                    raise AssertionError(f"[2b] evaluate {tag} at K={k}: "
                                         f"{bad} values differ")
                held += 1
        cost, n_res = treg.evaluate_cost(*args, cfg)
        score = cost.clone()
        sampled = lambda: treg.sampled_covariance(*args, cfg, score, n_res)
        # a sampled covariance is one evaluate launch and nothing else, and
        # never waits on the card
        sampled()
        torch.cuda.synchronize()
        lk.LAUNCHES_BY_ENTRY.clear()
        rm.LAUNCHES_BY_OP.clear()
        rm_total, lk_total = rm.LAUNCHES, lk.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            sampled()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if dict(lk.LAUNCHES_BY_ENTRY) != {"evaluate": 1} or \
                dict(rm.LAUNCHES_BY_OP) or \
                rm.LAUNCHES != rm_total or lk.LAUNCHES != lk_total + 1:
            raise AssertionError(
                f"[2b] evaluate {tag}: a sampled covariance made "
                f"{dict(lk.LAUNCHES_BY_ENTRY)} {dict(rm.LAUNCHES_BY_OP)}")
        single = lambda: treg.evaluate_cost(*args, cfg)
        entry = {}
        for name, call, s in (("sampled_covariance", sampled, 27),
                              ("evaluate_cost", single, 1)):
            def plain(call=call):
                with lk.plain_on_card():
                    return call()

            k1 = cuda_ms(call, 20)
            p1 = cuda_ms(plain, 2)
            p2 = cuda_ms(plain, 2)
            k2 = cuda_ms(call, 20)
            prof_us, windows = device_us_by_kernel(
                call, want="evaluation_kernel")
            ms, source = _kernel_ms(prof_us, "evaluation_kernel", k1, k2,
                                    f"evaluate {tag} {name}")
            bound = _evaluate_bound(b, tt, c, c, cfg.cost, s)
            entry[name] = dict(
                ms=ms, ms_source=source, profiler_windows=windows,
                events_ms_turns=[k1, k2],
                plain_ms=min(p1, p2), plain_ms_turns=[p1, p2],
                host_us=host_us(call, 20), plain_host_us=host_us(plain, 3),
                **bound)
            _share(f"evaluate {tag} {name}", bound["bound_ms"],
                   entry[name]["ms"])
            log(f"[2b] evaluate {tag} M={b} T={tt} C={c} {cfg.cost} "
                f"{cfg.loss} K={lk.cluster_size(b, tt, c, c, code, True)} "
                f"{name}: {entry[name]['ms']:.4f} ms of device time, "
                f"{k1:.4f} / {k2:.4f} ms by events (bound "
                f"{bound['bound_ms']:.6f} ms by {bound['bound_by']}), plain "
                f"{p1:.2f} / {p2:.2f} ms, host {entry[name]['host_us']:.1f} "
                f"us a call (plain {entry[name]['plain_host_us']:.1f})")
        times[tag] = dict(M=b, T=tt, C=c, cost=cfg.cost, loss=cfg.loss,
                          K=lk.cluster_size(b, tt, c, c, code, True), **entry)
    log(f"[2b] evaluate: bit-equal to the plain version in {held} calls "
        f"({len(EVAL_SHAPES)} shapes, forced cluster sizes included); one "
        f"evaluate launch a call; a sampled covariance made no host "
        f"synchronisation (sync debug mode \"error\")")
    return dict(max_abs_err=0.0, held=held, times=times)


# coral_tail's shapes on the paths: (M, slots a cloud, live share, live
# slots first): an offline loop wave (64 pairs of 4,096-peak clouds), an
# online loop closure's 12 candidates, a training pair's 13 perturbations
# of the default 4,800-slot clouds (10 % live, live first) and an
# evaluate-scans pair's 13 at SMALL's 1,600 slots (k_strongest = 4)
TAIL_SHAPES = {"loop_wave": (64, 4096, 0.8, False),
               "online_loop": (12, 4096, 0.8, False),
               "training": (13, 4800, 0.1, True),
               "scan_pairs": (13, 1600, 0.8, False)}
# float32 operations a live query, counted from coral_tail_kernel in the
# entropy mode (a fused multiply-add as two, ref_log's 32): the joint sums
# 6, two means and covariances 2 x 26, two determinants 2 x 4, two
# entropies 2 x 35, the window's two adds 2
TAIL_OPS_PER_QUERY = 138


def _tail_bound(sm, rm):
    """Least time of one ``coral_tail`` launch: the larger of its bytes
    (each live query's 14 moment floats and every mask byte read once, 13
    bytes of outputs a pair written once) over the memory rate and its
    float32 operations over the float32 rate."""
    live = float(sm.sum() + rm.sum())
    nbytes = 56.0 * live + sm.numel() + rm.numel() + 13.0 * sm.shape[0]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = TAIL_OPS_PER_QUERY * live / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_coral_tail():
    """(2c) ``coral_tail`` against its plain version on the card, given the
    same moments (the pair kernel's on random clouds), bit for bit, in both
    modes at the paths' shapes, one launch a call, at the cluster size the
    launch chooses and at 1, 2, 4 and 8 CTAs a pair; then its time in turns
    with the plain tail (kernel, plain, plain, kernel: CUDA events behind
    the device-side spin), its bound, its cluster size and the host's us a
    call."""
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import coral

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    held, times = 0, {}
    for tag, (m, n, live, packed) in TAIL_SHAPES.items():
        sx, sm, rx, rm = _moment_inputs(rng, m, n, n, dev, live, 15.0,
                                        packed)
        moments = cm.pair_moments(sx, sm, rx, rm, 1.0)
        for mode in ("entropy", "kl"):
            want = coral.coral_tail_reference(*moments, sm, rm, 1e-8, mode)
            for forced in (0, 1, 2, 4, 8):
                before = cm.TAIL_LAUNCHES
                got = coral.CoralResult(*cm.coral_tail(
                    *moments, sm, rm, 1e-8, mode, cluster=forced))
                if cm.TAIL_LAUNCHES != before + 1:
                    raise AssertionError(
                        f"[2c] coral_tail {tag}: "
                        f"{cm.TAIL_LAUNCHES - before} launches")
                bad = sum(bits_differ(g, w) for g, w in zip(got, want))
                if bad or not bool(got.overlap.max() > 0):
                    raise AssertionError(
                        f"[2c] coral_tail {tag} {mode} cluster {forced}: "
                        f"{bad} values differ (or no overlap)")
                held += 1
        call = lambda: coral.coral_tail(*moments, sm, rm, 1e-8, "entropy")
        plain = lambda: coral.coral_tail_reference(*moments, sm, rm, 1e-8,
                                                   "entropy")
        k1 = cuda_ms(call, 20)
        cluster = cm.TAIL_CLUSTER
        p1 = cuda_ms(plain, 2)
        p2 = cuda_ms(plain, 2)
        k2 = cuda_ms(call, 20)
        bound = _tail_bound(sm, rm)
        ms = min(k1, k2)
        times[tag] = dict(M=m, slots=2 * n, live=live, ms=ms, cluster=cluster,
                          ms_turns=[k1, k2], plain_ms=min(p1, p2),
                          plain_ms_turns=[p1, p2], host_us=host_us(call, 20),
                          plain_host_us=host_us(plain, 3),
                          share=_share(f"coral_tail {tag}",
                                       bound["bound_ms"], ms), **bound)
        log(f"[2c] coral_tail {tag} M={m} Q=2x{n} {live:.0%} live, "
            f"{cluster} CTAs a pair: {k1:.4f} / {k2:.4f} ms (bound {bound['bound_ms']:.6f} ms by "
            f"{bound['bound_by']}, {100 * times[tag]['share']:.1f} %), plain "
            f"{p1:.3f} / {p2:.3f} ms, host {times[tag]['host_us']:.1f} us a "
            f"call (plain {times[tag]['plain_host_us']:.1f})")
    log(f"[2c] coral_tail: bit-equal to the plain version in {held} calls "
        f"({len(TAIL_SHAPES)} shapes x 2 modes x 5 cluster sizes), one "
        f"launch a call")
    return dict(max_abs_err=0.0, held=held, times=times)


def _sc_distance_torch(query, candidate, search_ratio=0.1):
    """``sc_distance`` as the port computed it before its sums were written
    out: torch's matmul for the Gram matrix, ``torch.linalg.norm`` for the
    column norms, torch's means and sums (the path the ScanContext kernel
    replaced; timed beside it, never used)."""
    s = query.shape[-1]
    dev = query.device
    vq, vc = query.mean(-2), candidate.mean(-2)
    cols = torch.arange(s, device=dev)
    src = torch.remainder(cols[None, :] - cols[:, None], s)
    center = torch.argmin(((vq[..., None, :] - vc[..., src]) ** 2).sum(-1), -1)
    g = query.transpose(-1, -2) @ candidate
    dot = g[..., cols[None, :], src]
    qn = torch.linalg.norm(query, dim=-2)
    cn = torch.linalg.norm(candidate, dim=-2)[..., src]
    eff = (qn[..., None, :] > 0) & (cn > 0)
    sim = torch.where(eff, dot / torch.clamp(qn[..., None, :] * cn,
                                             min=1e-20),
                      torch.zeros((), dtype=dot.dtype, device=dev))
    dists = 1.0 - sim.sum(-1) / torch.clamp(eff.sum(-1), min=1)
    radius = int(round(0.5 * search_ratio * s))
    c = center[..., None]
    circ = torch.minimum(torch.remainder(cols - c, s),
                         torch.remainder(c - cols, s))
    masked = torch.where(circ <= radius, dists,
                         torch.full((), math.inf, device=dev))
    best = torch.argmin(masked, -1)
    return torch.gather(masked, -1, best[..., None])[..., 0], best


# the ScanContext kernels' shapes on the main paths: retrieve's pairs
# [B, A, K] online (B = 1) and in an offline wave (B = 64)
SC_WAVES = (1, 64)


def phase_scancontext(loops, pose_graph):
    """ScanContext's kernels (``csrc/scancontext.cu``) on phase 4's
    keyframes against their plain versions on the CPU, bit for bit: both
    keys of every descriptor, the coupled ring-key distance of every
    keyframe to the ones before it, and the distance of each keyframe's
    descriptor to its 10 nearest by ring key (retrieve's pairs); then each
    kernel's time at the main path's shapes (CUDA events) beside its plain
    version on the card and the torch path it replaced (matmul,
    ``torch.linalg.norm``), and its bound.  Last, phase 4's pose graph
    optimised with its measured covariances
    (``pgo.replace_cov_by_identity=false``): ``measured_sqrt_info``'s
    kernel once, its output there and on those covariances with singular,
    zero, negative definite, asymmetric and non-finite rows added held to
    its plain version bit for bit, and timed on the path's inputs."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import scancontext

    db = loops.db
    n = int(db.mask.sum())
    desc, keys = db.desc[:n], db.ring[:n]
    sc = loops.cfg.scancontext
    dev = desc.device
    bad, errs = {}, {"sc_key": 0.0}
    for ring in (True, False):
        got = rm.sc_key(desc, ring=ring)
        want = rm._PLAIN["sc_key"](desc.cpu(), ring=ring)
        bad[f"key_{'ring' if ring else 'sector'}"] = bits_differ(got, want)
        errs["sc_key"] = max(errs["sc_key"], abs_err(got, want))
    hist = torch.ones(n, n, dtype=torch.bool, device=dev).tril(-1)
    odom = scancontext.odometry_similarity(db.odom_pose[:n, :2], hist,
                                           sc.odom_sigma_error)
    d2 = rm.sc_ring_distance(keys, keys, hist, odom)
    want = rm._PLAIN["sc_ring_distance"](keys.cpu(), keys.cpu(), hist.cpu(),
                                         odom.cpu())
    bad["ring_distance"] = bits_differ(d2, want)
    errs["sc_ring_distance"] = abs_err(d2, want)
    k = min(sc.num_candidates_from_tree, n)
    idx = torch.sort(want, dim=-1, stable=True)[1][:, :k]
    cands = desc[idx.to(dev)][:, None]  # [n, 1, K, R, S]
    dist, shift = rm.sc_distance(desc[:, None, None], cands,
                                 search_ratio=sc.search_ratio)
    wd, ws = rm._PLAIN["sc_distance"](desc[:, None, None].cpu(), cands.cpu(),
                                      search_ratio=sc.search_ratio)
    bad["distance"] = bits_differ(dist, wd) + int((shift.cpu() != ws).sum())
    errs["sc_distance"] = max(abs_err(dist, wd), abs_err(shift, ws))
    log(f"[4s] ScanContext on phase 4's {n} keyframes: values differing "
        f"from the plain version {bad}")
    if any(bad.values()):
        raise AssertionError(f"[4s] ScanContext kernels differ: {bad}")

    r_, s_ = desc.shape[-2:]
    times = {}
    rng = torch.Generator(device="cpu").manual_seed(43)
    for b in SC_WAVES:
        a = 1 + (len(sc.augment_offsets) if sc.augment_sc else 0)
        q = desc[torch.randint(0, n, (b, a), generator=rng).to(dev)]
        c = desc[torch.randint(0, n, (b, a, k), generator=rng).to(dev)]
        qq = q[:, :, None]
        call = lambda: rm.sc_distance(qq, c, search_ratio=sc.search_ratio)
        plain = lambda: rm._PLAIN["sc_distance"](qq, c,
                                                 search_ratio=sc.search_ratio)
        old = lambda: _sc_distance_torch(qq, c, sc.search_ratio)
        k1, o1, o2, k2 = (cuda_ms(call, 50), cuda_ms(old, 20),
                          cuda_ms(old, 20), cuda_ms(call, 50))
        pairs = b * a * k
        width = min(2 * int(round(0.5 * sc.search_ratio * s_)) + 1, s_)
        nbytes = 4 * r_ * s_ * (b * a + pairs) + 12 * pairs
        # Gram entries at the reached shifts, the alignment's squares and
        # sums, the norms, sums and keys
        ops = pairs * (2 * r_ * s_ * width + 4 * s_ * s_ + 8 * r_ * s_
                       + 6 * width * s_)
        times[f"sc_distance_b{b}"] = dict(
            ms=min(k1, k2), ms_turns=[k1, k2], torch_path_ms=min(o1, o2),
            torch_path_ms_turns=[o1, o2], plain_ms=cuda_ms(plain, 3),
            host_us=host_us(call), pairs=pairs,
            bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                         ops / PEAK_F32_FLOPS) * 1e3,
            bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >=
            ops / PEAK_F32_FLOPS else "operations", library_ms=None,
            max_abs_err=errs["sc_distance"])
        log(f"[4s] sc_distance at [{b}, {a}, {k}] pairs: {k1:.4f} / "
            f"{k2:.4f} ms (bound {times[f'sc_distance_b{b}']['bound_ms']:.6f}"
            f" ms), the torch path it replaced {o1:.4f} / {o2:.4f} ms")
        qk = keys[torch.randint(0, n, (b, a), generator=rng).to(dev)]
        m = hist[torch.randint(0, n, (b, 1), generator=rng).to(dev)]
        o = odom[torch.randint(0, n, (b, 1), generator=rng).to(dev)]
        ring = lambda: rm.sc_ring_distance(qk, keys, m, o)
        old_ring = lambda: torch.where(
            m, ((keys - qk[..., None, :]) ** 2).sum(-1) + (10.0 * o) ** 2,
            torch.full((), math.inf, device=dev))
        # the keys, the similarity and the distances at 4 bytes, the bool
        # mask at 1
        nb = 4 * (b * a * r_ + n * r_ + b * n + b * a * n) + b * n
        times[f"sc_ring_distance_b{b}"] = dict(
            ms=cuda_ms(ring, 50), torch_path_ms=cuda_ms(old_ring, 50),
            plain_ms=cuda_ms(lambda: rm._PLAIN["sc_ring_distance"](
                qk, keys, m, o), 5), host_us=host_us(ring),
            bound_ms=max(nb / PEAK_BYTES_PER_S,
                         3 * r_ * b * a * n / PEAK_F32_FLOPS) * 1e3,
            bound_by="bytes" if nb / PEAK_BYTES_PER_S >= 3 * r_ * b * a * n
            / PEAK_F32_FLOPS else "operations", library_ms=None,
            max_abs_err=errs["sc_ring_distance"])
        qd = desc[torch.randint(0, n, (b, a), generator=rng).to(dev)]
        key = lambda: rm.sc_key(qd, ring=True)
        nb = 4 * (b * a * r_ * s_ + b * a * r_)
        times[f"sc_key_b{b}"] = dict(
            ms=cuda_ms(key, 50), torch_path_ms=cuda_ms(lambda: qd.mean(-1),
                                                       50),
            plain_ms=cuda_ms(lambda: rm._PLAIN["sc_key"](qd), 5),
            host_us=host_us(key),
            bound_ms=max(nb / PEAK_BYTES_PER_S,
                         b * a * r_ * s_ / PEAK_F32_FLOPS) * 1e3,
            bound_by="bytes", library_ms=cuda_ms(lambda: qd.mean(-1), 50),
            max_abs_err=errs["sc_key"])
        log(f"[4s] sc_ring_distance at [{b}, {a}, {n}]: "
            f"{times[f'sc_ring_distance_b{b}']['ms']:.4f} ms (torch path "
            f"{times[f'sc_ring_distance_b{b}']['torch_path_ms']:.4f}); "
            f"sc_key at [{b}, {a}]: {times[f'sc_key_b{b}']['ms']:.4f} ms "
            f"(torch mean {times[f'sc_key_b{b}']['torch_path_ms']:.4f})")

    # phase 4's graph with its measured covariances: measured_sqrt_info
    import copy
    import dataclasses

    g = copy.copy(pose_graph)
    g.cfg = dataclasses.replace(g.cfg, pgo=dataclasses.replace(
        g.cfg.pgo, replace_cov_by_identity=False))
    seen, real = [], rm.measured_sqrt_info

    def spy(*ts):  # the path's own inputs and output
        out = real(*ts)
        seen.append([t.clone() for t in ts + (out,)])
        return out

    rm.measured_sqrt_info = spy
    try:
        with kernel_path("measured_cov"):
            res = g.optimize()
    finally:
        rm.measured_sqrt_info = real
    sqrt_launches = REFMATH_LAUNCHES["measured_cov"].get(
        "measured_sqrt_info", 0)
    if sqrt_launches != 1 or len(seen) != 1:
        raise AssertionError(f"[4s] the measured-covariance PGO launched "
                             f"measured_sqrt_info {sqrt_launches} times")
    cov, scale, fb, out = seen[0]
    e = cov.shape[0]
    want = rm._PLAIN["measured_sqrt_info"](cov.cpu(), scale.cpu(), fb.cpu())
    sqrt_bad = dict(path=bits_differ(out, want))
    sqrt_err = abs_err(out, want)
    # the path's rows and degenerate ones after them: rank 2, zero, negative
    # definite, indefinite, asymmetric, NaN and inf entries, rank 1
    rows = np.tile(np.eye(3, dtype=np.float32) * 1e-3, (8, 1, 1))
    rows[0, 2, 2] = 0.0
    rows[1] = 0.0
    rows[2] *= -1.0
    rows[3] = -np.diag([1e-3, 1e-3, -1e-3])
    rows[4, 0, 1] = 5e-3
    rows[5, 1, 1] = np.nan
    rows[6, 0, 0] = np.inf
    rows[7] = np.outer([1, 2, 3], [1, 2, 3]) * 1e-4
    cov_x = torch.cat([cov, torch.as_tensor(rows, device=dev)])
    scale_x = torch.cat([scale, scale[:1].expand(8)])
    fb_x = torch.cat([fb, fb[:1].expand(8, 3, 3)])
    got = rm.measured_sqrt_info(cov_x, scale_x, fb_x)
    want = rm._PLAIN["measured_sqrt_info"](cov_x.cpu(), scale_x.cpu(),
                                           fb_x.cpu())
    sqrt_bad["with_degenerate"] = bits_differ(got, want)
    sqrt_err = max(sqrt_err, abs_err(got, want))
    fallen = [2, 3, 5, 6]  # negative definite, indefinite, non-finite
    if any(sqrt_bad.values()) or not torch.equal(want[e:][fallen],
                                                 fb_x.cpu()[e:][fallen]):
        raise AssertionError(f"[4s] measured_sqrt_info differs from its "
                             f"plain version {sqrt_bad} (max abs err "
                             f"{sqrt_err}), or a degenerate row kept no "
                             f"fallback")
    call = lambda: rm.measured_sqrt_info(cov, scale, fb)
    t = dict(ms=cuda_ms(call, 50), max_abs_err=sqrt_err, held=sqrt_bad,
             plain_ms=cuda_ms(lambda: rm._PLAIN["measured_sqrt_info"](
                 cov, scale, fb), 3),
             library_ms=cuda_ms(lambda: torch.linalg.cholesky_ex(
                 torch.linalg.inv(cov))[0], 20),
             edges=e, launches=sqrt_launches,
             final_cost=float(res.cost))
    nb = 4 * e * (9 + 1 + 9 + 9)
    t.update(bound_ms=max(nb / PEAK_BYTES_PER_S,
                          250 * e / PEAK_F32_FLOPS) * 1e3,
             bound_by="bytes" if nb / PEAK_BYTES_PER_S >= 250 * e /
             PEAK_F32_FLOPS else "operations")
    times["measured_sqrt_info"] = t
    log(f"[4s] measured_sqrt_info: one launch in the measured-covariance "
        f"PGO ({e} edges, final cost {t['final_cost']:.6g}), values "
        f"differing from the plain version {sqrt_bad}, "
        f"{t['ms']:.4f} ms against the torch.linalg path "
        f"{t['library_ms']:.4f} ms")
    return dict(times=times, keyframes=n, held=bad)


def phase_real_clouds(loops, sm_hz):
    """The kernel on the offline run's keyframe clouds: consecutive keyframes
    as (src, ref) pairs in the odometry frame, stacked into the widths of a
    loop-verification wave and of one online query."""
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.kernels import coral_moments as cm

    dev = torch.device("cuda")
    world = [se2.apply_np(pose, pc.xy.astype(np.float32))
             for pose, pc in zip(loops.kf_odom, loops.kf_peaks)]
    out = {}
    for m in (64, 12):
        ids = np.arange(m) % (len(world) - 1)
        up = lambda rows: torch.as_tensor(np.stack(rows), device=dev)
        sx, rx = up([world[i + 1] for i in ids]), up([world[i] for i in ids])
        sm = up([loops.kf_peaks[i + 1].mask for i in ids])
        rm = up([loops.kf_peaks[i].mask for i in ids])
        pair = lambda: cm.pair_moments(sx, sm, rx, rm, 1.0)
        count = pair()[0]
        want = cm.pair_moments_reference(sx[:4], sm[:4], rx[:4], rm[:4], 1.0)
        if not torch.equal(count[:, :4], want[0]):
            raise AssertionError("coral count differs on the keyframe clouds")
        live = torch.cat([sm, rm], 1)
        bound = _pair_bound(sx, sm, rx, rm, count, sm_hz)
        res = dict(
            M=m, capacity=int(sm.shape[1]),
            live_fraction=float(live.float().mean()),
            neighbours_per_query=float(count.sum(0)[live].mean()),
            pair_ms=cuda_ms(pair, 20), bound_ms=bound,
            pair_host_us=host_us(pair))
        res["share"] = _share("keyframe clouds", bound, res["pair_ms"])
        res["kernels_us"], res["profiler_windows"] = \
            device_us_by_kernel(pair)
        out[f"M{m}"] = res
        log(f"[4] pair_moments on keyframe clouds: {json.dumps(res)}")
    return out


def phase_training_cloud(cloud, sm_hz):
    """The kernel on the online run's last training cloud, as the learner
    hands it on: 13 shifted copies of it as src against the cloud itself."""
    from tbv_slam_public_torch.kernels import coral_moments as cm

    n = cloud.mask.shape[-1]
    xy, mask = cloud.xy.reshape(-1, n, 2)[0], cloud.mask.reshape(-1, n)[0]
    steps = torch.arange(13, device=xy.device, dtype=xy.dtype)
    shift = torch.stack([0.1 * steps, -0.05 * steps], -1)
    sx = xy[None] + shift[:, None]
    sm = mask[None].expand(13, -1)
    rx = xy[None].expand(13, -1, -1)
    pair = lambda: cm.pair_moments(sx, sm, rx, sm, 1.0)
    got, again = pair(), pair()
    four = _four(cm, sx, sm, rx, sm, 1.0)
    want = cm.pair_moments_reference(sx, sm, rx, sm, 1.0)
    err = _check_moments("training cloud", got, want, again)
    if not all(torch.equal(g, f) for g, f in zip(got, four)):
        raise AssertionError("pair_moments differs from four launches on "
                             "the training cloud")
    live = int(mask.sum())
    bound = _pair_bound(sx, sm, rx, sm, got[0], sm_hz)
    res = dict(M=13, capacity=int(n), live_fraction=live / n,
               live_first=bool(mask[:live].all()), max_abs_err=err,
               neighbours_per_query=float(
                   got[0].sum(0)[torch.cat([sm, sm], 1)].mean()),
               pair_ms=cuda_ms(pair, 20), bound_ms=bound,
               pair_host_us=host_us(pair))
    res["share"] = _share("training cloud", bound, res["pair_ms"])
    log(f"[7] pair_moments on the last training cloud: {json.dumps(res)}")
    return res


CLI = [sys.executable, "-m", "tbv_slam_public_torch.harness.cli"]
SHOWN = ("frames", "keyframes", "loops", "pgo_epochs", "ate_rmse", "solver",
         "iterations", "ate_rmse_before", "ate_rmse_after")


def run_cli(cmd, tag):
    """One CLI subcommand in a process of its own (no ``--device``: the
    card); returns the JSON object of its last line."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"{tag} {cmd[3]} {' '.join(a for a in cmd[4:] if a.startswith('--'))}"
        f" ok in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps({k: out[k] for k in SHOWN if k in out})}")
    return out


def phase_cli():
    """Returns the text of the unchunked run's trajectory file and the
    CorAl launches of ``evaluate-scans``."""
    with tempfile.TemporaryDirectory() as tmp:
        slam = CLI + ["slam", "--graph",
                      os.path.join(tmp, "odo", "simple_graph.npz")] + SMALL \
            + ["verification.model_threshold=0.5"]
        runs = [
            CLI + ["odometry", "--dataset", SIM, "--output",
                   os.path.join(tmp, "odo")] + SMALL,
            slam + ["--output", os.path.join(tmp, "slam")],
            slam + ["--output", os.path.join(tmp, "slam_chol"),
                    "--solver", "cholesky"],
        ]
        for cmd in runs:
            run_cli(cmd, "[3]")
        launches = phase_evaluate_scans(
            os.path.join(tmp, "odo", "simple_graph.npz"),
            os.path.join(tmp, "scans.csv"))
        # baseline over a tree of two jobs: the two slam runs
        root = os.path.join(tmp, "sweep")
        for job, src in (("job_0", "slam"), ("job_1", "slam_chol")):
            for sub in ("est", "odom"):
                shutil.copytree(os.path.join(tmp, src, sub),
                                os.path.join(root, job, sub))
        proc = subprocess.run(CLI + ["baseline", "--root", root],
                              capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0 or "== TBV SLAM (est) ==" not in proc.stdout \
                or "job_1" not in proc.stdout:
            raise RuntimeError(f"baseline failed:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        log("[3] baseline ok:\n" + proc.stdout.split("\n\n")[0])
        with open(os.path.join(tmp, "odo", "odom", "00.txt")) as f:
            return f.read(), launches


def phase_evaluate_scans(graph, out):
    """``evaluate-scans --max-pairs 5`` in this process, so that its CorAl
    launches can be counted: one ``pair_moments`` launch per pair."""
    import contextlib
    import io

    from tbv_slam_public_torch.harness import cli
    from tbv_slam_public_torch.kernels import coral_moments as cm

    buf = io.StringIO()
    cm.LAUNCHES = 0  # evaluate-scans' launches are counted from here
    t0 = time.perf_counter()
    with kernel_path("evaluate_scans"), contextlib.redirect_stdout(buf):
        rc = cli.main(["evaluate-scans", "--graph", graph, "--output", out,
                       "--max-pairs", "5"] + SMALL)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = cm.LAUNCHES
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = np.loadtxt(out, delimiter=",", skiprows=1, ndmin=2)
    log(f"[3] evaluate-scans --max-pairs 5 ok in {secs:.1f} s: "
        f"{json.dumps(res)}, CorAl launches {launches}")
    if rc != 0 or res["pairs"] != 5 or rows.shape != (res["samples"], 11) \
            or not np.isfinite(rows).all() or launches != res["pairs"]:
        raise AssertionError(f"evaluate-scans: rc {rc}, {res}, rows "
                             f"{rows.shape}, {launches} launches")
    if rows[:, 4].sum() != res["pairs"]:  # the unperturbed pose once a pair
        raise AssertionError("evaluate-scans: aligned rows miscounted")
    return launches


def phase_slice(n_frames):
    import torch_workload as wl
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.models.odometry import OdometryPipeline

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seq = wl.revisiting_sequence(n_frames)
    gt = np.stack([se2.relative_np(seq.gt_poses[0], g)
                   for g in seq.gt_poses])
    log(f"[4] rendered N={n_frames} frames 400x3768 in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = wl.sensor_config()

    cm.LAUNCHES = 0  # the offline path's launches are counted from here
    with kernel_path("offline"):
        pipe = OdometryPipeline(cfg, device=dev)
        pipe.process(seq.images[0], stamp=0.0, gt_pose=gt[0])  # first frame
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n_frames):
            pipe.process(seq.images[i], stamp=0.25 * i, gt_pose=gt[i])
        torch.cuda.synchronize()
        odo_s = time.perf_counter() - t0
        g = wl.checkpoint_graph(pipe)
        slam_s, slam = wl.loop_stage(cfg, g, dev, warm=False)
    launches = cm.LAUNCHES

    # the first frames again, once with the registration kernel and once
    # with the plain registration on the card: the trajectories must be
    # bit-equal
    n_cmp = min(20, n_frames)

    def first_frames(plain):
        from tbv_slam_public_torch.kernels import lm_solve as lk

        p = OdometryPipeline(cfg, device=dev)
        with lk.plain_on_card() if plain else contextlib.nullcontext():
            for i in range(n_cmp):
                p.process(seq.images[i], stamp=0.25 * i, gt_pose=gt[i])
        return np.asarray(p.frame_poses)

    t0 = time.perf_counter()
    kernel_poses = first_frames(False)
    t1 = time.perf_counter()
    plain_poses = first_frames(True)
    t2 = time.perf_counter()
    if not (np.array_equal(kernel_poses, plain_poses) and np.array_equal(
            kernel_poses, np.asarray(pipe.frame_poses)[:n_cmp])):
        raise AssertionError(
            f"[4] {n_cmp} frames with the registration kernel and with the "
            f"plain registration differ: max gap "
            f"{np.abs(kernel_poses - plain_poses).max()}")
    log(f"[4] {n_cmp} frames bit-equal with the registration kernel "
        f"({t1 - t0:.2f} s) and the plain registration on the card "
        f"({t2 - t1:.2f} s)")

    s = slam.summary
    ate0 = tj.ate_rmse(g.kf_poses, g.kf_gt)
    ate1 = s.metrics["ate_rmse"]
    n_cand = len(slam.loops.candidate_log)
    est = slam.graph.poses_array()
    res = dict(frames=n_frames, odometry_frames_per_s=(n_frames - 1) / odo_s,
               keyframes=s.num_keyframes, candidates=n_cand,
               loops_accepted=s.num_loops, ate_before=ate0, ate_after=ate1,
               slam_s=slam_s, coral_launches=launches,
               plain_lm_frames_bit_equal=n_cmp,
               plain_lm_frames_s=t2 - t1, kernel_lm_frames_s=t1 - t0,
               frame_ate=tj.ate_rmse(np.asarray(pipe.frame_poses), gt))
    log(f"[4] {json.dumps(res)}")
    if est.shape != (s.num_keyframes, 3) or not np.isfinite(est).all():
        raise AssertionError("optimized poses are not finite [N, 3]")
    if n_cand <= 0 or launches <= 0:
        raise AssertionError(f"no loop candidates ({n_cand}) or no CorAl "
                             f"kernel launches ({launches})")
    if not ate1 <= ate0 + 1e-3:
        raise AssertionError(f"PGO made ATE worse: {ate0} -> {ate1}")
    return launches, seq.images, gt, cfg, slam.loops, \
        np.asarray(pipe.frame_poses), g, slam.graph


VARIANTS = [("default", None), ("P2D", "registration.cost=P2D"),
            ("time-continuous", "odometry.time_continuous=true"),
            ("ceres", "odometry.cov_source=ceres"),
            ("cacfar", "radar.filter_type=cacfar"),
            ("bfar", "radar.filter_type=bfar"),
            ("mulran", "radar.num_range_bins=3360 radar.range_res=0.05952")]
VARIANT_FRAMES, CPU_FRAMES = 40, 5
# the ceres variant's frames/s, at least this share of the default's in the
# same run
CERES_PACE = 0.2


def _mulran_images(n_frames):
    """Simulator images at MulRan's shapes (400 x 3360 bins at 0.05952 m;
    the card machine may lack PIL, so no PNG is read) along phase 4's
    circle, and their ground truth from the first pose."""
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.io import simulate

    seq = simulate.make_sequence(
        num_frames=n_frames, seed=8, num_azimuths=400, num_range_bins=3360,
        range_res=0.05952, traj_kwargs=dict(radius=22.0, step=0.8,
                                            laps=0.25))
    return seq.images, np.stack([se2.relative_np(seq.gt_poses[0], g)
                                 for g in seq.gt_poses])


def _pose_gap(a, b):
    """Largest position and heading gap between two [N, 3] trajectories."""
    d = b[:, 2] - a[:, 2]
    return (float(np.linalg.norm(a[:, :2] - b[:, :2], axis=1).max()),
            float(np.abs(np.arctan2(np.sin(d), np.cos(d))).max()))


def phase_variants(images, gt, cfg):
    """Each odometry variant over phase 4's first 40 images on the card (the
    MulRan row over 40 simulator images at its own shapes), and its first 5
    frames again on the CPU."""
    from tbv_slam_public_torch.core.config import (apply_overrides,
                                                   parse_cli_overrides)
    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.models.odometry import OdometryPipeline

    out = {}
    phase4 = images, gt
    for name, override in VARIANTS:
        vcfg = cfg if override is None else apply_overrides(
            cfg, parse_cli_overrides(override.split()))
        images, gt = _mulran_images(VARIANT_FRAMES) if name == "mulran" \
            else phase4
        with kernel_path(f"variant_{name}"):
            pipe = OdometryPipeline(vcfg, device=torch.device("cuda"))
            pipe.process(images[0], stamp=0.0, gt_pose=gt[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(1, VARIANT_FRAMES):
                pipe.process(images[i], stamp=0.25 * i, gt_pose=gt[i])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        card = np.asarray(pipe.frame_poses)
        cpu = OdometryPipeline(vcfg, device="cpu")
        t0 = time.perf_counter()
        for i in range(CPU_FRAMES):
            cpu.process(images[i], stamp=0.25 * i)
        cpu_s = time.perf_counter() - t0
        cpu_poses = np.asarray(cpu.frame_poses)
        gap_m, gap_rad = _pose_gap(card[:CPU_FRAMES], cpu_poses)
        per_frame = np.linalg.norm(card[:CPU_FRAMES, :2] - cpu_poses[:, :2],
                                   axis=1)
        covs = np.asarray(pipe.frame_covs[1:])
        res = dict(variant=name, override=override,
                   frames_per_s=(VARIANT_FRAMES - 1) / secs,
                   keyframes=len(pipe.kf_poses),
                   ate=tj.ate_rmse(card, gt[:VARIANT_FRAMES]),
                   final_pose=card[-1].tolist(),
                   mean_cov_diag=np.diagonal(covs, 0, 1, 2).mean(0).tolist(),
                   cpu_frames_per_s=CPU_FRAMES / cpu_s,
                   card_vs_cpu_m=gap_m, card_vs_cpu_rad=gap_rad,
                   card_vs_cpu_m_per_frame=per_frame.tolist())
        log(f"[8] {json.dumps(res)}")
        if not np.isfinite(card).all() or not np.isfinite(covs).all():
            raise AssertionError(f"{name}: poses or covariances not finite")
        if not (gap_m <= POSE_ATOL_M and gap_rad <= POSE_ATOL_RAD):
            raise AssertionError(f"{name}: the card's first {CPU_FRAMES} "
                                 f"poses are {gap_m} m / {gap_rad} rad off "
                                 f"the CPU's")
        if len(pipe.kf_poses) < 2:
            raise AssertionError(f"{name}: no keyframe after the first")
        if name == "ceres":
            res["ceres_sync_free"] = _ceres_sync_free(pipe, vcfg)
            tail = REFMATH_LAUNCHES["variant_ceres"].get("ceres_covariance", 0)
            if tail <= 0:
                raise AssertionError("ceres: the path launched no "
                                     "ceres_covariance")
            # a keyframe's covariance is a few launches more than a frame's
            # registration: the variant keeps pace with the default one
            share = res["frames_per_s"] / out["default"]["frames_per_s"]
            res["frames_per_s_share_of_default"] = share
            if share < CERES_PACE:
                raise AssertionError(f"ceres: {res['frames_per_s']:.2f} "
                                     f"frames/s, {share:.1%} of the default "
                                     f"variant's (at least {CERES_PACE:.0%})")
        out[name] = res
    return out


def _ceres_sync_free(pipe, cfg) -> dict:
    """``ceres_covariance`` on the run's newest keyframe against the rest of
    its window, on the card: the tail one ``ceres_covariance`` launch, no
    library call and no host synchronisation (run under
    ``torch.cuda.set_sync_debug_mode("error")`` after a warm-up call), and
    its covariance and flag equal to the same call's on the CPU, bit for
    bit; the host's time a call."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import registration as treg

    st = pipe.state
    src = st.kf_cells.map(lambda x: x[-1:])
    tgt = st.kf_cells.map(lambda x: x[None, :-1])
    theta = st.kf_poses[-1:]
    args = (src, theta, tgt, st.kf_poses[None, :-1], st.kf_mask[None, :-1],
            cfg.registration, torch.ones(1, device=theta.device),
            torch.full((1,), 300, device=theta.device))
    call = lambda: treg.ceres_covariance(*args)
    call()
    torch.cuda.synchronize()
    rm.LAUNCHES_BY_OP.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        cov, ok = call()
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tail_launches = rm.LAUNCHES_BY_OP["ceres_covariance"]
    want = treg.ceres_covariance(*(a.map(lambda x: x.cpu()) if hasattr(
        a, "map") else a.cpu() if isinstance(a, torch.Tensor) else a
        for a in args))
    res = dict(ok=bool(ok[0]), host_ms=host_s * 1e3,
               host_ms_mean=host_us(call, 20) / 1e3,
               tail_launches=tail_launches,
               card_vs_cpu_differ=bits_differ(cov, want[0])
               + bits_differ(ok, want[1]))
    log(f"[8] ceres_covariance on the card under sync debug mode "
        f"\"error\": {res}")
    if res["card_vs_cpu_differ"] or tail_launches != 1:
        raise AssertionError(f"[8] ceres_covariance: {res['card_vs_cpu_differ']}"
                             f" values differ from the CPU's, "
                             f"{tail_launches} tail launches")
    return res


def _launches_per_call(fn) -> int:
    """Kernel launches the host makes in one call of ``fn`` (runtime launch
    calls seen by ``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"))


def phase_batched(images, gt, cfg, single_poses):
    """``batched_odometry_step`` at B = 4 over four simulator seeds (phase
    4's sequence and three more, 20 frames each); every row against its own
    B = 1 run."""
    import torch_workload as wl
    from tbv_slam_public_torch.models import odometry as om

    n, b, dev = 20, 4, torch.device("cuda")
    seqs = [images[:n]] + [wl.revisiting_sequence(
        n, seed, circle_frames=len(images)).images for seed in (11, 12, 13)]
    frames = torch.as_tensor(np.stack(seqs, 1), device=dev)  # [n, B, A, R]

    def run(rows):
        st = om.init_batched_state(cfg, len(rows), device=dev)
        st, out = om.batched_first_frame(st, frames[0, rows], cfg)
        poses = [out.pose]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(1, n):
            st, out = om.batched_odometry_step(st, frames[k, rows], cfg)
            poses.append(out.pose)
        torch.cuda.synchronize()
        return torch.stack(poses, 1).cpu().numpy(), \
            time.perf_counter() - t0, st

    with kernel_path("batched"):
        batch, secs, st = run(list(range(b)))
        # B = 2 over the first two sequences: phase 10(b) runs them one a
        # rank
        pair = dict(images=frames[:, :2].cpu().numpy(),
                    poses=run([0, 1])[0])
        alone = [run([r]) for r in range(1, b)]
        repeat = run([1])[0][0]
    singles = [single_poses[:n]] + [a[0][0] for a in alone]
    gaps = [_pose_gap(batch[r], singles[r]) for r in range(b)]
    b1_rate = (n - 1) * len(alone) / sum(a[1] for a in alone)
    repeat_equal = bool(np.array_equal(repeat, singles[1]))
    step = lambda rows, s: lambda: om.batched_odometry_step(
        s, frames[n - 1, rows], cfg)
    res = dict(B=b, frames=n, aggregate_frames_per_s=b * (n - 1) / secs,
               steps_per_s=(n - 1) / secs, b1_frames_per_s=b1_rate,
               speedup=b * (n - 1) / secs / b1_rate,
               launches_per_step_b1=_launches_per_call(
                   step([0], st.map(lambda x: x[:1]))),
               launches_per_step_b4=_launches_per_call(step(list(range(b)),
                                                            st)),
               b1_runs_bit_equal=repeat_equal,
               row_vs_single_m=[g[0] for g in gaps],
               row_vs_single_rad=[g[1] for g in gaps])
    log(f"[9] batched odometry: {json.dumps(res)}")
    if not repeat_equal:
        raise AssertionError("two B = 1 runs of one sequence differ")
    if not all(m <= POSE_ATOL_M and r <= POSE_ATOL_RAD for m, r in gaps):
        raise AssertionError(f"a row of the batch is off its B = 1 run: "
                             f"{gaps}")
    return res, pair


def _world_peaks(loops, ids, dev):
    """Keyframe peaks clouds [K, P] moved to the odometry frame."""
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.core.types import PointCloud

    up = lambda rows: torch.as_tensor(np.stack(rows), device=dev)
    return PointCloud(
        xy=up([se2.apply_np(loops.kf_odom[i], loops.kf_peaks[i].xy)
               for i in ids]),
        intensity=up([loops.kf_peaks[i].intensity for i in ids]),
        mask=up([loops.kf_peaks[i].mask for i in ids]))


def _world_cells(loops, ids, dev):
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.core.types import Cells

    up = lambda rows: torch.as_tensor(np.stack(rows), device=dev)
    cells = Cells(**{f: up([getattr(loops.kf_cells[i], f) for i in ids])
                     for f in ("mean", "cov", "normal", "nsamples",
                               "planarity", "avg_intensity", "valid")})
    pose = up([loops.kf_odom[i] for i in ids])
    rot = se2.rotmat(pose[:, 2])[:, None]
    return cells.replace(mean=se2.apply(pose, cells.mean),
                         cov=rot @ cells.cov @ rot.transpose(-1, -2))


def phase_rest(images, cfg, loops):
    """Max-mode retrieval, the Cen detectors, the quality metrics and joint
    registration on phase 4's images and keyframes."""
    import dataclasses

    from tbv_slam_public_torch.core.types import stack_records
    from tbv_slam_public_torch.models import loopclosure as lp
    from tbv_slam_public_torch.ops import cen, quality, registration

    dev = torch.device("cuda")
    out = {}
    # ScanContext retrieval with max-mode descriptors (and sum mode beside)
    for mode in ("max", "sum"):
        mcfg = dataclasses.replace(cfg, scancontext=dataclasses.replace(
            cfg.scancontext, desc_function=mode))
        lc = lp.LoopCloser(mcfg, device=dev)
        for p, c, o in zip(loops.kf_peaks, loops.kf_cells, loops.kf_odom):
            lc.add_keyframe(p, c, o)
        n = len(lc.kf_odom)
        lc._ensure_capacity(n)
        _, peaks, odom = lc._device_store()
        q = torch.arange(n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, r = lp.build_contexts_batched(peaks, odom, q, n, mcfg)
        lp.db_insert_batch(lc.db, q, d[:, 0], r[:, 0], odom[q])
        det = lp.detect(lc.db, d, r, q, mcfg)
        candidates = int(det.valid.sum())
        ms = (time.perf_counter() - t0) * 1e3
        occupied = float((d[:, 0] != mcfg.scancontext.no_point).float()
                         .mean())
        out[f"retrieval_{mode}"] = dict(keyframes=n, candidates=candidates,
                                        ms=ms, occupied_bins=occupied)
        if not torch.isfinite(d).all() or candidates <= 0:
            raise AssertionError(f"{mode}-mode retrieval: {candidates} "
                                 f"candidates")
    log(f"[9] retrieval: {json.dumps({k: v for k, v in out.items()})}")

    # Cen 2018 on the card, Cen 2019 on the host
    imgs = torch.as_tensor(images[:20], device=dev)
    cen.cen2018_filter(imgs[0], cfg.radar)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det18 = [int(cen.cen2018_filter(im, cfg.radar).mask.sum()) for im in imgs]
    torch.cuda.synchronize()
    ms18 = (time.perf_counter() - t0) * 1e3 / len(imgs)
    cpu18 = cen.cen2018_filter(torch.as_tensor(images[0]), cfg.radar)
    t0 = time.perf_counter()
    det19 = [int(cen.cen2019_filter(images[i], cfg.radar, device=dev)
                 .mask.sum()) for i in range(3)]
    ms19 = (time.perf_counter() - t0) * 1e3 / 3
    out["cen"] = dict(cen2018_ms_per_image=ms18,
                      cen2018_detections=float(np.mean(det18)),
                      cen2018_cpu_detections_image0=int(cpu18.mask.sum()),
                      cen2019_host_ms_per_image=ms19,
                      cen2019_detections=float(np.mean(det19)))
    log(f"[9] cen: {json.dumps(out['cen'])}")
    if min(det18) <= 0 or min(det19) <= 0:
        raise AssertionError(f"a Cen detector found nothing: {out['cen']}")

    # quality metrics of consecutive keyframe pairs, 8 pairs a call
    n = len(loops.kf_odom)
    sums, pairs = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n - 1, 8):
        ids = list(range(lo, min(lo + 8, n - 1)))
        src = _world_peaks(loops, [i + 1 for i in ids], dev)
        ref = _world_peaks(loops, ids, dev)
        ref_cells = _world_cells(loops, ids, dev)
        vals = dict(p2p=quality.p2p_quality(src, ref)[0],
                    repeatability=quality.keypoint_repeatability(src, ref),
                    p2d=quality.p2d_quality(src, ref_cells)[0],
                    cartesian_absdiff=quality.cartesian_absdiff_quality(
                        src, ref))
        for k, v in vals.items():
            sums[k] = sums.get(k, 0.0) + float(v.sum())
        pairs += len(ids)
    ms = (time.perf_counter() - t0) * 1e3
    out["quality"] = dict(pairs=pairs, ms=ms,
                          **{k: v / pairs for k, v in sums.items()})
    log(f"[9] quality metrics, mean over consecutive keyframe pairs: "
        f"{json.dumps(out['quality'])}")
    if not all(np.isfinite(v) for v in sums.values()) \
            or not 0.0 < out["quality"]["repeatability"] <= 1.0:
        raise AssertionError(f"quality metrics: {out['quality']}")

    # joint refinement of the last 5 keyframes (the first held as gauge)
    ids = list(range(n - 5, n))
    scans = stack_records([loops.kf_cells[i].map(
        lambda x: torch.as_tensor(x, device=dev)) for i in ids])
    poses0 = torch.as_tensor(np.stack([loops.kf_odom[i] for i in ids]),
                             device=dev)
    valid = torch.ones(5, dtype=torch.bool, device=dev)
    joint = lambda: registration.register_joint(
        scans, poses0, valid, ~valid, cfg.registration)
    res = joint()
    ms = cuda_ms(joint, 3, spin=False)
    change = (res.pose - poses0).abs().cpu().numpy()  # [5, 3]
    out["joint"] = dict(scans=5, ms=ms, score=float(res.score),
                        residuals=int(res.num_residuals),
                        max_change=change.max(0).tolist(),
                        gauge_moved=float(change[0].max()))
    log(f"[9] register_joint: {json.dumps(out['joint'])}")
    if not bool(res.success) or not torch.isfinite(res.pose).all() or \
            out["joint"]["gauge_moved"] != 0.0:
        raise AssertionError(f"register_joint: {out['joint']}")
    return out


def _oxford_instance(dev):
    """The 4470-node Oxford real-odometry instance as tensors on ``dev``."""
    from tbv_slam_public_torch.core.config import PGOConfig
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.ops import posegraph

    z = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    cfg = PGOConfig()
    m = inst.mask
    et = torch.as_tensor(inst.etype[m].astype(np.int64), device=dev)
    edges = posegraph.make_edges(inst.idx[m], inst.meas[m],
                                 posegraph.default_sqrt_info(et, cfg), et,
                                 m[m], device=dev)
    n = len(inst.poses)
    return (inst, cfg, edges, torch.as_tensor(inst.poses, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev))


def _run_solver(tag, solver, inst, cfg, edges, poses, node_mask):
    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.ops import posegraph

    n_loop = int((edges.mask & ~posegraph._is_chain(edges)).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = posegraph.optimize(poses, node_mask, edges, cfg, solver=solver,
                             loop_cap=n_loop if solver == "schur" else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(solver=solver, nodes=len(inst.poses), loops=inst.n_loops,
               ate_before=tj.ate_rmse(inst.poses, inst.gt),
               ate_after=tj.ate_rmse(res.poses.cpu().numpy(), inst.gt),
               wall_s=wall, iterations=int(res.iterations),
               cost0=float(res.cost0), cost=float(res.cost))
    log(f"{tag} {json.dumps(out)}")
    return out, res


def phase_pgo():
    inst = _oxford_instance(torch.device("cuda"))
    with kernel_path("pgo_cholesky"):
        out, _ = _run_solver("[5]", "cholesky", *inst)
    if not (6.5 < out["ate_before"] < 8.0 and out["ate_after"] < 4.072):
        raise AssertionError(f"PGO ATE outside its bands: {out}")
    return inst


def phase_solvers(instance):
    """schur and cg on the phase-5 instance, and one schur step against the
    float64 dense solve of the same damped, gauge-fixed normal equations."""
    from tbv_slam_public_torch.ops import posegraph as pg

    inst, cfg, edges, poses, node_mask = instance
    with kernel_path("pgo_schur"):
        out, first = _run_solver("[6]", "schur", *instance)
    if not (6.5 < out["ate_before"] < 8.0 and out["ate_after"] < 4.072):
        raise AssertionError(f"schur PGO ATE outside its bands: {out}")
    # the edge-to-node sums add in an order fixed per graph: a second run
    # is bit-equal
    again, second = _run_solver("[6] again", "schur", *instance)
    schur = dict(first_s=out["wall_s"], again_s=again["wall_s"],
                 bit_equal=bool(torch.equal(first.poses, second.poses)))
    log(f"[6] two schur runs: {json.dumps(schur)}")
    if not schur["bit_equal"]:
        raise AssertionError("two schur runs differ")
    with kernel_path("pgo_cg"):
        out, _ = _run_solver("[6]", "cg", *instance)
    if not (out["cost"] < out["cost0"]
            and out["ate_after"] < out["ate_before"]):
        raise AssertionError(f"cg PGO lowered neither cost nor ATE: {out}")

    n = poses.shape[0]
    dev = poses.device
    gauge = node_mask & (torch.arange(n, device=dev) != 0)
    sums = pg._GraphSums(n, edges)
    _, g, blocks = pg._gradient_and_blocks(poses, edges, cfg, sums)
    gm = torch.where(gauge[:, None], g, torch.zeros_like(g))
    wJb, wJe = blocks
    hdiag = sums.nodes(torch.einsum("eri,eri->ei", wJb, wJb),
                       torch.einsum("eri,eri->ei", wJe, wJe))
    lam_diag = cfg.init_lambda * hdiag
    is_loop = edges.mask & ~pg._is_chain(edges)
    loop_idx = torch.argsort((~is_loop).to(torch.uint8),
                             stable=True)[:int(is_loop.sum())]
    solve = lambda: pg._schur_solve(
        n, edges, blocks, gauge, lam_diag, gm, loop_idx,
        refine_level=cfg.schur_refine, seg_cap=cfg.schur_seg, sums=sums)
    step = solve()
    ms = cuda_ms(solve, 5)
    H = pg._dense_hessian(n, edges, (wJb.double(), wJe.double()), gauge)
    free = gauge.repeat_interleave(3)
    H = H + torch.diag(torch.where(free, lam_diag.reshape(-1).double(),
                                   torch.zeros((), dtype=torch.float64,
                                               device=dev)))
    want = -torch.cholesky_solve(gm.reshape(-1, 1).double(),
                                 torch.linalg.cholesky(H)).reshape(n, 3)
    rel = float(torch.linalg.norm(step.double() - want)
                / torch.linalg.norm(want))
    log(f"[6] one schur step (lambda {cfg.init_lambda:g}, {int(is_loop.sum())}"
        f" loop edges, seg {cfg.schur_seg}, refine {cfg.schur_refine}): "
        f"{ms:.2f} ms, relative error {rel:.3g} against the float64 dense "
        f"solve (limit {SCHUR_STEP_RTOL:g})")
    if not rel < SCHUR_STEP_RTOL:
        raise AssertionError(f"schur step off the dense solve by {rel}")
    return schur


def _tally(obj, name, tally, key):
    """Wrap ``obj.name`` so that the CorAl launches and the seconds spent
    inside it add up under ``tally[key]``."""
    from tbv_slam_public_torch.kernels import coral_moments as cm

    inner = getattr(obj, name)

    def wrapped(*a, **k):
        before, t0 = cm.LAUNCHES, time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        t = tally.setdefault(key, dict(launches=0, seconds=0.0, calls=0))
        t["launches"] += cm.LAUNCHES - before
        t["seconds"] += time.perf_counter() - t0
        t["calls"] += 1
        return out

    setattr(obj, name, wrapped)


def phase_online(images, gt, cfg, plain_trajectory, sm_hz):
    import dataclasses

    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.models.slam import TBVSLAM

    n_frames = len(images)
    cfg = dataclasses.replace(
        cfg, pgo=dataclasses.replace(cfg.pgo, optimize_every=5))
    cm.LAUNCHES = 0  # the online path's launches are counted from here
    with kernel_path("online"):
        slam = TBVSLAM(cfg, train_alignment=True,
                       device=torch.device("cuda"))
        tally = {}
        _tally(slam.alignment_learner, "add_training_pair", tally,
               "training")
        _tally(slam.loops, "process_pending", tally, "loop_closure")
        _tally(slam.loops, "finish", tally, "loop_closure")
        _tally(slam.graph, "optimize", tally, "pgo")
        slam.process_frame(images[0], stamp=0.0, gt_pose=gt[0])  # first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, n_frames):
            slam.process_frame(images[i], stamp=0.25 * i, gt_pose=gt[i])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        epochs_in_run = dict(tally.get("pgo", dict(calls=0, seconds=0.0)))
        ate0 = tj.ate_rmse(np.asarray(slam.odometry.kf_poses),
                           np.stack(slam.odometry.kf_gt))
        default_model = slam.loops.align_model
        t0 = time.perf_counter()
        s = slam.finish(optimize=True, solver="auto")
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t0
    launches = cm.LAUNCHES

    est = slam.graph.poses_array()
    res = dict(
        frames=n_frames, online_frames_per_s=(n_frames - 1) / loop_s,
        keyframes=s.num_keyframes, candidates=len(slam.loops.candidate_log),
        loops_accepted=s.num_loops, pgo_epochs=slam.pgo_epochs,
        s_per_pgo_epoch=epochs_in_run["seconds"] / max(epochs_in_run["calls"],
                                                       1),
        solver=slam.graph.last_solver, finish_s=finish_s,
        training_samples=slam.alignment_learner.num_samples,
        ate_before=ate0, ate_after=s.metrics["ate_rmse"],
        coral_launches=launches,
        coral_launches_training=tally["training"]["launches"],
        training_cloud_capacity=int(
            slam.alignment_learner._prev[0].mask.shape[-1]),
        loop_cloud_capacity=int(slam.loops.kf_peaks[0].mask.shape[-1]),
        coral_launches_loop_closure=tally["loop_closure"]["launches"],
        training_s=tally["training"]["seconds"],
        loop_closure_s=tally["loop_closure"]["seconds"])
    log(f"[7] {json.dumps(res)}")
    if est.shape != (s.num_keyframes, 3) or not np.isfinite(est).all():
        raise AssertionError("online poses are not finite [N, 3]")
    if res["candidates"] <= 0 or slam.pgo_epochs < 2:
        raise AssertionError(f"online run: {res['candidates']} candidates, "
                             f"{slam.pgo_epochs} PGO epochs (need > 0, >= 2)")
    if slam.graph.last_solver != "schur":
        raise AssertionError(f"auto resolved to {slam.graph.last_solver}")
    if not res["ate_after"] <= ate0 + 1e-3:
        raise AssertionError(f"online PGO made ATE worse: {ate0} -> "
                             f"{res['ate_after']}")
    if res["training_samples"] < 26 or \
            slam.loops.align_model is default_model:
        raise AssertionError("the alignment learner was not fitted")
    if res["coral_launches_training"] <= 0 or \
            res["coral_launches_loop_closure"] <= 0:
        raise AssertionError(f"a CorAl route launched no kernel: {res}")
    training = phase_training_cloud(slam.alignment_learner._prev[0], sm_hz)

    with tempfile.TemporaryDirectory() as tmp:
        online = os.path.join(tmp, "online")
        run_cli(CLI + ["online", "--dataset", SIM, "--output", online,
                       "--train-alignment", "pgo.optimize_every=5",
                       "verification.model_threshold=0.5"] + SMALL, "[7]")
        out = run_cli(CLI + ["reoptimize", "--graph",
                             os.path.join(online, "full_graph.npz"),
                             "pgo.loop_scaling=1e4"], "[7]")
        if out["solver"] != "schur" or not out["cost"] <= out["cost0"]:
            raise AssertionError(f"reoptimize: {out}")
        run_cli(CLI + ["odometry", "--dataset", SIM, "--output",
                       os.path.join(tmp, "chunk"), "--chunk", "16"] + SMALL,
                "[7]")
        a = np.loadtxt(os.path.join(tmp, "chunk", "odom", "00.txt"))
        b = np.asarray([[float(v) for v in ln.split()]
                        for ln in plain_trajectory.splitlines()])
        err = float(np.abs(a - b).max())
        log(f"[7] odometry --chunk 16 against the per-frame run: max abs "
            f"difference {err:.3g} over {a.shape[0]} frames (limit "
            f"{CHUNK_ATOL:g})")
        if a.shape != b.shape or not err <= CHUNK_ATOL:
            raise AssertionError(f"chunked trajectory differs by {err}")
    return launches, training

# phase 10: a sharded pair wave against one process (the kernels' reductions
# depend on the batch size, ROADMAP.md section 3), retrieval distances, and
# the ATE band of distributed PGO against one rank's
WAVE_TBE_ATOL_M = 1e-2
RETRIEVAL_DIST_ATOL = 1e-6
PGO_ATE_BAND_M = 0.1
RANKS = 2
DB_SLOTS, DB_QUERIES, TRAIN_PAIRS = 4608, 8, 8


@contextlib.contextmanager
def _env(**values):
    """``os.environ`` with ``values`` inside the block, as before after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _constraints(cons):
    """(ids [K, 2], t_be [K, 3]) of a list of LoopConstraint."""
    return (np.asarray([(c.id_from, c.id_to) for c in cons],
                       np.int64).reshape(-1, 2),
            np.asarray([c.t_be for c in cons], np.float32).reshape(-1, 3))


def _same_constraints(tag, got, want):
    """The same accepted (id_from, id_to) and t_be within the wave
    tolerance; returns the largest t_be gap."""
    if not np.array_equal(got[0], want[0]):
        raise AssertionError(f"{tag}: accepted {got[0].tolist()}, one "
                             f"process {want[0].tolist()}")
    gap = float(np.abs(got[1] - want[1]).max()) if len(got[1]) else 0.0
    if not gap <= WAVE_TBE_ATOL_M:
        raise AssertionError(f"{tag}: t_be {gap} m off one process's")
    return gap


def _oxford_graph(cfg, mesh):
    """``PoseGraph`` of phase 5's 4470-node instance (its poses as given),
    on the mesh's device."""
    from tbv_slam_public_torch.core.types import ODOMETRY
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.models.loopclosure import LoopConstraint
    from tbv_slam_public_torch.models.slam import PoseGraph

    z = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    g = PoseGraph(cfg, mesh=mesh)
    for p, q in zip(inst.poses, inst.gt):
        g.add_node(p, gt=q)
    for k in np.flatnonzero(inst.mask):
        a, b = int(inst.idx[k, 0]), int(inst.idx[k, 1])
        if inst.etype[k] == ODOMETRY:
            g.add_odometry_constraint(a, b, inst.meas[k])
        else:
            g.add_loop_constraint(LoopConstraint(
                id_from=a, id_to=b, t_be=inst.meas[k], prob=1.0))
    g.poses = [np.asarray(p, np.float32) for p in inst.poses]
    return g


def _distributed_pgo(tag, graph, mesh):
    from tbv_slam_public_torch.eval import trajectory as tj

    gt = graph.gt_array()
    ate0 = tj.ate_rmse(graph.poses_array(), gt)
    mesh.all_reduces = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = graph.optimize(solver="distributed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(ate_before=ate0, ate_after=tj.ate_rmse(graph.poses_array(),
                                                      gt),
               iterations=int(res.iterations), lm_steps=graph.cfg.pgo.
               max_iterations, wall_s=wall,
               s_per_lm_step=wall / graph.cfg.pgo.max_iterations,
               all_reduces=mesh.all_reduces, cost0=float(res.cost0),
               cost=float(res.cost))
    log(f"{tag} {json.dumps(out)}")
    if not (out["ate_after"] < 0.7 * ate0
            and out["cost"] < 0.2 * out["cost0"]):
        raise AssertionError(f"{tag} distributed PGO: {out}")
    return out


def phase_parallel_one(cfg, graph, loops):
    """10(a): one NCCL rank in this process."""
    import torch.distributed as dist

    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.models.slam import run_offline_slam
    from tbv_slam_public_torch.parallel import multihost

    with _env(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
              MASTER_ADDR="localhost", MASTER_PORT=str(_free_port())):
        multihost.initialize()
        try:
            mesh = multihost.global_mesh()
            if dist.get_backend() != "nccl" or mesh.size != 1:
                raise AssertionError(f"{dist.get_backend()}, {mesh}")
            before = cm.LAUNCHES
            t0 = time.perf_counter()
            with kernel_path("parallel_offline"):
                slam = run_offline_slam(cfg, graph, solver="cholesky",
                                        mesh=mesh)
                torch.cuda.synchronize()
            slam_s = time.perf_counter() - t0
            launches = cm.LAUNCHES - before
            gap = _same_constraints("[10a] run_offline_slam(mesh)",
                                    _constraints(slam.loops.constraints),
                                    _constraints(loops.constraints))
            bit_equal = gap == 0.0
            log(f"[10a] NCCL, 1 rank: run_offline_slam(mesh) in {slam_s:.1f}"
                f" s, {len(slam.loops.constraints)} loops as phase 4's, t_be "
                f"{'bit-equal' if bit_equal else f'within {gap:.3g} m'}, "
                f"CorAl launches {launches}")
            if launches <= 0:
                raise AssertionError("[10a] no CorAl launch")
            with kernel_path("parallel_pgo"):
                pgo = _distributed_pgo("[10a] PoseGraph(mesh) distributed",
                                       _oxford_graph(cfg, mesh), mesh)
            dry = _entry_and_dryrun("[10a]", mesh)
        finally:
            dist.destroy_process_group()
    return dict(backend="nccl", ranks=1, slam_s=slam_s, coral_launches=
                launches, loops=len(slam.loops.constraints),
                t_be_bit_equal=bit_equal, t_be_max_gap_m=gap, pgo=pgo,
                dryrun=dry)


def _entry_and_dryrun(tag, mesh):
    """``entry()``'s frame, then the dry run on ``mesh``; the dry run's
    CorAl launches are its path's: the count is set to 0 just before it and
    read just after (and the count around it kept)."""
    from tbv_slam_public_torch.harness import dryrun
    from tbv_slam_public_torch.kernels import coral_moments as cm

    fn, args = dryrun.entry()
    t0 = time.perf_counter()
    _, out = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    if out.pose.shape != (3,) or not bool(torch.isfinite(out.pose).all()):
        raise AssertionError(f"{tag} entry(): pose {out.pose}")
    saved, cm.LAUNCHES = cm.LAUNCHES, 0
    with kernel_path("dryrun"):
        rec = dryrun.dryrun(mesh)
    launches, cm.LAUNCHES = cm.LAUNCHES, saved
    res = dict(entry_s=entry_s, launches=launches,
               **{k: rec[k] for k in dryrun.STEPS})
    log(f"{tag} entry() and dryrun at mesh size {mesh.size}: "
        f"{json.dumps(res)}")
    if launches <= 0:
        raise AssertionError(f"{tag} the dry run launched no CorAl kernel")
    return res


def _config(overrides):
    from tbv_slam_public_torch.core.config import (TBVConfig, apply_overrides,
                                                   parse_cli_overrides)

    return apply_overrides(TBVConfig(), parse_cli_overrides(list(overrides)))


def _save_keyframes(path, loops, overrides, **arrays):
    """Phase 4's keyframe payloads (host records), its configuration (as
    overrides of the defaults) and ``arrays`` as one npz."""
    import dataclasses

    d = {"odom": np.stack(loops.kf_odom), "cfg": np.asarray(overrides, str),
         **arrays}
    for key, recs in (("peaks", loops.kf_peaks), ("cells", loops.kf_cells)):
        for f in dataclasses.fields(recs[0]):
            d[f"{key}.{f.name}"] = np.stack([getattr(r, f.name)
                                             for r in recs])
    np.savez(path, **d)


def _retrieval_db(dev):
    """A seeded 4608-slot database of 40 x 120 descriptors and 8 queries,
    noisy copies of spread slots."""
    from tbv_slam_public_torch.core.config import ScanContextConfig

    sc = ScanContextConfig()
    rng = np.random.default_rng(11)
    desc = rng.uniform(0, 2, (DB_SLOTS, sc.num_ring, sc.num_sector)).astype(
        np.float32)
    slots = np.linspace(5, DB_SLOTS - 1, DB_QUERIES).astype(np.int64)
    q = desc[slots] + np.float32(0.01)
    t = lambda a: torch.as_tensor(a, device=dev)
    return sc, dict(desc=t(desc), ring=t(desc.mean(-1)),
                    mask=t(rng.uniform(size=DB_SLOTS) > 0.2),
                    osim=t(rng.uniform(size=(DB_QUERIES, DB_SLOTS)).astype(
                        np.float32)),
                    qdesc=t(q), qkey=t(q.mean(-1)))


def _training_pairs(z, dev):
    """Keyframes 1..8 against 0..7: (cur peaks, cells, poses, prev ...)."""
    from tbv_slam_public_torch.core.types import Cells, PointCloud

    def rec(key, cls, lo):
        return cls(**{n: torch.as_tensor(z[f"{key}.{n}"][lo:lo + TRAIN_PAIRS],
                                         device=dev)
                      for n in cls.__dataclass_fields__})
    odom = torch.as_tensor(z["odom"], device=dev)
    return (rec("peaks", PointCloud, 1), rec("cells", Cells, 1),
            odom[1:1 + TRAIN_PAIRS], rec("peaks", PointCloud, 0),
            rec("cells", Cells, 0), odom[:TRAIN_PAIRS])


def ranks_worker(inputs, out_dir) -> int:
    """One rank of phase 10(b), under ``torchrun``: every case on this
    rank's share, its results written to ``out_dir/rank<r>.npz``."""
    import dataclasses

    import torch.distributed as dist

    from tbv_slam_public_torch.core.types import Cells, PointCloud
    from tbv_slam_public_torch.harness import dryrun
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.models import loopclosure as lc
    from tbv_slam_public_torch.ops import coral
    from tbv_slam_public_torch.parallel import candidates as par_cand
    from tbv_slam_public_torch.parallel import multihost
    from tbv_slam_public_torch.parallel import odometry as par_odo
    from tbv_slam_public_torch.parallel import pgo as par_pgo
    from tbv_slam_public_torch.parallel import retrieval as par_ret

    multihost.initialize(backend="gloo")
    mesh = multihost.global_mesh()
    dev = mesh.device
    out = {}
    try:
        # gloo sums CUDA tensors through host copies; that comes first
        s = multihost.psum(torch.full((4,), mesh.rank + 1.0, device=dev),
                           mesh)
        if not bool((s == RANKS * (RANKS + 1) / 2).all()):
            raise AssertionError(f"gloo all_reduce of a CUDA tensor: {s}")
        z = dict(np.load(inputs))
        cfg = _config(z["cfg"].tolist())
        timed = {}

        def run(key, fn):
            before, t0 = cm.LAUNCHES, time.perf_counter()
            rm.LAUNCHES = 0  # the case's own refmath and registration
            lk.LAUNCHES = 0  # launches
            lk.LAUNCHES_BY_ENTRY.clear()
            res = fn()
            torch.cuda.synchronize()
            timed[key] = (time.perf_counter() - t0, cm.LAUNCHES - before)
            out[f"{key}_refmath_launches"] = np.asarray(rm.LAUNCHES)
            out[f"{key}_lm_launches"] = np.asarray(lk.LAUNCHES)
            out[f"{key}_evaluate_launches"] = np.asarray(
                lk.LAUNCHES_BY_ENTRY["evaluate"])
            return res

        # the inputs of the first pair_moments call at each (M, slots) this
        # rank's path makes, kept to hold the kernel at those shapes
        seen = {}

        @contextlib.contextmanager
        def keep_kernel_inputs():
            real = coral.pair_moments

            def keep(*a):
                seen.setdefault(tuple(a[0].shape[:2]), a)
                return real(*a)
            coral.pair_moments = keep
            try:
                yield
            finally:
                coral.pair_moments = real

        def waves():
            closer = lc.LoopCloser(cfg, mesh=mesh)
            for i in range(len(z["odom"])):
                closer.add_keyframe(
                    PointCloud(**{n: z[f"peaks.{n}"][i]
                                  for n in PointCloud.__dataclass_fields__}),
                    Cells(**{n: z[f"cells.{n}"][i]
                             for n in Cells.__dataclass_fields__}),
                    z["odom"][i])
            return _constraints(closer.process_all_batched()), \
                len(closer.candidate_log)

        # the refmath kernel's first operands and result at each op and
        # shapes of this rank's cases, held to the plain version at the end
        refmath_kept = contextlib.ExitStack()
        kept = refmath_kept.enter_context(refmath_inputs())
        lm_kept = refmath_kept.enter_context(lm_inputs())
        win_kept = refmath_kept.enter_context(window_inputs())
        eval_kept = refmath_kept.enter_context(evaluate_inputs())
        # the first run of a fresh process loads its kernels; the second is
        # timed as the steady state, and the path's launches are counted
        # from there
        with keep_kernel_inputs():
            first = run("waves_first", waves)
        cm.LAUNCHES = 0
        (ids, t_be), n_cand = run("waves", waves)
        if not (np.array_equal(first[0][0], ids)
                and np.array_equal(first[0][1], t_be)):
            raise AssertionError("two runs of the sharded waves differ")
        out.update(waves_ids=ids, waves_t_be=t_be,
                   waves_candidates=np.asarray(n_cand))

        sc, db = _retrieval_db(dev)
        sharded = par_ret.shard_db(mesh, lc.LoopDB(
            desc=db["desc"], ring=db["ring"],
            odom_pose=torch.zeros(DB_SLOTS, 3, device=dev), mask=db["mask"]))
        del db["desc"]
        res = run("retrieval", lambda: par_ret.sharded_retrieve(
            mesh, db["qdesc"], db["qkey"], sharded.desc, sharded.ring,
            sharded.mask, db["osim"],
            num_candidates=sc.num_candidates_from_tree,
            search_ratio=sc.search_ratio, odometry_coupled=True))
        out.update({f"ret_{k}": v.cpu().numpy()
                    for k, v in res._asdict().items()})
        out["db_rows"] = np.asarray(sharded.desc.shape[0])

        poses, node_mask, edges = _oxford_graph(cfg, mesh)._padded()
        for pc in ("chain", "chain_sharded"):
            mesh.all_reduces = 0
            r = run(pc, lambda: par_pgo.optimize_distributed(
                mesh, poses, node_mask, edges, cfg.pgo,
                preconditioner=pc))
            out.update({f"{pc}_poses": r.poses.cpu().numpy(),
                        f"{pc}_iterations": np.asarray(int(r.iterations)),
                        f"{pc}_cost0": np.asarray(float(r.cost0)),
                        f"{pc}_cost": np.asarray(float(r.cost)),
                        f"{pc}_all_reduces": np.asarray(mesh.all_reduces)})

        with keep_kernel_inputs():
            model, x, y = run("training", lambda: par_cand.
                              alignment_training_step(
                                  mesh, *_training_pairs(z, dev), cfg))
        out.update(train_x=x.cpu().numpy(), train_y=y.cpu().numpy(),
                   train_intercept=model.intercept.cpu().numpy(),
                   train_coef=model.coef.cpu().numpy())
        out["coral_launches"] = np.asarray(cm.LAUNCHES)

        # phase 9's first two sequences, one a rank
        images = torch.as_tensor(z["odo_images"], device=dev)
        out["odo_poses"] = run("odometry", lambda: par_odo.run_sequences(
            mesh, images, cfg)[0].cpu().numpy())
        # the dry run: its launches are its own path's
        cm.LAUNCHES = 0
        with keep_kernel_inputs():
            rec = run("dryrun", lambda: dryrun.dryrun(mesh))
        out["dryrun_launches"] = np.asarray(cm.LAUNCHES)
        model, x, _ = rec["out"]["training"]
        out.update(dryrun_pose=rec["out"]["odometry"].pose.cpu().numpy(),
                   dryrun_x=x.cpu().numpy(),
                   dryrun_cov=rec["out"]["pair_wave"].cov.cpu().numpy(),
                   dryrun_index=rec["out"]["retrieval"].index.cpu().numpy())
        refmath_kept.close()
        for step in dryrun.STEPS:
            timed[f"dryrun_{step}"] = (rec[step]["s"], rec[step]["launches"])
        for key, (secs, launches) in timed.items():
            out[f"{key}_s"] = np.asarray(secs)
            out[f"{key}_launches"] = np.asarray(launches)
        # the kernel at this rank's own shapes against its plain version
        # (after the count: these launches are not the path's)
        errs = []
        for (m, slots), args in sorted(seen.items()):
            got, again = cm.pair_moments(*args), cm.pair_moments(*args)
            torch.cuda.synchronize()
            want = cm.pair_moments_reference(*args)
            errs.append(_check_moments(
                f"[10b] rank {mesh.rank} pair_moments M={m} S={slots}", got,
                want, again))
        out["kernel_shapes"] = np.asarray(sorted(seen), np.int64)
        out["kernel_max_abs_err"] = np.asarray(max(errs))
        out["refmath_held"] = np.asarray(hold_refmath(
            f"[10b] rank {mesh.rank}", kept))
        out["lm_held"] = np.asarray(hold_lm(f"[10b] rank {mesh.rank}",
                                            lm_kept))
        out["window_held"] = np.asarray(hold_window(
            f"[10b] rank {mesh.rank}", win_kept))
        out["evaluate_held"] = np.asarray(hold_evaluate(
            f"[10b] rank {mesh.rank}", eval_kept))
        np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def phase_parallel_ranks(overrides, loops, one, dev, pair):
    """10(b): two gloo ranks on the one card, each case held to this
    process's single-rank result; ``overrides`` are phase 4's configuration
    as overrides of the defaults, ``pair`` phase 9's B = 2 run."""
    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.harness import dryrun
    from tbv_slam_public_torch.kernels.checks import bits_differ
    from tbv_slam_public_torch.ops import logistic, scancontext

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "keyframes.npz")
        _save_keyframes(inputs, loops, overrides, odo_images=pair["images"])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={RANKS}", os.path.abspath(__file__),
             "--ranks-worker", inputs, tmp], capture_output=True, text=True,
            cwd=ROOT, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"torchrun failed ({proc.returncode}):\n"
                               f"{proc.stdout[-6000:]}\n"
                               f"{proc.stderr[-12000:]}")
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(RANKS)]
    r0 = outs[0]
    for k in r0:  # every rank returns the whole result
        if not k.endswith(("_s", "_launches", "kernel_max_abs_err",
                           "refmath_held", "lm_held", "window_held",
                           "evaluate_held")) and \
                not np.array_equal(r0[k], outs[1][k]):
            raise AssertionError(f"[10b] ranks differ in {k}")
    res = dict(backend="gloo", ranks=RANKS, torchrun_s=wall,
               coral_launches_per_rank=[int(o["coral_launches"])
                                        for o in outs])
    if min(res["coral_launches_per_rank"]) <= 0:
        raise AssertionError(f"[10b] a rank launched no CorAl kernel: {res}")
    # the refmath kernel's launches of each case, a list of the ranks'
    cases = sorted(k[:-len("_refmath_launches")] for k in r0
                   if k.endswith("_refmath_launches"))
    REFMATH_LAUNCHES["ranks"] = {c: [int(o[f"{c}_refmath_launches"])
                                     for o in outs] for c in cases}
    REFMATH_HELD["ranks"] = [int(o["refmath_held"]) for o in outs]
    if min(sum(v[r] for v in REFMATH_LAUNCHES["ranks"].values())
           for r in range(RANKS)) <= 0:
        raise AssertionError(f"[10b] a rank launched no refmath kernel: "
                             f"{REFMATH_LAUNCHES['ranks']}")
    LM_LAUNCHES["ranks"] = {c: [int(o[f"{c}_lm_launches"]) for o in outs]
                            for c in cases}
    LM_HELD["ranks"] = [int(o["lm_held"]) for o in outs]
    WINDOW_HELD["ranks"] = [int(o["window_held"]) for o in outs]
    EVAL_HELD["ranks"] = [int(o["evaluate_held"]) for o in outs]
    LM_LAUNCHES["ranks_evaluate"] = {
        c: [int(o[f"{c}_evaluate_launches"]) for o in outs] for c in cases}
    for case in ("waves", "odometry", "dryrun"):
        if min(LM_LAUNCHES["ranks"][case]) <= 0:
            raise AssertionError(f"[10b] a rank's {case} launched no "
                                 f"registration kernel: "
                                 f"{LM_LAUNCHES['ranks']}")
    for case in ("waves", "training", "dryrun"):
        if min(LM_LAUNCHES["ranks_evaluate"][case]) <= 0:
            raise AssertionError(f"[10b] a rank's {case} launched no "
                                 f"evaluation entry: "
                                 f"{LM_LAUNCHES['ranks_evaluate']}")
    # (M, slots) of every launch held to the plain version: the first
    # wave's share (waves of 64 pairs, fewer candidates padded to a multiple
    # of the ranks) and the training step's share of 13 perturbations a pair
    shapes = [tuple(int(v) for v in row) for row in r0["kernel_shapes"]]
    res["kernel_checks"] = dict(
        shapes=shapes, max_abs_err=max(float(o["kernel_max_abs_err"])
                                       for o in outs))
    first_wave = min(64, -(-int(r0["waves_candidates"]) // RANKS) * RANKS)
    want_m = {first_wave // RANKS, 13 * TRAIN_PAIRS // RANKS}
    if not want_m <= {m for m, _ in shapes}:
        raise AssertionError(f"[10b] the kernel was held at {shapes}, not "
                             f"at every M of {sorted(want_m)}")
    # the dry run's shapes: its training step (13 perturbations of one scan
    # pair a rank) and its pair wave (one pair a rank), 1024 slots all live
    peaks = dryrun.dryrun_config().verification.peaks_capacity
    if not {(13, peaks), (1, peaks)} <= set(shapes):
        raise AssertionError(f"[10b] the kernel was not held at the dry "
                             f"run's shapes: {shapes}")

    gap = _same_constraints("[10b] LoopCloser(mesh) waves",
                            (r0["waves_ids"], r0["waves_t_be"]),
                            _constraints(loops.constraints))
    res["waves"] = dict(loops=len(r0["waves_ids"]), t_be_max_gap_m=gap,
                        candidates=int(r0["waves_candidates"]),
                        s_per_rank=[float(o["waves_s"]) for o in outs],
                        first_s_per_rank=[float(o["waves_first_s"])
                                          for o in outs],
                        launches_per_rank=[int(o["waves_launches"])
                                           for o in outs])

    sc, db = _retrieval_db(dev)
    want = scancontext.retrieve(
        db["qdesc"], db["qkey"], db["desc"], db["ring"], db["mask"],
        db["osim"], num_candidates=sc.num_candidates_from_tree,
        search_ratio=sc.search_ratio, odometry_coupled=True)
    for f in ("index", "shift", "valid"):
        if not np.array_equal(r0[f"ret_{f}"], getattr(want, f).cpu().numpy()):
            raise AssertionError(f"[10b] sharded retrieval: {f} differs")
    dist_gap = float(np.abs(r0["ret_dist"] - want.dist.cpu().numpy())[
        r0["ret_valid"]].max())
    if not dist_gap <= RETRIEVAL_DIST_ATOL:
        raise AssertionError(f"[10b] retrieval dist off by {dist_gap}")
    res["retrieval"] = dict(slots=DB_SLOTS, rows_per_rank=int(r0["db_rows"]),
                            queries=DB_QUERIES, dist_max_gap=dist_gap,
                            ms_per_rank=[1e3 * float(o["retrieval_s"])
                                         for o in outs])

    inst = _oxford_instance(dev)[0]
    lm_steps = _config(overrides).pgo.max_iterations
    ate0 = tj.ate_rmse(inst.poses, inst.gt)
    for pc in ("chain", "chain_sharded"):
        ate = tj.ate_rmse(r0[f"{pc}_poses"], inst.gt)
        out = dict(ate_before=ate0, ate_after=ate,
                   iterations=int(r0[f"{pc}_iterations"]),
                   wall_s=float(r0[f"{pc}_s"]),
                   s_per_lm_step=float(r0[f"{pc}_s"]) / lm_steps,
                   all_reduces=int(r0[f"{pc}_all_reduces"]),
                   cost0=float(r0[f"{pc}_cost0"]),
                   cost=float(r0[f"{pc}_cost"]))
        res[pc] = out
        if not (ate < 0.7 * ate0 and out["cost"] < 0.2 * out["cost0"]
                and abs(ate - one["pgo"]["ate_after"]) < PGO_ATE_BAND_M):
            raise AssertionError(f"[10b] {pc}: {out}, one rank "
                                 f"{one['pgo']['ate_after']}")

    x, y = r0["train_x"], r0["train_y"]
    # each rank's fit of the gathered x on the card against the port's own
    # fit of the same x and y on the CPU, bit for bit: every rounding of
    # the fit (sigmoid, the ordered products, the gradient's loop order,
    # the solve's LAPACK order) is the refmath kernel's on the card and the
    # plain version's on the CPU, and the CPU fit is held bit-equal to the
    # reference's (tests/test_torch_parity_faults.py).  On these 8 pairs
    # the IRLS cycles (a near-constant column beside the intercept, as in
    # the one-street test), so the probabilities and mean linear scores
    # are reported, not held.
    cpu = logistic.fit(torch.as_tensor(x), torch.as_tensor(y), balanced=True)
    want = np.r_[cpu.intercept.numpy(), cpu.coef.numpy()]
    differ = [bits_differ(np.r_[o["train_intercept"], o["train_coef"]], want)
              for o in outs]
    model = logistic.LogisticModel(torch.as_tensor(r0["train_intercept"]),
                                   torch.as_tensor(r0["train_coef"]))
    p = logistic.predict_proba(model, torch.as_tensor(x)).numpy()
    z = logistic.predict_linear(model, torch.as_tensor(x)).double().numpy()
    res["training"] = dict(x_shape=list(x.shape), positives=int(y.sum()),
                           values_differ_from_cpu_fit=differ,
                           intercept=float(want[0]),
                           p_aligned=float(p[y == 1].mean()),
                           p_perturbed=float(p[y == 0].mean()),
                           score_aligned=float(z[y == 1].mean()),
                           score_perturbed=float(z[y == 0].mean()),
                           s_per_rank=[float(o["training_s"]) for o in outs])
    if x.shape != (13 * TRAIN_PAIRS, 6) or not np.isfinite(x).all() or \
            any(differ):
        raise AssertionError(f"[10b] training step: {res['training']}")
    # batched odometry, one sequence a rank, against phase 9's B = 2 run in
    # one process on the same images
    got = np.swapaxes(r0["odo_poses"], 0, 1)
    gap_m, gap_rad = max(_pose_gap(got[b], pair["poses"][b])
                         for b in range(2))
    res["odometry"] = dict(
        frames=int(got.shape[1]), bit_equal=bool(np.array_equal(
            got, pair["poses"])), gap_m=gap_m, gap_rad=gap_rad,
        frames_per_s=2 * (got.shape[1] - 1) / max(
            float(o["odometry_s"]) for o in outs))
    if not (gap_m <= POSE_ATOL_M and gap_rad <= POSE_ATOL_RAD):
        raise AssertionError(f"[10b] sharded odometry: {res['odometry']}")
    res["dryrun"] = dict(
        launches_per_rank=[int(o["dryrun_launches"]) for o in outs],
        **{step: dict(s_per_rank=[float(o[f"dryrun_{step}_s"])
                                  for o in outs],
                      launches_per_rank=[int(o[f"dryrun_{step}_launches"])
                                         for o in outs])
           for step in dryrun.STEPS})
    if r0["dryrun_x"].shape != (13 * RANKS, 6) or \
            min(res["dryrun"]["launches_per_rank"]) <= 0:
        raise AssertionError(f"[10b] dry run: {res['dryrun']}")
    log(f"[10b] {json.dumps(res)}")
    return res


def phase_sweep():
    """10(c): ``sweep`` with a two-value parameter row on the card, in this
    process so that its CorAl launches count."""
    import io

    from tbv_slam_public_torch.harness import cli
    from tbv_slam_public_torch.kernels import coral_moments as cm

    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, "pars.csv")
        with open(par, "w") as f:
            f.write("radar.k_strongest,10,12\n")
        out = os.path.join(tmp, "sweep")
        before, t0 = cm.LAUNCHES, time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["sweep", "--par-file", par, "--dataset", "sim:20:1",
                           "--output", out, "--device", "cuda"] + SMALL
                          + ["verification.model_threshold=0.5"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(os.path.join(out, "merged.csv")) as f:
            rows = f.read().strip().splitlines()
        with open(os.path.join(out, "sweep_report.json")) as f:
            report = json.load(f)
    res = dict(rc=rc, jobs=len(rows) - 1, seconds=secs,
               coral_launches=cm.LAUNCHES - before,
               report={k: report[k] for k in ("hosts", "frames",
                                              "total_jobs")})
    log(f"[10c] sweep: {json.dumps(res)}")
    if rc != 0 or res["jobs"] != 2 or report["total_jobs"] != 2:
        raise AssertionError(f"[10c] sweep: {res}")
    return res


def phase_parallel(cfg, graph, loops, pair, overrides=()):
    """Phase 10 on phase 4's configuration (``overrides`` of the defaults),
    checkpoint and loop closer, and phase 9's B = 2 run ``pair``; returns its
    results, the CorAl launches of the parallel path and of the dry run
    (this process's and every rank's), and the kernel checks' error."""
    from tbv_slam_public_torch.kernels import coral_moments as cm

    if _config(overrides) != cfg:
        raise ValueError("the overrides do not give phase 4's configuration")
    cm.LAUNCHES = 0  # the parallel path's launches are counted from here
    one = phase_parallel_one(cfg, graph, loops)
    ranks = phase_parallel_ranks(overrides, loops, one, torch.device("cuda"),
                                 pair)
    sweep = phase_sweep()
    launches = cm.LAUNCHES + sum(ranks["coral_launches_per_rank"])
    dry = one["dryrun"]["launches"] + sum(
        ranks["dryrun"]["launches_per_rank"])
    return dict(one_rank=one, two_ranks=ranks, sweep=sweep), launches, dry, \
        ranks["kernel_checks"]["max_abs_err"]


SITE_SOURCE = "tbv_slam_public_torch/csrc/refmath_sites.cu"
CHAIN_SOURCE = "tbv_slam_public_torch/csrc/refmath_chains.cu"
SC_SOURCE = "tbv_slam_public_torch/csrc/scancontext.cu"
# what each site, chain and ScanContext kernel computes in the reference
SITE_REPLACES = {
    "compose": "tbv_slam_public_tpu/core/se2.py (compose)",
    "inverse": "tbv_slam_public_tpu/core/se2.py (inverse)",
    "relative": "tbv_slam_public_tpu/core/se2.py (relative)",
    "apply": "tbv_slam_public_tpu/core/se2.py (apply)",
    "rotate": "tbv_slam_public_tpu/core/se2.py (rotate)",
    "interpolate": "tbv_slam_public_tpu/core/se2.py (interpolate)",
    "rotmat": "tbv_slam_public_tpu/core/se2.py (rotmat)",
    "norm2": "tbv_slam_public_torch/core/refmath.py::norm2",
    "world_targets": "tbv_slam_public_tpu/ops/registration.py "
                     "(the window's world-frame targets)",
    "motion_compensate": "tbv_slam_public_tpu/ops/radar.py "
                         "(motion_compensate)",
    "odometry_pose_tail": "tbv_slam_public_tpu/models/odometry.py "
                          "(the pose tail after registration)",
    "motion_compensate_pair": "tbv_slam_public_tpu/ops/radar.py "
                              "(motion_compensate of a frame's two clouds)",
    "loop_guess": "tbv_slam_public_tpu/models/loopclosure.py "
                  "(Taug^-1 R(yaw))",
    "local_map": "tbv_slam_public_tpu/models/loopclosure.py "
                 "(the local map's keyframes moved into the query's frame)",
    "alignment_apply": "tbv_slam_public_tpu/models/verification.py "
                       "(the pair's clouds moved by its pose)",
    "sc_key": "tbv_slam_public_tpu/ops/scancontext.py:84 (ring_key, "
              "sector_key)",
    "sc_ring_distance": "tbv_slam_public_tpu/ops/scancontext.py:198 "
                        "(retrieve's ring-key distance)",
    "sc_distance": "tbv_slam_public_tpu/ops/scancontext.py:123 "
                   "(sc_distance under retrieve's vmap)",
    "measured_sqrt_info": "tbv_slam_public_tpu/ops/posegraph.py:80 "
                          "(jnp.linalg.inv and cholesky on jaxlib's LAPACK)"}
NO_TPU = " (no TPU kernel: XLA's fusions on the CPU; the port's plain " \
    "version runs on a CPU tensor)"


def refmath_entries(sites, chains, sc_k):
    """The kernels line's entries of the per-site, per-chain and ScanContext
    kernels and ``measured_sqrt_info`` that some path launches: launches on
    the offline path, or on the path that launches it most where the
    offline path does not; then the names of those no path launches on
    its own (sites whose arithmetic the chains run; their times are the
    ``refmath`` entry's ``sites``)."""
    from tbv_slam_public_torch.kernels import refmath as rm

    def entry(name, source, t, op, frames):
        by = {p: v.get(op, 0) for p, v in REFMATH_LAUNCHES.items()}
        path = "offline" if by.get("offline") else max(by, key=by.get)
        if not by[path]:
            return None
        return {"name": name, "route": "cuda", "source": source,
                "replaces": SITE_REPLACES[op] + NO_TPU,
                "launches": by[path], "path": path,
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), "times": t,
                "stack_frame_spills": {k: v for k, v in STACK_FRAMES.items()
                                       if frames in k},
                "launches_by_path": {p: v for p, v in by.items() if v}}

    sc = sc_k["times"]
    cases = [(f"site_{s}", SITE_SOURCE, sites[s], s,
              f"site_kernelILi{i}E") for s, i in rm.SITES.items()]
    cases += [(f"chain_{c}", CHAIN_SOURCE, chains[c], c, f"chain_{c}E")
              for c in rm.CHAIN_KERNELS]
    cases += [("sc_key", SC_SOURCE, sc["sc_key_b1"], "sc_key",
               "sc_key_kernel"),
              ("sc_ring_distance", SC_SOURCE, sc["sc_ring_distance_b1"],
               "sc_ring_distance", "sc_ring_distance_kernel"),
              ("sc_distance", SC_SOURCE, sc["sc_distance_b1"], "sc_distance",
               "18sc_distance_kernel"),
              ("measured_sqrt_info", "tbv_slam_public_torch/csrc/refmath.cu",
               sc["measured_sqrt_info"], "measured_sqrt_info",
               "sqrt_info_kernel")]
    out = [entry(*c) for c in cases]
    return [e for e in out if e], [c[0] for c, e in zip(cases, out) if not e]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=200,
                    help="frames of the sensor-size slice (phases 4 and 7)")
    ap.add_argument("--ranks-worker", nargs=2, metavar=("INPUTS", "OUT_DIR"),
                    help=argparse.SUPPRESS)  # one rank of phase 10(b)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(1, os.path.join(ROOT, "scripts"))
    import tbv_slam_public_torch  # noqa: F401  (sets full-f32 matmuls)

    if args.ranks_worker:
        return ranks_worker(*args.ranks_worker)

    t_start = time.perf_counter()
    marks = [t_start]

    phase_s = {}

    def done(tag):
        marks.append(time.perf_counter())
        phase_s[tag] = marks[-1] - marks[-2]
        log(f"[{tag}] phase took {phase_s[tag]:.1f} s")

    smi, sm_hz = phase_build()
    k = phase_kernels(sm_hz)
    refmath_k = phase_refmath()
    sites = phase_refmath_sites()
    import torch_workload as wl
    chains = phase_chains(wl.sensor_config())
    lm_k = phase_registration()
    eval_k = phase_evaluation()
    tail_k = phase_coral_tail()
    done("1-2")
    plain_trajectory, scan_launches = phase_cli()
    done("3")
    launches, images, gt, cfg, loops, frame_poses, graph, pose_graph = \
        phase_slice(args.frames)
    sc_k = phase_scancontext(loops, pose_graph)
    real = phase_real_clouds(loops, sm_hz)
    cells_k = phase_cells(images, cfg)
    done("4")
    schur_twice = phase_solvers(phase_pgo())
    done("5-6")
    online_launches, training = phase_online(images, gt, cfg,
                                             plain_trajectory, sm_hz)
    done("7")
    variants = phase_variants(images, gt, cfg)
    done("8")
    batched, pair = phase_batched(images, gt, cfg, frame_poses)
    with kernel_path("rest"):
        rest = phase_rest(images, cfg, loops)
    done("9")
    parallel, parallel_launches, dry_launches, parallel_err = \
        phase_parallel(cfg, graph, loops, pair)
    done("10")
    by_path = dict(offline=launches, online=online_launches,
                   evaluate_scans=scan_launches, parallel=parallel_launches,
                   dryrun=dry_launches)
    launches += online_launches + scan_launches + parallel_launches \
        + dry_launches
    per_kernel, on_no_path = refmath_entries(sites, chains, sc_k)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "coral_moments", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/coral_moments.cu",
        "replaces": "tbv_slam_public_tpu/pallas/coral_moments.py:36",
        "launches": launches,
        "max_abs_err": max(k["max_abs_err"], parallel_err),
        "ms": k["times"]["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None, "share_of_bound": k["times"]["share"],
        "pair_moments": {m: t for m, t in k["times"].items()
                         if m.startswith("M")},
        "launches_by_path": by_path,
        "keyframe_clouds": real, "training_cloud": training}, {
        "name": "refmath", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/refmath.cu",
        "replaces": "tbv_slam_public_torch/core/refmath.py:1 (no TPU kernel: "
                    "XLA's inline exp/log/log1p, glibc's sinf/cosf/atan2f)",
        "launches": REFMATH_LAUNCHES["offline"]["total"],
        "max_abs_err": refmath_k["max_abs_err"],
        "ms": refmath_k["times"]["sincos_n4096"]["ms"],
        "plain_ms": refmath_k["times"]["sincos_n4096"]["plain_ms"],
        "bound_ms": refmath_k["times"]["sincos_n4096"]["bound_ms"],
        "bound_by": refmath_k["times"]["sincos_n4096"]["bound_by"],
        "library_ms": refmath_k["times"]["sincos_n4096"]["library_ms"],
        "times": refmath_k["times"], "sites": sites,
        "kernels_on_no_path": on_no_path,
        "op_kernels": refmath_k["kernels"],
        "launches_by_path": REFMATH_LAUNCHES,
        "strided_operands_by_path": REFMATH_STRIDED,
        "shapes_held_by_path": REFMATH_HELD}, {
        "name": "mul", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/refmath.cu",
        "replaces": "tbv_slam_public_torch/core/refmath.py::mul (no TPU "
                    "kernel: a lone product on the reference's DAZ / FTZ "
                    "threads, PGO's weighted residual at "
                    "tbv_slam_public_tpu/ops/posegraph.py:190)",
        "launches": REFMATH_LAUNCHES["offline"].get("mul", 0),
        "max_abs_err": refmath_k["max_abs_err"],
        "ms": refmath_k["times"]["mul_n4096"]["ms"],
        "plain_ms": refmath_k["times"]["mul_n4096"]["plain_ms"],
        "bound_ms": refmath_k["times"]["mul_n4096"]["bound_ms"],
        "bound_by": refmath_k["times"]["mul_n4096"]["bound_by"],
        "library_ms": refmath_k["times"]["mul_n4096"]["library_ms"],
        "times": {k: v for k, v in refmath_k["times"].items()
                  if k.startswith("mul_")},
        "launches_by_path": {p: v.get("mul", 0)
                             for p, v in REFMATH_LAUNCHES.items()}}, {
        "name": "ceres_covariance", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/refmath.cu",
        "replaces": "tbv_slam_public_tpu/ops/registration.py:808 (no TPU "
                    "kernel: jaxlib's LAPACK ssyevd, sgetrf and strsm on "
                    "the CPU; the port's plain version is "
                    "core/refmath.py::ceres_covariance)",
        "launches": REFMATH_LAUNCHES["variant_ceres"].get(
            "ceres_covariance", 0),
        "max_abs_err": refmath_k["ceres"]["max_abs_err"],
        "ms": refmath_k["ceres"]["times"]["rows1"]["ms"],
        "plain_ms": refmath_k["ceres"]["times"]["rows1"]["plain_ms"],
        "bound_ms": refmath_k["ceres"]["times"]["rows1"]["bound_ms"],
        "bound_by": refmath_k["ceres"]["times"]["rows1"]["bound_by"],
        "library_ms": None, "times": refmath_k["ceres"]["times"],
        "rows_held": refmath_k["ceres"]["held"],
        "launches_by_path": {p: v["ceres_covariance"]
                             for p, v in REFMATH_LAUNCHES.items()
                             if "ceres_covariance" in v},
        "path": "variant_ceres (phase 8, odometry.cov_source=ceres)"}, {
        "name": "cell_stats", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/cells.cu",
        "replaces": "tbv_slam_public_tpu/ops/features.py:97 (no TPU kernel: "
                    "XLA fuses compute_cells; the port's plain version is "
                    "ops/features.py::_cell_stats_reference)",
        "launches": CELLS_LAUNCHES["offline"],
        "max_abs_err": 0.0, "ms": cells_k["ms"],
        "plain_ms": cells_k["plain_ms"], "bound_ms": cells_k["bound_ms"],
        "bound_by": cells_k["bound_by"], "library_ms": None,
        "times": cells_k, "launches_by_path": CELLS_LAUNCHES,
        "shapes_held_by_path": CELLS_HELD, "design": CELLS_DESIGN}, {
        "name": "register_window", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/lm_solve.cu",
        "replaces": "tbv_slam_public_tpu/ops/registration.py:395 (no TPU "
                    "kernel: XLA fuses register_window, associate and "
                    "_lm_solve; the port's plain version is "
                    "ops/registration.py::_register_window_reference)",
        "launches": LM_LAUNCHES["offline"]["total"],
        "max_abs_err": lm_k["max_abs_err"],
        "ms": lm_k["times"]["odometry"]["ms"],
        "plain_ms": lm_k["times"]["odometry"]["plain_ms"],
        "bound_ms": lm_k["times"]["odometry"]["bound_ms"],
        "bound_by": lm_k["times"]["odometry"]["bound_by"],
        "library_ms": None,
        "profiler_windows": lm_k["times"]["odometry"]["profiler_windows"],
        "times": lm_k["times"], "window_calls_held": lm_k["held"],
        "forced_cluster_and_batch_calls_held": lm_k["forced"],
        "passes_against_serial": lm_k["passes"],
        "solve_entry": {"times": lm_k["solve_times"],
                        "grid_solves_held": lm_k["solves"],
                        "schedule": lm_k["schedule"]},
        "launches_by_path": LM_LAUNCHES,
        "world_targets_launches_by_path": {
            p: v.get("world_targets", 0)
            for p, v in REFMATH_LAUNCHES.items()},
        "window_shapes_held_by_path": WINDOW_HELD,
        "solve_shapes_held_by_path": LM_HELD}, {
        "name": "evaluate", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/lm_solve.cu",
        "replaces": "tbv_slam_public_tpu/ops/registration.py:658 (no TPU "
                    "kernel: XLA fuses evaluate_cost and the vmapped "
                    "sampled_covariance at :577; the port's plain versions "
                    "are ops/registration.py::_evaluate_cost_reference and "
                    "_sampled_covariance_reference)",
        "launches": LM_LAUNCHES["offline"].get("evaluate", 0),
        "max_abs_err": eval_k["max_abs_err"],
        "ms": eval_k["times"]["loop_wave"]["sampled_covariance"]["ms"],
        "plain_ms":
            eval_k["times"]["loop_wave"]["sampled_covariance"]["plain_ms"],
        "bound_ms":
            eval_k["times"]["loop_wave"]["sampled_covariance"]["bound_ms"],
        "bound_by":
            eval_k["times"]["loop_wave"]["sampled_covariance"]["bound_by"],
        "library_ms": None, "profiler_windows":
            eval_k["times"]["loop_wave"]["sampled_covariance"][
                "profiler_windows"],
        "times": eval_k["times"], "calls_held": eval_k["held"],
        "launches_by_path": {p: v.get("evaluate", 0)
                             for p, v in LM_LAUNCHES.items()
                             if not p.startswith("ranks")},
        "ranks_launches": LM_LAUNCHES.get("ranks_evaluate"),
        "shapes_held_by_path": EVAL_HELD,
        "design": "all S poses in one pass over the records, the 3 x 3 "
                  "covariance in the launch (no library call, no host "
                  "synchronisation)"}, {
        "name": "coral_tail", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/coral_moments.cu",
        "replaces": "tbv_slam_public_tpu/ops/coral.py:118 (no TPU kernel: "
                    "XLA fuses _coral_impl's tail around the Pallas call; "
                    "the port's plain version is ops/coral.py::"
                    "coral_tail_reference)",
        "launches": TAIL_LAUNCHES["offline"],
        "max_abs_err": tail_k["max_abs_err"],
        "ms": tail_k["times"]["loop_wave"]["ms"],
        "plain_ms": tail_k["times"]["loop_wave"]["plain_ms"],
        "bound_ms": tail_k["times"]["loop_wave"]["bound_ms"],
        "bound_by": tail_k["times"]["loop_wave"]["bound_by"],
        "library_ms": None, "times": tail_k["times"],
        "calls_held": tail_k["held"], "launches_by_path": TAIL_LAUNCHES,
        "shapes_held_by_path": TAIL_HELD}] + per_kernel,
        "variants": variants, "batched": batched, "rest": rest,
        "schur_twice": schur_twice, "parallel": parallel,
        "phase_s": phase_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
