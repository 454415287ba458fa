#!/usr/bin/env python3
"""The ``cell_stats`` kernel and the registration kernel's window entry of
several trees or build variants on one card, in turns.

``cell_stats``: its time by CUDA events behind a device-side spin and the
host's microseconds a call, at phase 4's clouds of ``chip_smoke.py``
(400 x 3768 bins, default configuration, 4,800 points, 512 cells) and at
the cfear3_oxford preset's (k_strongest 40: 16,000 points, 3 m radius),
each held bit for bit against the plain version on the card.  ``window``:
``register_window`` at the odometry's shapes (B = 1 and 4, T = 4, C = 512,
P2P, 8 outer x 20 inner iterations), at an offline loop wave's (B = 64,
T = 1, P2L, 10 inner) and at B = 1 with 4 and 8 CTAs a row forced
(``kernels/checks.py::window_problem`` from seed 17): the kernel's device
time a launch from ``torch.profiler``, the call's time by CUDA events
behind a spin long enough for the host to enqueue every call, the host's
microseconds a call and the ``world_targets`` site launches a call; its
outputs' digest shows whether two trees compute the same bits.  ``moments``: the
CorAl ``pair_moments`` kernel at an offline loop wave's shape (M = 64,
4,096-slot clouds, 80 % live), by events, with a digest.  ``evaluate``:
``sampled_covariance`` at an offline loop wave's shape (64 pairs, P2L),
the evaluation kernel's device time, the call's time by events and the
host's microseconds, with a digest of the covariances.  ``tail``:
``coral_tail`` at ``chip_smoke.py``'s four shapes (a 64-pair wave, an
online loop closure, a training pair, ``evaluate-scans`` pairs), by events,
the host's microseconds and the cluster size (and, where the tree takes
it, the time at 1, 2, 4 and 8 CTAs a pair), with digests.  ``ops``: each
refmath op at 1, 4,096 and 2^19 values and with a broadcast operand, by
events, the host's microseconds at 4,096, with digests.  ``sites``: each
refmath site at its path's shape (``norm2`` beside
``torch.linalg.vector_norm``); ``chains``: each chain at its path's shape;
``scancontext``: ``retrieve`` (and its pairs' ``sc_distance`` and the ring
keys) at B = 1 and 64 against 256 keyframes, with the device kernels a
call runs; each by events, the host's microseconds, with digests.

A run is a fresh process on one tree (its package first on ``sys.path``)
with optional ``nvcc`` defines (``csrc/cells.cu`` reads ``CELLS_WARPS``,
the staged design's warps a block, and
``CELLS_BATCH``, the windows whose loads a warp of the global-memory
design issues together).  A variant is ``TREE[:NAME=VALUE,...][@SET,...]`` (a
tree whose kernel takes only phase 4's clouds runs with ``@phase4``); the
order is the variants, then backwards, so that drift of the card shows.
One JSON line a run, then one with all runs, whether each set's (and
shape's) outputs have the same digest in every run (``same_digests``) and
the card's name and power limit:

    python3 scripts/time_cells.py \
        [--sets phase4,cfear3_oxford,window,moments,evaluate,tail,ops,\
                sites,chains,scancontext] \
        VARIANT ...
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, reps: int) -> float:
    """Mean microseconds the host spends inside one call, each call made on
    an idle device."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e6


def events_ms(fn, reps: int, spin_cycles: int) -> float:
    """Mean milliseconds a call by CUDA events, after one warm-up call (a
    library kernel's first call loads its module), the calls enqueued
    while the device spins."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(spin_cycles)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cloud_set(name, reps, dev):
    """``cell_stats`` on the first four clouds of the set's configuration."""
    import numpy as np
    import torch

    import torch_workload as wl
    from tbv_slam_public_torch.core.config import PRESETS
    from tbv_slam_public_torch.kernels import cells as kc
    from tbv_slam_public_torch.ops import features as tf
    from tbv_slam_public_torch.ops import radar

    images = wl.revisiting_sequence(8, circle_frames=200).images
    if name == "phase4":
        base = wl.sensor_config()
        rcfg, fcfg = base.radar, base.features
    else:
        preset = PRESETS[name]()
        rcfg, fcfg = preset.radar, preset.features
    times, hosts, digest = [], [], hashlib.sha256()
    for img in images[:4]:
        cloud = radar.filter_scan(torch.as_tensor(img, device=dev), rcfg)[0]
        cen, occ = tf.select_cells(cloud, fcfg)
        args = (cloud.xy, cloud.intensity, cloud.mask, cen, occ, fcfg)
        got = kc.cell_stats(*args)
        with kc.plain_on_card():
            want = kc.cell_stats(*args)
        for g, w in zip(got, want):
            if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                raise AssertionError(f"{name}: the kernel differs from the "
                                     f"plain version")
            digest.update(g.cpu().numpy().tobytes())
        times.append(events_ms(lambda: kc.cell_stats(*args), reps,
                               50_000_000))
        hosts.append(host_us(lambda: kc.cell_stats(*args), 50))
    return dict(ms=float(np.mean(times)), ms_by_cloud=times,
                host_us=float(np.mean(hosts)),
                points=int(cloud.xy.shape[0]), cells=int(cen.shape[0]),
                digest=digest.hexdigest()[:16])


#: the window entry's shapes: (B, T, C, cost, inner iterations): the
#: odometry step at B = 1 and 4 and an offline loop wave of 64 pairs
WINDOW_SHAPES = {"odometry": (1, 4, 512, "P2P", 20),
                 "odometry_b4": (4, 4, 512, "P2P", 20),
                 "loop_wave": (64, 1, 512, "P2L", 10)}


def window_set(reps, dev):
    """``register_window`` at the odometry's and a loop wave's shapes
    (``WINDOW_SHAPES``, 8 outer iterations, ``kernels/checks.py::
    window_problem`` from seed 17), and at B = 1 with the cluster forced
    to 4 and 8 CTAs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.core.types import Cells
    from tbv_slam_public_torch.kernels import lm_solve as lk
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    chooser = lk.cluster_size
    out = {}
    cases = [(name, shape, None) for name, shape in WINDOW_SHAPES.items()]
    cases += [(f"odometry_k{k}", WINDOW_SHAPES["odometry"], k)
              for k in (4, 8)]
    for name, (b, t, c, cost, inner), forced in cases:
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
        lk.cluster_size = (lambda *a, **kw: forced) if forced else chooser
        getattr(lk, "_PLANS", {}).clear()
        call = lambda: treg.register_window(*args)
        res = call()
        lk.LAUNCHES_BY_ENTRY.clear()
        sites = dict(rm.LAUNCHES_BY_OP)
        call()
        if dict(lk.LAUNCHES_BY_ENTRY) != {"window": 1}:
            raise AssertionError(f"window: launches "
                                 f"{dict(lk.LAUNCHES_BY_ENTRY)}, not one "
                                 f"window")
        world = rm.LAUNCHES_BY_OP.get("world_targets", 0) - sites.get(
            "world_targets", 0)
        digest = hashlib.sha256()
        for v in (res.pose, res.score, res.num_residuals, res.iterations):
            digest.update(v.cpu().numpy().tobytes())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kernel = [e for e in prof.key_averages()
                  if "registration_kernel" in e.key
                  and e.device_time_total > 0]
        if not kernel:
            raise AssertionError("window: the profiler saw no kernel time")
        out[name] = dict(
            B=b, cluster=forced, ms=kernel[0].device_time_total
            / kernel[0].count / 1e3,
            events_ms=events_ms(call, reps, 400_000_000),
            host_us=host_us(call, 50), world_targets_launches=world,
            iterations=res.iterations.tolist()[:8],
            digest=digest.hexdigest()[:16])
    lk.cluster_size = chooser
    getattr(lk, "_PLANS", {}).clear()
    return out


def moments_set(reps, dev):
    """``pair_moments`` (the CorAl moments kernel) at an offline loop
    wave's shape: M = 64 pairs of 4,096-slot clouds, 80 % live (as
    ``chip_smoke.py``'s phase 2, seed 19)."""
    import numpy as np
    import torch

    from tbv_slam_public_torch.kernels import coral_moments as cm

    rng = np.random.default_rng(19)
    t = lambda a: torch.as_tensor(a, device=dev)
    args = [t(rng.uniform(-60, 60, (64, 4096, 2)).astype(np.float32)),
            t(rng.uniform(size=(64, 4096)) < 0.8),
            t(rng.uniform(-60, 60, (64, 4096, 2)).astype(np.float32)),
            t(rng.uniform(size=(64, 4096)) < 0.8)]
    call = lambda: cm.pair_moments(*args, 1.0)
    digest = hashlib.sha256()
    for v in call():
        digest.update(v.cpu().numpy().tobytes())
    return dict(ms=events_ms(call, reps, 200_000_000),
                host_us=host_us(call, 50), digest=digest.hexdigest()[:16])


def evaluate_set(reps, dev):
    """``sampled_covariance`` at an offline loop wave's shape (64 pairs of
    512 cells against one target scan, P2L, the loop registration's
    configuration): the evaluation kernel's device time a launch from
    ``torch.profiler``, the call's time by CUDA events and the host's
    microseconds a call (a tree whose covariance reads back to the host
    waits there)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tbv_slam_public_torch.core.config import TBVConfig
    from tbv_slam_public_torch.core.types import Cells
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.models import loopclosure
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(23), 64, 1, 512, 512)
    t = lambda k: torch.as_tensor(prob[k], device=dev)

    def cells(side):
        f = lambda k: t(f"{side}_{k}")
        return Cells(mean=f("mean"), cov=f("cov"), normal=f("normal"),
                     nsamples=f("nsamples"), planarity=f("planarity"),
                     avg_intensity=torch.zeros_like(f("nsamples")),
                     valid=f("valid"))

    cfg = loopclosure._loop_registration_cfg(TBVConfig())
    args = (cells("src"), t("pose0"), cells("tgt"), t("tgt_poses"),
            t("scan_mask"), cfg)
    score, n_res = treg.evaluate_cost(*args)
    call = lambda: treg.sampled_covariance(*args, score, n_res)
    cov, convex = call()
    digest = hashlib.sha256()
    for v in (cov, convex):
        digest.update(v.cpu().numpy().tobytes())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    kernel = [e for e in prof.key_averages() if e.device_time_total > 0 and (
        "registration_kernel" in e.key or "evaluation_kernel" in e.key)]
    if not kernel:
        raise AssertionError("evaluate: the profiler saw no kernel time")
    return dict(ms=kernel[0].device_time_total / kernel[0].count / 1e3,
                events_ms=events_ms(call, reps, 400_000_000),
                host_us=host_us(call, 50), convex=int(convex.sum()),
                digest=digest.hexdigest()[:16])


#: coral_tail's shapes: (M, slots a cloud, live share, live slots first),
#: as chip_smoke.py's TAIL_SHAPES
TAIL_SHAPES = {"loop_wave": (64, 4096, 0.8, False),
               "online_loop": (12, 4096, 0.8, False),
               "training": (13, 4800, 0.1, True),
               "scan_pairs": (13, 1600, 0.8, False)}


def tail_set(reps, dev):
    """``coral_tail`` at each of :data:`TAIL_SHAPES` on the pair moments of
    seeded clouds (entropy mode): its time by events behind a spin, the
    host's microseconds a call and a digest of its outputs."""
    import numpy as np
    import torch

    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.ops import coral

    out = {}
    for tag, (m, n, live, packed) in TAIL_SHAPES.items():
        rng = np.random.default_rng(31)
        t = lambda a: torch.as_tensor(a, device=dev)
        if packed:
            k = rng.integers(int(0.5 * live * n), int(1.5 * live * n) + 1,
                             (m, 1))
            sm, rm = (t(np.arange(n)[None] < k) for _ in range(2))
        else:
            sm, rm = (t(rng.uniform(size=(m, n)) < live) for _ in range(2))
        xy = rng.uniform(-15, 15, (m, n, 2)).astype(np.float32)
        moments = cm.pair_moments(t(xy), sm, t(xy + rng.normal(
            0, 0.2, xy.shape).astype(np.float32)), rm, 1.0)
        call = lambda: coral.coral_tail(*moments, sm, rm, 1e-8, "entropy")
        digest = hashlib.sha256()
        for v in call():
            digest.update(v.cpu().numpy().tobytes())
        out[tag] = dict(ms=events_ms(call, reps, 100_000_000),
                        host_us=host_us(call, 50),
                        cluster=getattr(cm, "TAIL_CLUSTER", None),
                        digest=digest.hexdigest()[:16])
        if hasattr(cm, "TAIL_CLUSTER"):  # the CTAs a pair, forced
            out[tag]["ms_by_cluster"] = {
                g: events_ms(lambda: cm.coral_tail(
                    *moments, sm, rm, 1e-8, "entropy", cluster=g), reps,
                    100_000_000) for g in (1, 2, 4, 8)}
    return out


def ops_set(reps, dev):
    """Each refmath op at 1, 4,096 and 2^19 contiguous values, and at 4,096
    with a broadcast operand (a [1] second operand, or one value
    expanded), by events behind a spin, the host's microseconds a call at
    4,096, with a digest of the 2^19-value results (``mul`` only where the
    tree has it)."""
    import numpy as np
    import torch

    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import REFMATH_RANGES

    ops = dict(REFMATH_RANGES, fma=(-10.0, 10.0), mul=(-10.0, 10.0))
    arity = dict(atan2=2, fma=3, mul=2)
    library = dict(exp=torch.exp, log=torch.log, log1p=torch.log1p,
                   sigmoid=torch.sigmoid, sqrt=torch.sqrt, atan2=torch.atan2,
                   sincos=lambda v: (torch.sin(v), torch.cos(v)),
                   wrap_angle=lambda v: torch.atan2(torch.sin(v),
                                                    torch.cos(v)),
                   fma=lambda a, b, c: torch.addcmul(c, a, b), mul=torch.mul)
    out = {}
    for op, (lo, hi) in ops.items():
        if not hasattr(rm, op):
            continue
        fn = getattr(rm, op)
        k = arity.get(op, 1)
        rng = np.random.default_rng(37)
        res = {}
        fn(torch.zeros(4, device=dev), *(torch.zeros(4, device=dev)
                                         for _ in range(k - 1)))
        for size in (1, 4096, 1 << 19):
            args = [torch.as_tensor(rng.uniform(lo, hi, size).astype(
                np.float32), device=dev) for _ in range(k)]
            call = lambda: fn(*args)
            res[f"n{size}"] = events_ms(call, reps, 20_000_000)
            if op in library and size > 1:
                res[f"torch_n{size}"] = events_ms(
                    lambda: library[op](*args), reps, 20_000_000)
            if size == 4096:
                res["host_us"] = host_us(call, 200)
                wide = [args[0]] + [a[:1] for a in args[1:]] if k > 1 \
                    else [args[0][:1].expand(size)]
                res["broadcast_n4096"] = events_ms(lambda: fn(*wide), reps,
                                                   20_000_000)
        digest = hashlib.sha256()
        got = call()
        for v in got if isinstance(got, tuple) else (got,):
            digest.update(v.cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()[:16]
        out[op] = res
    return out


def _smoke():
    """This tree's ``chip_smoke.py``, loaded from its path (a timed tree's
    own copy may be older): the sites' and chains' main-path shapes
    (``SITE_SHAPES``, ``_chain_shapes``) and their operands
    (``path_operands``, ``frame_motions``) come from it, so that the
    timings here measure what it checks."""
    import importlib.util

    if "_tbv_chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "_tbv_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
    return sys.modules["_tbv_chip_smoke"]


def _digest(outs, digest):
    for v in outs if isinstance(outs, tuple) else (outs,):
        if v is not None:
            digest.update(v.cpu().numpy().tobytes())


def sites_set(reps, dev):
    """Each refmath site at its path's shape by events behind a spin, the
    host's microseconds a call, ``torch.linalg.vector_norm`` beside
    ``norm2``, with digests."""
    import torch

    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.ops import radar, registration  # noqa: F401

    cs = _smoke()
    out = {}
    # norm2 also at one value
    for name, (site, shapes, opts) in dict(
            cs.SITE_SHAPES, norm2_n1=("norm2", ((1, 2),), {})).items():
        ts = cs.path_operands(shapes, dev, 5)
        call = lambda: rm.site(site, *ts, **opts)
        call()
        res = dict(ms=events_ms(call, reps, 20_000_000),
                   host_us=host_us(call, 200))
        if site == "norm2":
            lib = lambda: torch.linalg.vector_norm(ts[0], dim=-1)
            res["library_ms"] = events_ms(lib, reps, 20_000_000)
        digest = hashlib.sha256()
        _digest(call(), digest)
        res["digest"] = digest.hexdigest()[:16]
        out[name] = res
    return out


def chains_set(reps, dev):
    """Each refmath chain at its path's shape (the sensor-size
    configuration's) by events behind a spin, the host's microseconds a
    call, with digests (the pose tail's motions those of a frame)."""
    import torch_workload as wl
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.models import (loopclosure, odometry,  # noqa
                                              verification)
    from tbv_slam_public_torch.ops import radar  # noqa: F401

    cs = _smoke()
    out = {}
    for name, (shapes, opts) in cs._chain_shapes(wl.sensor_config()).items():
        ts = cs.path_operands(shapes, dev, 7)
        if name == "odometry_pose_tail":
            cs.frame_motions(ts)
        call = lambda: rm.chain(name, *ts, **opts)
        call()
        res = dict(ms=events_ms(call, reps, 20_000_000),
                   host_us=host_us(call, 200))
        digest = hashlib.sha256()
        _digest(call(), digest)
        res["digest"] = digest.hexdigest()[:16]
        out[name] = res
    return out


def _launches(fn):
    """The device kernels one call of fn runs, by torch.profiler (None
    where the profiler shows no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def scancontext_set(reps, dev):
    """ScanContext's retrieval at the online shape (B = 1) and an offline
    wave's (B = 64) against a 256-keyframe database of descriptor-like
    values (A = 5 augmentations, K = 10 candidates): ``retrieve`` whole,
    ``sc_distance`` on its pairs and the ring keys, by events, the host's
    microseconds, the device kernels a ``retrieve`` call runs (profiler),
    with digests."""
    import torch

    from tbv_slam_public_torch.ops import scancontext as sc

    g = torch.Generator(device="cpu").manual_seed(11)

    def desc(*shape):
        x = torch.randint(60, 255, shape, generator=g) * torch.randint(
            0, 6, shape, generator=g) / 1000.0
        return torch.where(torch.rand(shape, generator=g) < 0.6,
                           torch.zeros(()), x).float().to(dev)

    n, a, k = 256, 5, 10
    db = desc(n, 40, 120)
    keys = sc.ring_key(db)
    out = {}
    for b in (1, 64):
        q = desc(b, a, 40, 120)
        qk = sc.ring_key(q)
        mask = (torch.rand(b, 1, n, generator=g) < 0.9).to(dev)
        odom = torch.rand(b, 1, n, generator=g).to(dev)
        ret = lambda: sc.retrieve(q, qk, db, keys, mask, odom,
                                  num_candidates=k, search_ratio=0.1)
        r = ret()
        cands = db[r.index]
        pair = lambda: sc.sc_distance(q[..., None, :, :], cands)
        key = lambda: sc.ring_key(q)
        res = dict(retrieve_ms=events_ms(ret, reps, 20_000_000),
                   retrieve_host_us=host_us(ret, 50),
                   retrieve_launches=_launches(ret),
                   sc_distance_ms=events_ms(pair, reps, 20_000_000),
                   ring_key_ms=events_ms(key, reps, 20_000_000))
        digest = hashlib.sha256()
        _digest((r.dist, r.index, r.shift, *pair(), key()), digest)
        res["digest"] = digest.hexdigest()[:16]
        out[f"b{b}"] = res
    return out


def run(tree: str, defines: list, sets: list, reps: int) -> dict:
    """One variant, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, os.path.join(ROOT, "scripts"))
    import torch

    from tbv_slam_public_torch.kernels import build

    build.NVCC_FLAGS = build.NVCC_FLAGS + [f"-D{d}" for d in defines]
    build.library()
    dev = torch.device("cuda")
    out = dict(tree=tree, defines=defines)
    named = dict(window=window_set, moments=moments_set,
                 evaluate=evaluate_set, tail=tail_set, ops=ops_set,
                 sites=sites_set, chains=chains_set,
                 scancontext=scancontext_set)
    for name in sets:
        out[name] = (named[name](reps, dev) if name in named
                     else cloud_set(name, reps, dev))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", default="phase4,cfear3_oxford")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("variants", nargs="+")
    a = ap.parse_args()
    if a.run:
        tree, _, defs = a.variants[0].partition(":")
        res = run(tree, [d for d in defs.split(",") if d],
                  a.sets.split(","), a.reps)
        print("RESULT " + json.dumps(res), flush=True)
        return
    runs = []
    for v in a.variants + a.variants[::-1]:
        v, _, sets = v.partition("@")
        sets = sets or a.sets
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", "--sets",
             sets, "--reps", str(a.reps), v], capture_output=True, text=True,
            cwd=ROOT)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise SystemExit(f"{v}: exit {proc.returncode}")
        runs.append(json.loads(line[0][7:]))
        print(line[0], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "same_digests": same_digests(runs),
                      "runs": runs}))


def same_digests(runs):
    """For each measured set (and shape) that reports a digest, whether
    every run that measured it gave the same one: the trees and variants
    compute the same bits there."""
    seen = {}

    def walk(key, value):
        if isinstance(value, dict):
            if "digest" in value:
                seen.setdefault(key, set()).add(value["digest"])
            for k, v in value.items():
                if isinstance(v, dict):
                    walk(f"{key}/{k}", v)

    for r in runs:
        for name, value in r.items():
            if isinstance(value, dict):
                walk(name, value)
    return {k: len(v) == 1 for k, v in seen.items()}


if __name__ == "__main__":
    main()
