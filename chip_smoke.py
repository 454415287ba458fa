#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``tbv_slam_public_torch``).

Needs one CUDA card.  Phases, each of which raises on failure:

1. device and kernel build (nvcc, sm_90a);
2. every kernel of the main path against its plain PyTorch version on the
   card, at the main path's shapes, with both times;
3. the port's CLI: ``odometry`` then ``slam`` (default solver, and again
   with ``--solver cholesky``) on a small simulated sequence;
4. the offline slice at the sensor's size (400 azimuths x 3768 bins at
   0.0438 m, default config): odometry per frame -> simple_graph save/load
   -> loop closure with CorAl verification -> cholesky PGO, with the kernel
   launch count of that run;
5. cholesky PGO on the 4470-node Oxford real-odometry instance;
6. the ``schur`` and ``cg`` solvers on that instance beside ``cholesky``,
   and one ``_schur_solve`` step against a float64 dense solve of the same
   damped system;
7. the online path at the sensor's size: ``TBVSLAM`` with in-run alignment
   training and periodic PGO epochs over the phase-4 frames, with the kernel
   launch counts of the training route and of the per-keyframe loop closure;
   then the ``online`` and ``reoptimize`` CLIs and ``odometry --chunk 16``
   against the unchunked run of phase 3.

Prints the card's name and power limit, one JSON line with the kernels, and
last ``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py [--frames N]
"""
from __future__ import annotations

import argparse
import json
import os
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
# same arithmetic, but index_add_ sums with atomics on the card, so two runs
# of one path already differ in the last bits and an association may flip
CHUNK_ATOL = 2e-3

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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
    return smi, float(clock) * 1e6


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
    and 132 SMs x 128 lanes x the card's maximum SM clock: the work the
    kernel does as written, masked or not."""
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


def _moment_inputs(rng, m, q, p, dev, frac=0.8, extent=60.0):
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(rng.uniform(-extent, extent, (m, q, 2)).astype(np.float32)),
            t(rng.uniform(size=(m, q)) < frac),
            t(rng.uniform(-extent, extent, (m, p, 2)).astype(np.float32)),
            t(rng.uniform(size=(m, p)) < frac))


def phase_kernels(sm_hz):
    from tbv_slam_public_torch.kernels import coral_moments as cm

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    radius = 1.0
    cases = [(1, 50, 70, 0.8), (1, 128, 512, 0.8), (1, 200, 600, 0.8),
             (1, 4096, 4096, 0.8), (64, 4096, 4096, 0.8),
             (13, 4096, 4096, 0.8), (12, 4096, 4096, 0.8),
             (3, 300, 700, 0.0)]
    worst = 0.0
    for m, q, p, frac in cases:
        args = _moment_inputs(rng, m, q, p, dev, frac)
        got = cm.neighbor_moments(*args, radius)
        torch.cuda.synchronize()
        want = cm.neighbor_moments_reference(*args, radius)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"coral count differs at M={m} Q={q} P={p}")
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want)) \
            if got[0].numel() else 0.0
        worst = max(worst, err)
        log(f"[2] coral_moments M={m} Q={q} P={p} mask={frac}: ok, "
            f"max_abs_err={err:.3g}, neighbours/query="
            f"{float(want[0].float().mean()):.2f}")
    args = _moment_inputs(rng, 64, 4096, 4096, dev)
    ms = cuda_ms(lambda: cm.neighbor_moments(*args, radius), 20)
    plain_ms = cuda_ms(lambda: cm.neighbor_moments_reference(*args, radius), 3)
    bound = _moment_bound(args, cm.neighbor_moments(*args, radius)[0], sm_hz)
    log(f"[2] coral_moments at M=64 Q=P=4096: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
        f"{bound['bound_by']} ({bound['bound_ms'] / ms:.1%} reached), "
        f"all-pairs bound {bound['all_pairs_bound_ms']:.4f} ms "
        f"({bound['all_pairs_bound_ms'] / ms:.1%} reached); no single "
        f"PyTorch call computes this function")
    for m in (13, 12):  # the online path's launch widths
        a = _moment_inputs(rng, m, 4096, 4096, dev)
        t = cuda_ms(lambda: cm.neighbor_moments(*a, radius), 20)
        log(f"[2] coral_moments at M={m} Q=P=4096: kernel {t:.3f} ms")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, **bound)


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
    """Returns the text of the unchunked run's trajectory file."""
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
        with open(os.path.join(tmp, "odo", "odom", "00.txt")) as f:
            return f.read()


def phase_slice(n_frames):
    from tbv_slam_public_torch.core import se2
    from tbv_slam_public_torch.core.config import RadarConfig, TBVConfig
    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.io import checkpoint, simulate
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.models.odometry import OdometryPipeline
    from tbv_slam_public_torch.models.slam import run_offline_slam

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    seq = simulate.make_sequence(
        num_frames=n_frames, seed=7, num_azimuths=400, num_range_bins=3768,
        range_res=0.0438,
        traj_kwargs=dict(radius=0.11 * n_frames, step=0.8, laps=1.25))
    gt = np.stack([se2.relative_np(seq.gt_poses[0], g)
                   for g in seq.gt_poses])
    log(f"[4] rendered N={n_frames} frames 400x3768 in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = TBVConfig(radar=RadarConfig(num_azimuths=400, num_range_bins=3768,
                                      range_res=0.0438))

    cm.LAUNCHES = 0  # the offline path's launches are counted from here
    pipe = OdometryPipeline(cfg, device=dev)
    pipe.process(seq.images[0], stamp=0.0, gt_pose=gt[0])  # first frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_frames):
        pipe.process(seq.images[i], stamp=0.25 * i, gt_pose=gt[i])
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "simple_graph.npz")
        checkpoint.save_simple_graph(path, checkpoint.from_odometry(pipe))
        g = checkpoint.load_simple_graph(path)
    t0 = time.perf_counter()
    slam = run_offline_slam(cfg, g, solver="cholesky", device=dev)
    torch.cuda.synchronize()
    slam_s = time.perf_counter() - t0
    launches = cm.LAUNCHES

    s = slam.summary
    ate0 = tj.ate_rmse(g.kf_poses, g.kf_gt)
    ate1 = s.metrics["ate_rmse"]
    n_cand = len(slam.loops.candidate_log)
    est = slam.graph.poses_array()
    res = dict(frames=n_frames, odometry_frames_per_s=(n_frames - 1) / odo_s,
               keyframes=s.num_keyframes, candidates=n_cand,
               loops_accepted=s.num_loops, ate_before=ate0, ate_after=ate1,
               slam_s=slam_s, coral_launches=launches,
               frame_ate=tj.ate_rmse(np.asarray(pipe.frame_poses), gt))
    log(f"[4] {json.dumps(res)}")
    if est.shape != (s.num_keyframes, 3) or not np.isfinite(est).all():
        raise AssertionError("optimized poses are not finite [N, 3]")
    if n_cand <= 0 or launches <= 0:
        raise AssertionError(f"no loop candidates ({n_cand}) or no CorAl "
                             f"kernel launches ({launches})")
    if not ate1 <= ate0 + 1e-3:
        raise AssertionError(f"PGO made ATE worse: {ate0} -> {ate1}")
    return launches, seq.images, gt, cfg


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
    return out


def phase_pgo():
    inst = _oxford_instance(torch.device("cuda"))
    out = _run_solver("[5]", "cholesky", *inst)
    if not (6.5 < out["ate_before"] < 8.0 and out["ate_after"] < 4.072):
        raise AssertionError(f"PGO ATE outside its bands: {out}")
    return inst


def phase_solvers(instance):
    """schur and cg on the phase-5 instance, and one schur step against the
    float64 dense solve of the same damped, gauge-fixed normal equations."""
    from tbv_slam_public_torch.ops import posegraph as pg

    inst, cfg, edges, poses, node_mask = instance
    out = _run_solver("[6]", "schur", *instance)
    if not (6.5 < out["ate_before"] < 8.0 and out["ate_after"] < 4.072):
        raise AssertionError(f"schur PGO ATE outside its bands: {out}")
    out = _run_solver("[6]", "cg", *instance)
    if not (out["cost"] < out["cost0"]
            and out["ate_after"] < out["ate_before"]):
        raise AssertionError(f"cg PGO lowered neither cost nor ATE: {out}")

    n = poses.shape[0]
    dev = poses.device
    gauge = node_mask & (torch.arange(n, device=dev) != 0)
    _, g, blocks = pg._gradient_and_blocks(poses, edges, cfg)
    gm = torch.where(gauge[:, None], g, torch.zeros_like(g))
    wJb, wJe = blocks
    hdiag = pg._scatter_nodes(n, edges, torch.einsum("eri,eri->ei", wJb, wJb),
                              torch.einsum("eri,eri->ei", wJe, wJe))
    lam_diag = cfg.init_lambda * hdiag
    is_loop = edges.mask & ~pg._is_chain(edges)
    loop_idx = torch.argsort((~is_loop).to(torch.uint8),
                             stable=True)[:int(is_loop.sum())]
    solve = lambda: pg._schur_solve(
        n, edges, blocks, gauge, lam_diag, gm, loop_idx,
        refine_level=cfg.schur_refine, seg_cap=cfg.schur_seg)
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


def phase_online(images, gt, cfg, plain_trajectory):
    import dataclasses

    from tbv_slam_public_torch.eval import trajectory as tj
    from tbv_slam_public_torch.kernels import coral_moments as cm
    from tbv_slam_public_torch.models.slam import TBVSLAM

    n_frames = len(images)
    cfg = dataclasses.replace(
        cfg, pgo=dataclasses.replace(cfg.pgo, optimize_every=5))
    cm.LAUNCHES = 0  # the online path's launches are counted from here
    slam = TBVSLAM(cfg, train_alignment=True, device=torch.device("cuda"))
    tally = {}
    _tally(slam.alignment_learner, "add_training_pair", tally, "training")
    _tally(slam.loops, "process_pending", tally, "loop_closure")
    _tally(slam.loops, "finish", tally, "loop_closure")
    _tally(slam.graph, "optimize", tally, "pgo")
    slam.process_frame(images[0], stamp=0.0, gt_pose=gt[0])  # first frame
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
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=200,
                    help="frames of the sensor-size slice (phases 4 and 7)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tbv_slam_public_torch  # noqa: F401  (sets full-f32 matmuls)

    t_start = time.perf_counter()
    smi, sm_hz = phase_build()
    k = phase_kernels(sm_hz)
    plain_trajectory = phase_cli()
    launches, images, gt, cfg = phase_slice(args.frames)
    phase_solvers(phase_pgo())
    launches += phase_online(images, gt, cfg, plain_trajectory)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "coral_moments", "route": "cuda",
        "source": "tbv_slam_public_torch/csrc/coral_moments.cu",
        "replaces": "tbv_slam_public_tpu/pallas/coral_moments.py:36",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,
        "all_pairs_bound_ms": k["all_pairs_bound_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
