"""Command-line entry points of the port.

Subcommands: ``odometry`` (CFEAR odometry over a dataset -> trajectories and
the ``simple_graph.npz`` checkpoint), ``slam`` (loop closure + PGO from a
checkpoint), ``online`` (the full per-frame pipeline from images),
``reoptimize`` (PGO again on a saved full graph with other ``pgo.*``
weights), ``constraints`` (dump / re-verify a full graph's loop
constraints), ``train-alignment``, ``train-loop``, ``evaluate-scans``
(alignment features of perturbed keyframe pairs to CSV), ``baseline`` (the
result tables of a tree of runs), ``sweep`` (a parameter file's cartesian
product of ``online`` or ``odometry`` jobs, merged into one table; under
``torchrun`` the jobs are split over the processes) and ``eval``.

Same arguments and dotted ``key=value`` config overrides as
``tbv_slam_public_tpu.harness.cli``, plus ``--device`` where tensors are
computed: the CUDA card when the option is absent (an error where there is
none), ``--device cpu`` for the CPU.  ``--solver`` defaults to ``auto``
(schur on a SLAM graph).  Plots are written only where matplotlib is
installed.

    python -m tbv_slam_public_torch.harness.cli odometry --dataset sim:60:5 \
        --output out/odo radar.k_strongest=4
    python -m tbv_slam_public_torch.harness.cli slam \
        --graph out/odo/simple_graph.npz --output out/slam
    python -m tbv_slam_public_torch.harness.cli online --dataset sim:60:5 \
        --output out/online --train-alignment pgo.optimize_every=10
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _build_cfg(meta: dict, overrides: List[str]):
    """Config from dataset meta + dotted overrides; a leading
    ``preset=<name>`` token starts from a published configuration."""
    from ..core.config import (PRESETS, RadarConfig, TBVConfig,
                               apply_overrides, parse_cli_overrides)

    overrides = list(overrides or [])
    preset = None
    for tok in list(overrides):
        if tok.startswith("preset="):
            preset = tok.split("=", 1)[1]
            overrides.remove(tok)
    radar = dict(num_azimuths=meta["num_azimuths"],
                 num_range_bins=meta["num_range_bins"],
                 range_res=meta["range_res"])
    if preset:
        cfg = PRESETS[preset]()
        cfg = dataclasses.replace(cfg, radar=dataclasses.replace(cfg.radar,
                                                                 **radar))
    else:
        cfg = TBVConfig(radar=RadarConfig(**radar))
    if overrides:
        cfg = apply_overrides(cfg, parse_cli_overrides(overrides))
    return cfg


def _device(name: Optional[str]):
    from ..core.device import resolve

    return resolve(name or None)


SENSOR = dict(num_azimuths=400, num_range_bins=3768, range_res=0.0438)


def _write_pars(cfg, outdir: str) -> None:
    from ..core.config import to_pars_text

    with open(os.path.join(outdir, "pars.txt"), "w") as f:
        f.write(to_pars_text(cfg) + "\n")


def _write_timing(outdir: str) -> None:
    from ..core.timing import timing

    with open(os.path.join(outdir, "time_statistics.txt"), "w") as f:
        f.write(timing.present())


def _export_trajectories(outdir: str, est: np.ndarray,
                         gt: Optional[np.ndarray], stamps, sub: str,
                         seq: int = 0, covs=None) -> dict:
    from ..eval import kitti, trajectory

    d = os.path.join(outdir, sub)
    os.makedirs(d, exist_ok=True)
    trajectory.write_kitti(os.path.join(d, "00.txt"), est)
    trajectory.write_tum(os.path.join(d, "00.tum"), np.asarray(stamps), est)
    if covs is not None and len(covs) == len(est):
        trajectory.write_cov(os.path.join(d, "cov_00.txt"),
                             np.asarray(stamps), np.asarray(covs))
    metrics = {}
    if gt is not None and len(gt) == len(est):
        trajectory.write_kitti(os.path.join(d, "00_gt.txt"), gt)
        m = kitti.evaluate(gt, est)
        kitti.write_result(os.path.join(d, "result.txt"), seq, m)
        metrics = m.as_dict()
    return metrics


def cmd_odometry(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..io import checkpoint, oxford
    from ..models.odometry import OdometryPipeline

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    pipe = OdometryPipeline(cfg, device=_device(args.device))
    n = 0
    gts = []
    chunk = max(int(args.chunk or 0), 0)
    buf = []  # (image, stamp, gt) gathered for one device-resident chunk
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        if chunk > 1:
            buf.append((fr.image, fr.stamp, fr.gt_pose))
            if len(buf) == chunk:
                pipe.process_chunk(np.stack([b[0] for b in buf]),
                                   [b[1] for b in buf], [b[2] for b in buf])
                buf.clear()
        else:
            pipe.process(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        gts.append(fr.gt_pose)
        n += 1
    for img, stamp, gt_pose in buf:  # tail (< chunk frames)
        pipe.process(img, stamp=stamp, gt_pose=gt_pose)

    est = np.asarray(pipe.frame_poses)
    gt = np.stack(gts) if gts and all(g is not None for g in gts) else None
    metrics = _export_trajectories(args.output, est, gt, pipe.frame_stamps,
                                   "odom", covs=pipe.frame_covs)
    checkpoint.save_simple_graph(
        os.path.join(args.output, "simple_graph.npz"),
        checkpoint.from_odometry(pipe))
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps(dict(frames=n, keyframes=len(pipe.kf_poses), **metrics)))
    return 0


def _write_plots(outdir, gt, est, g, slam, labeled) -> None:
    from ..eval import loops as loops_eval
    from ..eval import plots

    plots.plot_trajectories(os.path.join(outdir, "plots", "trajectory.png"),
                            dict(gt=gt, est=est, odom=g.kf_poses))
    plots.plot_constraint_map(
        os.path.join(outdir, "plots", "constraint_map.png"), est,
        slam.graph.edges, keyframe_clouds=slam.loops.kf_peaks, gt=gt)
    if labeled:
        probs = np.asarray([r["prob"] for r in labeled])
        labels = np.asarray([r["is_loop"] for r in labeled], float)
        _, prec, rec = loops_eval.pr_curve(probs, labels)
        plots.plot_pr_curves(os.path.join(outdir, "plots", "loop_pr.png"),
                             {"TBV": (prec, rec)})


def cmd_slam(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..eval import loops as loops_eval
    from ..io import checkpoint
    from ..models.slam import run_offline_slam

    g = checkpoint.load_simple_graph(args.graph)
    cfg = _build_cfg(SENSOR, overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    slam = run_offline_slam(cfg, g, solver=args.solver,
                            device=_device(args.device))
    s = slam.summary
    est = slam.graph.poses_array()
    gt = slam.graph.gt_array()
    metrics = _export_trajectories(args.output, est, gt, slam.graph.stamps,
                                   "est")
    _export_trajectories(args.output, g.kf_poses, gt, g.kf_stamps, "odom")
    labeled = []
    if gt is not None:
        labeled = loops_eval.label_candidate_log(slam.loops.candidate_log, gt)
        loops_eval.write_loop_csv(
            os.path.join(args.output, "loop", "loop.csv"), labeled)
        if labeled:
            cm = loops_eval.classifier_metrics(
                np.asarray([r["prob"] for r in labeled]),
                np.asarray([r["is_loop"] for r in labeled], float))
            loops_eval.write_result_txt(
                os.path.join(args.output, "loop", "result.txt"), cm)
    checkpoint.save_full_graph(os.path.join(args.output, "full_graph.npz"),
                               slam.graph, slam=slam)
    if gt is not None:
        if importlib.util.find_spec("matplotlib") is not None:
            _write_plots(args.output, gt, est, g, slam, labeled)
        else:
            print("matplotlib is not installed: plots skipped",
                  file=sys.stderr)
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps({**(s.metrics or {}), **metrics,
                      "keyframes": s.num_keyframes, "loops": s.num_loops,
                      "traveled": s.traveled_distance}))
    return 0


def cmd_online(args, overrides: List[str]) -> int:
    from ..core.timing import timing
    from ..io import checkpoint, oxford
    from ..models.slam import TBVSLAM

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)
    timing.reset()

    slam = TBVSLAM(cfg, train_alignment=args.train_alignment,
                   device=_device(args.device))
    n = 0
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        slam.process_frame(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        n += 1
    s = slam.finish(optimize=True, solver=args.solver)
    if slam.alignment_learner is not None:
        slam.alignment_learner.save(
            os.path.join(args.output, "trained_alignment_classifier.txt"))
    est = slam.graph.poses_array()
    gt = slam.graph.gt_array()
    metrics = _export_trajectories(args.output, est, gt, slam.graph.stamps,
                                   "est")
    checkpoint.save_full_graph(os.path.join(args.output, "full_graph.npz"),
                               slam.graph, slam=slam)
    _write_pars(cfg, args.output)
    _write_timing(args.output)
    print(json.dumps({**(s.metrics or {}), **metrics, "frames": n,
                      "keyframes": s.num_keyframes, "loops": s.num_loops,
                      "pgo_epochs": slam.pgo_epochs}))
    return 0


def _classifier_report(model, x: np.ndarray, y: np.ndarray, device):
    """(probabilities, metrics) of a fitted model on its training data."""
    import torch

    from ..eval import loops as loops_eval
    from ..ops import logistic

    probs = logistic.predict_proba(
        model, torch.as_tensor(x, device=device)).cpu().numpy()
    return probs, loops_eval.classifier_metrics(probs, y)


def cmd_train_alignment(args, overrides: List[str]) -> int:
    """Alignment-classifier training (the odometry_training_node): run
    odometry, generate the 13-perturbation training pairs per keyframe, fit,
    save the coefficients and the ROC data."""
    from ..eval import loops as loops_eval
    from ..io import oxford
    from ..models.odometry import OdometryPipeline
    from ..models.verification import AlignmentLearner

    frames, meta = oxford.open_sequence(args.dataset)
    cfg = _build_cfg(meta, overrides)
    os.makedirs(args.output, exist_ok=True)
    dev = _device(args.device)

    pipe = OdometryPipeline(cfg, device=dev)
    learner = AlignmentLearner(cfg.verification, device=dev)
    n = n_kf = 0
    for fr in frames:
        if args.max_frames and n >= args.max_frames:
            break
        pipe.process(fr.image, stamp=fr.stamp, gt_pose=fr.gt_pose)
        while n_kf < len(pipe.kf_poses):
            learner.add_training_pair(pipe.kf_peaks[n_kf], pipe.kf_cells[n_kf],
                                      pipe.kf_poses[n_kf])
            n_kf += 1
        n += 1
    learner.fit()
    learner.save(os.path.join(args.output,
                              "trained_alignment_classifier.txt"))

    x, y = learner.training_data()
    probs, cm = _classifier_report(learner.model, x, y, dev)
    loops_eval.write_result_txt(os.path.join(args.output, "result.txt"), cm)
    ths, prec, rec = loops_eval.pr_curve(probs, y)
    np.savetxt(os.path.join(args.output, "roc.csv"),
               np.stack([ths, prec, rec], 1), delimiter=",",
               header="threshold,precision,recall")
    print(json.dumps(dict(samples=int(len(y)), **cm.as_dict())))
    return 0


def cmd_train_loop(args, overrides: List[str]) -> int:
    """Loop-verification classifier training: fit on a loop.csv (features +
    GT labels) or a ``y,odom,sc,align`` data file."""
    import torch

    from ..eval import loops as loops_eval
    from ..ops import logistic

    if args.loop_csv:
        rows = loops_eval.read_loop_csv(args.loop_csv)
        x = np.asarray([[r["odom_bounds"], r["sc_sim"],
                         r["alignment_quality"]] for r in rows], np.float32)
        y = np.asarray([r["is_loop"] for r in rows], np.float32)
    elif args.data:
        data = np.loadtxt(args.data, delimiter=",")
        y = data[:, 0].astype(np.float32)
        x = data[:, 1:4].astype(np.float32)
    else:
        print("error: give --loop-csv or --data", file=sys.stderr)
        return 2
    dev = _device(args.device)
    model = logistic.fit(torch.as_tensor(x, device=dev),
                         torch.as_tensor(y, device=dev), balanced=False)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    logistic.save_coefficients(model, args.output)
    _, cm = _classifier_report(model, x, y, dev)
    print(json.dumps(dict(samples=int(len(y)), **cm.as_dict())))
    return 0


def cmd_evaluate_scans(args, overrides: List[str]) -> int:
    """Perturbation-sweep scan evaluator (the coral scanEvaluator): alignment
    features of each consecutive keyframe pair of a checkpoint under a grid
    of offsets, one CSV row per sample, for separability analysis."""
    import torch

    from ..io import checkpoint, convert
    from ..models import verification as verif

    dev = _device(args.device)
    g = checkpoint.load_simple_graph(args.graph)
    cfg = _build_cfg(SENSOR, overrides)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)

    offsets = np.linspace(-args.range_max, args.range_max, args.range_steps)
    thetas = np.radians(np.linspace(-args.theta_max_deg, args.theta_max_deg,
                                    args.theta_steps))
    perts = np.asarray([[dx, dy, th] for dx in offsets for dy in offsets
                        for th in thetas], np.float32)
    perts_t = torch.as_tensor(perts, device=dev)

    def scan(i):
        take = lambda rec: {f.name: getattr(rec, f.name)[i]
                            for f in dataclasses.fields(rec)}
        pose = torch.as_tensor(g.kf_poses[i], dtype=torch.float32,
                               device=dev)
        return (convert.cloud_from_numpy(take(g.peaks), dev),
                convert.cells_from_numpy(take(g.cells), dev), pose)

    rows = []
    n_pairs = min(g.num_keyframes - 1, args.max_pairs)
    for i in range(n_pairs):
        x, y = verif.perturbed_training_features(
            *scan(i + 1), *scan(i), perts_t, cfg.verification)
        x, y = x.cpu().numpy(), y.cpu().numpy()
        for k in range(len(perts)):
            rows.append([i, *perts[k], float(y[k]), *x[k]])

    header = ("pair,dx,dy,dtheta,aligned,"
              "coral_joint,coral_sep,coral_overlap,"
              "cfear_score,cfear_nres,cfear_size")
    np.savetxt(args.output, np.asarray(rows), delimiter=",", header=header,
               comments="")
    print(json.dumps(dict(pairs=n_pairs, samples=len(rows))))
    return 0


def cmd_baseline(args, overrides: List[str]) -> int:
    """Aggregate the ``result.txt`` files of a tree of runs into Tab I/II
    style tables (1_baseline); host only."""
    from ..eval import baseline

    report = baseline.write_baseline(
        args.root, args.output or os.path.join(args.root, "baseline.txt"))
    print(report)
    return 0


def cmd_reoptimize(args, overrides: List[str]) -> int:
    """Re-run PGO on a saved full graph with overridden weights (the
    debug_optimizer / dynamic_reconfigure analogue): each invocation applies
    ``pgo.*`` overrides (e.g. ``pgo.loop_scaling=1e4``) and reports the
    metrics before and after."""
    from ..io import checkpoint

    cfg = _build_cfg(SENSOR, overrides)
    graph = checkpoint.load_full_graph(args.graph, cfg,
                                       device=_device(args.device))
    pre = graph.align_to_gt()
    res = graph.optimize(solver=args.solver)
    post = graph.align_to_gt()
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        checkpoint.save_full_graph(args.output, graph,
                                   loop_log=checkpoint.load_loop_log(
                                       args.graph))
    out = dict(cost0=float(res.cost0), cost=float(res.cost),
               iterations=int(res.iterations), solver=graph.last_solver)
    if pre is not None:
        out.update(ate_rmse_before=pre["ate_rmse"],
                   ate_rmse_after=post["ate_rmse"])
    print(json.dumps(out))
    return 0


def cmd_constraints(args, overrides: List[str]) -> int:
    """Dump / re-verify the loop constraints of a saved full graph (the
    DebugConstraints analogue): every loop-type constraint with its relative
    pose, measured covariance and, when the checkpoint carries scan payloads
    and ``--reverify`` is set, a freshly computed alignment quality at the
    stored t_be.  With GT present, each constraint also gets the
    EvaluationManager label geometry (< 4 m, < 2.5 deg)."""
    import csv

    import torch

    from ..core import se2
    from ..core.types import ODOMETRY, stack_records
    from ..io import checkpoint
    from ..models import verification as verif
    from ..ops import logistic

    cfg = _build_cfg(SENSOR, overrides)
    dev = _device(args.device)
    graph = checkpoint.load_full_graph(args.graph, cfg, device=dev)
    gt = graph.gt_array()
    slam = None
    if args.reverify:
        if "peaks_xy" not in np.load(args.graph).files:
            print("error: checkpoint has no scan payloads; re-save with "
                  "save_full_graph(..., slam=...)", file=sys.stderr)
            return 2
        slam = checkpoint.load_full_graph_slam(args.graph, cfg, device=dev)
    align_model = logistic.from_values(cfg.verification.alignment_coefs[0],
                                       cfg.verification.alignment_coefs[1:],
                                       device=dev)
    loops = [ed for ed in graph.edges if ed["etype"] != ODOMETRY]
    quality = None
    if slam is not None and loops:
        lp = slam.loops
        src = [lp._payload(ed["idx"][0]) for ed in loops]
        ref = [lp._payload(ed["idx"][1]) for ed in loops]
        t_be = torch.as_tensor(np.stack([ed["meas"] for ed in loops]),
                               device=dev)
        x6 = verif.alignment_features(
            stack_records([p for _, p in src]),
            stack_records([c for c, _ in src]), torch.zeros_like(t_be),
            stack_records([p for _, p in ref]),
            stack_records([c for c, _ in ref]), t_be, cfg.verification)
        quality = logistic.predict_linear(align_model, x6).cpu().numpy()

    rows = []
    for k, ed in enumerate(loops):
        a, b = ed["idx"]
        row = dict(id_from=int(a), id_to=int(b), etype=int(ed["etype"]),
                   t_x=float(ed["meas"][0]), t_y=float(ed["meas"][1]),
                   t_yaw=float(ed["meas"][2]),
                   has_cov=ed.get("cov") is not None)
        if ed.get("cov") is not None:
            c = np.asarray(ed["cov"])
            row.update(cov_xx=float(c[0, 0]), cov_yy=float(c[1, 1]),
                       cov_tt=float(c[2, 2]))
        if gt is not None:
            t_gt = se2.relative_np(gt[a], gt[b])
            err_t = float(np.linalg.norm(ed["meas"][:2] - t_gt[:2]))
            d = float(ed["meas"][2] - t_gt[2])
            err_r = abs(float(np.arctan2(np.sin(d), np.cos(d))))
            row.update(gt_err_m=round(err_t, 4),
                       gt_err_deg=round(float(np.degrees(err_r)), 4),
                       positive_ok=bool(err_t < 4.0
                                        and err_r < np.radians(2.5)))
        if quality is not None:
            row["alignment_quality"] = float(quality[k])
        rows.append(row)

    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        keys = sorted({k for r in rows for k in r})
        with open(args.output, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    n_pos = sum(1 for r in rows if r.get("positive_ok"))
    print(json.dumps(dict(n_loops=len(rows),
                          n_with_cov=sum(1 for r in rows if r["has_cov"]),
                          n_positive_ok=n_pos if gt is not None else None,
                          reverified=slam is not None,
                          rows=rows if args.print_rows else None)))
    return 0


def cmd_eval(args, overrides: List[str]) -> int:
    from ..eval import kitti

    m = kitti.evaluate_files(args.gt, args.est, args.output)
    print(json.dumps(m.as_dict()))
    return 0


def cmd_sweep(args, overrides: List[str]) -> int:
    from ..parallel import multihost
    from .sweep import run_sweep

    multihost.initialize(device=_device(args.device))  # under torchrun only
    results = run_sweep(args.par_file, args.dataset, args.output,
                        base_overrides=overrides, workers=args.workers,
                        max_frames=args.max_frames, mode=args.mode,
                        device=args.device)
    print(json.dumps(results))
    return 0


SOLVER_CHOICES = ["auto", "schur", "cholesky", "cg"]
DEVICE_HELP = "cuda (the default; an error without a card) or cpu"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tbv-torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("odometry")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--chunk", type=int, default=0,
                   help="run frames in device-resident chunks of this size "
                        "(one upload and one read per chunk)")
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_odometry)

    p = sub.add_parser("slam")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--solver", default="auto", choices=SOLVER_CHOICES)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_slam)

    p = sub.add_parser("online")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--train-alignment", action="store_true",
                   help="train the alignment classifier during the run")
    p.add_argument("--solver", default="auto", choices=SOLVER_CHOICES,
                   help="solver of the final optimization")
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_online)

    p = sub.add_parser("reoptimize")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--solver", default="auto", choices=SOLVER_CHOICES)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_reoptimize)

    p = sub.add_parser("constraints")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", default="")
    p.add_argument("--reverify", action="store_true")
    p.add_argument("--print-rows", action="store_true")
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_constraints)

    p = sub.add_parser("train-alignment")
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_train_alignment)

    p = sub.add_parser("train-loop")
    p.add_argument("--loop-csv", default=None)
    p.add_argument("--data", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_train_loop)

    p = sub.add_parser("baseline")
    p.add_argument("--root", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_baseline)

    p = sub.add_parser("evaluate-scans")
    p.add_argument("--graph", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--range-max", type=float, default=1.0)
    p.add_argument("--range-steps", type=int, default=3)
    p.add_argument("--theta-max-deg", type=float, default=2.0)
    p.add_argument("--theta-steps", type=int, default=3)
    p.add_argument("--max-pairs", type=int, default=50)
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_evaluate_scans)

    p = sub.add_parser("eval")
    p.add_argument("--gt", required=True)
    p.add_argument("--est", required=True)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("sweep")
    p.add_argument("--par-file", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--mode", default="online",
                   choices=["online", "odometry"])
    p.add_argument("--device", default=None, help=DEVICE_HELP)
    p.set_defaults(fn=cmd_sweep)

    args, overrides = ap.parse_known_args(argv)
    return args.fn(args, overrides)


if __name__ == "__main__":
    sys.exit(main())
