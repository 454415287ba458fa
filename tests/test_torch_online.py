"""Port parity of the online entry point: ``TBVSLAM.process_frame`` with
periodic PGO epochs and in-run alignment training against the JAX package on
one simulated loop (framed as tests/test_slam.py's online test, shorter), and
the chunked odometry against the per-frame path and the JAX trajectory."""
import dataclasses

import numpy as np
import pytest
import torch

from test_slam import slam_config
from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import slam as jslam
from tbv_slam_public_tpu.models.odometry import OdometryPipeline as JOdometry
from tbv_slam_public_torch.models import slam as tslam
from tbv_slam_public_torch.models.odometry import OdometryPipeline as TOdometry

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

N_FRAMES = 100  # 1.3 laps of a 10.5 m circle at 0.8 m a frame


@pytest.fixture(scope="module")
def sequence():
    seq = simulate.make_sequence(
        num_frames=N_FRAMES, seed=3, num_azimuths=120, num_range_bins=200,
        range_res=0.35, traj_kwargs=dict(radius=10.5, step=0.8, laps=1.3))
    gt = np.stack([jse2.relative_np(seq.gt_poses[0], g)
                   for g in seq.gt_poses])
    return seq.images, gt


def _online_cfg():
    cfg = slam_config()
    return dataclasses.replace(
        cfg, pgo=dataclasses.replace(cfg.pgo, optimize_every=5))


@pytest.fixture(scope="module")
def online_runs(sequence):
    images, gt = sequence
    out = []
    for make in (lambda: jslam.TBVSLAM(_online_cfg(), train_alignment=True),
                 lambda: tslam.TBVSLAM(_online_cfg(), train_alignment=True,
                                       device="cpu")):
        slam = make()
        for i in range(N_FRAMES):
            slam.process_frame(images[i], stamp=i * 0.25, gt_pose=gt[i])
        default_model = slam.loops.align_model
        odom = slam.graph.poses_array().copy()
        n_mid = slam.graph.num_loops()
        summary = slam.finish(optimize=True, solver="auto")
        out.append((slam, summary, default_model, odom, n_mid))
    return out


def test_online_run_matches(online_runs):
    """The same frames through both packages' online mode: the same
    keyframes, PGO epochs, training samples and node bookkeeping; the same
    loops wherever the reference's probability is clear of the threshold; the
    final ATE within 1 cm."""
    (j, js, _, _, j_mid), (t, ts, _, _, t_mid) = online_runs
    assert ts.num_frames == js.num_frames == N_FRAMES
    assert ts.num_keyframes == js.num_keyframes >= 40
    assert t.graph.stamps == j.graph.stamps  # identical keyframe decisions
    assert t._kf_to_node == j._kf_to_node == list(range(ts.num_keyframes))
    assert t.pgo_epochs == j.pgo_epochs >= 2
    assert t_mid >= 1 and j_mid >= 1  # loops closed during the run
    assert t.alignment_learner.num_samples == \
        j.alignment_learner.num_samples >= 26

    chain = lambda s: [e["idx"] for e in s.graph.edges if e["etype"] == 0]
    assert chain(t) == chain(j)
    th = _online_cfg().verification.model_threshold
    jprob = {(r["id_from"], r["id_to"]): r["prob"]
             for r in j.loops.candidate_log}
    jloops = {e["idx"] for e in j.graph.edges if e["etype"] != 0}
    tloops = {e["idx"] for e in t.graph.edges if e["etype"] != 0}
    assert len(jloops) >= 3
    # a probability within 0.1 of the threshold may fall on either side (the
    # refitted alignment model is a 6-feature fit to ~600 nearly separable
    # samples: its coefficients are loosely determined)
    assert {k for k in jloops if jprob[k] > th + 0.1} <= tloops
    assert all(jprob.get(k, 1.0) > th - 0.1 for k in tloops)
    # periodic epochs rebase the poses the next constraints compose off: the
    # two trajectories stay together to 1 cm in ATE and 5 cm at any keyframe
    assert abs(ts.metrics["ate_rmse"] - js.metrics["ate_rmse"]) < 1e-2
    assert np.abs(t.graph.poses_array()[:, :2]
                  - j.graph.poses_array()[:, :2]).max() < 5e-2
    assert t.graph.last_solver == "schur"


def test_online_run_is_sound(online_runs):
    """What tests/test_slam.py asks of the reference's online mode, asked of
    the port: epochs ran, loops were accepted, the trajectory is not
    corrupted, the learner refitted the verifier's model."""
    _, (t, ts, default_model, odom, _) = online_runs
    assert t.pgo_epochs >= 1 and ts.num_loops >= 1
    assert ts.metrics["ate_rmse"] < 2.0
    assert np.isfinite(t.graph.poses_array()).all()
    assert t.loops.align_model is not default_model
    assert t.loops.align_model is t.alignment_learner.model
    gt = t.graph.gt_array()
    for e in t.graph.edges:
        if e["etype"] != 0:
            a, b = e["idx"]
            assert abs(a - b) > 5
            assert np.linalg.norm(gt[a, :2] - gt[b, :2]) < 6.0
    assert ts.pgo_cost <= ts.pgo_cost0
    assert t.summary is ts


@pytest.fixture(scope="module")
def per_frame(sequence):
    images, gt = sequence
    n = 33
    pipe = TOdometry(slam_config(), device="cpu")
    for i in range(n):
        pipe.process(images[i], stamp=i * 0.25, gt_pose=gt[i])
    return n, pipe


@pytest.mark.parametrize("chunk", [8, 16])
def test_process_chunk_equals_per_frame(sequence, per_frame, chunk):
    """K frames in one upload with no host read between the steps give the
    per-frame path's records: the same arithmetic in the same order, so
    poses, covariances, keyframes and constraints are equal bit for bit."""
    images, gt = sequence
    n, ref = per_frame
    pipe = TOdometry(slam_config(), device="cpu")
    n_kf = 0
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        n_kf += pipe.process_chunk(images[lo:hi],
                                   [i * 0.25 for i in range(lo, hi)],
                                   gt[lo:hi])
    assert n_kf == len(pipe.kf_poses) == len(ref.kf_poses) >= 10
    np.testing.assert_array_equal(np.asarray(pipe.frame_poses),
                                  np.asarray(ref.frame_poses))
    np.testing.assert_array_equal(np.asarray(pipe.frame_covs),
                                  np.asarray(ref.frame_covs))
    assert pipe.frame_stamps == ref.frame_stamps
    assert pipe.kf_stamps == ref.kf_stamps
    for a, b in zip(pipe.kf_constraints, ref.kf_constraints):
        assert (a["id_begin"], a["id_end"]) == (b["id_begin"], b["id_end"])
        np.testing.assert_array_equal(a["t_be"], b["t_be"])
    for a, b in zip(pipe.kf_peaks, ref.kf_peaks):
        np.testing.assert_array_equal(a.xy.numpy(), b.xy.numpy())
    np.testing.assert_array_equal(np.stack(pipe.kf_gt), np.stack(ref.kf_gt))


def test_process_chunk_matches_reference_trajectory(sequence, per_frame):
    """The chunked path against the JAX package's chunked path
    (``odometry_scan``), at the tolerance of the per-frame comparison in
    test_torch_slice.py: 1 mm on average, 2 mm at worst, 1e-4 rad."""
    images, gt = sequence
    n, _ = per_frame
    stamps = [i * 0.25 for i in range(n)]
    jp = JOdometry(slam_config())
    tp = TOdometry(slam_config(), device="cpu")
    for lo in range(0, n, 16):
        hi = min(lo + 16, n)
        jp.process_chunk(images[lo:hi], stamps[lo:hi], gt[lo:hi])
        tp.process_chunk(images[lo:hi], stamps[lo:hi], gt[lo:hi])
    assert tp.kf_stamps == jp.kf_stamps
    est, ref = np.asarray(tp.frame_poses), np.asarray(jp.frame_poses)
    err = np.abs(est[:, :2] - ref[:, :2]).max(1)
    assert err.mean() < 1e-3 and err.max() < 2e-3, err
    assert np.abs(est[:, 2] - ref[:, 2]).max() < 1e-4


def test_process_frames_chunked_bookkeeping(sequence, per_frame):
    """TBVSLAM.process_frames_chunked keeps the graph, the loop closer and
    the node map as process_frame does."""
    images, gt = sequence
    n, ref = per_frame
    slam = tslam.TBVSLAM(slam_config(), device="cpu")
    n_kf = slam.process_frames_chunked(
        images[:n], [i * 0.25 for i in range(n)], gt[:n], chunk=16,
        search_loops=True)
    assert n_kf == len(ref.kf_poses) == slam.graph.num_nodes
    assert slam._kf_to_node == list(range(n_kf)) and slam._frames == n
    assert len(slam.loops.kf_odom) == n_kf
    assert [e["idx"] for e in slam.graph.edges if e["etype"] == 0] == \
        [(i, i + 1) for i in range(n_kf - 1)]
    # the graph composes each node off its predecessor and the constraint
    np.testing.assert_allclose(slam.graph.poses_array(),
                               np.asarray(ref.kf_poses), atol=1e-4)
    np.testing.assert_array_equal(slam.graph.gt_array(), np.stack(ref.kf_gt))
    assert slam.loops._processed == n_kf - slam.cfg.loopclosure.n_aggregate
