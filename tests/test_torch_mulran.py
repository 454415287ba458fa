"""MulRan ingestion through the port, against the JAX package.

The port's counterpart of ``tests/test_mulran_e2e.py``: the same MulRan
release-layout directory (nanosecond-stamped polar PNGs stored before the
loader's rot90, ``global_pose.csv`` interpolated to the scan stamps, 3360
bins of 0.05952 m) goes through the port's ``open_sequence("mulran:...")``
and ``OdometryPipeline``, and through the port's ``cli odometry --device
cpu``; both are held to the JAX pipeline on the same directory at the
odometry variants' tolerance (tests/test_torch_odometry_variants.py):
keyframes equal, trajectory within 1 mm mean / 2 mm max.
"""
import json
import os

import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import config as jconfig
from tbv_slam_public_tpu.io import oxford as joxford
from tbv_slam_public_tpu.models import odometry as jodo
from tbv_slam_public_torch.core import config as tconfig
from tbv_slam_public_torch.harness import cli
from tbv_slam_public_torch.io import checkpoint
from tbv_slam_public_torch.io import oxford as toxford
from tbv_slam_public_torch.models import odometry as todo
from test_mulran_e2e import RES, A, R
from test_mulran_e2e import mulran_dir  # noqa: F401  (the fixture)

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

MEAN_TOL, MAX_TOL = 1e-3, 2e-3
# test_mulran_e2e.py's configuration, as overrides of the dataset's radar
OVERRIDES = ["radar.k_strongest=12", "radar.min_distance=2.5",
             "radar.max_distance=120.0", "features.resolution=3.0",
             "features.cell_capacity=256", "features.grid_extent=150.0",
             "registration.cost=P2L", "registration.weight_option=4",
             "odometry.submap_scan_size=3", "odometry.compensate=false"]


def _config(pkg, meta):
    radar = pkg.RadarConfig(num_azimuths=meta["num_azimuths"],
                            num_range_bins=meta["num_range_bins"],
                            range_res=meta["range_res"])
    return pkg.apply_overrides(pkg.TBVConfig(radar=radar),
                               pkg.parse_cli_overrides(OVERRIDES))


@pytest.fixture(scope="module")
def reference(mulran_dir):  # noqa: F811
    """The JAX pipeline on the directory: (frames, keyframe poses, frame
    poses, ground truth)."""
    root, _ = mulran_dir
    frames, meta = joxford.open_sequence(f"mulran:{root}")
    pipe = jodo.OdometryPipeline(_config(jconfig, meta))
    for fr in frames:
        pipe.process(fr.image, fr.stamp, gt_pose=fr.gt_pose)
    return (frames, np.asarray(pipe.kf_poses), np.asarray(pipe.frame_poses),
            np.asarray([fr.gt_pose for fr in frames]))


def _assert_trajectory(got, want):
    d = np.linalg.norm(got[:, :2] - want[:, :2], axis=1)
    assert d.mean() < MEAN_TOL and d.max() < MAX_TOL, d
    assert np.abs(got[:, 2] - want[:, 2]).max() < MAX_TOL


def test_port_reader_matches_the_reference(mulran_dir, reference):  # noqa
    """The port's reader gives the reference's frames: 3360 bins after
    rot90, the same stamps and the same interpolated ground truth."""
    root, _ = mulran_dir
    want_frames = reference[0]
    frames, meta = toxford.open_sequence(f"mulran:{root}")
    assert (meta["num_range_bins"], meta["range_res"]) == (R, RES)
    assert len(frames) == len(want_frames)
    for got, want in zip(frames, want_frames):
        assert got.image.shape == (A, R)
        np.testing.assert_array_equal(got.image, want.image)
        assert got.stamp == want.stamp
        np.testing.assert_array_equal(got.gt_pose, want.gt_pose)


def test_port_pipeline_matches_the_reference(mulran_dir, reference):  # noqa
    """``open_sequence`` + ``OdometryPipeline`` on the CPU: the reference's
    keyframes and trajectory."""
    root, _ = mulran_dir
    _, want_kf, want_frames, _ = reference
    frames, meta = toxford.open_sequence(f"mulran:{root}")
    pipe = todo.OdometryPipeline(_config(tconfig, meta), device="cpu")
    for fr in frames:
        pipe.process(fr.image, fr.stamp, gt_pose=fr.gt_pose)
    assert len(pipe.kf_poses) == len(want_kf) >= 2
    _assert_trajectory(np.asarray(pipe.frame_poses), want_frames)
    _assert_trajectory(np.asarray(pipe.kf_poses), want_kf)


def test_port_cli_matches_the_reference(mulran_dir, reference, tmp_path,
                                        capsys):  # noqa: F811
    """``cli odometry --dataset mulran:<dir> --device cpu``: its checkpoint
    holds the reference's keyframes, with the dataset's ground truth."""
    root, _ = mulran_dir
    _, want_kf, _, gt = reference
    out = tmp_path / "odo"
    rc = cli.main(["odometry", "--dataset", f"mulran:{root}", "--output",
                   str(out), "--device", "cpu"] + OVERRIDES)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == len(gt) and line["keyframes"] == len(want_kf)
    g = checkpoint.load_simple_graph(os.path.join(out, "simple_graph.npz"))
    _assert_trajectory(np.asarray(g.kf_poses), want_kf)
    assert len(g.kf_gt) == len(want_kf)
