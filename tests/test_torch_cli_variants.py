"""Port parity of the ``baseline`` and ``evaluate-scans`` subcommands.

``baseline``: the report text identical to the reference CLI's on the same
tree of ``result.txt`` files.  ``evaluate-scans``: from one JAX-written
``simple_graph.npz``, the ``pair,dx,dy,dtheta,aligned`` columns exact, the
CFEAR columns within rtol 1e-4, and the CorAl columns held as the
verification tests hold them.  These keyframes (4 peaks per azimuth of the
simulator at its default size) are sparse scans for CorAl: at most 1.4 % of
a merged cloud has neighbours within the 1 m radius, so each entropy is a
mean over a handful of neighbourhoods, near-collinear ones among them, where
one near-singular covariance moves the mean (the online tests see the two
packages' entropies up to 10 % apart on such scans).  So the CorAl columns
are held by their decision: the published alignment classifier's verdict on
the whole row, wherever the reference's probability is clear of 0.5 by 0.1;
and the overlap to two points of the merged cloud (a point on the 1 m
radius may flip).
"""
import json
import os

import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import VerificationConfig
from tbv_slam_public_tpu.eval import kitti as jkitti
from tbv_slam_public_tpu.harness import cli as jcli
from tbv_slam_public_torch.harness import cli as tcli

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

SMALL = ["radar.k_strongest=4", "features.cell_capacity=128",
         "features.grid_extent=60.0", "registration.cost=P2L"]


def _result_tree(root, rng):
    """job_*/{est,odom}/result.txt with random KITTI metrics; one job lacks
    its odometry result and one directory is not a job."""
    for j in range(3):
        for sub in ("est", "odom"):
            if j == 2 and sub == "odom":
                continue
            d = os.path.join(root, f"job_{j}", sub)
            os.makedirs(d)
            v = rng.uniform(0.01, 5, 12)
            m = jkitti.OdometryMetrics(*map(float, v), num_segments=7)
            jkitti.write_result(os.path.join(d, "result.txt"), j, m)
    os.makedirs(os.path.join(root, "other", "est"))


def test_baseline_report_identical(tmp_path, capsys):
    rng = np.random.default_rng(0)
    root = str(tmp_path / "sweep")
    _result_tree(root, rng)
    assert jcli.main(["baseline", "--root", root, "--output",
                      str(tmp_path / "j.txt")]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["baseline", "--root", root, "--output",
                      str(tmp_path / "t.txt")]) == 0
    got = capsys.readouterr().out
    assert got == want and "job_2" in got and "mean" in got
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    # the default output path, and an empty tree
    assert tcli.main(["baseline", "--root", root]) == 0
    assert os.path.exists(os.path.join(root, "baseline.txt"))
    os.makedirs(tmp_path / "empty")
    assert tcli.main(["baseline", "--root", str(tmp_path / "empty")]) == 0
    assert jcli.main(["baseline", "--root", str(tmp_path / "empty")]) == 0


@pytest.fixture(scope="module")
def jax_graph(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("odo"))
    assert jcli.main(["odometry", "--dataset", "sim:10:5", "--output", out]
                     + SMALL) == 0
    return os.path.join(out, "simple_graph.npz")


@pytest.mark.parametrize("sweep", [
    [], ["--range-max", "2.0", "--range-steps", "2", "--theta-max-deg", "5",
         "--theta-steps", "2", "--max-pairs", "2"]], ids=["defaults", "grid"])
def test_evaluate_scans_matches(jax_graph, tmp_path, capsys, sweep):
    args = ["evaluate-scans", "--graph", jax_graph] + sweep + SMALL
    want_path, got_path = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    assert jcli.main(args[:1] + ["--output", want_path] + args[1:]) == 0
    want_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(args[:1] + ["--output", got_path, "--device", "cpu"]
                     + args[1:]) == 0
    got_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got_out == want_out and want_out["samples"] > 0
    with open(want_path) as f, open(got_path) as g:
        header = f.readline()
        assert g.readline() == header
    want = np.loadtxt(want_path, delimiter=",", skiprows=1)
    got = np.loadtxt(got_path, delimiter=",", skiprows=1)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :5], want[:, :5])
    if not sweep:  # the default grid holds the unperturbed pose once
        assert want[:, 4].sum() == want_out["pairs"]
    # CFEAR: cost, residual count, size; the unperturbed pose of a pair with
    # a couple of residuals costs ~5e-14, the float32 rounding of an exact
    # alignment, which only an absolute floor can compare
    np.testing.assert_allclose(got[:, 8:], want[:, 8:], rtol=1e-4,
                               atol=1e-9)
    # CorAl: the joint/separate entropies and the overlap
    z = np.load(jax_graph)
    mask = z["peaks_mask"].sum(1)
    pair = want[:, 0].astype(int)
    merged = (mask[pair] + mask[pair + 1]).astype(float)
    assert np.all(np.abs(got[:, 7] - want[:, 7]) <= 2.0 / merged + 1e-6)
    coef = np.asarray(VerificationConfig().alignment_coefs)
    prob = lambda x: 1.0 / (1.0 + np.exp(-(coef[0] + x[:, 5:] @ coef[1:])))
    clear = np.abs(prob(want) - 0.5) > 0.1
    assert clear.mean() > 0.5
    np.testing.assert_array_equal((prob(got) > 0.5)[clear],
                                  (prob(want) > 0.5)[clear])
