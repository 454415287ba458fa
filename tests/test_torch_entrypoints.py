"""The port's entry points: the card is the default device and its absence an
error, and every CLI subcommand of the online slice runs on ``sim:`` data
with ``--device cpu``."""
import json
import os

import numpy as np
import pytest
import torch

from tbv_slam_public_torch.core import device as tdevice
from tbv_slam_public_torch.core.config import TBVConfig
from tbv_slam_public_torch.harness import cli
from tbv_slam_public_torch.io import checkpoint
from tbv_slam_public_torch.models import loopclosure, odometry, slam
from tbv_slam_public_torch.models import verification
from tbv_slam_public_torch.ops import cen
from tbv_slam_public_torch.parallel import multihost

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

SMALL = ["radar.k_strongest=4", "features.cell_capacity=128",
         "features.grid_extent=60.0", "registration.cost=P2L",
         "registration.max_outer_iterations=3",
         "verification.model_threshold=0.5",
         "verification.peaks_capacity=1024"]
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1])


def test_resolve(monkeypatch):
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdevice.resolve(None)
    assert tdevice.resolve("cuda:1") == torch.device("cuda", 1)  # as given
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve(None) == torch.device("cuda")


ENTRY_POINTS = {
    "OdometryPipeline": lambda cfg: odometry.OdometryPipeline(cfg),
    "LoopCloser": lambda cfg: loopclosure.LoopCloser(cfg),
    "PoseGraph": lambda cfg: slam.PoseGraph(cfg),
    "TBVSLAM": lambda cfg: slam.TBVSLAM(cfg),
    "AlignmentLearner": lambda cfg: verification.AlignmentLearner(
        cfg.verification),
    "run_offline_slam": lambda cfg: slam.run_offline_slam(cfg, None),
    "load_full_graph": lambda cfg: checkpoint.load_full_graph(
        os.path.join(FIXTURES, "missing.npz"), cfg),
    "train_loop_model_from_file": lambda cfg:
        verification.train_loop_model_from_file(
            os.path.join(FIXTURES, "missing.txt")),
    "init_batched_state": lambda cfg: odometry.init_batched_state(cfg, 2),
    "cen2019_filter": lambda cfg: cen.cen2019_filter(
        np.zeros((8, 32), np.uint8), cfg.radar),
    "global_mesh": lambda cfg: multihost.global_mesh(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_by_default(monkeypatch, name):
    """With no device given and no card, an entry point raises; nothing
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ENTRY_POINTS[name](TBVConfig())


@pytest.mark.parametrize("argv", [
    ["odometry", "--dataset", "sim:4:1", "--output", "{tmp}/o"],
    ["online", "--dataset", "sim:4:1", "--output", "{tmp}/o"],
    ["train-alignment", "--dataset", "sim:4:1", "--output", "{tmp}/o"],
    ["train-loop", "--data", "{tmp}/model.txt", "--output", "{tmp}/c.txt"],
    ["evaluate-scans", "--graph", "{tmp}/g.npz", "--output", "{tmp}/e.csv"],
    ["sweep", "--par-file", "{tmp}/p.csv", "--dataset", "sim:4:1",
     "--output", "{tmp}/s"],
], ids=lambda a: a[0])
def test_cli_needs_a_card_by_default(monkeypatch, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.load(os.path.join(FIXTURES, "tbv_model_8.npz"))["data"][:50]
    np.savetxt(str(tmp_path / "model.txt"), data, delimiter=",")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([a.format(tmp=tmp_path) for a in argv])


@pytest.fixture(scope="module")
def online_out(tmp_path_factory):
    """``online --train-alignment`` over a simulated sequence with a PGO
    epoch every 5 keyframes."""
    out = str(tmp_path_factory.mktemp("online"))
    rc = cli.main(["online", "--dataset", "sim:30:5", "--output", out,
                   "--train-alignment", "--device", "cpu",
                   "pgo.optimize_every=5"] + SMALL)
    return rc, out


def test_cli_online(online_out, capsys):
    rc, out = online_out
    assert rc == 0
    for name in ("full_graph.npz", "trained_alignment_classifier.txt",
                 "pars.txt", "time_statistics.txt", "est/00.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    z = np.load(os.path.join(out, "full_graph.npz"))
    assert z["poses"].shape[1] == 3 and np.isfinite(z["poses"]).all()
    assert "peaks_xy" in z.files  # payloads: re-verification can resume


@pytest.mark.parametrize("solver", [None, "schur", "cholesky", "cg"])
def test_cli_reoptimize(online_out, tmp_path, capsys, solver):
    _, out = online_out
    argv = ["reoptimize", "--graph", os.path.join(out, "full_graph.npz"),
            "--output", str(tmp_path / "re.npz"), "--device", "cpu",
            "pgo.loop_scaling=1e4"]
    assert cli.main(argv + (["--solver", solver] if solver else [])) == 0
    res = _last_json(capsys)
    assert res["cost"] <= res["cost0"] + 1e-9
    # no --solver means auto: schur on a chain with sparse loops, the dense
    # solver on a graph with too few keyframes for that
    assert res["solver"] in ((solver,) if solver else ("schur", "cholesky"))
    assert np.isfinite(np.load(str(tmp_path / "re.npz"))["poses"]).all()


@pytest.mark.parametrize("reverify", [False, True])
def test_cli_constraints(online_out, tmp_path, capsys, reverify):
    _, out = online_out
    argv = ["constraints", "--graph", os.path.join(out, "full_graph.npz"),
            "--output", str(tmp_path / "c.csv"), "--print-rows",
            "--device", "cpu"] + SMALL
    assert cli.main(argv + (["--reverify"] if reverify else [])) == 0
    res = _last_json(capsys)
    assert res["reverified"] == reverify and res["n_loops"] >= 0
    assert os.path.exists(str(tmp_path / "c.csv"))
    if reverify and res["n_loops"]:
        assert all(np.isfinite(r["alignment_quality"]) for r in res["rows"])


def test_cli_odometry_chunk_slam_and_train_loop(tmp_path, capsys):
    """``odometry --chunk`` writes the per-frame run's trajectory; ``slam``
    runs with its default solver from that checkpoint and writes loop.csv,
    which ``train-loop --loop-csv`` takes; ``train-loop --data`` takes the
    reference system's training file."""
    ov = [a for a in SMALL if not a.startswith("verification")]
    odo = lambda name, extra: cli.main(
        ["odometry", "--dataset", "sim:30:5", "--output",
         str(tmp_path / name), "--device", "cpu"] + extra + ov)
    assert odo("chunked", ["--chunk", "16"]) == 0
    assert odo("plain", []) == 0
    a = np.loadtxt(str(tmp_path / "chunked" / "odom" / "00.txt"))
    b = np.loadtxt(str(tmp_path / "plain" / "odom" / "00.txt"))
    np.testing.assert_array_equal(a, b)  # the same arithmetic in that order

    assert cli.main(["slam", "--graph",
                     str(tmp_path / "chunked" / "simple_graph.npz"),
                     "--output", str(tmp_path / "slam"), "--device", "cpu"]
                    + SMALL) == 0
    res = _last_json(capsys)
    assert res["keyframes"] >= 10 and np.isfinite(res["ate_rmse"])
    loop_csv = str(tmp_path / "slam" / "loop" / "loop.csv")
    if os.path.exists(loop_csv) and sum(1 for _ in open(loop_csv)) > 3:
        assert cli.main(["train-loop", "--loop-csv", loop_csv, "--output",
                         str(tmp_path / "loop_coef.txt"), "--device",
                         "cpu"]) == 0
    data = np.load(os.path.join(FIXTURES, "tbv_model_8.npz"))["data"]
    np.savetxt(str(tmp_path / "model.txt"), data, delimiter=",")
    assert cli.main(["train-loop", "--data", str(tmp_path / "model.txt"),
                     "--output", str(tmp_path / "coef.txt"), "--device",
                     "cpu"]) == 0
    res = _last_json(capsys)
    assert res["samples"] == len(data)
    coef = np.loadtxt(str(tmp_path / "coef.txt"), delimiter=",").ravel()
    assert coef.size == 4 and np.isfinite(coef).all()
    assert cli.main(["train-loop", "--output", str(tmp_path / "x.txt"),
                     "--device", "cpu"]) == 2  # neither input given


def test_cli_train_alignment(tmp_path, capsys):
    assert cli.main(["train-alignment", "--dataset", "sim:16:5", "--output",
                     str(tmp_path / "ta"), "--device", "cpu"] + SMALL) == 0
    res = _last_json(capsys)
    assert res["samples"] >= 26 and res["samples"] % 13 == 0
    for name in ("trained_alignment_classifier.txt", "result.txt", "roc.csv"):
        assert os.path.exists(str(tmp_path / "ta" / name)), name
