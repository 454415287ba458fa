"""Port parity: the secondary alignment-quality metrics (``ops/quality.py``)
on ``tests/test_quality.py``'s inputs, held to rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.core.types import make_cells
from tbv_slam_public_tpu.ops import quality as jq
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.core.types import stack_records
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.ops import quality as tq

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

RTOL = 1e-5


def _pair(xy, inten, mask):
    return (JCloud(jnp.asarray(xy), jnp.asarray(inten), jnp.asarray(mask)),
            TCloud(torch.as_tensor(xy), torch.as_tensor(inten),
                   torch.as_tensor(mask)))


def _clouds():
    """test_quality.py's clouds: a reference, a jittered copy, a shifted
    copy, a far copy, and one with masked points."""
    rng = np.random.default_rng(0)
    n = 300
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    inten = rng.uniform(60, 200, n).astype(np.float32)
    full = np.ones(n, bool)
    part = rng.uniform(size=n) < 0.6
    return dict(
        ref=_pair(xy, inten, full),
        good=_pair((xy + rng.normal(0, 0.05, xy.shape)).astype(np.float32),
                   inten, full),
        shifted=_pair(xy + np.float32(0.2), inten, full),
        bad=_pair(xy + np.float32(1.5), inten, part),
        far=_pair(xy + np.float32(50.0), inten, full),
        masked=_pair((xy + rng.normal(0, 0.5, xy.shape)).astype(np.float32),
                     inten, part))


def _close(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("src", ["good", "shifted", "bad", "far", "masked"])
@pytest.mark.parametrize("metric,kw", [
    ("p2p_quality", {}), ("keypoint_repeatability", dict(radius=1.0)),
    ("cartesian_absdiff_quality", dict(extent=25.0)),
    ("cartesian_absdiff_quality", dict(extent=100.0, size=64))])
def test_point_metrics_match(metric, kw, src):
    c = _clouds()
    (js, ts), (jr, tr) = c[src], c["ref"]
    _close(getattr(tq, metric)(ts, tr, **kw),
           getattr(jq, metric)(js, jr, **kw))


def _cells(rng, n_cells=32):
    centers = rng.uniform(-10, 10, (n_cells, 2)).astype(np.float32)
    cov = np.tile(0.2 * np.eye(2, dtype=np.float32), (n_cells, 1, 1))
    cov[:, 0, 1] = cov[:, 1, 0] = rng.uniform(-0.05, 0.05, n_cells)
    c = make_cells(n_cells).replace(
        mean=jnp.asarray(centers), cov=jnp.asarray(cov),
        valid=jnp.asarray(rng.uniform(size=n_cells) < 0.9))
    return c, cells_from_numpy({f: np.array(getattr(c, f)) for f in (
        "mean", "cov", "normal", "nsamples", "planarity", "avg_intensity",
        "valid")}), centers


@pytest.mark.parametrize("offset", [0.0, 0.8])
def test_p2d_quality_matches(offset):
    rng = np.random.default_rng(0)
    jc, tc, centers = _cells(rng)
    pts = (np.repeat(centers, 4, axis=0) + offset
           + rng.normal(0, 0.1, (len(centers) * 4, 2))).astype(np.float32)
    js, ts = _pair(pts, np.ones(len(pts), np.float32),
                   np.ones(len(pts), bool))
    got, want = tq.p2d_quality(ts, tc), jq.p2d_quality(js, jc)
    _close(got, want)
    assert int(want[1]) > 0


def test_render_cartesian_matches():
    (jr, tr) = _clouds()["masked"]
    np.testing.assert_allclose(tq.render_cartesian(tr, 25.0, 128).numpy(),
                               np.asarray(jq.render_cartesian(jr, 25.0, 128)),
                               rtol=RTOL, atol=0)


def test_batched_rows_equal_single_rows():
    """The leading axis is a plain batch: row b equals its own call."""
    c = _clouds()
    names = ["good", "bad", "far"]
    src = stack_records([c[k][1] for k in names])
    ref = stack_records([c["ref"][1]] * 3)
    for metric in ("p2p_quality", "keypoint_repeatability",
                   "cartesian_absdiff_quality"):
        batch = getattr(tq, metric)(src, ref)
        for b, k in enumerate(names):
            one = getattr(tq, metric)(c[k][1], c["ref"][1])
            for x, y in zip(batch if isinstance(batch, tuple) else (batch,),
                            one if isinstance(one, tuple) else (one,)):
                torch.testing.assert_close(x[b], y, rtol=RTOL, atol=0)
