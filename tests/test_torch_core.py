"""Port parity: core (config, SE(2), records), logistic, the copied
jax-free modules.

Every input is made with numpy from a seed and handed to both packages.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import config as jcfg
from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.core import timing as jtiming
from tbv_slam_public_tpu.ops import logistic as jlog
from tbv_slam_public_torch.core import config as tcfg
from tbv_slam_public_torch.core import se2 as tse2
from tbv_slam_public_torch.core import timing as ttiming
from tbv_slam_public_torch.core.types import Cells, make_cells
from tbv_slam_public_torch.io import convert
from tbv_slam_public_torch.io import native_loader as port_native
from tbv_slam_public_torch.ops import logistic as tlog

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# trig of identical float32 angles differs by an ulp between XLA and torch
TRIG_ATOL = 2e-6


def _poses(rng, n):
    p = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return p


@pytest.mark.parametrize("name", ["compose", "relative"])
def test_se2_binary_ops(rng, name):
    a, b = _poses(rng, 64), _poses(rng, 64)
    want = np.asarray(getattr(jse2, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tse2, name)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=2e-5)
    d = np.angle(np.exp(1j * (got[:, 2] - want[:, 2])))
    assert np.abs(d).max() < TRIG_ATOL


def test_se2_unary_and_points(rng):
    a = _poses(rng, 16)
    pts = rng.uniform(-80, 80, (16, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(tse2.inverse(torch.as_tensor(a)).numpy(),
                               np.asarray(jse2.inverse(jnp.asarray(a))),
                               atol=2e-5)
    for fn in ("apply", "rotate"):
        want = np.asarray(getattr(jse2, fn)(jnp.asarray(a), jnp.asarray(pts)))
        got = getattr(tse2, fn)(torch.as_tensor(a), torch.as_tensor(pts))
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    th = rng.uniform(-20, 20, 100).astype(np.float32)
    np.testing.assert_allclose(
        tse2.wrap_angle(torch.as_tensor(th)).numpy(),
        np.asarray(jse2.wrap_angle(jnp.asarray(th))), atol=TRIG_ATOL)


def test_se2_interpolate_scale_identity(rng):
    a, b = _poses(rng, 32), _poses(rng, 32)
    for f in (0.0, 0.3, 1.0, rng.uniform(size=32).astype(np.float32)):
        want = np.asarray(jse2.interpolate(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(f)))
        got = tse2.interpolate(torch.as_tensor(a), torch.as_tensor(b),
                               torch.as_tensor(f)).numpy()
        np.testing.assert_allclose(got[:, :2], want[:, :2], atol=2e-5)
        d = np.angle(np.exp(1j * (got[:, 2] - want[:, 2])))
        assert np.abs(d).max() < 10 * TRIG_ATOL
    np.testing.assert_array_equal(
        tse2.scale(torch.as_tensor(a), 0.37).numpy(),
        np.asarray(jse2.scale(jnp.asarray(a), 0.37)))
    np.testing.assert_array_equal(tse2.identity().numpy(),
                                  np.asarray(jse2.identity()))


def test_point_cloud_and_scan_records():
    from tbv_slam_public_tpu.core.types import make_point_cloud as jmake
    from tbv_slam_public_torch.core.types import (Scan, make_point_cloud,
                                                  stack_records)

    pc, want = make_point_cloud(6), jmake(6)
    for f in ("xy", "intensity", "mask"):
        got = getattr(pc, f).numpy()
        assert got.shape == getattr(want, f).shape
        assert got.dtype == np.asarray(getattr(want, f)).dtype
        assert not got.any()
    scan = Scan(cloud=pc, peaks=make_point_cloud(6), cells=make_cells(3))
    two = stack_records([scan, scan])  # nested records stack field by field
    assert two.cells.cov.shape == (2, 3, 2, 2)
    assert two.map(lambda x: x[1]).peaks.xy.shape == (6, 2)


def test_se2_numpy_helpers_identical(rng):
    a, b = _poses(rng, 1)[0], _poses(rng, 1)[0]
    pts = rng.uniform(-9, 9, (7, 2)).astype(np.float32)
    np.testing.assert_array_equal(tse2.relative_np(a, b),
                                  jse2.relative_np(a, b))
    np.testing.assert_array_equal(tse2.compose_np(a, b),
                                  jse2.compose_np(a, b))
    np.testing.assert_array_equal(tse2.apply_np(a, pts),
                                  jse2.apply_np(a, pts))


@pytest.mark.parametrize("preset", [None] + sorted(jcfg.PRESETS))
def test_config_copy_pars_text_identical(preset):
    jc = jcfg.PRESETS[preset]() if preset else jcfg.TBVConfig()
    tc = tcfg.PRESETS[preset]() if preset else tcfg.TBVConfig()
    assert tcfg.to_pars_text(tc) == jcfg.to_pars_text(jc)
    ov = {"radar.k_strongest": "7", "pgo.step_ladder": "1,0.5",
          "odometry.compensate": "false"}
    assert tcfg.to_pars_text(tcfg.apply_overrides(tc, ov)) == \
        jcfg.to_pars_text(jcfg.apply_overrides(jc, ov))


def _code(pkg, rel):
    """The module's syntax tree: its code and docstrings, not comments."""
    with open(os.path.join(ROOT, pkg, rel)) as f:
        return ast.dump(ast.parse(f.read()))


# jax-free modules the port carries as copies, so that the port and its
# smoke run import nothing of the JAX package; only comments may differ
# (config.py drops the reference's device measurements)
@pytest.mark.parametrize("rel", [
    "core/config.py", "io/simulate.py", "io/oxford.py", "eval/kitti.py",
    "eval/trajectory.py", "eval/loops.py", "eval/plots.py", "core/se3.py",
    "eval/baseline.py", "io/native_loader.py"])
def test_copies_hold_the_same_code(rel):
    assert _code("tbv_slam_public_torch", rel) == \
        _code("tbv_slam_public_tpu", rel)


def _oxford_dir(root, n=4):
    from PIL import Image

    from tbv_slam_public_torch.io import oxford

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "radar"))
    truth = []
    for i in range(n):
        img = rng.integers(0, 255, (16, oxford.OXFORD_META_COLUMNS + 24),
                           dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(
            root, "radar", f"{500_000 * (i + 1):016d}.png"))
        truth.append(img[:, oxford.OXFORD_META_COLUMNS:])
    return truth


@pytest.mark.skipif(not port_native.available(),
                    reason="native toolchain unavailable")
def test_oxford_reader_takes_the_native_decoder(tmp_path, monkeypatch):
    """Where the native loader is available the port's reader decodes
    through it, as the reference's does; the images are the PIL path's."""
    from tbv_slam_public_torch.io import oxford

    truth = _oxford_dir(str(tmp_path))
    opened = []

    class Recording(port_native.NativeSequenceReader):
        def __init__(self, files, **kw):
            opened.append(len(files))
            super().__init__(files, **kw)

    monkeypatch.setattr(port_native, "NativeSequenceReader", Recording)
    frames = list(oxford.OxfordSequence(str(tmp_path)))
    assert opened == [4]
    assert len(frames) == 4
    for fr, want in zip(frames, truth):
        np.testing.assert_array_equal(fr.image, want)
        np.testing.assert_array_equal(
            oxford.load_oxford_scan(os.path.join(
                str(tmp_path), "radar", f"{int(fr.stamp * 1e6):016d}.png")),
            want)


@pytest.mark.skipif(not port_native.available(),
                    reason="native toolchain unavailable")
@pytest.mark.parametrize("name", ["test_decode_matches_pil",
                                  "test_prefetching_reader_order",
                                  "test_reader_survives_missing_file"])
def test_native_loader_copy_passes_the_reference_tests(tmp_path,
                                                       monkeypatch, name):
    """``tests/test_native_loader.py``'s three cases, run against the port's
    copy of the loader and the port's oxford reader."""
    import test_native_loader as cases

    from tbv_slam_public_torch.io import oxford

    monkeypatch.setattr(cases, "native_loader", port_native)
    monkeypatch.setattr(cases, "oxford", oxford)
    getattr(cases, name)(tmp_path)


def test_timing_statistics_match():
    js, ts = jtiming.Statistics(), ttiming.Statistics()
    for name, v in [("a", 1.0), ("a", 3.0), ("b", 2.5)]:
        js.document(name, v)
        ts.document(name, v)
    assert ts.present() == js.present()
    assert ts.get("a") == js.get("a") and ts.get("zz") == js.get("zz")


def test_logistic_inference_and_coefficient_files(rng, tmp_path):
    coef = rng.normal(size=6).astype(np.float32)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    jm = jlog.from_values(0.3, coef)
    tm = convert.logistic_from_numpy(0.3, coef)
    np.testing.assert_allclose(
        tlog.predict_linear(tm, torch.as_tensor(x)).numpy(),
        np.asarray(jlog.predict_linear(jm, jnp.asarray(x))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tlog.predict_proba(tm, torch.as_tensor(x)).numpy(),
        np.asarray(jlog.predict_proba(jm, jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)
    # files cross between the packages in both directions
    jlog.save_coefficients(jm, str(tmp_path / "j.txt"))
    tlog.save_coefficients(tm, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    back = tlog.load_coefficients(str(tmp_path / "j.txt"))
    np.testing.assert_allclose(back.coef.numpy(), coef, rtol=1e-5)


def test_convert_records_roundtrip(rng):
    c = make_cells(5)
    d = {k: getattr(c, k).numpy() for k in
         ("mean", "cov", "normal", "nsamples", "planarity", "avg_intensity",
          "valid")}
    d["valid"] = rng.uniform(size=5) < 0.5
    got = convert.cells_from_numpy(d)
    assert isinstance(got, Cells) and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.valid.numpy(), d["valid"])
    e = convert.edges_from_numpy(dict(
        idx=np.asarray([[0, 1]], np.int32), meas=np.zeros((1, 3)),
        sqrt_info=np.eye(3)[None], etype=np.zeros(1, np.int32),
        mask=np.ones(1, bool)))
    assert e.idx.dtype == torch.long and e.meas.dtype == torch.float32
