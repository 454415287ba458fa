"""Port parity: the CA-CFAR, BFAR, Cen 2018 and Cen 2019 detectors and the
max-mode ScanContext descriptor.

Every input is made with numpy from a seed and handed to both packages.
Tolerances: CFAR detection sets (azimuth, bin) and intensities exact, xy
within 1e-4 m (sin/cos of one float32 angle differ by an ulp between XLA and
torch); Cen 2018 detections equal away from bins whose score lies within
1e-5 sigma of the threshold, cloud within 1e-4 m; Cen 2019 detections
bit-equal (the port's function is the reference's NumPy, held equal by its
syntax tree); the max-mode descriptor exactly equal.
"""
import ast
import dataclasses
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import RadarConfig, ScanContextConfig
from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.ops import cen as jcen
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_tpu.ops import scancontext as jsc
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.ops import cen as tcen
from tbv_slam_public_torch.ops import radar as tradar
from tbv_slam_public_torch.ops import scancontext as tsc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cen import synthetic_image  # noqa: E402

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

XY_ATOL = 1e-4


def _cfar_cfg(**kw):
    base = dict(num_azimuths=16, num_range_bins=64, range_res=0.5, z_min=60,
                k_strongest=4, min_distance=2.5, max_distance=30.0,
                cfar_guard_cells=2, cfar_window_size=4,
                cfar_false_alarm_rate=0.5, bfar_scale=1.5, bfar_offset=15.0)
    base.update(kw)
    return RadarConfig(**base)


def _images():
    """(name, image, config): test_radar.py's inputs, random speckle with
    strong returns, and rows of tied intensities."""
    rng = np.random.default_rng(3)
    one = np.full((16, 64), 20, np.uint8)
    one[3, 40] = 250
    bfar = rng.integers(0, 8, (16, 64)).astype(np.uint8)
    bfar[5, 30], bfar[9, 12] = 200, 180
    speckle = rng.integers(0, 90, (48, 200)).astype(np.uint8)
    for _ in range(150):
        speckle[rng.integers(48), rng.integers(200)] = rng.integers(100, 256)
    # equal intensities: more detections per row than k, so the tie order
    # of the selection decides which are kept
    ties = rng.integers(0, 30, (24, 120)).astype(np.uint8)
    ties[:, 20:100:6] = 200
    ties[::3, 23:100:6] = 200
    big = dict(num_range_bins=200, num_azimuths=48, range_res=0.3,
               min_distance=1.0, max_distance=55.0)
    return [
        ("one target", one, _cfar_cfg(z_min=60)),
        ("bfar targets", bfar, _cfar_cfg(z_min=10.0, min_distance=1.0)),
        ("speckle", speckle, _cfar_cfg(z_min=40, k_strongest=9,
                                       cfar_window_size=7,
                                       cfar_false_alarm_rate=0.05, **big)),
        ("speckle, no guard", speckle, _cfar_cfg(
            z_min=0, cfar_guard_cells=0, cfar_window_size=1, **big)),
        ("tied intensities", ties, _cfar_cfg(
            z_min=50, k_strongest=5, num_azimuths=24, num_range_bins=120,
            cfar_guard_cells=1, cfar_window_size=2, bfar_offset=40.0,
            min_distance=0.5, max_distance=60.0)),
    ]


def _assert_same_detections(got: TCloud, want):
    gm, wm = got.mask.numpy(), np.asarray(want.mask)
    np.testing.assert_array_equal(gm, wm)  # same (azimuth, slot) set
    np.testing.assert_array_equal(got.intensity.numpy()[gm],
                                  np.asarray(want.intensity)[wm])
    np.testing.assert_allclose(got.xy.numpy()[gm], np.asarray(want.xy)[wm],
                               rtol=0, atol=XY_ATOL)


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("name", ["cacfar_filter", "bfar_filter"])
def test_cfar_detectors_match(name, case):
    tag, img, cfg = _images()[case]
    want = getattr(jradar, name)(jnp.asarray(img), cfg)
    got = getattr(tradar, name)(torch.as_tensor(img), cfg)
    _assert_same_detections(got, want)
    if tag == "tied intensities":
        vals = np.asarray(want.intensity)[np.asarray(want.mask)]
        assert (vals == 200).sum() > len(np.unique(vals)), \
            "the case must select among equal intensities"


def test_filter_scan_dispatch():
    _, img, cfg = _images()[2]
    for ft in ("kstrong", "cacfar", "bfar"):
        c = dataclasses.replace(cfg, filter_type=ft)
        tc, tp = tradar.filter_scan(torch.as_tensor(img), c)
        jc, jp = jradar.filter_scan(jnp.asarray(img), c)
        _assert_same_detections(tc, jc)
        _assert_same_detections(tp, jp)
    with pytest.raises(ValueError, match="unknown filter_type"):
        tradar.filter_scan(torch.as_tensor(img),
                           dataclasses.replace(cfg, filter_type="nope"))


CEN_CFG = RadarConfig(num_azimuths=64, num_range_bins=256, range_res=0.4,
                      min_distance=4.0, k_strongest=8)


@pytest.mark.parametrize("seed,noise", [(0, 5.0), (1, 12.0), (2, 25.0)])
def test_cen2018_matches(seed, noise):
    img = synthetic_image(noise=noise, seed=seed)
    min_range = int(np.ceil(CEN_CFG.min_distance / CEN_CFG.range_res))
    _, _, _, want = jcen._cen2018_impl(jnp.asarray(img), zq=3.0,
                                       sigma_gauss=17, min_range=min_range,
                                       capacity=512)
    y, thres, got = tcen.cen2018_scores(torch.as_tensor(img), 3.0, 17,
                                        min_range)
    # a bin whose score sits on the threshold may flip, and with it the
    # middle of its run: compare rows whose scores all clear it
    sigma = (thres / 3.0).numpy()
    near = (np.abs(y.numpy() - thres.numpy()) <= 1e-5 * sigma).any(1)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got[~near], want[~near])
    assert near.mean() < 0.1 and got.sum() > 3
    jc = jcen.cen2018_filter(jnp.asarray(img), CEN_CFG)
    tc = tcen.cen2018_filter(torch.as_tensor(img), CEN_CFG)
    if not near.any():
        _assert_same_detections(tc, jc)


def _function_tree(module, name):
    """A function's syntax tree without its docstring."""
    fn = ast.parse(inspect.getsource(getattr(module, name))).body[0]
    if ast.get_docstring(fn) is not None:
        fn.body = fn.body[1:]
    return ast.dump(fn)


def test_cen2019_features_is_the_reference_code():
    assert _function_tree(tcen, "cen2019_features") == \
        _function_tree(jcen, "cen2019_features")


@pytest.mark.parametrize("seed,max_points", [(0, 1000), (4, 200)])
def test_cen2019_matches(seed, max_points):
    img = synthetic_image(seed=seed)
    np.testing.assert_array_equal(
        tcen.cen2019_features(img, max_points, 10),
        jcen.cen2019_features(img, max_points, 10))
    # cen2019_filter's xy comes from jnp in the reference, from NumPy here:
    # the same float32 formula, trig an ulp apart
    got = tcen.cen2019_filter(img, CEN_CFG, max_points, device="cpu")
    want = jcen.cen2019_filter(img, CEN_CFG, max_points)
    _assert_same_detections(got, want)
    assert int(got.mask.sum()) >= 3


@pytest.mark.parametrize("lead", [(), (3,)])
def test_max_mode_descriptor_matches(lead):
    rng = np.random.default_rng(5)
    cfg = dataclasses.replace(ScanContextConfig(), desc_function="max")
    n = 600
    xy = rng.uniform(-90, 90, lead + (n, 2)).astype(np.float32)
    inten = rng.integers(0, 255, lead + (n,)).astype(np.float32)
    mask = rng.uniform(size=lead + (n,)) < 0.8
    got = tsc.make_descriptor(TCloud(torch.as_tensor(xy),
                                     torch.as_tensor(inten),
                                     torch.as_tensor(mask)), cfg).numpy()
    rows = [()] if not lead else [(i,) for i in range(lead[0])]
    for r in rows:
        want = np.asarray(jsc.make_descriptor(
            JCloud(jnp.asarray(xy[r]), jnp.asarray(inten[r]),
                   jnp.asarray(mask[r])), cfg))
        np.testing.assert_array_equal(got[r], want)
        assert (want != cfg.no_point).sum() > 100
