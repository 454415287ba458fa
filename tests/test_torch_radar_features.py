"""Port parity: radar filtering and CFEAR cells against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import FeatureConfig, RadarConfig
from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.ops import features as jfeat
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.ops import features as tfeat
from tbv_slam_public_torch.ops import radar as tradar

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

RCFG = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                   k_strongest=12, min_distance=1.0, max_distance=75.0)
FCFG = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")


def _tie_image(rng, a=64, r=300):
    """uint8 image drawn from a handful of levels: most top-k picks tie."""
    levels = np.asarray([0, 40, 60, 61, 120, 255], np.uint8)
    return levels[rng.integers(0, len(levels), (a, r))]


def _sim_images(n=3, seed=1):
    return simulate.make_sequence(
        num_frames=n, seed=seed, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7,
                                        laps=0.12)).images


def _assert_clouds(jc, tc):
    # selection (bins, their order, masks, intensities) must be identical;
    # coordinates are cos/sin of identical float32 angles, which the two
    # libraries round differently by up to an ulp (~8e-6 m at 75 m)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.intensity.numpy(),
                                  np.asarray(jc.intensity))
    np.testing.assert_allclose(tc.xy.numpy(), np.asarray(jc.xy), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kstrongest_exact_with_forced_ties(seed):
    img = _tie_image(np.random.default_rng(seed))
    cfg = RadarConfig(num_azimuths=64, num_range_bins=300, range_res=0.25,
                      k_strongest=10, min_distance=1.0, max_distance=70.0)
    jc, jp = jradar.kstrongest_filter(jnp.asarray(img), cfg)
    tc, tp = tradar.kstrongest_filter(torch.as_tensor(img), cfg)
    _assert_clouds(jc, tc)
    _assert_clouds(jp, tp)


def test_kstrongest_exact_on_simulated_images():
    for img in _sim_images():
        jc, jp = jradar.kstrongest_filter(jnp.asarray(img), RCFG)
        tc, tp = tradar.kstrongest_filter(torch.as_tensor(img), RCFG)
        _assert_clouds(jc, tc)
        _assert_clouds(jp, tp)


@pytest.mark.parametrize("window", [1, 3])
def test_axial_nms_mask_exact(window):
    img = _tie_image(np.random.default_rng(5), 32, 128)
    np.testing.assert_array_equal(
        tradar._axial_nms_peak_mask(torch.as_tensor(img), window).numpy(),
        np.asarray(jradar._axial_nms_peak_mask(jnp.asarray(img), window)))


@pytest.mark.parametrize("ccw", [False, True])
def test_motion_compensate(rng, ccw):
    xy = rng.uniform(-60, 60, (500, 2)).astype(np.float32)
    motion = np.asarray([0.8, -0.1, 0.05], np.float32)
    want = jradar.motion_compensate(
        JCloud(xy=jnp.asarray(xy), intensity=jnp.zeros(500),
               mask=jnp.ones(500, bool)), jnp.asarray(motion), ccw)
    got = tradar.motion_compensate(
        TCloud(xy=torch.as_tensor(xy), intensity=torch.zeros(500),
               mask=torch.ones(500, dtype=torch.bool)),
        torch.as_tensor(motion), ccw)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), atol=2e-5)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_compute_cells_match(frame):
    """Same input cloud into both: cells within 1e-5 and ``valid`` exact."""
    img = _sim_images()[frame]
    jc, _ = jradar.kstrongest_filter(jnp.asarray(img), RCFG)
    tc = TCloud(xy=torch.as_tensor(np.asarray(jc.xy)),
                intensity=torch.as_tensor(np.asarray(jc.intensity)),
                mask=torch.as_tensor(np.asarray(jc.mask)))
    want = jfeat.compute_cells(jc, FCFG, origin=(0.5, -0.2))
    got = tfeat.compute_cells(tc, FCFG, origin=(0.5, -0.2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.nsamples.numpy(),
                                  np.asarray(want.nsamples))
    assert int(got.valid.sum()) > 50
    for f in CELL_FIELDS[:-1]:
        # float32 sums taken in another order; planarity = log1p(cond / 2)
        # amplifies that through the eigenvalue ratio, hence rtol as well
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_eigh2x2_and_transform_cells(rng):
    a = rng.normal(size=(200, 2, 2)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1)
    cov[:5, 0, 1] = cov[:5, 1, 0] = 0.0  # axis-aligned (degenerate) branch
    for g, w in zip(tfeat.eigh2x2(torch.as_tensor(cov)),
                    jfeat.eigh2x2(jnp.asarray(cov))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    img = _sim_images(1)[0]
    jc, _ = jradar.kstrongest_filter(jnp.asarray(img), RCFG)
    jcells = jfeat.compute_cells(jc, FCFG)
    tcells = tfeat.compute_cells(
        TCloud(xy=torch.as_tensor(np.asarray(jc.xy)),
               intensity=torch.as_tensor(np.asarray(jc.intensity)),
               mask=torch.as_tensor(np.asarray(jc.mask))), FCFG)
    pose = np.asarray([3.0, -2.0, 0.4], np.float32)
    want = jfeat.transform_cells(jcells, jnp.asarray(pose))
    got = tfeat.transform_cells(tcells, torch.as_tensor(pose))
    for f in ("mean", "normal", "cov"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4)
