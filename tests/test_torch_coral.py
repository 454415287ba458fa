"""Port parity: CorAl moments (plain version and CUDA kernel), CorAl
quality and the alignment features, against the JAX package.

The JAX side's Pallas kernel runs in interpret mode, as tests/test_pallas.py
runs it on the CPU.  The CUDA kernel's own tests, which need a card, are in
the jax-free tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import VerificationConfig
from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.models import verification as jverif
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.pallas import coral_moments as jmoments
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.models import verification as tverif
from tbv_slam_public_torch.ops import coral as tcoral

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# float32 sums taken in another order (the same bound as test_pallas.py)
RTOL, ATOL = 1e-5, 1e-4
CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")


def _inputs(rng, m, q, p, frac=0.8, extent=30.0):
    return (rng.uniform(-extent, extent, (m, q, 2)).astype(np.float32),
            rng.uniform(size=(m, q)) < frac,
            rng.uniform(-extent, extent, (m, p, 2)).astype(np.float32),
            rng.uniform(size=(m, p)) < frac)


@pytest.mark.parametrize("q,p", [(50, 70), (128, 512), (200, 600)])
def test_plain_moments_match_pallas_interpret(rng, q, p):
    qs, qm, ps, pm = _inputs(rng, 2, q, p)
    got = tmoments.neighbor_moments(*map(torch.as_tensor, (qs, qm, ps, pm)),
                                    2.5)
    for i in range(2):
        want = jmoments.neighbor_moments(
            jnp.asarray(qs[i]), jnp.asarray(qm[i]), jnp.asarray(ps[i]),
            jnp.asarray(pm[i]), 2.5, interpret=True)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)


def test_plain_moments_empty_masks(rng):
    qs, _, ps, _ = _inputs(rng, 1, 64, 128, extent=5.0)
    z = lambda n: torch.zeros(1, n, dtype=torch.bool)
    n, s1, s2 = tmoments.neighbor_moments(torch.as_tensor(qs), z(64),
                                          torch.as_tensor(ps), z(128), 1.0)
    want = jmoments.neighbor_moments(
        jnp.asarray(qs[0]), jnp.zeros(64, bool), jnp.asarray(ps[0]),
        jnp.zeros(128, bool), 1.0, interpret=True)
    assert float(n.sum()) == float(jnp.sum(want[0])) == 0.0
    assert float(s1.abs().sum()) == 0.0 and float(s2.abs().sum()) == 0.0


def test_cpu_tensors_take_the_plain_version(rng):
    before = tmoments.LAUNCHES
    args = tuple(map(torch.as_tensor, _inputs(rng, 2, 40, 50)))
    got = tmoments.neighbor_moments(*args, 1.5)
    want = tmoments.neighbor_moments_reference(*args, 1.5)
    assert tmoments.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the plain version's chunking over pairs does not change the result
    chunked = tmoments.neighbor_moments_reference(*args, 1.5,
                                                  chunk_bytes=1)
    for g, w in zip(chunked, want):
        assert torch.equal(g, w)


def test_other_devices_raise():
    t = lambda *s: torch.zeros(s, device="meta")
    with pytest.raises(ValueError):
        tmoments.neighbor_moments(t(1, 4, 2), t(1, 4).bool(), t(1, 4, 2),
                                  t(1, 4).bool(), 1.0)


def _peak_pair(rng, n=600):
    """Two overlapping 'peak clouds' along wall-like structures."""
    t = rng.uniform(0, 40, n)
    base = np.stack([t - 20.0, 0.3 * t + rng.normal(0, 0.3, n)], 1)
    other = base + rng.normal(0, 0.15, base.shape) + [0.2, -0.1]
    inten = rng.uniform(60, 200, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return base.astype(np.float32), other.astype(np.float32), inten, mask


@pytest.mark.parametrize("mode", ["entropy", "kl"])
def test_coral_quality_matches(rng, mode):
    a, b, inten, mask = _peak_pair(rng)
    want = jcoral.coral_quality(
        JCloud(xy=jnp.asarray(a), intensity=jnp.asarray(inten),
               mask=jnp.asarray(mask)),
        JCloud(xy=jnp.asarray(b), intensity=jnp.asarray(inten),
               mask=jnp.ones(len(mask), bool)), radius=1.0, mode=mode)
    got = tcoral.coral_quality(
        TCloud(xy=torch.as_tensor(a)[None],
               intensity=torch.as_tensor(inten)[None],
               mask=torch.as_tensor(mask)[None]),
        TCloud(xy=torch.as_tensor(b)[None],
               intensity=torch.as_tensor(inten)[None],
               mask=torch.ones(1, len(mask), dtype=torch.bool)),
        radius=1.0, mode=mode)
    for f in ("joint", "sep", "overlap"):
        np.testing.assert_allclose(float(getattr(got, f)[0]),
                                   float(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert bool(got.valid[0]) == bool(want.valid)
    assert float(want.overlap) > 0.3


def test_alignment_features_match():
    """x6 of keyframe pairs from the simulator, at a perturbed pose."""
    from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig)
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import features as jfeat
    from tbv_slam_public_tpu.ops import radar as jradar

    seq = simulate.make_sequence(num_frames=4, seed=2, num_azimuths=200,
                                 num_range_bins=256, range_res=0.3)
    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    outs = [jradar.kstrongest_filter(jnp.asarray(im), rc)
            for im in seq.images]
    cells = [jfeat.compute_cells(c, fc) for c, _ in outs]
    peaks = [p for _, p in outs]
    vcfg = VerificationConfig()
    src_pose = np.asarray([0.9, 0.05, 0.01], np.float32)
    want = jverif.alignment_features(peaks[1], cells[1],
                                     jnp.asarray(src_pose), peaks[0],
                                     cells[0], jnp.zeros(3), vcfg)
    tc = lambda c: cells_from_numpy(
        {f: np.array(getattr(c, f)) for f in CELL_FIELDS}).map(
            lambda x: x[None])
    tp = lambda p: TCloud(xy=torch.as_tensor(np.array(p.xy))[None],
                          intensity=torch.as_tensor(
                              np.array(p.intensity))[None],
                          mask=torch.as_tensor(np.array(p.mask))[None])
    got = tverif.alignment_features(tp(peaks[1]), tc(cells[1]),
                                    torch.as_tensor(src_pose)[None],
                                    tp(peaks[0]), tc(cells[0]),
                                    torch.zeros(1, 3), vcfg)
    # the CorAl entropies take log(det) of small-neighbourhood covariances;
    # near-degenerate ones amplify float32 summation order, hence 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    assert float(want[4]) > 10  # CFEAR residuals present
