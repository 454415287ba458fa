"""Port parity: logistic fit and metrics, the 13-perturbation training
features, the alignment learner and the loop classifier against the JAX
package, on inputs made from a numpy seed."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig,
                                             VerificationConfig)
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import verification as jverif
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.ops import features as jfeatures
from tbv_slam_public_tpu.ops import logistic as jlog
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.core.types import stack_records
from tbv_slam_public_torch.io import convert
from tbv_slam_public_torch.models import verification as tverif
from tbv_slam_public_torch.ops import logistic as tlog

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
T = lambda a: torch.as_tensor(np.asarray(a))


def _two_blobs(rng, n0, n1, d, gap):
    x = np.concatenate([rng.normal(size=(n0, d)) - gap / 2,
                        rng.normal(size=(n1, d)) + gap / 2]).astype(np.float32)
    y = np.concatenate([np.zeros(n0), np.ones(n1)]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n0,n1,d,gap,balanced", [
    (200, 200, 2, 2.0, True),  # overlapping classes
    (300, 30, 1, 2.0, True),  # imbalanced, balanced weights
    (300, 30, 3, 2.0, False),  # imbalanced, unweighted
    (60, 60, 2, 12.0, True),  # separable: the step clip and the ridge decide
])
def test_logistic_fit_matches(rng, n0, n1, d, gap, balanced):
    x, y = _two_blobs(rng, n0, n1, d, gap)
    want = jlog.fit(jnp.asarray(x), jnp.asarray(y), balanced=balanced)
    got = tlog.fit(T(x), T(y), balanced=balanced)
    # 50 Newton steps of a float32 4x4 solve in two libraries: coefficients
    # to 1e-3 relative, probabilities to 1e-4
    np.testing.assert_allclose(
        np.r_[float(got.intercept), got.coef.numpy()],
        np.r_[float(want.intercept), np.asarray(want.coef)],
        rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        tlog.predict_proba(got, T(x)).numpy(),
        np.asarray(jlog.predict_proba(want, jnp.asarray(x))), atol=1e-4)
    assert float(tlog.accuracy(got, T(x), T(y))) == pytest.approx(
        float(jlog.accuracy(want, jnp.asarray(x), jnp.asarray(y))), abs=1e-6)


def test_logistic_metrics_match(rng):
    """accuracy / confusion / roc_curve of one model (the reference's own
    coefficients) on the same samples: counts exact."""
    x, y = _two_blobs(rng, 150, 90, 3, 1.5)
    mask = rng.uniform(size=len(y)) < 0.8
    jm = jlog.fit(jnp.asarray(x), jnp.asarray(y))
    tm = convert.logistic_from_numpy(jm.intercept, jm.coef)
    jx, jy, jmask = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    for m_j, m_t in ((None, None), (jmask, T(mask))):
        assert [int(v) for v in tlog.confusion(tm, T(x), T(y), m_t)] == \
            [int(v) for v in jlog.confusion(jm, jx, jy, m_j)]
        assert float(tlog.accuracy(tm, T(x), T(y), m_t)) == pytest.approx(
            float(jlog.accuracy(jm, jx, jy, m_j)), abs=1e-6)
        fpr_t, tpr_t = tlog.roc_curve(tm, T(x), T(y), m_t, thresholds=41)
        fpr_j, tpr_j = jlog.roc_curve(jm, jx, jy, m_j, thresholds=41)
        # a probability within float32 rounding of a threshold may cross it
        assert np.abs(fpr_t - fpr_j).max() <= 1.0 / 150 + 1e-9
        assert np.abs(tpr_t - tpr_j).max() <= 1.0 / 90 + 1e-9
    np.testing.assert_array_equal(tlog.predict(tm, T(x)).numpy(),
                                  np.asarray(jlog.predict(jm, jx)))


def test_loop_classifier_reproduces_published_coefficients(tmp_path):
    """The reference system's own loop training data (tbv_model_8) through the
    port's IRLS gives the published trained_loop_classifier coefficients, at
    the tolerance of tests/test_verification.py:210, and the JAX fit's to
    1e-4; the same through ``train_loop_model_from_file``."""
    data = np.load(os.path.join(FIXTURES, "tbv_model_8.npz"))["data"]
    x, y = data[:, 1:4].astype(np.float32), data[:, 0].astype(np.float32)
    m = tlog.fit(T(x), T(y), balanced=True)
    np.testing.assert_allclose(float(m.intercept), 4.53196, atol=2e-3)
    np.testing.assert_allclose(m.coef.numpy(), [-5.06267, -11.9655, 0.268186],
                               rtol=2e-3, atol=2e-3)
    want = jlog.fit(jnp.asarray(x), jnp.asarray(y), balanced=True)
    np.testing.assert_allclose(m.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-4, atol=1e-5)
    path = str(tmp_path / "tbv_model_8.txt")
    np.savetxt(path, data, delimiter=",")
    m2 = tverif.train_loop_model_from_file(path, device="cpu")
    np.testing.assert_allclose(m2.coef.numpy(), m.coef.numpy(), rtol=1e-4)


def test_small_helpers_match():
    cfg = VerificationConfig()
    np.testing.assert_array_equal(tverif.make_perturbations(cfg),
                                  jverif.make_perturbations(cfg))
    jm = jverif.default_loop_model(cfg)
    tm = tverif.default_loop_model(cfg)
    for args in ((0.0, 0.3, 5.0), (1.0, 1.5, -5.0), (0.2, 0.7, 1.0)):
        assert float(tverif.verification_probability(tm, *args)) == \
            pytest.approx(float(jverif.verification_probability(jm, *args)),
                          abs=1e-6)
    path = np.cumsum(np.random.default_rng(3).normal(size=(40, 2)), 0)
    for a, b in ((0, 39), (30, 5), (10, 11)):
        assert tverif.odometry_consistency(path, a, b, 0.05) == pytest.approx(
            jverif.odometry_consistency(path, a, b, 0.05), abs=1e-12)


RCFG = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                   k_strongest=12, min_distance=1.0, max_distance=70.0)
FCFG = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
VCFG = VerificationConfig(peaks_capacity=1024)


@pytest.fixture(scope="module")
def scans():
    """Five keyframes along a gentle arc: (peaks, cells, pose) as numpy
    records, from the reference's own filter and features."""
    world = simulate.make_world(np.random.default_rng(8), num_walls=50,
                                extent=50.0)
    out = []
    for i in range(5):
        pose = np.array([1.6 * i, 0.1 * i, 0.02 * i], np.float32)
        img = simulate.render_scan(world, pose, num_azimuths=200,
                                   num_range_bins=256, range_res=0.3,
                                   rng=np.random.default_rng(10 + i))
        cloud, peaks = jradar.kstrongest_filter(img, RCFG)
        cells = jfeatures.compute_cells(cloud, FCFG)
        peaks = jcoral.compact_cloud(peaks, VCFG.peaks_capacity)
        out.append((jax.tree.map(np.asarray, peaks),
                    jax.tree.map(np.asarray, cells), pose))
    return out


def _torch_scan(scan):
    peaks, cells, pose = scan
    fields = lambda rec: {k: getattr(rec, k) for k in rec.__dataclass_fields__}
    return (convert.cloud_from_numpy(fields(peaks)),
            convert.cells_from_numpy(fields(cells)), T(pose))


def _assert_features_close(x, ref, merged):
    """x6 of the port against the reference's.  CFEAR features to 1e-3.
    Overlap is a count over the merged cloud: a point on the 1 m CorAl radius
    may flip its validity, so it agrees to two points.  The entropies where
    they average at least 10 valid points: over fewer, one near-singular
    neighbourhood covariance moves the mean."""
    np.testing.assert_allclose(x[:, 3:], ref[:, 3:], rtol=1e-3, atol=1e-3)
    assert np.all(np.abs(x[:, 2] - ref[:, 2]) <= 2.0 / merged + 1e-6)
    ok = ref[:, 2] * merged >= 10
    assert ok.sum() >= 5
    np.testing.assert_allclose(x[ok, :2], ref[ok, :2], rtol=1e-3, atol=1e-3)


def test_perturbed_training_features_match(scans):
    """x, y of one keyframe pair under the 13 perturbations."""
    cur, prev = scans[3], scans[2]
    perts = jverif.make_perturbations(VCFG)
    jx, jy = jverif.perturbed_training_features(
        *jax.tree.map(jnp.asarray, cur), *jax.tree.map(jnp.asarray, prev),
        jnp.asarray(perts), VCFG)
    tx, ty = tverif.perturbed_training_features(
        *_torch_scan(cur), *_torch_scan(prev), T(perts), VCFG)
    assert tx.shape == (13, 6) and ty.shape == (13,)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert ty.sum() == 1 and ty[0] == 1
    merged = float(cur[0].mask.sum() + prev[0].mask.sum())
    _assert_features_close(tx.numpy(), np.asarray(jx), merged)


def test_batched_training_features_match(scans):
    """Two stacked pairs in one batch == the two pairs one by one (same
    arithmetic per row: 1e-6), rows ordered pair-major as the reference."""
    perts = T(jverif.make_perturbations(VCFG))
    pairs = [(scans[1], scans[0]), (scans[4], scans[3])]
    ts = [[_torch_scan(s) for s in pair] for pair in pairs]
    cur_p = stack_records([t[0][0] for t in ts])
    cur_c = stack_records([t[0][1] for t in ts])
    prev_p = stack_records([t[1][0] for t in ts])
    prev_c = stack_records([t[1][1] for t in ts])
    x, y = tverif.batched_training_features(
        cur_p, cur_c, torch.stack([t[0][2] for t in ts]), prev_p, prev_c,
        torch.stack([t[1][2] for t in ts]), perts, VCFG)
    assert x.shape == (26, 6) and y.shape == (26,)
    for b, t in enumerate(ts):
        x1, y1 = tverif.perturbed_training_features(*t[0], *t[1], perts, VCFG)
        np.testing.assert_allclose(x[13 * b:13 * b + 13].numpy(), x1.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(y[13 * b:13 * b + 13].numpy(),
                                      y1.numpy())


def test_alignment_learner_matches(scans, tmp_path):
    """The learner fed the same five keyframes in both packages: the same
    pairs are generated, the training features agree, and the fit on the
    reference's own samples (carried across by ``io.convert``) gives scores
    within 1e-2 of the reference's on those samples (a 6-feature IRLS on 52
    nearly separable samples: the coefficients themselves are loosely
    determined, the scores are not)."""
    jl = jverif.AlignmentLearner(VCFG)
    tl = tverif.AlignmentLearner(VCFG, device="cpu")
    for scan in scans:
        peaks, cells, pose = scan
        a = jl.add_training_pair(jax.tree.map(jnp.asarray, peaks),
                                 jax.tree.map(jnp.asarray, cells), pose)
        tp, tc, _ = _torch_scan(scan)
        assert tl.add_training_pair(tp, tc, pose) == a
    assert tl.num_samples == jl.num_samples == 52
    x, y = tl.training_data()
    jx, jy = np.concatenate(jl._x), np.concatenate(jl._y)
    np.testing.assert_array_equal(y, jy)
    merged = float(scans[0][0].mask.sum() + scans[1][0].mask.sum())
    _assert_features_close(x, jx, 0.9 * merged)

    jl.fit()
    convert.training_data_from_numpy(tl, jx, jy)
    tl.fit()
    want = np.asarray(jl.alignment_quality(jnp.asarray(jx)))
    got = tl.alignment_quality(T(jx)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert got[jy > 0.5].min() > got[jy < 0.5].mean()

    path = str(tmp_path / "alignment.txt")
    tl.save(path)
    t2 = tverif.AlignmentLearner(VCFG, device="cpu")
    t2.load(path)
    np.testing.assert_allclose(t2.alignment_quality(T(jx)).numpy(), got,
                               rtol=1e-4, atol=1e-3)
    j2 = jverif.AlignmentLearner(VCFG)
    j2.load(path)  # coefficient files cross between the packages
    np.testing.assert_allclose(
        np.asarray(j2.alignment_quality(jnp.asarray(jx))), got, rtol=1e-4,
        atol=1e-3)
