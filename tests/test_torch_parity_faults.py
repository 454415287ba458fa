"""Last-bit parity of the port with the JAX package where the reference's
compiled CPU program rounds or orders float32 work in its own way.

Each case holds one repair: the CorAl covariance determinants and the order
of the CorAl moment sums, the CFEAR cell arithmetic, the detector's points,
the row independence of the plain CorAl moments, the CA-CFAR window
sums above 2^24, the SoftLOne and Tukey losses at any loss limit, the
logistic fit (the gradient's sum, the solve, the whole fit), the
ScanContext rings and sectors, the two-value norms of the odometry gates
and the loop search, the subnormal Cauchy and combined weights, and the
subnormal flushing of the logistic solve and fit, the CorAl covariances,
the eigen gates, the registration residuals and PGO's weights and
information products (and the P2D whitening, which needs none).  Run as
a program, the file prints the shares of
bit-equal results on sensor-size scans (``--frames`` of them) for the
package on the path, so the same command measures a tree before and after
a change:

    PYTHONPATH=<tree> JAX_PLATFORMS=cpu python tests/test_torch_parity_faults.py
"""
import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import FeatureConfig as JFeatureConfig
from tbv_slam_public_tpu.core.config import RadarConfig as JRadarConfig
from tbv_slam_public_tpu.core.config import \
    ScanContextConfig as JScanContextConfig
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.models import strategies as jstrategies
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.ops import features as jfeatures
from tbv_slam_public_tpu.ops import logistic as jlogistic
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_tpu.ops import scancontext as jsc
from tbv_slam_public_torch.core.config import (FeatureConfig, RadarConfig,
                                               ScanContextConfig)
from tbv_slam_public_torch.core.refmath import recip
from tbv_slam_public_torch.core.types import PointCloud
from tbv_slam_public_torch.io import simulate
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.kernels import refmath as trefmath
from tbv_slam_public_torch.models import odometry as todometry
from tbv_slam_public_torch.models import strategies as tstrategies
from tbv_slam_public_torch.ops import coral as tcoral
from tbv_slam_public_torch.ops import features as tfeatures
from tbv_slam_public_torch.ops import logistic as tlogistic
from tbv_slam_public_torch.ops import radar as tradar
from tbv_slam_public_torch.ops import registration as treg
from tbv_slam_public_torch.ops import scancontext as tsc

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

CELL_FIELDS = ("cov", "normal", "planarity", "mean")
# (cells not bit-equal to the reference's, max abs gap) of the 955 valid
# cells of the two sensor-size scans of ``_sensor_scans``, measured (before
# the repair: 168, 240, 200 and 4 cells; planarity 95 before its log1p
# became the reference's).  What is left: the reference sums each voxel's
# points in a matrix product whose order moves some centroids by an ulp.
# The reference's own result moves with the host's core count (its matrix
# product is sharded over its threads): measured on 8 cores and on 1 (31,
# 29, 25, 4), the larger count held.
CELL_MISMATCH = {"cov": (35, 7.2e-7), "normal": (31, 2.1e-7),
                 "planarity": (27, 1.62e-4), "mean": (4, 2.4e-7)}


def _neighbourhoods(rng, collinear: bool, n: int):
    """(count [n], Σ(p−q) [n, 2], Σ(p−q)(p−q)ᵀ [n, 2, 2]) of n
    neighbourhoods of 3-5 points centred on their first point: on one ray
    from the sensor (k-strongest peaks of one azimuth), or in a 2 m square
    at up to 80 m."""
    ns, s1, s2 = [], [], []
    for _ in range(n):
        k = rng.integers(3, 6)
        if collinear:
            th, r = rng.uniform(0, 2 * np.pi), rng.uniform(5, 80, k)
            pts = np.stack([r * np.cos(th), r * np.sin(th)], -1)
        else:
            pts = rng.uniform(-1, 1, (k, 2)) + rng.uniform(-80, 80, 2)
        pts = pts.astype(np.float32)
        rel = pts - pts[0]
        ns.append(k)
        s1.append(rel.sum(0, dtype=np.float32))
        s2.append(np.einsum("pi,pj->ij", rel, rel).astype(np.float32))
    return (np.asarray(ns, np.float32), np.asarray(s1, np.float32),
            np.asarray(s2, np.float32))


@pytest.mark.parametrize("collinear", [True, False])
def test_coral_determinants_bit_equal_on_equal_moments(collinear):
    """On equal moments the port's covariance determinants and entropies
    are the reference's bit for bit, with the same sign and finiteness;
    collinear neighbourhoods, where the determinant is rounding noise,
    included (two roundings instead of the reference's fused multiply-adds
    made 0 % of them equal and 24 % of the other sign; the entropies were
    1e-6 apart before the log was the reference's)."""
    n, s1, s2 = _neighbourhoods(np.random.default_rng(0), collinear, 4000)
    want_ent, want_det = map(np.asarray, jax.jit(
        lambda *a: jcoral._entropy_from_moments(*a, 1e-8))(n, s1, s2))
    got_ent, got_det = (x.numpy() for x in tcoral._entropy_from_moments(
        torch.as_tensor(n), torch.as_tensor(s1), torch.as_tensor(s2), 1e-8))
    np.testing.assert_array_equal(got_det, want_det)
    np.testing.assert_array_equal(np.isfinite(got_ent), np.isfinite(want_ent))
    np.testing.assert_array_equal(got_ent, want_ent)
    # and the KL mode's determinants
    mean, cov = tcoral._mean_cov_from_moments(
        torch.as_tensor(n), torch.as_tensor(s1), torch.as_tensor(s2))
    jmean, jcov = jax.jit(jcoral._mean_cov_from_moments)(n, s1, s2)
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jcov))
    got_kl, got_fin = tcoral._kl_divergence_2d(mean, cov, mean, cov)
    want_kl, want_fin = jax.jit(jcoral._kl_divergence_2d)(jmean, jcov, jmean,
                                                          jcov)
    np.testing.assert_array_equal(got_fin.numpy(), np.asarray(want_fin))


def _ray_cloud(rng, n, live, shift=0.0, rays=400):
    """A cloud of ``n`` k-strongest-like peaks: returns on ``rays`` azimuth
    rays at 2-12 m, ``live`` of the slots masked in, moved by ``shift``
    metres along x."""
    az = rng.integers(0, rays, n) * (2 * np.pi / rays)
    r = rng.uniform(2, 12, n)
    xy = np.stack([r * np.cos(az) + shift, r * np.sin(az)], -1)
    return xy.astype(np.float32), rng.uniform(size=n) < live


@pytest.mark.parametrize("q,p,live,shift", [
    (700, 700, 1.0, None), (1024, 1024, 0.6, 0.3), (300, 4800, 0.1, 0.3),
    (4096, 4096, 0.8, None), (20, 30, 1.0, 0.2)])
def test_plain_moments_bit_equal_to_the_reference(q, p, live, shift):
    """The plain CorAl moments sum in the reference's order (one fused
    multiply-add a neighbour for Σ(p−q)(p−q)ᵀ, windows of 32 slots for
    Σ(p−q)): count, Σ(p−q) and Σ(p−q)(p−q)ᵀ bit-equal to the reference's
    on ray clouds of 30 to 4800 slots, a cloud against itself (``shift``
    None) or against another, one row at a time and in a batch (before, a
    batch's rows were summed over its widest live row)."""
    rng = np.random.default_rng(q + p)
    rays = 400 if p > 100 else 4
    ps, pm = _ray_cloud(rng, p, live, rays=rays)
    qs, qm = (ps, pm) if shift is None \
        else _ray_cloud(rng, q, live, shift, rays)
    want = jax.jit(jcoral._neighbor_moments)(qs, qm, ps, pm, np.float32(1.0))
    assert float(np.asarray(want[0]).sum()) >= qm.sum()  # neighbours
    # the row alone, and beside a row of 5 % of its live points
    sparse = pm & (rng.uniform(size=pm.shape) < 0.05)
    batch = [torch.as_tensor(np.stack(x)) for x in
             ((qs, qs), (qm, qm), (ps, ps), (pm, sparse))]
    for got in (tmoments.neighbor_moments_reference(
            *(torch.as_tensor(x)[None] for x in (qs, qm, ps, pm)), 1.0),
            tmoments.neighbor_moments_reference(*batch, 1.0)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_a_row_of_the_plain_moments_does_not_depend_on_its_neighbours():
    """Row m of an M-pair call is bit-equal to the same row called alone:
    rows of 40 to 700 live points, whose widest row set every row's
    reduction length before."""
    rng = np.random.default_rng(3)
    rows = [_ray_cloud(rng, 700, live) for live in (1.0, 0.06, 0.5)]
    xy = torch.as_tensor(np.stack([r[0] for r in rows]))
    mask = torch.as_tensor(np.stack([r[1] for r in rows]))
    got = tmoments.neighbor_moments_reference(xy, mask, xy, mask, 1.0)
    for m in range(len(rows)):
        one = (xy[m:m + 1], mask[m:m + 1])
        alone = tmoments.neighbor_moments_reference(*one, *one, 1.0)
        for g, a in zip(got, alone):
            assert torch.equal(g[m], a[0])


def _sensor_scans(frames: int):
    """Sensor-size simulated scans (400 x 3768, 0.0438 m) of the Oxford
    radar through the reference's k-strongest filter."""
    seq = simulate.make_sequence(frames, seed=5, num_range_bins=3768,
                                 range_res=0.0438)
    return seq.images, [jax.tree.map(np.asarray, jradar.kstrongest_filter(
        jnp.asarray(img), JRadarConfig())) for img in seq.images]


def cell_mismatch(frames: int):
    """{field: (cells not bit-equal, valid cells, max abs gap)} of the
    port's and the reference's ``compute_cells`` on the same clouds."""
    _, outs = _sensor_scans(frames)
    stats = {f: [0, 0, 0.0] for f in CELL_FIELDS}
    for cloud, _ in outs:
        want = jax.tree.map(np.asarray, jfeatures.compute_cells(
            jax.tree.map(jnp.asarray, cloud), JFeatureConfig()))
        got = tfeatures.compute_cells(PointCloud(
            *(torch.as_tensor(getattr(cloud, f))
              for f in ("xy", "intensity", "mask"))), FeatureConfig())
        np.testing.assert_array_equal(got.valid.numpy(), want.valid)
        v = want.valid
        for f in CELL_FIELDS:
            a = getattr(got, f).numpy()[v].reshape(v.sum(), -1)
            b = getattr(want, f)[v].reshape(v.sum(), -1)
            s = stats[f]
            s[0] += int((a != b).any(1).sum())
            s[1] += int(v.sum())
            s[2] = max(s[2], float(np.abs(a - b).max()))
    return stats


def test_cfear_cells_round_as_the_reference():
    """The cells of two sensor-size scans: the valid masks equal, and the
    cells not bit-equal and the largest gap at most the measured ones (a
    fifth to a half of the port's before the repair)."""
    for f, (bad, n, gap) in cell_mismatch(2).items():
        assert n == 955
        assert bad <= CELL_MISMATCH[f][0], (f, bad)
        assert gap <= CELL_MISMATCH[f][1], (f, gap)


def test_detector_points_bit_equal_at_the_sensor_size():
    """k-strongest on a sensor-size scan: the port's points, intensities and
    masks are the reference's bit for bit (sin and cos as the C library's
    cosf and sinf, scaled by the range resolution first, as its compiled
    program computes them)."""
    images, outs = _sensor_scans(1)
    got = tradar.kstrongest_filter(torch.as_tensor(images[0]), RadarConfig())
    for g, w in zip(got, outs[0]):
        for f in ("xy", "intensity", "mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          getattr(w, f))


@pytest.mark.parametrize("bins", [100, 256, 3360, 3768])
@pytest.mark.parametrize("kw", [
    dict(filter_type="cacfar", cfar_false_alarm_rate=0.01),
    dict(filter_type="cacfar", cfar_false_alarm_rate=0.3,
         cfar_guard_cells=2, cfar_window_size=6),
    dict(filter_type="bfar"),
    dict(filter_type="bfar", bfar_scale=1.0, bfar_offset=5.0)],
    ids=["cacfar", "cacfar_g2w6", "bfar", "bfar_affine"])
def test_cfar_above_two_to_the_24(bins, kw):
    """CA-CFAR and BFAR on rows whose sum of squares passes 2^24 (intensity
    >= 67 over 3768 bins): the detections, points and intensities equal the
    reference's, whose float32 cumsum is inexact there (the port adds in its
    order; an exact sum missed one detection in 16 rows at rate 0.01)."""
    rng = np.random.default_rng(bins)
    img = np.concatenate([
        rng.integers(67, 256, (8, bins)),
        np.clip(rng.normal(150, 60, (8, bins)), 0, 255)]).astype(np.uint8)
    if bins == 3768:
        assert (img.astype(np.int64) ** 2).sum(1).min() > 2 ** 24
    want = jradar.filter_scan(jnp.asarray(img), JRadarConfig(
        num_azimuths=16, num_range_bins=bins, **kw))[0]
    got = tradar.filter_scan(torch.as_tensor(img), RadarConfig(
        num_azimuths=16, num_range_bins=bins, **kw))[0]
    assert int(got.mask.sum()) > 0
    for f in ("xy", "intensity", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def _squared_residuals(rng):
    """196,608 squared residuals over [1e-8, 1e4], log-uniform, and the
    special values (zeros, subnormals, the range ends, infinities, NaN)."""
    from tbv_slam_public_torch.kernels.checks import REFMATH_SPECIAL

    s = np.exp(rng.uniform(np.log(1e-8), np.log(1e4), 3 << 16))
    return np.concatenate([s.astype(np.float32), REFMATH_SPECIAL])


@pytest.mark.parametrize("loss", ["softlone", "tukey"])
@pytest.mark.parametrize("delta", [0.1, 0.3, 1.0, 2.0])
def test_softlone_and_tukey_round_as_the_reference(loss, delta):
    """rho and the IRLS weight of ``_rho_and_weight`` bit-equal to the
    reference's at every tested loss limit.  Its program divides by the
    constant b = delta^2 as a product by the float32 reciprocal, fuses that
    product into 1 + s / b (SoftLOne) and 1 - s / b (Tukey), computes u^3 as
    u (u u) with 1 - u^3 one fused multiply-add, and folds 2 b and b / 3
    into constants (optimized HLO and object code of the losses compiled
    alone).  Before: 22,198 (SoftLOne) and 15,268 (Tukey) of these values
    differed at 0.1."""
    s = _squared_residuals(np.random.default_rng(3))
    code = jreg.loss_code(loss)
    want = jax.jit(lambda v: jreg._rho_and_weight(v, code, delta))(s)
    got = treg._rho_and_weight(torch.as_tensor(s), code, delta)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        same = (g.view(np.int32) == w.view(np.int32)) | \
            (np.isnan(g) & np.isnan(w))
        assert same.all(), (int((~same).sum()), s[~same][:5])


@pytest.mark.parametrize("n", [13, 26, 39, 52, 104, 1287])
def test_logistic_gradient_rounds_as_the_reference(n):
    """The IRLS gradient xb^T (sw (p - y)) of ``logistic.fit`` bit-equal to
    the reference's at the paths' row counts: 13 perturbations a scan pair,
    so the training step at 1-4 and 8 pairs (52: the four-street and
    one-street pairs) and the online learner's refit after 99 pairs (1287,
    ``chip_smoke.py`` phase 7).  The reference sums in a loop that LLVM
    vectorises (``copy_dot_fusion``; the same object code compiled alone
    as inside ``fit``), whose order ``core/refmath.py::loop_dot_shape``
    writes out as a function of n.  Before: a library matrix product."""
    rng = np.random.default_rng(n)
    x = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 6)) * np.exp(
        rng.uniform(-3, 3, (1, 6)))], 1).astype(np.float32)
    r = (rng.uniform(0.5, 2.0, n) * (rng.uniform(size=n) - (
        rng.uniform(size=n) < 0.5))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a.T @ b)(x, r))
    got = tlogistic.gradient(torch.as_tensor(x.T.copy()),
                             torch.as_tensor(r)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k", [7, 4])
def test_logistic_solve_rounds_as_the_reference(k):
    """The Newton step's solve of ``logistic.fit`` bit-equal to the
    reference's ``jnp.linalg.solve`` on 600 of the fit's systems (k = 7:
    the alignment model; 4: the loop model) and on general matrices that
    pivot: both are LAPACK's sgetrf and BLAS's strsm, SciPy's (jaxlib calls
    those), with the reference's permutation of the right-hand side.
    Before: ``torch.linalg.solve``."""
    rng = np.random.default_rng(k)
    solve = jax.jit(jnp.linalg.solve)
    for t in range(600):
        xb = (rng.normal(size=(52, k)) * np.exp(rng.uniform(-3, 3, (1, k)))
              ).astype(np.float32)
        r = np.exp(rng.uniform(-8, 0, 52)).astype(np.float32)
        h = ((xb * r[:, None]).T @ xb + np.diag(np.r_[0.0, np.ones(k - 1)])
             + 1e-8 * np.eye(k)).astype(np.float32)
        if t % 3 == 0:
            h = rng.normal(size=(k, k)).astype(np.float32)
        g = (10.0 * rng.normal(size=k)).astype(np.float32)
        got = tlogistic.solve(torch.as_tensor(h), torch.as_tensor(g)).numpy()
        want = np.asarray(solve(h, g))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [13, 52, 104, 260])
def test_logistic_fit_bit_equal_to_the_reference(n):
    """With the gradient's sum and the solve the reference's, the whole
    IRLS fit (50 clipped Newton steps, balanced weights) is bit-equal to
    the JAX package's on the same x and y, five draws a row count, one of
    them with a near-constant column beside the intercept (the one-street
    pairs' case, where both fits cycle)."""
    rng = np.random.default_rng(n)
    for t in range(5):
        x = (rng.normal(size=(n, 6)) * np.exp(rng.uniform(-2, 2, (1, 6)))
             ).astype(np.float32)
        if t == 4:
            x[:, 5] = 470.0 + rng.normal(size=n).astype(np.float32)
        y = (rng.uniform(size=n) < 0.15).astype(np.float32)
        y[0] = 1.0
        want = jlogistic.fit(jnp.asarray(x), jnp.asarray(y), balanced=True)
        got = tlogistic.fit(torch.as_tensor(x), torch.as_tensor(y),
                            balanced=True)
        np.testing.assert_array_equal(
            np.r_[got.intercept.numpy(), got.coef.numpy()].view(np.int32),
            np.r_[np.asarray(want.intercept), np.asarray(want.coef)]
            .view(np.int32))



def _same_bits(got, want):
    """Positions where two float32 arrays differ in their bits (NaNs
    alike)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return ~((got.view(np.int32) == want.view(np.int32))
             | (np.isnan(got) & np.isnan(want)))


def _boundary_cloud(rng, n, cfg):
    """n points within 1e-7 (relative) of a ring's outer radius and, half
    of them, of a sector's edge, with small integer intensities (every bin
    sum exact, so a descriptor differs only where a point changes bins)."""
    ring = rng.integers(1, cfg.num_ring + 1, n)
    r = ring * cfg.max_radius / cfg.num_ring * (1 + rng.normal(size=n) * 1e-7)
    edge = rng.integers(0, cfg.num_sector, n) * 2 * np.pi / cfg.num_sector
    th = np.where(rng.uniform(size=n) < 0.5,
                  edge * (1 + rng.normal(size=n) * 1e-7),
                  rng.uniform(0, 2 * np.pi, n))
    xy = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    return (xy, rng.integers(1, 4, n).astype(np.float32), np.ones(n, bool))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scancontext_rings_and_sectors_round_as_the_reference(seed):
    """The descriptor of points on ring and sector edges bit-equal to the
    reference's: its radius is sqrt(fma(y, y, x*x)) with the IEEE root, its
    ring a true division by max_radius (a runtime operand of its jitted
    function) times the ring count, its sector the angle times one folded
    float32 constant (optimized HLO and object code of
    ``_descriptor_impl``).  Before: 1,606 of 81,920 such points changed ring
    between torch's rounding and the reference's."""
    rng = np.random.default_rng(seed)
    cfg, jcfg = ScanContextConfig(), JScanContextConfig()
    for _ in range(4):
        xy, inten, mask = _boundary_cloud(rng, 4096, cfg)
        want = jsc.make_descriptor(JPointCloud(
            jnp.asarray(xy), jnp.asarray(inten), jnp.asarray(mask)), jcfg)
        got = tsc.make_descriptor(PointCloud(
            torch.as_tensor(xy), torch.as_tensor(inten),
            torch.as_tensor(mask)), cfg)
        assert not _same_bits(got.numpy(), want).any()


def ring_flips(frames: int):
    """(points whose ScanContext ring differs between torch's former
    rounding, sqrt((xy * xy).sum(-1)) / max_radius * num_ring, and the
    reference's, valid points) over sensor-size k-strongest clouds."""
    cfg = ScanContextConfig()
    flips = total = 0
    for cloud, _ in _sensor_scans(frames)[1]:
        xy = torch.as_tensor(cloud.xy[cloud.mask])
        old = torch.ceil(torch.sqrt((xy * xy).sum(-1)) / cfg.max_radius
                         * cfg.num_ring)
        new = torch.ceil(trefmath.norm2(xy)
                         / torch.tensor(cfg.max_radius) * cfg.num_ring)
        clip = lambda v: torch.clamp(v, 1, cfg.num_ring)
        flips += int((clip(old) != clip(new)).sum())
        total += len(xy)
    return flips, total


def _vectors(rng, n):
    return (rng.normal(size=(n, 3)) * np.exp(rng.uniform(-4, 3, (n, 1)))
            ).astype(np.float32)


@pytest.mark.parametrize("site", ["speed", "acceleration", "keyframe",
                                  "segments", "distance", "verify"])
def test_norm_sites_round_as_the_reference(site):
    """The two-value norms of the odometry gates and of the loop search
    bit-equal to the reference's: sqrt(fma(y, y, x*x)) with the IEEE root
    where its program fuses the reduction (the gates of ``odometry_step``,
    ``detect``'s distance to the current pose, ``verify_by_odometry``), the
    divisions of the gates by the constants dt and dt^2 products by their
    reciprocals, the segment lengths of ``detect`` unfused in its 8-wide
    vector loop and fused in the scalar remainder, and
    ``verify_by_odometry``'s division by 2 sigma^2 (sigma an operand there)
    a true one (optimized HLO and object code of each)."""
    rng = np.random.default_rng(11)
    if site in ("speed", "acceleration", "keyframe"):
        dt = 0.3  # 1 / dt and 1 / dt^2 not exact
        cur, prev = _vectors(rng, 400), _vectors(rng, 400)
        ref = {"speed": lambda a, b: jnp.linalg.norm(a[:2]) / dt,
               "acceleration": lambda a, b: jnp.linalg.norm(a[:2] - b[:2])
               / (dt * dt),
               "keyframe": lambda a, b: jnp.linalg.norm(a[:2])}[site]
        f = jax.jit(ref)
        want = np.array([np.asarray(f(a, b)) for a, b in zip(cur, prev)])
        vel, acc = todometry.motion_rates(torch.as_tensor(cur),
                                          torch.as_tensor(prev), dt)
        got = {"speed": vel, "acceleration": acc,
               "keyframe": trefmath.norm2(torch.as_tensor(cur[:, :2]))}[site]
    elif site == "segments":
        f = jax.jit(lambda p: jnp.linalg.norm(p[1:, :2] - p[:-1, :2],
                                              axis=-1))
        want, got = [], []
        for n in (128, 1024, 4608):
            pose = np.cumsum(_vectors(rng, n), 0).astype(np.float32)
            want.append(np.asarray(f(pose)))
            got.append(tsc._segment_lengths(torch.as_tensor(
                pose[1:, :2] - pose[:-1, :2])).numpy())
        want, got = np.concatenate(want), np.concatenate(got)
    elif site == "distance":
        pos = np.cumsum(_vectors(rng, 1024)[:, :2], 0).astype(np.float32)
        f = jax.jit(lambda p, c: jnp.linalg.norm(p[c][None, :] - p, axis=-1))
        want = np.concatenate([np.asarray(f(pos, c)) for c in (7, 500)])
        p = torch.as_tensor(pos)
        got = torch.cat([trefmath.norm2(p[c][None, :] - p) for c in (7, 500)])
    else:
        poses = np.cumsum(_vectors(rng, 512), 0).astype(np.float32)
        trav = np.cumsum(rng.uniform(0, 3, 512)).astype(np.float32)
        ids = rng.integers(0, 512, (2, 256))
        want = jstrategies.verify_by_odometry(
            jnp.asarray(poses), jnp.asarray(trav), jnp.asarray(ids[0]),
            jnp.asarray(ids[1]), 3.0)
        got = tstrategies.verify_by_odometry(
            torch.as_tensor(poses), torch.as_tensor(trav),
            torch.as_tensor(ids[0]), torch.as_tensor(ids[1]), 3.0)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert not _same_bits(got, want).any()


@pytest.mark.parametrize("capacity", [128, 256, 512, 1000, 1152, 4608])
def test_detect_travel_sums_as_the_reference(capacity):
    """``detect``'s travelled distance: ``odometry_similarity`` bit-equal
    and ``num_exclude_recent`` equal to the reference's on a random
    trajectory, the exclusion distance set to one of the reference's own
    travelled distances so that an ulp moves the count.  The reference's
    ``jnp.cumsum`` is XLA's blocked reduce-window (rows of 16, the rows'
    totals scanned recursively), not torch's order."""
    rng = np.random.default_rng(capacity)
    pos = np.cumsum(rng.normal(size=(capacity, 2)) * rng.uniform(
        0.1, 3.0, (capacity, 1)), 0).astype(np.float32)
    mask = np.arange(capacity) < rng.integers(capacity // 2, capacity + 1)
    want = np.asarray(jax.jit(jsc.odometry_similarity, static_argnums=2)(
        pos, mask, 3.0))
    got = tsc.odometry_similarity(torch.as_tensor(pos), torch.as_tensor(mask),
                                  3.0).numpy()
    assert not _same_bits(got, want).any()
    cur = int(mask.sum()) - 1
    seg = np.asarray(jax.jit(lambda p: jnp.cumsum(jnp.concatenate([
        jnp.zeros(1), jnp.linalg.norm(p[1:] - p[:-1], axis=-1)])))(pos))
    for i in (cur // 3, cur // 2, cur - 5):
        dist = float(seg[cur] - seg[i])
        want = int(jax.jit(jsc.num_exclude_recent, static_argnums=2)(
            pos, mask, dist))
        got = int(tsc.num_exclude_recent(torch.as_tensor(pos),
                                         torch.as_tensor(mask), dist))
        assert got == want, (i, got, want)


@pytest.mark.parametrize("loss", ["cauchy", "combined"])
@pytest.mark.parametrize("delta", [0.1, 1.0])
def test_subnormal_weights_flush_as_the_reference(loss, delta):
    """The Cauchy and combined IRLS weights at squared residuals near the
    float32 maximum: subnormal in torch's arithmetic, zero in the
    reference's, whose threads flush subnormal results (FTZ).  Before: 1 of
    the 196,608 values of ``_squared_residuals`` and 6-7 of the large ones
    differed."""
    rng = np.random.default_rng(5)
    s = np.concatenate([_squared_residuals(rng), np.exp(rng.uniform(
        np.log(1e37), np.log(3.4e38), 4096)).astype(np.float32)])
    code = jreg.loss_code(loss)
    want = jax.jit(lambda v: jreg._rho_and_weight(v, code, delta))(s)
    got = treg._rho_and_weight(torch.as_tensor(s), code, delta)
    for g, w in zip(got, want):
        assert not _same_bits(g.numpy(), w).any()


# ---- subnormal flushing (the reference's threads run with DAZ and FTZ) --
#
# Each site's inputs are driven into the subnormal range; where the site is
# held bit for bit elsewhere it is held bit for bit here, elsewhere what a
# flush changes is compared: zero against non-zero, a subnormal in the
# port's output, a gate that flips.

_MIN_NORMAL = np.float32(1.1754943508222875e-38)


def _subnormals(x) -> int:
    x = np.asarray(x, np.float32)
    return int(((np.abs(x) < _MIN_NORMAL) & (x != 0)).sum())


def _zero_pattern_differs(got, want) -> int:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return int(((got == 0) != (want == 0)).sum())


def _spd(rng, n, lo, hi):
    """n float32 SPD 2 x 2 matrices scaled by e^U(log lo, log hi)."""
    a = rng.normal(size=(n, 2, 2))
    c = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(2)
    return (c * np.exp(rng.uniform(np.log(lo), np.log(hi), n))[:, None, None]
            ).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
def test_lu_solve_flushes_subnormals_as_the_reference(k):
    """The logistic fit's solve on systems whose entries, right-hand sides,
    pivots and solutions reach the subnormal range (``checks.
    lu_subnormal_systems``), bit-equal to the reference's
    ``jnp.linalg.solve``: its LAPACK runs on the reference's thread, which
    treats a subnormal operand as zero (a subnormal pivot too) and flushes
    every subnormal result.  Before: 442 of 2,800 such systems differed
    (subnormal solutions where the reference has zeros)."""
    from tbv_slam_public_torch.kernels.checks import lu_subnormal_systems

    h, g = lu_subnormal_systems(np.random.default_rng(200 + k), 100, k)
    solve = jax.jit(jnp.linalg.solve)
    want = np.stack([np.asarray(solve(h[i], g[i])) for i in range(len(h))])
    got = tlogistic.solve(torch.as_tensor(h), torch.as_tensor(g)).numpy()
    assert not _same_bits(got, want).any()
    assert _subnormals(got) == 0


def test_logistic_fit_flushes_subnormals_as_the_reference():
    """The whole IRLS fit with features whose products with the IRLS
    weights are subnormal (a column at 1e-36) or saturate the sigmoid,
    bit-equal to the JAX package's: the ordered products (``dot``,
    ``loop_dot``) and the solve flush their subnormal operands and results
    as the reference's threads do.  Before: both fits with the 1e-36
    column differed in a coefficient (the other two are guards)."""
    for n, t in ((13, 0), (13, 1), (13, 2), (52, 2)):
        rng = np.random.default_rng((2, n, t))
        x = (rng.normal(size=(n, 6)) * np.exp(rng.uniform(-2, 2, (1, 6)))
             ).astype(np.float32)
        if t == 0:
            x[:, 0] *= np.float32(60.0)  # saturated sigmoids
        elif t == 1:
            x[:, 1:3] = (x[:, 1:3] * 1e-19).astype(np.float32)
        else:
            x[:, 2] = (rng.normal(size=n) * 1e-36).astype(np.float32)
        y = (rng.uniform(size=n) < 0.3).astype(np.float32)
        y[0] = 1.0
        want = jlogistic.fit(jnp.asarray(x), jnp.asarray(y), balanced=True)
        got = tlogistic.fit(torch.as_tensor(x), torch.as_tensor(y),
                            balanced=True)
        assert not _same_bits(
            np.r_[got.intercept.numpy(), got.coef.numpy()],
            np.r_[np.asarray(want.intercept), np.asarray(want.coef)]
        ).any(), (n, t)


def test_coral_covariances_flush_subnormals_as_the_reference():
    """CorAl's moments-to-covariance step on neighbourhoods of 3-5 points
    spread over 1e-22 to 1e-17 m (second moments and covariances in the
    subnormal range): the mean, the covariance, its determinant (the
    product c01 c10, an operation of its own, flushed before the fused
    subtraction) and the entropy bit-equal to the reference's; the KL
    branch on such covariances keeps the reference's finite flags and
    zeros (its inverse determinant and inverse entries flushed; its sums
    are einsums, not held bit for bit).  Before: 10,194 of 16,000
    covariance entries subnormal where the reference has zeros, 195 of
    4,000 determinants and 11 of 4,000 KL flags differed."""
    rng = np.random.default_rng(0)
    m = 4000
    n = rng.integers(3, 6, m).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(1e-22), np.log(1e-17), m))
    pts = rng.normal(size=(m, 5, 2)) * scale[:, None, None]
    live = (np.arange(5)[None] < n[:, None])[..., None]
    d = (pts - pts[:, :1]) * live
    s1 = d.sum(1).astype(np.float32)
    s2 = np.einsum("nki,nkj->nij", d, d).astype(np.float32)
    want_m, want_c = jax.jit(jcoral._mean_cov_from_moments)(n, s1, s2)
    want_e = jax.jit(lambda *a: jcoral._entropy_from_moments(*a, 1e-8))(
        n, s1, s2)
    t = [torch.as_tensor(a) for a in (n, s1, s2)]
    got_m, got_c = tcoral._mean_cov_from_moments(*t)
    got_e = tcoral._entropy_from_moments(*t, 1e-8)
    for g, w in ((got_m, want_m), (got_c, want_c), (got_e[0], want_e[0]),
                 (got_e[1], want_e[1])):
        assert not _same_bits(g.numpy(), w).any()
    assert _subnormals(got_c.numpy()) == 0
    # the KL branch: a tiny covariance beside a moderate one, both ways
    ftz = trefmath.ftz
    s_tiny = ftz(torch.as_tensor(_spd(rng, m, 1e-40, 1e-15)))
    s_mid = ftz(torch.as_tensor(_spd(rng, m, 1e-25, 1e2)))
    u0 = ftz(torch.as_tensor((rng.normal(size=(m, 2)) * 1e-20)
                             .astype(np.float32)))
    u1 = ftz(torch.as_tensor((rng.normal(size=(m, 2)) * np.exp(
        rng.uniform(-50, 0, (m, 1)))).astype(np.float32)))
    for s0, s1k in ((s_tiny, s_mid), (s_mid, s_tiny)):
        want_s, want_f = jax.jit(jcoral._kl_divergence_2d)(
            *(a.numpy() for a in (u0, s0, u1, s1k)))
        got_s, got_f = tcoral._kl_divergence_2d(u0, s0, u1, s1k)
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert _zero_pattern_differs(got_s.numpy(), want_s) == 0
        assert _subnormals(got_s.numpy()) == 0


def test_eigen_gates_flush_subnormals_as_the_reference():
    """The CFEAR eigen gates (``eigh2x2``) on covariances of 1e-44 to 1e-15
    (a third with a subnormal off-diagonal): no subnormal eigenvalue or
    normal, and the reference's zeros, where before 794 eigenvalues were
    subnormal and 1,106 normal entries were zero in one package only.  The
    values are not held: near the subnormal range the products' last bits
    are most of their value, and the function compiled alone fuses
    otherwise than inside ``compute_cells``, whose form the port follows.
    Then ``compute_cells`` on clouds with a cluster spread over 1e-21 to
    1e-16 m at the origin: the same valid cells, with no subnormal field.
    ``csrc/cells.cu`` runs the same flushes."""
    rng = np.random.default_rng(1)
    cov = _spd(rng, 4000, 1e-44, 1e-15)
    off = (rng.normal(size=cov[::3, 0, 1].shape) * 1e-40).astype(np.float32)
    cov[::3, 0, 1] = cov[::3, 1, 0] = off
    want = jax.jit(jfeatures.eigh2x2)(cov)
    got = tfeatures.eigh2x2(torch.as_tensor(cov))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert _subnormals(g) == 0
        assert _zero_pattern_differs(g, w) == 0
    for seed in range(3):
        r = np.random.default_rng(10 + seed)
        tiny = r.normal(size=(300, 2)) * np.exp(r.uniform(np.log(1e-21),
                                                          np.log(1e-16)))
        xy = np.concatenate([tiny, r.uniform(-40, 40, (300, 2))]
                            ).astype(np.float32)
        inten = r.integers(61, 200, 600).astype(np.float32)
        mask = r.uniform(size=600) > 0.05
        want = jfeatures.compute_cells(
            JPointCloud(xy=jnp.asarray(xy), intensity=jnp.asarray(inten),
                        mask=jnp.asarray(mask)), JFeatureConfig())
        got = tfeatures.compute_cells(
            PointCloud(xy=torch.as_tensor(xy), intensity=torch.as_tensor(
                inten), mask=torch.as_tensor(mask)), FeatureConfig())
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        for f in ("mean", "cov", "normal", "planarity"):
            assert _subnormals(getattr(got, f).numpy()) == 0, f


@pytest.mark.parametrize("cost", [jreg.COST_P2L, jreg.COST_P2D,
                                  jreg.COST_P2P])
def test_residual_terms_flush_subnormals_as_the_reference(cost):
    """The registration's residuals, Jacobians and squared norms with cell
    means, targets and P2D whitening at 1e-20 to 1e-17 (their products
    subnormal), against the reference's ``_residual_terms``: J and the
    squared norms bit for bit, the residuals too (P2D's agree in their
    zeros and to 1e-6: the function compiled alone rounds its whitening
    product otherwise than the odometry step the port follows).  Before:
    up to 4,000 of 4,000 squared norms subnormal where the reference has
    zeros.  The registration kernel runs the same flushes (``csrc/
    lm_solve.cu::leaf``)."""
    from tbv_slam_public_tpu.core.types import Cells as JCells
    from tbv_slam_public_torch.core.types import Cells

    rng = np.random.default_rng(cost)
    c = 4000
    for sc in (1e-20, 1e-18):
        mean = (rng.normal(size=(1, c, 2)) * sc).astype(np.float32)
        tm = (rng.normal(size=(1, 1, c, 2)) * sc).astype(np.float32)
        tn = rng.normal(size=(1, 1, c, 2))
        tn = (tn / np.linalg.norm(tn, axis=-1, keepdims=True) * np.exp(
            rng.uniform(np.log(1e-25), 0, (1, 1, c, 1)))).astype(np.float32)
        si = np.zeros((1, 1, c, 2, 2), np.float32)
        si[..., 0, 0] = rng.uniform(1e-19, 1e-17, (1, 1, c))
        si[..., 1, 1] = rng.uniform(1e-19, 1.0, (1, 1, c))
        si[..., 0, 1] = rng.uniform(-1e-19, 1e-19, (1, 1, c))
        theta = np.array([[sc, -sc, 1e-3]], np.float32)
        w = np.ones((1, 1, c), np.float32)
        mask = np.ones((1, 1, c), bool)
        want = jax.jit(lambda th, m, a: jreg._residual_terms(
            th, JCells(m, None, None, None, None, None, None), a, cost))(
            theta[0], mean[0], jreg.Associations(tm[0], tn[0], si[0], w[0],
                                                 mask[0]))
        got = treg._residual_terms(
            torch.as_tensor(theta),
            Cells(torch.as_tensor(mean), None, None, None, None, None, None),
            treg.Associations(torch.as_tensor(tm), torch.as_tensor(tn),
                              torch.as_tensor(w), torch.as_tensor(mask),
                              torch.as_tensor(si)
                              if cost == jreg.COST_P2D else None), cost)
        for i, (g, wv) in enumerate(zip(got, want)):
            g = g[0].numpy()
            wv = np.asarray(wv).reshape(g.shape)
            assert _subnormals(g) == 0
            if cost == jreg.COST_P2D and i == 0:
                assert _zero_pattern_differs(g, wv) == 0
                np.testing.assert_allclose(g, wv, rtol=1e-6, atol=0)
            else:
                assert not _same_bits(g, wv).any(), (sc, i)


def test_chol2x2_whitening_needs_no_flush():
    """Audited with no fault: the P2D whitening ``_chol2x2_inv_sqrt`` on
    SPD matrices from 1e-25 to 1e-15 and from 1e15 to 1e25 is bit-equal to
    the reference's (its clamps at 1e-20 keep every operand normal)."""
    rng = np.random.default_rng(6)
    for lo, hi in ((1e-25, 1e-15), (1e15, 1e25)):
        m = _spd(rng, 4000, lo, hi)
        want = jax.jit(jreg._chol2x2_inv_sqrt)(m)
        got = treg._chol2x2_inv_sqrt(torch.as_tensor(m))
        assert not _same_bits(got.numpy(), want).any()


def test_pgo_weights_and_information_products_flush_as_the_reference():
    """PGO with whitening entries from 1e-40 to 1e-15 (information
    products subnormal) and loop residuals up to 1e19 (Cauchy weights
    subnormal): the whitened residuals, Jacobian blocks, weights, gradient
    and dense Hessian have the reference's zeros and no subnormal entry,
    and agree with it to 1e-4 (its einsums and sums are not held bit for
    bit).  Before: 138 of 1,200 residuals, 332 and 245 of 3,600 Jacobian
    entries, 212 of 4,000 weights and 1,150 of 22,500 Hessian entries were
    subnormal where the reference has zeros."""
    from tbv_slam_public_tpu.core.config import PGOConfig as JPGOConfig
    from tbv_slam_public_tpu.ops import posegraph as jpgo
    from tbv_slam_public_torch.core.config import PGOConfig
    from tbv_slam_public_torch.ops import posegraph as tpgo

    rng = np.random.default_rng(3)
    n, e = 50, 400
    poses = np.cumsum(rng.normal(size=(n, 3)) * [1, 1, 0.1], 0).astype(
        np.float32)
    idx = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    meas = rng.normal(size=(e, 3)).astype(np.float32)
    si = np.zeros((e, 3, 3), np.float32)
    for k in range(3):
        si[:, k, k] = np.exp(rng.uniform(np.log(1e-40), np.log(1e-15), e))
    si[:, 0, 1] = rng.normal(size=e) * 1e-39
    etype = np.where(rng.uniform(size=e) < 0.5, 0, 1)
    mask = np.ones(e, bool)
    jed = jpgo.make_edges(idx.astype(np.int32), meas, si, etype, mask)
    ted = tpgo.make_edges(idx, meas, si, etype, mask)
    want = jax.jit(lambda p: jpgo._gradient_and_blocks(p, jed, JPGOConfig()))(
        poses)
    got = tpgo._gradient_and_blocks(torch.as_tensor(poses), ted, PGOConfig())
    gauge = np.ones(n, bool)
    gauge[0] = False
    want_h = jax.jit(lambda b: jpgo._dense_hessian(n, jed, b, jnp.asarray(
        gauge)))(want[2])
    got_h = tpgo._dense_hessian(n, ted, got[2], torch.as_tensor(gauge))
    want_r = jax.jit(lambda p: jpgo._edge_jacobians(p, jed))(poses)
    got_r = tpgo._edge_jacobians(torch.as_tensor(poses), ted)
    r = (rng.normal(size=(4000, 3)) * np.exp(rng.uniform(
        np.log(1e15), np.log(1e19), (4000, 1)))).astype(np.float32)
    et = np.where(np.arange(4000) % 4 == 0, 0, 1)
    ones = np.ones((4000, 3), np.float32)
    zeros = np.zeros((4000, 2), np.int32)
    wj = jax.jit(lambda v: jpgo._cauchy_weights(v, jpgo.make_edges(
        zeros, ones, ones, et, np.ones(4000, bool)), JPGOConfig()))(r)[1]
    wt = tpgo._cauchy_weights(torch.as_tensor(r), tpgo.make_edges(
        zeros, ones, ones, et, np.ones(4000, bool)), PGOConfig())[1]
    pairs = list(zip(got_r, want_r)) + [(got[1], want[1]),
                                        (got[2][0], want[2][0]),
                                        (got_h, want_h), (wt, wj)]
    for g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert _subnormals(g) == 0
        assert _zero_pattern_differs(g, w) == 0
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("scale", [1e-20, 1e-18])
def test_coral_moment_sums_flush_subnormals_as_the_reference(scale):
    """The plain CorAl moments of a cloud whose offsets are at ``scale``
    metres (their products and partial sums subnormal), against the
    reference's: count, Σ(p−q) and Σ(p−q)(p−q)ᵀ bit-equal, with no
    subnormal entry.  Before: Σ(p−q)(p−q)ᵀ differed (subnormal sums where
    the reference has zeros) at both scales.  ``csrc/coral_moments.cu``
    flushes the same sums."""
    rng = np.random.default_rng(int(-np.log10(scale)))
    n = 64
    ps = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    pm = rng.uniform(size=n) < 0.9
    want = jax.jit(jcoral._neighbor_moments)(ps, pm, ps, pm, np.float32(1.0))
    got = tmoments.neighbor_moments_reference(
        *(torch.as_tensor(x)[None] for x in (ps, pm, ps, pm)), 1.0)
    for g, w in zip(got, want):
        g, w = g[0].numpy(), np.asarray(w)
        # zeros of either sign alike: the reference's loop also adds the
        # other slots' zero terms, which only ever change a zero's sign
        assert not (_same_bits(g, w) & ~((g == 0) & (w == 0))).any()
        assert _subnormals(g) == 0


def test_cell_moment_sums_need_no_further_flush():
    """Audited with no fault: ``compute_cells`` on clouds with a cluster
    spread over 1e-21 to 1e-16 m at the origin (its neighbour chain's
    products and sums subnormal) is bit-equal to the reference's in every
    field; its chain flushes as ``refmath.fma`` does (``csrc/cells.cu``
    alike)."""
    for seed in range(2):
        r = np.random.default_rng(20 + seed)
        tiny = r.normal(size=(300, 2)) * np.exp(r.uniform(np.log(1e-21),
                                                          np.log(1e-16)))
        xy = np.concatenate([tiny, r.uniform(-40, 40, (300, 2))]
                            ).astype(np.float32)
        inten = r.integers(61, 200, 600).astype(np.float32)
        mask = r.uniform(size=600) > 0.05
        want = jfeatures.compute_cells(
            JPointCloud(xy=jnp.asarray(xy), intensity=jnp.asarray(inten),
                        mask=jnp.asarray(mask)), JFeatureConfig())
        got = tfeatures.compute_cells(
            PointCloud(xy=torch.as_tensor(xy), intensity=torch.as_tensor(
                inten), mask=torch.as_tensor(mask)), FeatureConfig())
        for f in ("mean", "cov", "normal", "planarity", "valid"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if f == "valid":
                np.testing.assert_array_equal(g, w)
            else:
                assert not _same_bits(g, w).any(), f


def _associate_both(mean, normal, tm, tn, radius, gate, weight_option=2):
    """The reference's jitted ``associate`` and the port's on one source
    scan of C cells against one target scan (unit nsamples and
    planarity): (winner means, mask, weight) of each."""
    from tbv_slam_public_tpu.core.types import Cells as JCells
    from tbv_slam_public_torch.core.types import Cells

    c, ct = mean.shape[0], tm.shape[1]
    ns, pl = np.full(c, 5, np.float32), np.ones(c, np.float32)
    tns, tpl = np.full((1, ct), 5, np.float32), np.ones((1, ct), np.float32)
    valid, tv = np.ones(c, bool), np.ones((1, ct), bool)
    cov = np.broadcast_to(np.eye(2, dtype=np.float32), (1, ct, 2, 2)).copy()
    pose = np.zeros(3, np.float32)
    kw = dict(weight_option=weight_option, regularization=0.0, cov_scale=1.0,
              angle_gate_cos=gate)
    want = jax.jit(lambda *a: jreg.associate(
        JCells(a[0], None, a[1], a[2], a[3], None, a[4]), *a[5:], radius,
        cost=jreg.COST_P2P, **kw))(mean, normal, ns, pl, valid, pose, tm, tn,
                                   cov, tns, tpl, tv)
    t = lambda x: torch.as_tensor(x)[None]
    got = treg.associate(
        Cells(t(mean), None, t(normal), t(ns), t(pl), None, t(valid)),
        t(pose), t(tm), t(tn), t(cov), t(tns), t(tpl), t(tv), radius,
        cost=treg.COST_P2P, **kw)
    return ((got.tgt_mean_w[0].numpy(), got.mask[0].numpy(),
             got.weight[0].numpy()),
            (np.asarray(want.tgt_mean_w), np.asarray(want.mask),
             np.asarray(want.weight)))


def test_association_distances_round_and_flush_as_the_reference():
    """The association against the reference's compiled ``associate``:
    (1) cells at 1e-19 and 1e-21 m (squared distances subnormal: the
    reference's tie at zero, the first target wins) with their winners,
    masks and weights bit-equal; (2) the radius gate placed between the
    two roundings of the squared distance, which the reference fuses
    (fma(dy, dy, dx dx)): the same masks.  Before: every winner differed at
    1e-19 and 1e-21 m, and every gate case.  ``csrc/lm_solve.cu``'s
    association rounds and flushes the same."""
    rng = np.random.default_rng(31)
    c, ct = 128, 48
    normal = np.tile(np.array([[1.0, 0.0]], np.float32), (c, 1))
    tn = np.tile(np.array([[[1.0, 0.0]]], np.float32), (1, ct, 1))
    for sc in (1e-19, 1e-21):
        mean = (rng.normal(size=(c, 2)) * sc).astype(np.float32)
        tm = (rng.normal(size=(1, ct, 2)) * sc).astype(np.float32)
        got, want = _associate_both(mean, normal, tm, tn, float(sc * 10), 0.5)
        for g, w in zip(got, want):
            assert not _same_bits(np.asarray(g, np.float32),
                                  np.asarray(w, np.float32)).any(), sc
    # the radius gate: a target at offset d whose fused |d|^2 lies below
    # its two roundings, the radius at the two-rounding value
    from fractions import Fraction

    pts = []
    while len(pts) < 12:
        d = (rng.normal(size=2) * 2.0).astype(np.float32)
        p0 = np.float32(d[0] * d[0])
        two = np.float32(p0 + np.float32(d[1] * d[1]))
        fused = np.float32(Fraction(float(p0)) + Fraction(float(d[1])) ** 2)
        r = float(np.sqrt(np.float64(two)))
        if fused < two and np.float32(r * r) == two:
            pts.append((d, r))
    for d, r in pts:
        got, want = _associate_both(np.zeros((1, 2), np.float32), normal[:1],
                                    d[None, None].astype(np.float32),
                                    tn[:, :1], r, 0.5)
        assert bool(want[1][0, 0]) and bool(got[1][0, 0])


def test_lm_products_flush_subnormals_as_the_reference():
    """``_cost_grad_hess`` on rows of one P2L association (unit weight, no
    loss: the reference's w (J^T J) and the port's (w J_a) J_b are then the
    same products) whose Jacobian and residual entries are 1e-21 to 1e-18
    (their products subnormal): H, g and the cost bit-equal to the
    reference's, with no subnormal entry.  Before: the subnormal products
    were kept where the reference has zeros.  ``csrc/lm_solve.cu``'s
    ``leaf`` flushes the same products."""
    from tbv_slam_public_tpu.core.types import Cells as JCells
    from tbv_slam_public_torch.core.types import Cells

    rng = np.random.default_rng(44)
    b = 2000
    mean = (rng.normal(size=(b, 1, 2)) * np.exp(rng.uniform(
        np.log(1e-20), np.log(1e-18), (b, 1, 1)))).astype(np.float32)
    tm = (rng.normal(size=(b, 1, 1, 2)) * 1e-19).astype(np.float32)
    tn = rng.normal(size=(b, 1, 1, 2))
    tn = (tn / np.linalg.norm(tn, axis=-1, keepdims=True)).astype(np.float32)
    theta = np.zeros((b, 3), np.float32)
    theta[:, 2] = rng.uniform(-1e-3, 1e-3, b)
    w = np.ones((b, 1, 1), np.float32)
    m = np.ones((b, 1, 1), bool)
    kw = dict(cost=jreg.COST_P2L, loss=jreg.LOSS_NONE, delta=1.0)
    want = jax.jit(jax.vmap(lambda th, mu, a, n_: jreg._cost_grad_hess(
        th, JCells(mu, None, None, None, None, None, None),
        jreg.Associations(a, n_, jnp.broadcast_to(jnp.eye(2), (1, 1, 2, 2)),
                          jnp.ones((1, 1)), jnp.ones((1, 1), bool)), **kw)))(
        theta, mean, tm, tn)
    got = treg._cost_grad_hess(
        torch.as_tensor(theta),
        Cells(torch.as_tensor(mean), None, None, None, None, None, None),
        treg.Associations(torch.as_tensor(tm), torch.as_tensor(tn),
                          torch.as_tensor(w), torch.as_tensor(m)), **kw)
    for g, wv in zip(got, want):
        g, wv = g.numpy(), np.asarray(wv)
        assert _subnormals(g) == 0
        assert not _same_bits(g, wv).any()


def test_refmath_fma_flushes_as_the_reference():
    """``refmath.fma`` on operands and results in the subnormal range
    against the reference's fused a * b + c (one ``vfmadd`` on its DAZ and
    FTZ threads): bit-equal.  Before: 4,118 of 10,000 results differed
    (3,460 subnormal where the reference has zeros)."""
    rng = np.random.default_rng(12)
    n = 10000
    a = (rng.normal(size=n) * np.exp(rng.uniform(-100, 0, n))).astype(
        np.float32)
    b = (rng.normal(size=n) * np.exp(rng.uniform(-100, 0, n))).astype(
        np.float32)
    c = (rng.normal(size=n) * np.exp(rng.uniform(-95, -80, n))).astype(
        np.float32)
    want = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    got = trefmath.fma(*(torch.as_tensor(x) for x in (a, b, c)))
    assert not _same_bits(got.numpy(), want).any()
    assert _subnormals(got.numpy()) == 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="bit-equal shares against the "
                                "JAX package, for the port on the path")
    p.add_argument("--frames", type=int, default=6)
    a = p.parse_args(argv)
    torch.set_num_threads(4)
    print("port:", tcoral.__file__)
    for f, (bad, n, gap) in cell_mismatch(a.frames).items():
        print(f"cells {f}: {bad} of {n} not bit-equal "
              f"({100.0 * bad / n:.2f} %), max gap {gap:.3g}")
    images, outs = _sensor_scans(a.frames)
    same = total = 0
    for img, (cloud, _) in zip(images, outs):
        got, _ = tradar.kstrongest_filter(torch.as_tensor(img), RadarConfig())
        m = cloud.mask
        same += int((got.xy.numpy()[m] == cloud.xy[m]).all(1).sum())
        total += int(m.sum())
    print(f"detector points bit-equal: {same} of {total}")
    flips, total = ring_flips(a.frames)
    print(f"ScanContext rings changed by the reference's rounding: {flips} "
          f"of {total} points")
    # odometry against the reference over tests/test_torch_odometry_variants.py's
    # two sequences, each package with its own detector
    import test_torch_odometry_variants as variants
    from tbv_slam_public_tpu.models import odometry as jodo
    from tbv_slam_public_torch.models import odometry as todo
    for name in ("default", "time_continuous", "p2d", "cacfar"):
        jc, tc = variants._configs(variants.VARIANTS.get(name, {}))
        for k, seq in enumerate(variants._sequences()):
            want = variants._run(jodo.OdometryPipeline(jc), seq.images)[0]
            got = variants._run(todo.OdometryPipeline(tc, device="cpu"),
                                seq.images)[0]
            d = np.linalg.norm(got[:, :2] - want[:, :2], axis=1) * 1e3
            print(f"odometry {name}, sequence {k}: mean {d.mean():.3f} mm, "
                  f"max {d.max():.3f} mm over {len(d)} frames")
    for collinear in (True, False):
        n, s1, s2 = _neighbourhoods(np.random.default_rng(0), collinear,
                                    20000)
        _, want = jax.jit(lambda *x: jcoral._entropy_from_moments(
            *x, 1e-8))(n, s1, s2)
        _, got = tcoral._entropy_from_moments(
            torch.as_tensor(n), torch.as_tensor(s1), torch.as_tensor(s2),
            1e-8)
        want, got = np.asarray(want), got.numpy()
        print(f"coral dets ({'collinear' if collinear else 'general'}): "
              f"{100.0 * np.mean(got == want):.1f} % bit-equal, "
              f"{100.0 * np.mean(np.sign(got) != np.sign(want)):.1f} % "
              f"other sign")
    rng = np.random.default_rng(4096)
    ps, pm = _ray_cloud(rng, 4096, 0.8)
    want = jax.jit(jcoral._neighbor_moments)(ps, pm, ps, pm, np.float32(1.0))
    sparse = pm & (rng.uniform(size=pm.shape) < 0.05)
    got = tmoments.neighbor_moments_reference(
        *(torch.as_tensor(np.stack(x)) for x in
          ((ps, ps), (pm, pm), (ps, ps), (pm, sparse))), 1.0)
    print("plain moments of a 4096-slot ray cloud beside a sparse row, "
          "entries bit-equal: " + ", ".join(
              f"{100.0 * np.mean(g[0].numpy() == np.asarray(w)):.1f} %"
              for g, w in zip(got, want)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
