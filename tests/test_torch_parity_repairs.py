"""Two last-bit repairs of the port against the JAX package, on the CPU.

``ceres_covariance``'s 3 x 3 algebra: the reference computes
``jnp.linalg.eigvalsh`` and the guarded ``jnp.linalg.inv`` of the Gauss-
Newton Hessian (jaxlib's ``lapack_ssyevd_ffi``, ``lapack_sgetrf_ffi`` and two
``lapack_strsm_ffi`` calls in its optimized HLO); the port writes that library
out (``core/refmath.py::eigvalsh3``, ``inv3``) and is held bit for bit on
seeded Hessians, convex, indefinite and near-singular, with equal ``ok``
flags.

The flush tie: the reference's threads (and the card's ``.ftz``
instructions) flush a result whose rounding with an unbounded exponent is
below 2^-126, so an exact result in [2^-126 - 2^-150, 2^-126 - 2^-151),
which gradual underflow rounds up to 2^-126, is flushed.  Each case puts a
product or a fused multiply-add of a repaired site there (at 2^-126 - 2^-150
and strictly inside) and holds the site against the JAX function.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.types import Cells as JCells
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.core import refmath as plain
from tbv_slam_public_torch.core.types import Cells
from tbv_slam_public_torch.kernels.checks import tie_products
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.kernels import refmath as trefmath
from tbv_slam_public_torch.ops import coral as tcoral
from tbv_slam_public_torch.ops import registration as treg

# one intra-op thread per test worker (the suite runs several on one host)
torch.set_num_threads(1)

MIN_NORM = 2.0 ** -126


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---- ceres_covariance ------------------------------------------------------

def _reference_tail(h, final_score, n_res, cost):
    """The reference's ``ceres_covariance`` after its Hessian
    (``tbv_slam_public_tpu/ops/registration.py``), for one Hessian, as the
    unbatched odometry step calls it."""
    eigs = jnp.linalg.eigvalsh(h)
    ok = eigs[0] > 1e-9
    resid_dim = jnp.where(cost == jreg.COST_P2L, 1, 2) * n_res
    denom = (resid_dim - 3).astype(final_score.dtype)
    ok = ok & (denom > 0)
    scale = 30.0 * final_score / jnp.maximum(denom, 1.0)
    hinv = jnp.linalg.inv(h + (~ok) * jnp.eye(3))
    fallback = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2],
                                    jnp.float32))
    return jnp.where(ok, scale * hinv, fallback), ok


def _hessians(rng, n):
    """n symmetric 3 x 3 float32 Hessians: convex (J^T J of 2-400 residuals,
    as registration sums them), indefinite, and near-singular (a rank-2 J^T
    J plus a tiny or negative third eigenvalue), at scales 1e-6 to 1e6."""
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            j = rng.normal(size=(rng.integers(2, 400), 3))
            h = j.T @ j
        elif kind == 1:
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            h = q @ np.diag(rng.normal(size=3) * 10) @ q.T
        else:
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            ev = [abs(rng.normal()) * 100, abs(rng.normal()),
                  rng.choice([1e-12, 1e-9, 1.01e-9, 0.0, -1e-10])]
            h = q @ np.diag(ev) @ q.T
        h = (h + h.T) / 2 * 10.0 ** rng.uniform(-6, 6)
        out.append(h)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("cost", [jreg.COST_P2L, jreg.COST_P2P])
def test_ceres_covariance_bit_equal_on_seeded_hessians(cost):
    """2,100 Hessians through ``_ceres_from_hessian`` against the
    reference's tail: covariances bit-equal, ``ok`` flags equal (before:
    ``torch.linalg``'s eigenvalues and inverse, last bits off)."""
    rng = np.random.default_rng(1300 + cost)
    n = 2100
    h = _hessians(rng, n)
    score = rng.uniform(0.01, 50.0, n).astype(np.float32)
    n_res = rng.integers(0, 300, n).astype(np.int32)
    want_cov, want_ok = jax.jit(jax.vmap(
        lambda a, s, k: _reference_tail(a, s, k, cost)))(h, score, n_res)
    # the unbatched call (as the odometry step makes it) gives the same bits
    one = jax.jit(lambda a, s, k: _reference_tail(a, s, k, cost))
    for i in range(0, n, 300):
        c1, o1 = one(h[i], score[i], n_res[i])
        assert (_bits(c1) == _bits(want_cov[i])).all() and o1 == want_ok[i]
    got_cov, got_ok = treg._ceres_from_hessian(
        torch.as_tensor(h), torch.as_tensor(score),
        torch.as_tensor(n_res).long(), cost)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert 0 < int(np.sum(want_ok)) < n
    np.testing.assert_array_equal(_bits(got_cov.numpy()), _bits(want_cov))


def test_ceres_covariance_calls_no_linalg(monkeypatch):
    """``ceres_covariance`` reaches no ``torch.linalg`` function."""
    def refuse(*a, **k):
        raise AssertionError("torch.linalg called")
    for name in ("eigvalsh", "inv", "eigh", "solve", "lu_factor"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    h = torch.as_tensor(_hessians(np.random.default_rng(5), 6))
    cov, ok = treg._ceres_from_hessian(h, torch.ones(6),
                                       torch.full((6,), 50), jreg.COST_P2L)
    assert cov.shape == (6, 3, 3) and ok.shape == (6,)


@pytest.mark.parametrize("cost", [jreg.COST_P2L, jreg.COST_P2P])
def test_ceres_covariance_op_on_every_kind(cost):
    """The refmath op ``ceres_covariance`` (the kernel's plain version on
    the CPU) on the shared card inputs (``kernels/checks.py::
    ceres_hessians``: convex, indefinite, near-singular, singular,
    subnormal, non-finite entries, subnormal scores) against the
    reference's tail: flags equal, covariances bit-equal (NaN payloads
    aside)."""
    from tbv_slam_public_torch.kernels.checks import (bits_differ,
                                                      ceres_hessians)

    h, score, n_res = ceres_hessians(np.random.default_rng(1310 + cost),
                                     2000)
    want_cov, want_ok = jax.jit(jax.vmap(
        lambda a, s, k: _reference_tail(a, s, k, cost)))(
            h, score, n_res.astype(np.int32))
    got_cov, got_ok = trefmath.ceres_covariance(
        torch.as_tensor(h), torch.as_tensor(score), torch.as_tensor(n_res),
        p2l=cost == jreg.COST_P2L, fallback=treg.DEFAULT_COV_DIAG)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert 0 < int(np.sum(want_ok)) < len(h)
    assert bits_differ(got_cov, np.asarray(want_cov)) == 0


# ---- the flush tie ---------------------------------------------------------

_LO = Fraction(2) ** -126 - Fraction(2) ** -150
_HI = Fraction(2) ** -126 - Fraction(2) ** -151


def _f32(x) -> np.float32:
    return np.float32(x)


def _tie_pairs(rng, n, c=0.0):
    """n float32 pairs (a, b) whose exact a * b + c lies in [2^-126 - 2^-150,
    2^-126 - 2^-151): the first exactly at 2^-126 - 2^-150 (when c = 0),
    the rest strictly inside, signs mixed where c = 0."""
    out = []
    if c == 0.0:
        out.append((_f32(np.ldexp(1.0 - 2.0 ** -24, -63)),
                    _f32(np.ldexp(1.0, -63))))
    mid = (_LO + _HI) / 2 - Fraction(float(c))
    while len(out) < n:
        b = _f32(np.ldexp(rng.uniform(1.0, 2.0), int(rng.integers(-70, -56))))
        a0 = _f32(float(mid / Fraction(float(b))))
        for a in (a0, np.nextafter(a0, _f32(0)), np.nextafter(a0, _f32(1))):
            p = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
            if _LO < p < _HI:
                out.append((a, b))
                break
    a, b = (np.asarray(x, np.float32) for x in zip(*out[:n]))
    if c == 0.0:
        s = np.where(rng.uniform(size=n) < 0.5, -1, 1).astype(np.float32)
        s[0] = 1
        a = a * s
    return a, b


def test_flush_tie_refmath_fma():
    """``refmath.fma`` (plain; ``refmath.cuh::ref_fma``, one fma.rn.ftz, on
    the card) with exact results in the tie interval, against the
    reference's fused a * b + c: flushed to zero alike.  Before: each kept
    as 2^-126."""
    rng = np.random.default_rng(13)
    cases = [_tie_pairs(rng, 40)]
    for c in (-1.0001 * MIN_NORM, -3.7 * MIN_NORM):
        cases.append(_tie_pairs(rng, 20, c) + (np.float32(c),))
    for case in cases:
        a, b = case[:2]
        c = np.full_like(a, case[2] if len(case) > 2 else 0.0)
        want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
        assert (want == 0).all()
        got = trefmath.fma(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _p2l_rows(normal, weight, theta=None):
    """B rows of one P2L association at pose 0: source cell at the origin,
    target at (0, -1) with the given normal [B, 2] and weight [B]: J = (n0,
    n1, 0) and r = n1, so H = w J^T J and g = w J r hold the products n0 n1
    (the reference's and the port's products are the same at w = 1)."""
    b = normal.shape[0]
    mean = np.zeros((b, 1, 2), np.float32)
    tm = np.tile(np.float32([[[[0.0, -1.0]]]]), (b, 1, 1, 1))
    tn = normal.reshape(b, 1, 1, 2).astype(np.float32)
    w = weight.reshape(b, 1, 1).astype(np.float32)
    theta = np.zeros((b, 3), np.float32) if theta is None else theta
    return theta, mean, tm, tn, w


def _lm_both(fn, theta, mean, tm, tn, w):
    kw = dict(cost=jreg.COST_P2L, loss=jreg.LOSS_NONE, delta=1.0)
    want = jax.jit(jax.vmap(lambda th, mu, a, n_, wt: getattr(jreg, fn)(
        th, JCells(mu, None, None, None, None, None, None),
        jreg.Associations(a, n_, jnp.broadcast_to(jnp.eye(2), (1, 1, 2, 2)),
                          wt, jnp.ones((1, 1), bool)), **kw)))(
        theta, mean, tm, tn, w)
    got = getattr(treg, fn)(
        torch.as_tensor(theta),
        Cells(torch.as_tensor(mean), None, None, None, None, None, None),
        treg.Associations(torch.as_tensor(tm), torch.as_tensor(tn),
                          torch.as_tensor(w),
                          torch.ones(w.shape, dtype=torch.bool)), **kw)
    return got, want


def test_flush_tie_lm_products():
    """The LM products w J [J | r] of ``_cost_grad_hess`` (``mul_ftz``;
    ``csrc/lm_solve.cu``'s ``leaf``, mul.rn.ftz) with n0 n1 in the tie
    interval: H[0, 1] and g[0] flushed as the reference's, H, g and the
    cost bit-equal.  Before: 2^-126 where the reference has 0."""
    rng = np.random.default_rng(14)
    a, b = _tie_pairs(rng, 48)
    got, want = _lm_both("_cost_grad_hess",
                         *_p2l_rows(np.stack([a, b], -1), np.ones(48)))
    assert (np.asarray(want[2])[:, 0, 1] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_flush_tie_cost_half():
    """The cost's half, 0.5 x sum (``mul_ftz``; mul.rn.ftz in
    ``csrc/lm_solve.cu``'s ``finish`` and the evaluation entry), at a sum
    of 2^-125 - 2^-149: exactly 2^-126 - 2^-150, the only tie a halving
    reaches.  ``_cost_only`` and ``_cost_grad_hess`` bit-equal to the
    reference's (0).  Before: 2^-126."""
    w = np.full(4, np.ldexp(2.0 - 2.0 ** -23, -126), np.float32)
    normal = np.tile(np.float32([[0.0, 1.0]]), (4, 1))
    for fn in ("_cost_only", "_cost_grad_hess"):
        got, want = _lm_both(fn, *_p2l_rows(normal, w))
        got, want = (got, want) if fn == "_cost_grad_hess" else \
            ((got,), (want,))
        assert (np.asarray(want[0]) == 0).all()
        np.testing.assert_array_equal(_bits(got[0].numpy()),
                                      _bits(want[0]))


def test_flush_tie_coral_moment_sums():
    """The CorAl moments' fused sum of xy products (``sum_ftz``;
    fma.rn.ftz in ``csrc/coral_moments.cu``) on two-point clouds whose
    offset (a, b) has a b in the tie interval: Σ(p−q)(p−q)ᵀ's xy entry
    flushed as the reference's (zeros of either sign alike, as the
    reference's loop adds the other slots' zero terms).  Before: ±2^-126."""
    rng = np.random.default_rng(15)
    a, b = _tie_pairs(rng, 8)
    ref = jax.jit(jcoral._neighbor_moments)
    pm = np.ones(2, bool)
    for x, y in zip(a, b):
        ps = np.float32([[0.0, 0.0], [x, y]])
        want = ref(ps, pm, ps, pm, np.float32(1.0))
        got = tmoments.neighbor_moments_reference(
            *(torch.as_tensor(v)[None] for v in (ps, pm, ps, pm)), 1.0)
        assert (np.asarray(want[2])[:, 0, 1] == 0).all()
        for g, w in zip(got, want):
            g, w = g[0].numpy(), np.asarray(w)
            same = (_bits(g) == _bits(w)) | ((g == 0) & (w == 0))
            assert same.all()


def test_association_distances_never_reach_the_tie():
    """Audited, nothing to repair: the association's squared distance
    fma(dy, dy, dx dx) (the product, then ``refmath.fma``, which flushes it
    as an operand; ``csrc/lm_solve.cu``'s ``sqdist``) meets the tie only
    through a square or a fused sum onto 0 or a value >= 2^-126, and no
    float32 square lies in [2^-126 - 2^-150, 2^-126 - 2^-151): with x =
    m 2^e, m the 24-bit significand, x^2 = 2^-126 (1 - d) needs m^2 in
    [2^48 - 2^24, 2^48 - 2^23), and the largest square below 2^48,
    (2^24 - 1)^2 = 2^48 - 2^25 + 1, is under that."""
    m = np.arange(2 ** 23, 2 ** 24, dtype=np.int64)
    sq = m * m
    assert not ((sq >= 2 ** 48 - 2 ** 24) & (sq < 2 ** 48 - 2 ** 23)).any()
    # and every square of a float32 at 2^-64 m keeps the gradual rounding
    x = torch.as_tensor(np.ldexp(m[-4096:].astype(np.float64), -87)
                        .astype(np.float32))
    np.testing.assert_array_equal(plain.mul_ftz(x, x).numpy(),
                                  plain.ftz(x * x).numpy())


# ---- the flush tie in the lone products ------------------------------------

def _tie_factor(b, rng):
    """A float32 a with the exact a * b strictly inside the tie interval
    (b > 0 fixed; None when none of the three nearest floats is)."""
    a0 = _f32(float((_LO + _HI) / 2 / Fraction(float(b))))
    for a in (a0, np.nextafter(a0, _f32(0)), np.nextafter(a0, _f32(1))):
        if _LO < Fraction(float(a)) * Fraction(float(b)) < _HI:
            return a
    return None


def _with_tie_factor(v):
    """(v', a): the first float32 v' from v upwards that has a tie factor a
    (:func:`_tie_factor`)."""
    v = _f32(v)
    while _tie_factor(v, None) is None:
        v = np.nextafter(v, _f32(np.inf))
    return v, _tie_factor(v, None)


def _pgo_weighted_residual(rng):
    """PGO's gradient w r (``ops/posegraph.py::_gradient_and_blocks``): loop
    edges whose residual (x, y, 0) has a Cauchy weight w(x), the same in
    both packages, and w y in the tie interval; with theta 0 the gradient's
    y entries are -w y and w y."""
    from tbv_slam_public_tpu.core.config import PGOConfig as JPGOConfig
    from tbv_slam_public_tpu.ops import posegraph as jpgo
    from tbv_slam_public_torch.core.config import PGOConfig
    from tbv_slam_public_torch.ops import posegraph as tpgo

    rows = []
    one = np.eye(3, dtype=np.float32)[None]
    edge = (np.zeros((1, 2), np.int32), np.zeros((1, 3), np.float32), one,
            np.ones(1, np.int32), np.ones(1, bool))
    weight = jax.jit(lambda r: jpgo._cauchy_weights(
        r, jpgo.make_edges(*edge), JPGOConfig())[1])
    while len(rows) < 12:
        x = _f32(rng.uniform(0.02, 0.3))
        r = np.float32([[x, 0.0, 0.0]])
        w = tpgo._cauchy_weights(torch.as_tensor(r), tpgo.make_edges(*edge),
                                 PGOConfig())[1].numpy()
        y = _tie_factor(w[0], rng)
        if y is not None and _bits(w) == _bits(weight(r)):
            rows.append((x, y))
    e = len(rows)
    poses = np.zeros((2 * e, 3), np.float32)
    poses[1::2, :2] = rows
    args = (np.stack([np.arange(0, 2 * e, 2), np.arange(1, 2 * e, 2)], 1),
            np.zeros((e, 3), np.float32), np.tile(one, (e, 1, 1)),
            np.ones(e, np.int64), np.ones(e, bool))
    jed = jpgo.make_edges(args[0].astype(np.int32), *args[1:])
    want = jax.jit(lambda p: jpgo._gradient_and_blocks(p, jed, JPGOConfig()))(
        poses)[1]
    got = tpgo._gradient_and_blocks(torch.as_tensor(poses),
                                    tpgo.make_edges(*args), PGOConfig())[1]
    return got, want


def _cells_both(xy, **cfg):
    """compute_cells of both packages on one cloud (equal intensities)."""
    from tbv_slam_public_tpu.core.config import FeatureConfig as JFeatureConfig
    from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
    from tbv_slam_public_tpu.ops import features as jfeatures
    from tbv_slam_public_torch.core.config import FeatureConfig
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.ops import features as tfeatures

    inten = np.full(len(xy), 100.0, np.float32)
    mask = np.ones(len(xy), bool)
    want = jfeatures.compute_cells(JPointCloud(
        xy=jnp.asarray(xy), intensity=jnp.asarray(inten),
        mask=jnp.asarray(mask)), JFeatureConfig(**cfg))
    got = tfeatures.compute_cells(PointCloud(
        xy=torch.as_tensor(xy), intensity=torch.as_tensor(inten),
        mask=torch.as_tensor(mask)), FeatureConfig(**cfg))
    return got, want


def _axis_cloud(u, v):
    """Six points at the origin (its cell's centroid is exactly 0) and (-u,
    0), (0, -v) in other voxels: that cell's neighbours have weights 1/8,
    mean (-u/8, -v/8), qq = diag(u^2, v^2) / 8 and no off-diagonal term."""
    return np.float32([(0.0, 0.0)] * 6 + [(-u, 0.0), (0.0, -v)])


def _cells_covariance(rng):
    """The CFEAR cells' covariance qq - mu mu^T (``ops/features.py``,
    ``csrc/cells.cu``'s ``finish_cell``): mu0 mu1 = uv / 64 in the tie
    interval, so the origin cell's off-diagonal is 0 in the reference and
    -2^-126 before (min_det -1 keeps the tiny cell valid)."""
    a, b = tie_products(rng, 4)
    got, want = zip(*(_cells_both(_axis_cloud(8 * x, 8 * y), min_det=-1.0)
                      for x, y in zip(a, b)))
    assert all(np.asarray(w.valid).sum() == 3 for w in want)
    return (torch.stack([g.cov for g in got]),
            np.stack([np.asarray(w.cov) for w in want]))


# (u, v) of _axis_cloud whose origin cell's eigenvalues multiply exactly
# into the tie interval (found by a search over the port's arithmetic)
_DET_TIES = [(4.8264885e-09, 2.0537982e-10), (5.5467746e-09, 1.7870891e-10),
             (3.7497334e-09, 2.6435676e-10), (6.6410184e-09, 1.4926298e-10)]


def _cells_determinant(rng):
    """The eigen gate's determinant lmax lmin (``ops/features.py``,
    ``finish_cell``) in the tie interval, with min_det 0: the reference's
    flushed determinant fails the gate det > 0, 2^-126 passed it before."""
    got, want = zip(*(_cells_both(_axis_cloud(_f32(u), _f32(v)), min_det=0.0)
                      for u, v in _DET_TIES))
    return (torch.stack([g.valid for g in got]),
            np.stack([np.asarray(w.valid) for w in want]))


def _cells_normal_direction(rng):
    """The normal's orientation toward the origin, n . (o - mean) as
    fma(n1, d1, n0 d0) (``ops/features.py``, ``finish_cell``): a cross of
    points at +-(2, 1) and +-(-0.95, 2), two at the origin and one at (-u,
    0) with leaf 1.5, so the origin cell has weights 1/8, d0 = u / 8, d1 = 0
    and |n0| d0 in the tie interval.  The reference flushes n0 d0 and keeps
    the eigenvector; 2^-126 of the sign of n0 < 0 flipped it before."""
    c = float(_f32(0.95))
    u = _f32(8.0) * _tie_factor(_f32(0.8479982), rng)  # |n0| of this cell
    xy = np.float32([(2.0, 1.0), (-2.0, -1.0), (-c, 2.0), (c, -2.0),
                     (0.0, 0.0), (0.0, 0.0), (-u, 0.0), (0.0, 0.0)])
    got, want = _cells_both(xy, downsample_factor=2.0)
    assert np.asarray(want.valid)[0]
    return got.normal, np.asarray(want.normal)


def _coral_determinant(rng):
    """CorAl's determinant fma(c00, c11, -(c01 c10)) (``ops/coral.py::
    _det2x2``, ``csrc/coral_moments.cu``'s ``tail_det``): c00 = 0 and c01
    c10 in the tie interval, from n = 2 and zero means (cov = s2)."""
    a, b = _tie_pairs(rng, 16)
    s2 = np.zeros((16, 2, 2), np.float32)
    s2[:, 0, 1], s2[:, 1, 0], s2[:, 1, 1] = a, b, 1.0
    n, s1 = np.full(16, 2.0, np.float32), np.zeros((16, 2), np.float32)
    want = jax.jit(lambda *x: jcoral._entropy_from_moments(*x, 1e-8))(
        n, s1, s2)[1]
    got = tcoral._entropy_from_moments(
        *(torch.as_tensor(x) for x in (n, s1, s2)), 1e-8)[1]
    return got, want


def _coral_kl_inverse(rng):
    """The KL divergence's inverse entries s1i = adj(S1) / det1
    (``_kl_divergence_2d``, ``tail_kl``): S1 = [[1, a], [0, y]] with
    fl(1 / y) = b and a b in the tie interval, so s1i[0, 1] is 0 in the
    reference (and -2^-126 before), and S0 = [[1, 0], [1e38, 1]] carries it
    into the trace."""
    rows = []
    while len(rows) < 12:
        b = _f32(np.ldexp(rng.uniform(1.0, 2.0), -63))
        y = _f32(1.0) / b
        inv = _f32(1.0) / y
        a = _tie_factor(inv, rng)
        if a is not None:
            rows.append((a, y))
    m = len(rows)
    s1 = np.tile(np.eye(2, dtype=np.float32), (m, 1, 1))
    s1[:, 0, 1] = [a for a, _ in rows]
    s1[:, 1, 1] = [y for _, y in rows]
    s0 = np.tile(np.float32([[1.0, 0.0], [1e38, 1.0]]), (m, 1, 1))
    u = np.zeros((m, 2), np.float32)
    want = jax.jit(jcoral._kl_divergence_2d)(u, s0, u, s1)[0]
    got = tcoral._kl_divergence_2d(*(torch.as_tensor(x)
                                     for x in (u, s0, u, s1)))[0]
    return got, want


_TIE_SITES = {"pgo_weighted_residual": _pgo_weighted_residual,
              "cells_covariance": _cells_covariance,
              "cells_determinant": _cells_determinant,
              "cells_normal_direction": _cells_normal_direction,
              "coral_determinant": _coral_determinant,
              "coral_kl_inverse": _coral_kl_inverse}


@pytest.mark.parametrize("site", sorted(_TIE_SITES))
def test_flush_tie_in_lone_products(site):
    """A lone product of the reference (a multiply not fused into an add)
    whose exact value lies in the tie interval, at each repaired site:
    flushed as the reference's FTZ threads flush it (``mul_ftz``; the
    refmath op ``mul`` where PGO runs on the card; ``mul_ftz``, one
    mul.rn.ftz, in the kernels), the site's outputs bit-equal to the JAX
    function's.  Before: 2^-126 kept, as ``ftz(a * b)`` and
    ``daz(__fmul_rn(a, b))`` keep it."""
    got, want = _TIE_SITES[site](np.random.default_rng(1400))
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
        assert not want.all()
        return
    same = (_bits(got) == _bits(want)) | ((got == 0) & (want == 0))
    assert same.all(), f"{(~same).sum()} of {same.size} differ"


def test_mul_op_flushes_as_the_reference():
    """The refmath op ``mul``'s plain version (``core/refmath.py::mul``)
    against the reference's product a * b on its FTZ / DAZ threads: tie
    products flushed, every other product, subnormal operands (flushed, as
    DAZ flushes them) and specials bit-equal; operands broadcast together;
    ``kernels/refmath.py::mul`` on normal operands the same."""
    rng = np.random.default_rng(1401)
    a, b = _tie_pairs(rng, 64)
    x = np.concatenate([a, rng.normal(size=4096).astype(np.float32)
                        * np.exp(rng.uniform(-85, 85, 4096)).astype(
                            np.float32),
                        np.float32([0.0, -0.0, np.inf, -np.inf, np.nan,
                                    1e-40, -3e-39, 2.0 ** -126])])
    y = np.concatenate([b, rng.normal(size=4096).astype(np.float32)
                        * np.exp(rng.uniform(-85, 85, 4096)).astype(
                            np.float32),
                        np.float32([np.inf, 5.0, 0.0, -2.0, 1.0, 1e30,
                                    -1e38, 0.5])])
    want = np.asarray(jax.jit(lambda p, q: p * q)(x, y))
    got = plain.mul(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert (want[:64] == 0).all()
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{(~same).sum()} differ"
    normal = np.abs(x) >= MIN_NORM
    normal &= np.abs(y) >= MIN_NORM
    np.testing.assert_array_equal(_bits(trefmath.mul(torch.as_tensor(
        x[normal]), torch.as_tensor(y[normal])).numpy()), _bits(got[normal]))
    col = plain.mul(torch.as_tensor(x[:8, None]), torch.as_tensor(y[:3]))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jax.jit(
        lambda p, q: p * q)(x[:8, None], y[:3])))


def test_exp_scale_never_reaches_the_tie():
    """Audited, nothing to repair: XLA's exp scales its polynomial y by 2^n
    (``core/refmath.py::exp``'s ftz(y 2^n); ``refmath.cuh``'s ``ref_exp``),
    a product by a power of two that is at the tie only for y 2^n =
    2^-126 - 2^-150 exactly.  Every float32 x in [-88, -87] (where the
    result crosses 2^-126) gives the reference's bits."""
    x = np.arange(np.float32(-88.0).view(np.int32),
                  np.float32(-87.0).view(np.int32) - 1, -1,
                  dtype=np.int32).view(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = plain.exp(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cost", [jreg.COST_P2L, jreg.COST_P2P,
                                  jreg.COST_P2D])
def test_residual_terms_flush_the_sine_of_a_subnormal_theta(cost):
    """The sine of a subnormal theta: glibc's sinf returns a tiny argument
    unchanged, and the reference's DAZ threads then read it as zero in
    every product (``_residual_terms`` and ``csrc/lm_solve.cu``'s ``leaf``
    flush it).  Cells at (0, 1000) and (3, -700), theta 1e-40 and -3e-39:
    residuals, Jacobians and squared norms bit-equal to the JAX function's.
    Before: s uy kept as a normal -1e-37 in the residual and Jacobian."""
    mean = np.float32([[0.0, 1000.0], [3.0, -700.0]])
    tm = np.float32([[[0.5, -2.0], [1.0, 4.0]]])
    tn = np.tile(np.float32([0.6, 0.8]), (1, 2, 1))
    si = np.tile(np.float32([[2.0, 0.5], [0.0, 1.5]]), (1, 2, 1, 1))
    w, m = np.ones((1, 2), np.float32), np.ones((1, 2), bool)
    jc = JCells(mean, None, None, None, None, None, None)
    for t in (1e-40, -3e-39):
        th = np.float32([0.25, -1.0, t])
        want = jax.jit(lambda v: jreg._residual_terms(
            v, jc, jreg.Associations(tm, tn, si, w, m), cost))(th)
        got = treg._residual_terms(
            torch.as_tensor(th)[None],
            Cells(torch.as_tensor(mean)[None], None, None, None, None, None,
                  None),
            treg.Associations(torch.as_tensor(tm)[None],
                              torch.as_tensor(tn)[None],
                              torch.as_tensor(w)[None],
                              torch.as_tensor(m)[None],
                              tgt_sqrtinfo=torch.as_tensor(si)[None]), cost)
        for g, v in zip(got, want):
            g, v = g[0].numpy(), np.asarray(v)
            same = (_bits(g) == _bits(v)) | ((g == 0) & (v == 0))
            assert same.all(), (t, g, v)


def _residuals_both(theta, mean, tm, tn, si, cost):
    """``_residual_terms`` of both packages for one row of theta [3], cells
    mean [C, 2], one target scan (tm, tn [1, C, 2], si [1, C, 2, 2])."""
    w, m = np.ones(tm.shape[:2], np.float32), np.ones(tm.shape[:2], bool)
    jc = JCells(mean, None, None, None, None, None, None)
    want = jax.jit(lambda v: jreg._residual_terms(
        v, jc, jreg.Associations(tm, tn, si, w, m), cost))(theta)
    got = treg._residual_terms(
        torch.as_tensor(theta)[None],
        Cells(torch.as_tensor(mean)[None], None, None, None, None, None,
              None),
        treg.Associations(torch.as_tensor(tm)[None],
                          torch.as_tensor(tn)[None],
                          torch.as_tensor(w)[None], torch.as_tensor(m)[None],
                          tgt_sqrtinfo=torch.as_tensor(si)[None]), cost)
    return [(g[0].numpy(), np.asarray(v)) for g, v in zip(got, want)]


@pytest.mark.parametrize("cost", [jreg.COST_P2L, jreg.COST_P2P,
                                  jreg.COST_P2D])
def test_flush_tie_in_residual_products(cost):
    """The first products of the residuals' fused sums (``_residual_terms``;
    ``csrc/lm_solve.cu``'s ``leaf``: mul.rn.ftz), each a lone product of the
    reference, driven into the tie interval with the sum's other term zero:
    P2L's n0 e0 (residual) and n1 dy (Jacobian), P2D's u0 e0 (residual) and
    u_r0 dx (Jacobian), the rotation's c uy and s uy (P2P at theta 0.3).
    Residuals, Jacobians and squared norms bit-equal to the JAX function's
    (zeros of either sign alike).  Before: 2^-126 where the reference has
    0."""
    (n0, a0), (n1, a1), (u0, b0) = (_with_tie_factor(v)
                                    for v in (0.6, 0.8, 0.7))
    si = np.tile(np.float32([[u0, 0.25], [0.75, 1.25]]), (1, 2, 1, 1))
    tm = np.zeros((1, 2, 2), np.float32)
    tn = np.tile(np.float32([n0, n1]), (1, 2, 1))
    theta = np.zeros(3, np.float32)
    if cost == jreg.COST_P2L:  # ux n0 and ux n1 at theta 0: e0 = dy = ux
        mean = np.float32([[a0, 0.0], [a1, 0.0]])
    elif cost == jreg.COST_P2D:  # ux u0 (e0 = ux), then -uy u0 (dx = -uy)
        mean = np.float32([[b0, 0.0], [0.0, b0]])
    else:  # ux = 0: e1 = wy = c uy, e0 = dy = -(s uy)
        t = _f32(0.3)
        while True:
            s, c = (_f32(float(v)) for v in trefmath.sincos(torch.tensor([t])))
            fc, fs = _tie_factor(c, None), _tie_factor(s, None)
            if fc is not None and fs is not None:
                break
            t = np.nextafter(t, _f32(1))
        theta[2] = t
        mean = np.float32([[0.0, fc], [0.0, fs]])
    for g, w in _residuals_both(theta, mean, tm, tn, si, cost):
        same = (_bits(g) == _bits(w)) | ((g == 0) & (w == 0))
        assert same.all(), (g, w)


# ---- se2: a subnormal angle, sine or coordinate ----------------------------

_SE2_POSES = np.float32([[0.0, 0.0, 1e-40], [0.0, 0.0, -3e-39],
                         [1000.0, 0.0, 1e-40], [1e-40, -2e-39, 0.0],
                         [1.5e-38, 2e-38, 1e-40], [3e-39, 0.0, 3.0]])
_SE2_POINTS = np.float32([[1000.0, 0.0], [0.0, 1000.0], [MIN_NORM, 0.0],
                          [1e-40, -1e-39]])
_SE2_OTHERS = np.float32([[1000.0, 0.0, 0.0], [0.0, 0.0, 1e-40],
                          [1.2e-38, 0.0, -2e-39], [0.0, 0.0, -3.0]])


def _se2_cases(fn):
    """(JAX function, port function, operands) of ``fn`` over the poses,
    points and second poses above (both orders of a pair)."""
    from tbv_slam_public_tpu.core import se2 as jse2
    from tbv_slam_public_torch.core import se2 as tse2
    j, t = getattr(jse2, fn), getattr(tse2, fn)
    p = _SE2_POSES
    if fn in ("apply", "rotate"):
        return j, t, [(p[:, None, :], _SE2_POINTS[None].repeat(len(p), 0))]
    if fn == "inverse":
        return j, t, [(p,)]
    a = np.repeat(p, len(_SE2_OTHERS), 0)
    b = np.tile(_SE2_OTHERS, (len(p), 1))
    pairs = [(a, b), (b, a)]
    if fn == "interpolate":
        return j, t, [pr + (np.float32(f),) for pr in pairs
                      for f in (0.5, 1e-40)]
    return j, t, pairs


@pytest.mark.parametrize("fn", ["apply", "rotate", "compose", "inverse",
                                "relative", "interpolate"])
def test_se2_flushes_subnormal_angles_and_coordinates(fn):
    """se2 at theta 1e-40 and -3e-39 and at subnormal translations and
    points: the reference's DAZ / FTZ threads read a subnormal sine,
    coordinate or angle as zero in a lone product or a sum and flush a
    subnormal result (``core/se2.py::_mul``, ``_add``; the site kernels'
    mul_ftz / add_ftz).  Bit-equal to the jitted JAX function.  Before:
    s u kept as a normal product (-9.9999461e-38 where the reference has 0),
    a subnormal angle sum or translation kept (theta 1e-40 after compose
    where the reference has 0)."""
    j, t, cases = _se2_cases(fn)
    for ops in cases:
        want = np.asarray(jax.jit(j)(*ops))
        got = t(*(torch.as_tensor(x) for x in ops)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=fn)


# ---- ScanContext's keys and distance ---------------------------------------
#
# ``core/refmath.py::sc_key``, ``sc_ring_distance`` and ``sc_distance``
# against the JAX functions compiled as the main path compiles them: the
# keys in ``context_descriptors`` (vmapped over the augmentations) and
# jitted alone, the distance vmapped over the candidates as ``retrieve``
# calls it, ``retrieve`` jitted whole.

from tbv_slam_public_tpu.core.config import PGOConfig, TBVConfig  # noqa: E402
from tbv_slam_public_tpu.core.types import PointCloud as JCloud  # noqa: E402
from tbv_slam_public_tpu.models import loopclosure as jlc  # noqa: E402
from tbv_slam_public_tpu.ops import posegraph as jpg  # noqa: E402
from tbv_slam_public_tpu.ops import scancontext as jsc  # noqa: E402
from tbv_slam_public_torch.ops import posegraph as tpg  # noqa: E402
from tbv_slam_public_torch.ops import scancontext as tsc  # noqa: E402

_SC = TBVConfig().scancontext


def _descs(rng, shape):
    """Descriptor-like values: sums of byte intensities / 1000, 60 % empty
    bins."""
    x = (rng.integers(60, 255, shape) * rng.integers(0, 6, shape)
         / 1000.0).astype(np.float32)
    x[rng.uniform(size=shape) < 0.6] = 0.0
    return x


def _same_bits(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sc_keys_bit_equal(seed):
    rng = np.random.default_rng(seed)
    p = 3000
    cloud = JCloud(xy=jnp.asarray(rng.uniform(-80, 80, (p, 2)), jnp.float32),
                   intensity=jnp.asarray(rng.integers(60, 255, p),
                                         jnp.float32),
                   mask=jnp.asarray(rng.uniform(size=p) < 0.9))
    d, rings, _ = jlc.context_descriptors(cloud, TBVConfig())
    _same_bits(tsc.ring_key(torch.as_tensor(np.asarray(d))), rings)
    x = _descs(rng, (16, _SC.num_ring, _SC.num_sector))
    x[0] = 0.0
    x[1, :, :7] = 0.0
    t = torch.as_tensor(x)
    _same_bits(tsc.ring_key(t), jax.jit(jsc.ring_key)(x))
    _same_bits(tsc.sector_key(t), jax.jit(jsc.sector_key)(x))


@pytest.mark.parametrize("n", [7, 40, 120, 1000])
def test_sc_tree_sum_flushes_mixed_signs(n):
    """Mixed-sign rows of normals near 2^-126 whose partial sums cancel to
    subnormals: the flushed tree sum (``core/refmath.py::_tree_sum_ftz``)
    equals the jitted ``jnp.sum``, where the unflushed one does not; and
    the keys of such descriptors equal the JAX functions'."""
    from tbv_slam_public_torch.kernels.checks import bits_differ

    rng = np.random.default_rng(n)
    tiny = np.float32(2.0 ** -126)
    x = (rng.integers(1, 4, (64, n)) * tiny
         * rng.choice([-1, 1], (64, n))).astype(np.float32)
    x[:, ::5] = rng.uniform(1, 1.5, x[:, ::5].shape) * tiny
    x[0] = rng.normal(size=n)
    want = jax.jit(lambda v: jnp.sum(v, -1))(x)
    _same_bits(plain._tree_sum_ftz(torch.as_tensor(x)), want)
    assert bits_differ(plain.tree_sum(torch.as_tensor(x)), want) > 0
    d = (rng.integers(1, 4, (4, _SC.num_ring, _SC.num_sector)) * tiny
         * rng.choice([-1, 1], (4, _SC.num_ring, _SC.num_sector))).astype(
        np.float32)
    d[0] = rng.normal(size=d.shape[1:])
    _same_bits(tsc.ring_key(torch.as_tensor(d)), jax.jit(jsc.ring_key)(d))
    _same_bits(tsc.sector_key(torch.as_tensor(d)),
               jax.jit(jsc.sector_key)(d))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sc_distance_bit_equal(seed):
    """Distance and shift of a query against candidates: random ones, a
    rolled copy (the shift), ones with zero columns and an empty one (the
    effective-column gate), at the default 40 x 120."""
    rng = np.random.default_rng(seed)
    q = _descs(rng, (_SC.num_ring, _SC.num_sector))
    c = _descs(rng, (10, _SC.num_ring, _SC.num_sector))
    c[1] = np.roll(q, 7 + seed, axis=1)
    c[2][:, :50] = 0.0
    c[3] = 0.0
    c[4][:, ::3] = 0.0
    f = jax.jit(jax.vmap(jsc.sc_distance, in_axes=(None, 0)))
    wd, ws = f(q, c)
    gd, gs = tsc.sc_distance(torch.as_tensor(q), torch.as_tensor(c))
    _same_bits(gd, wd)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert int(gs[1]) == -(7 + seed) % _SC.num_sector  # the roll found


@pytest.mark.parametrize("coupled", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_retrieve_bit_equal(seed, coupled):
    rng = np.random.default_rng(seed)
    n = 96
    db = _descs(rng, (n, _SC.num_ring, _SC.num_sector))
    db[5] = np.roll(db[0], 3, axis=1)
    keys = np.asarray(jax.jit(jsc.ring_key)(db))
    mask = rng.uniform(size=n) < 0.9
    odom = rng.uniform(0, 1, n).astype(np.float32)
    opts = dict(num_candidates=10, search_ratio=_SC.search_ratio,
                odometry_coupled=coupled)
    want = jsc.retrieve(db[0], keys[0], db, keys, mask, odom, **opts)
    got = tsc.retrieve(*(torch.as_tensor(x) for x in
                         (db[0], keys[0], db, keys, mask, odom)), **opts)
    for f in ("dist", "dist_sc", "dist_odom", "index", "shift", "valid"):
        _same_bits(getattr(got, f).numpy().astype(np.float32)
                   if f in ("dist", "dist_sc", "dist_odom")
                   else getattr(got, f).numpy().astype(np.int32),
                   np.asarray(getattr(want, f)).astype(
                       np.float32 if f in ("dist", "dist_sc", "dist_odom")
                       else np.int32))


# ---- measured_sqrt_info ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_measured_sqrt_info_bit_equal(seed):
    """jaxlib's inverse and Cholesky factor written out: SPD covariances at
    scales 1e-5 to 10, random-rank, singular, zero, negative definite and
    asymmetric ones (the degenerate ones take the default diagonal)."""
    rng = np.random.default_rng(seed)
    e = 600
    a = rng.normal(size=(e, 3, 3)).astype(np.float32)
    scale = np.exp(rng.uniform(-12, 2, (e, 1, 1))).astype(np.float32)
    cov = ((a @ a.transpose(0, 2, 1) + 0.3 * np.eye(3)) * scale).astype(
        np.float32)
    cov[:40] = (a[:40, :, :2] @ a[:40, :, :2].transpose(0, 2, 1)) * 1e-4
    cov[40:60, 2] = 0.0
    cov[40:60, :, 2] = 0.0
    cov[60] = 0.0
    cov[61:80] *= -1.0
    cov[80:120, 0, 1] += rng.normal(size=40).astype(np.float32)
    et = rng.integers(0, 2, e).astype(np.int32)
    cfg = PGOConfig()
    want = jpg.measured_sqrt_info(jnp.asarray(cov), jnp.asarray(et), cfg)
    got = tpg.measured_sqrt_info(torch.as_tensor(cov), torch.as_tensor(et),
                                 cfg)
    _same_bits(got, want)
    fallback = np.asarray(jax.vmap(jnp.diag)(jpg.default_sqrt_info(
        jnp.asarray(et), cfg)))
    # the negative definite ones fail the factor and take the fallback
    assert (np.asarray(want)[61:80] == fallback[61:80]).all()
