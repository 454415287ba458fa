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
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.kernels import refmath as trefmath
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
