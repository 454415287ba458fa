"""The registration's LM solve (``ops/registration.py::_lm_solve``) on the
CPU: the reduction order of its CUDA kernel (``csrc/lm_solve.cu``), the
plain version against the JAX package's solve, the written-out prior terms,
and the dispatch.  The kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.types import Cells as JCells
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
from tbv_slam_public_torch.kernels.checks import lm_problem
from tbv_slam_public_torch.ops import registration as treg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

F32 = np.float32
THREADS = 256  # the kernel's CTA
COSTS = ("P2L", "P2P", "P2D")
LOSSES = ("none", "huber", "cauchy", "softlone", "tukey", "combined")


def kernel_tree(x: np.ndarray) -> np.ndarray:
    """Sums over the last axis of float32 [rows, N] in the kernel's
    decomposition: leaves padded with zeros to a power of two W, thread t
    of min(256, W) holding leaves [t L, t L + L) (L = W / threads) and
    reducing them in order with a stack of partial sums (one per level),
    then __shfl_xor_sync levels 1, 2, .., 16 below the thread count, then a
    pairwise tree over the warps' sums."""
    rows, n = x.shape
    w = 1
    while w < n:
        w <<= 1
    nthr = min(THREADS, w)
    run = w // nthr
    leaves = np.zeros((rows, w), F32)
    leaves[:, :n] = x
    leaves = leaves.reshape(rows, nthr, run)
    stack = {}
    for k in range(run):
        v = leaves[:, :, k]
        lvl = 0
        while (k >> lvl) & 1:
            v = (stack[lvl] + v).astype(F32)
            lvl += 1
        stack[lvl] = v
    v = stack[run.bit_length() - 1]
    lanes = np.arange(nthr)
    o = 1
    while o < min(nthr, 32):
        v = (v + v[:, lanes ^ o]).astype(F32)
        o <<= 1
    if nthr > 32:
        v = v[:, ::32]
        while v.shape[1] > 1:
            v = (v[:, 0::2] + v[:, 1::2]).astype(F32)
    return v[:, 0]


@pytest.mark.parametrize("n", [1, 3, 512, 1000, 4096, 5000])
def test_kernel_reduction_tree_is_the_row_sums_tree(n):
    """(a) The kernel's thread / warp / CTA decomposition of the pairwise
    tree is ``_row_sums`` bit for bit, on leaves over 80 decades of
    magnitude with both signs, signed zeros and subnormals, and on rows of
    only -0.0 (which the zero padding turns to +0.0 unless N is a power of
    two)."""
    rng = np.random.default_rng(n)
    rows = 6
    x = (rng.normal(size=(rows, n)) * np.exp(rng.uniform(-40, 40, (rows, n)))
         ).astype(F32)
    pick = rng.uniform(size=(rows, n))
    x[pick < 0.1] = -0.0
    x[(pick >= 0.1) & (pick < 0.2)] = 0.0
    x[(pick >= 0.2) & (pick < 0.3)] = (rng.normal(size=int(
        ((pick >= 0.2) & (pick < 0.3)).sum())) * 1e-40).astype(F32)
    x[1] = np.where(rng.uniform(size=n) < 0.5, -0.0, F32(1e-42))
    x[2] = -0.0
    want = treg._row_sums(torch.as_tensor(x)).numpy()
    got = kernel_tree(x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _port(theta0, src, tm, tn, weight, mask, si, prior, **kw):
    t = torch.as_tensor
    assoc = treg.Associations(t(tm), t(tn), t(weight), t(mask),
                              None if si is None else t(si))
    return treg._lm_solve(t(theta0), SimpleNamespace(mean=t(src)), assoc,
                          prior=None if prior is None else
                          tuple(map(t, prior)), **kw)


def _jax_row(i, theta0, src, tm, tn, weight, mask, si, prior, **kw):
    c = src.shape[1]
    cells = JCells(mean=src[i], cov=np.zeros((c, 2, 2), F32),
                   normal=np.zeros((c, 2), F32), nsamples=np.zeros(c, F32),
                   planarity=np.zeros(c, F32), avg_intensity=np.zeros(c, F32),
                   valid=np.ones(c, bool))
    eye = np.broadcast_to(np.eye(2, dtype=F32), tm.shape[1:3] + (2, 2))
    assoc = jreg.Associations(tgt_mean_w=tm[i], tgt_normal_w=tn[i],
                              tgt_sqrtinfo=eye if si is None else si[i],
                              weight=weight[i], mask=mask[i])
    p = None if prior is None else (prior[0][i], prior[1], prior[2][i])
    return _jax_solve(kw["cost"], kw["loss"], kw["delta"], kw["max_iter"],
                      kw["init_lambda"])(theta0[i], cells, assoc, p)


_JAX = {}


def _jax_solve(cost, loss, delta, max_iter, init_lambda):
    key = (cost, loss, delta, max_iter, init_lambda)
    if key not in _JAX:
        _JAX[key] = jax.jit(lambda th, src, assoc, prior: jreg._lm_solve(
            th, src, assoc, cost=cost, loss=loss, delta=delta,
            max_iter=max_iter, init_lambda=init_lambda, prior=prior))
    return _JAX[key]


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("with_prior", [False, True])
def test_plain_solve_matches_jax(cost, with_prior):
    """(b) The plain ``_lm_solve`` against the JAX package's, every loss, at
    B = 2, T = 2, C = 32, with and without the prior.  Tolerance: the cost,
    gradient and Hessian add their terms in the port's pairwise tree and in
    XLA's reduction order (ROADMAP.md section 3, item 2), so a candidate
    whose cost is within an ulp of the incumbent's may be accepted by one
    and not the other; both solves then end within the LM's own precision
    of one optimum: 1e-4 m and 1e-5 rad, the cost to 1e-4 of itself (the
    tolerances of tests/test_torch_registration.py).  The last relative
    decrease is the one of the last candidate each accepted, which near the
    optimum may be one ulp-sized step in one solve and an earlier step in the
    other (measured here: 8.6e-8 against 6.5e-4): it is held to [0, 1] and
    to 1e-3 absolutely."""
    rng = np.random.default_rng(COSTS.index(cost) * 2 + with_prior)
    prob = lm_problem(rng, 2, 2, 32, cost, with_prior)
    for loss in LOSSES:
        kw = dict(cost=treg.cost_code(cost), loss=treg.loss_code(loss),
                  delta=0.3, max_iter=20, init_lambda=1e-3)
        got = [x.numpy() for x in _port(*prob, **kw)]
        for i in range(2):
            want = [np.asarray(x) for x in _jax_row(i, *prob, **kw)]
            np.testing.assert_allclose(got[0][i, :2], want[0][:2], rtol=0,
                                       atol=1e-4, err_msg=loss)
            np.testing.assert_allclose(got[0][i, 2], want[0][2], rtol=0,
                                       atol=1e-5, err_msg=loss)
            np.testing.assert_allclose(got[1][i], want[1], rtol=1e-4,
                                       err_msg=loss)
            assert 0.0 <= got[2][i] <= 1.0 and 0.0 <= want[2] <= 1.0
            np.testing.assert_allclose(got[2][i], want[2], rtol=0,
                                       atol=1e-3, err_msg=loss)


def test_prior_terms_bit_equal_to_jax():
    """(c) The prior's cost, gradient and Hessian terms, written out one
    fused multiply-add a term in order from zero, bit-equal to the JAX
    package's ``_cost_grad_hess`` with a prior (``sqrt_info @ (theta -
    guess) * pw``, ``Jp.T @ Jp``, ``Jp.T @ pr``) on 256 random priors; every
    association masked, so the residual sums are zeros in any order."""
    rng = np.random.default_rng(11)
    b, c = 256, 8
    theta = rng.normal(size=(b, 3)).astype(F32)
    guess = rng.normal(size=(b, 3)).astype(F32)
    s = rng.normal(size=(3, 3)).astype(F32)
    pw = np.sqrt(rng.integers(1, 600, b)).astype(F32)
    src = rng.normal(size=(b, c, 2)).astype(F32)
    zeros = np.zeros((b, 1, c, 2), F32)
    assoc = treg.Associations(torch.as_tensor(zeros), torch.as_tensor(zeros),
                              torch.zeros(b, 1, c),
                              torch.zeros(b, 1, c, dtype=torch.bool))
    got = treg._cost_grad_hess(
        torch.as_tensor(theta), SimpleNamespace(mean=torch.as_tensor(src)),
        assoc, cost=treg.COST_P2P, loss=treg.LOSS_HUBER, delta=0.1,
        prior=(torch.as_tensor(guess), torch.as_tensor(s),
               torch.as_tensor(pw)))
    fn = jax.jit(partial(jreg._cost_grad_hess, cost=jreg.COST_P2P,
                         loss=jreg.LOSS_HUBER, delta=0.1))
    eye = np.broadcast_to(np.eye(2, dtype=F32), (1, c, 2, 2))
    for i in range(b):
        cells = JCells(mean=src[i], cov=np.zeros((c, 2, 2), F32),
                       normal=np.zeros((c, 2), F32),
                       nsamples=np.zeros(c, F32), planarity=np.zeros(c, F32),
                       avg_intensity=np.zeros(c, F32), valid=np.ones(c, bool))
        ja = jreg.Associations(tgt_mean_w=zeros[i], tgt_normal_w=zeros[i],
                               tgt_sqrtinfo=eye, weight=np.zeros((1, c), F32),
                               mask=np.zeros((1, c), bool))
        want = fn(theta[i], cells, ja, prior=(guess[i], s, pw[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy().view(np.int32),
                                          np.asarray(w).view(np.int32))


def test_loss_constants_are_the_plain_versions():
    """The float32 constants the kernel is given are the ones the plain
    ``_rho_and_weight`` rounds: on squared residuals whose losses use
    them, a float64 evaluation with the constants rounded to float32 gives
    the plain version's rho where no other rounding enters (s on the
    constant's own grid)."""
    for delta in (0.1, 0.3, 1.0, 2.0):
        k = lm_kernel.loss_constants(treg.LOSS_HUBER, delta)
        assert k[0] == float(torch.tensor(delta * delta))
        assert k[1] == float(torch.tensor(2.0 * delta))
        for loss in (treg.LOSS_CAUCHY, treg.LOSS_SOFTLONE, treg.LOSS_TUKEY):
            rb = lm_kernel.loss_constants(loss, delta)[0]
            assert rb == float(torch.tensor(1.0) /
                               torch.tensor(delta * delta))
        # rho of Tukey at s = 0 is b / 3 * (1 - 1), of SoftLOne 2 b (1 - 1)
        # and its weight 1: the constants enter as the plain version's
        s = torch.zeros(1)
        for loss in (treg.LOSS_SOFTLONE, treg.LOSS_TUKEY):
            rho, w = treg._rho_and_weight(s, loss, delta)
            assert float(rho) == 0.0 and float(w) == 1.0


def test_a_cuda_tensor_never_reaches_the_plain_solve():
    """The plain solve refuses any tensor not on the CPU (here a meta
    tensor) outside ``plain_on_card``, and the kernel's wrapper refuses a
    CPU tensor: a CUDA tensor goes to the kernel or raises."""
    prob = lm_problem(np.random.default_rng(5), 1, 1, 8, "P2P", False)
    kw = dict(cost=treg.COST_P2P, loss=treg.LOSS_HUBER, delta=0.1,
              max_iter=2, init_lambda=1e-3)
    t = lambda x: torch.as_tensor(x)
    assoc = treg.Associations(*(t(x).to("meta") for x in prob[2:6]))
    src = SimpleNamespace(mean=t(prob[1]).to("meta"))
    with pytest.raises(RuntimeError, match="plain LM solve"):
        treg._lm_solve_reference(t(prob[0]).to("meta"), src, assoc, **kw)
    with pytest.raises(RuntimeError, match="no kernel"):
        lm_kernel.lm_solve(t(prob[0]), t(prob[1]), t(prob[2]), t(prob[3]),
                           t(prob[4]), t(prob[5]), None, **kw)
    with lm_kernel.plain_on_card():
        assert lm_kernel.plain_on_card_enabled()
    assert not lm_kernel.plain_on_card_enabled()
    # the CPU path is the plain version, and runs
    got = _port(*prob, **kw)
    assert got[0].shape == (1, 3) and torch.isfinite(got[0]).all()
