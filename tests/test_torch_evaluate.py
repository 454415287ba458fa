"""The registration's cost evaluation (``evaluate_cost``,
``sampled_covariance``) and the order in which ``csrc/lm_solve.cu``'s
evaluation entry runs it, on the CPU: the sampled costs pose by pose over one
association set equal the plain version's repeated rows, the cost-only sum
is the cost row of the LM's sums (the entry's tree), the CFEAR feature's
evaluation against the JAX package, and the dispatch.  The entry itself is
held to the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import RegistrationConfig as JRegCfg
from tbv_slam_public_tpu.core.types import Cells as JCells
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.core import refmath as plain
from tbv_slam_public_torch.core.config import (RegistrationConfig, TBVConfig,
                                               VerificationConfig)
from tbv_slam_public_torch.core.types import Cells
from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
from tbv_slam_public_torch.kernels.checks import window_problem
from tbv_slam_public_torch.models import loopclosure as tloop
from tbv_slam_public_torch.models import verification as tverif
from tbv_slam_public_torch.ops import registration as treg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# the sampled covariance's grid (``sampled_covariance``'s defaults)
GRID = (0.4, 0.0043625, 3)


def _cells(prob, side):
    t = lambda k: torch.as_tensor(prob[f"{side}_{k}"])
    return Cells(mean=t("mean"), cov=t("cov"), normal=t("normal"),
                 nsamples=t("nsamples"), planarity=t("planarity"),
                 avg_intensity=torch.zeros_like(t("nsamples")),
                 valid=t("valid"))


def _args(prob):
    t = lambda k: torch.as_tensor(prob[k])
    return (_cells(prob, "src"), t("pose0"), _cells(prob, "tgt"),
            t("tgt_poses"), t("scan_mask"))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("cost,loss,weight_option", [
    ("P2L", "huber", 0), ("P2D", "cauchy", 4), ("P2P", "tukey", 1),
    ("P2L", "combined", 2), ("P2D", "softlone", 3), ("P2P", "none", 0)])
def test_sampled_costs_pose_by_pose_equal_the_repeated_rows(cost, loss,
                                                            weight_option):
    """The plain ``sampled_covariance`` evaluates a row's steps^3 poses as
    steps^3 rows over repeated copies of its sources and associations; the
    same poses evaluated one after another over the one association set
    (the evaluation entry's order, without the copies) give the same costs
    bit for bit, and folding each cost into the fit one fused multiply-add
    at a time, subnormals flushed (as the entry does), gives
    ``refmath.dot``'s fit."""
    prob = window_problem(np.random.default_rng(len(cost) + weight_option),
                          3, 2, 40, 48)
    src, pose, tgt, tposes, smask = _args(prob)
    cfg = RegistrationConfig(cost=cost, loss=loss, loss_limit=0.3,
                             weight_option=weight_option)
    costs, q = treg._sampled_fit_reference(src, pose, tgt, tposes, smask, cfg,
                                           *GRID)
    pinv, offs = treg._quad_fit_pinv(*GRID, torch.device("cpu"))
    assoc = treg._associator(src, tgt, tposes, smask, cfg)(pose, cfg.radius)
    code, lcode = treg.cost_code(cost), treg.loss_code(loss)
    one = torch.stack([treg._cost_only(pose + offs[s], src, assoc, cost=code,
                                       loss=lcode, delta=cfg.loss_limit)
                       for s in range(offs.shape[0])], 1)
    assert torch.equal(_bits(one), _bits(costs))
    fold = torch.zeros_like(q)
    for s in range(offs.shape[0]):  # operands and steps flushed, as dot's
        fold = plain.ftz(plain.fma(plain.ftz(one[:, s:s + 1]),
                                   plain.ftz(pinv[:, s]), fold))
    assert torch.equal(_bits(fold), _bits(q))
    assert (assoc.mask.sum((1, 2)) > 10).all()


@pytest.mark.parametrize("cost", ["P2L", "P2D", "P2P"])
def test_cost_only_is_the_cost_row_of_the_lm_sums(cost):
    """``_cost_only``'s sum over the T x C cells equals the cost row of
    ``_cost_grad_hess``'s sums over the T x C x R leaves (each cell's term
    followed by a zero when R = 2) bit for bit, at every loss: the entry
    sums the cost alone in the LM's tree, whose first level adds the zeros
    exactly."""
    prob = window_problem(np.random.default_rng(7), 4, 3, 37, 41)
    src, pose, tgt, tposes, smask = _args(prob)
    code = treg.cost_code(cost)
    for loss in ("none", "huber", "cauchy", "softlone", "tukey", "combined"):
        cfg = RegistrationConfig(cost=cost, loss=loss, loss_limit=0.3,
                                 weight_option=4)
        assoc = treg._associator(src, tgt, tposes, smask, cfg)(pose,
                                                               cfg.radius)
        kw = dict(cost=code, loss=treg.loss_code(loss), delta=cfg.loss_limit)
        for d in (0.0, 0.05, -0.2):
            theta = pose + torch.tensor([d, -d, d / 10])
            total, _, _ = treg._cost_grad_hess(theta, src, assoc, **kw)
            assert torch.equal(_bits(treg._cost_only(theta, src, assoc, **kw)),
                               _bits(total)), (loss, d)


def test_cfear_feature_evaluation_matches_jax():
    """``evaluate_cost`` at the CFEAR feature's configuration (P2L, Huber,
    uniform weights, radius 2) on M pairs of one target scan each, against
    the JAX package's vmapped over the pairs: the residual counts equal,
    the costs at the present tolerance (rtol 1e-5: the sums over the cells
    add in another order than the reference's)."""
    prob = window_problem(np.random.default_rng(11), 6, 1, 64, 64)
    prob["scan_mask"][:] = True
    src, pose, tgt, tposes, smask = _args(prob)
    cfg = tverif._cfear_eval_cfg(VerificationConfig())
    got_c, got_n = treg.evaluate_cost(src, pose, tgt, tposes, smask, cfg)
    jcfg = JRegCfg(cost=cfg.cost, loss=cfg.loss, loss_limit=cfg.loss_limit,
                   weight_option=cfg.weight_option)
    jc = lambda side: JCells(**{f: jnp.asarray(np.asarray(getattr(
        _cells(prob, side), f))) for f in ("mean", "cov", "normal",
                                           "nsamples", "planarity",
                                           "avg_intensity", "valid")})
    want_c, want_n = jax.vmap(lambda s, p, t, tp, tm: jreg.evaluate_cost(
        s, p, t, tp, tm, jcfg))(jc("src"), jnp.asarray(prob["pose0"]),
                                jc("tgt"), jnp.asarray(prob["tgt_poses"]),
                                jnp.asarray(prob["scan_mask"]))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert (got_n > 10).all()
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5)


def test_a_cpu_tensor_never_reaches_the_evaluation_entry(monkeypatch):
    """On CPU tensors ``evaluate_cost`` and ``sampled_covariance`` (at the
    loop registration's configuration) run their plain versions and never
    the entry; the plain versions refuse any tensor not on the CPU (here a
    meta tensor) outside ``plain_on_card``, and the entry's wrapper refuses
    a CPU tensor: a CUDA tensor goes to the kernel or raises."""
    prob = window_problem(np.random.default_rng(5), 2, 1, 32, 32)
    src, pose, tgt, tposes, smask = _args(prob)
    cfg = tloop._loop_registration_cfg(TBVConfig())

    def refuse(*a, **k):
        raise AssertionError("the evaluation entry ran on a CPU tensor")

    monkeypatch.setattr(lm_kernel, "evaluate", refuse)
    cost, n = treg.evaluate_cost(src, pose, tgt, tposes, smask, cfg)
    cov, convex = treg.sampled_covariance(src, pose, tgt, tposes, smask, cfg,
                                          cost, n)
    assert cost.shape == (2,) and cov.shape == (2, 3, 3)
    assert torch.isfinite(cov).all() and convex.dtype == torch.bool
    monkeypatch.undo()
    meta = lambda x: x.map(lambda v: v.to("meta")) if hasattr(x, "map") \
        else x.to("meta")
    margs = [meta(x) for x in (src, pose, tgt, tposes, smask)]
    with pytest.raises(RuntimeError, match="plain evaluate_cost"):
        treg._evaluate_cost_reference(*margs, cfg)
    with pytest.raises(RuntimeError, match="plain sampled_covariance"):
        treg._sampled_covariance_reference(*margs, cfg, meta(cost), meta(n))
    with pytest.raises(RuntimeError, match="no kernel"):
        lm_kernel.evaluate(
            pose, src.mean, src.normal, src.nsamples, src.planarity,
            src.valid, tposes, tgt.mean, tgt.normal, None, tgt.valid, smask,
            tgt.nsamples, tgt.planarity, cost=treg.COST_P2L,
            loss=treg.LOSS_HUBER,
            delta=0.1, radius=2.0, angle_gate_cos=0.8, weight_option=0,
            regularization=0.01, cov_scale=1.0)


def _jax_covariance(q, final_score, n_res, p2l, cov_scaler):
    """``tbv_slam_public_tpu/ops/registration.py``'s sampled covariance
    after its fit (``sampled_covariance``'s last lines), for one row."""
    h = jnp.asarray([[2 * q[0], q[3], q[5]], [q[3], 2 * q[1], q[4]],
                     [q[5], q[4], 2 * q[2]]])
    convex = jnp.all(jnp.linalg.eigvalsh(h) > 0)
    resid_dim = jnp.where(p2l, 1, 2) * n_res
    denom = jnp.maximum(resid_dim - 3, 1).astype(final_score.dtype)
    hinv = jnp.linalg.inv(h + (~convex) * jnp.eye(3))
    cov = 2.0 * hinv * (final_score / denom) * cov_scaler
    fallback = jnp.diag(jnp.asarray([0.1 ** 2, 0.1 ** 2, 0.01 ** 2],
                                    cov.dtype))
    return jnp.where(convex, cov, fallback), convex


def seeded_hessian_fits(rng, n):
    """Fits q [n, 10] whose Hessians are convex, indefinite, near-singular
    (the smallest eigenvalue within 1e-6 or 1e-7 of the largest's scale, of
    either sign) and general symmetric matrices of any scale (1e-40 to
    1e30, some subnormal entries)."""
    kind = np.arange(n) % 6
    rot = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    s = 10.0 ** rng.uniform(-3, 9, n)
    ev = s[:, None] * rng.uniform(0.01, 1.0, (n, 3))
    ev[kind == 1, 2] *= -1
    for k, eps in ((2, 1e-6), (3, 1e-7)):
        ev[kind == k, 2] = s[kind == k] * rng.uniform(-eps, eps,
                                                      (kind == k).sum())
    h = np.einsum("nij,nj,nkj->nik", rot, ev, rot)
    g = kind >= 4
    h[g] = rng.normal(size=(g.sum(), 3, 3)) * 10.0 ** rng.uniform(
        -40, 30, (g.sum(), 1, 1))
    h = ((h + h.transpose(0, 2, 1)) / 2).astype(np.float32)
    q = rng.normal(size=(n, 10)).astype(np.float32)
    q[:, 0], q[:, 1], q[:, 2] = h[:, 0, 0] / 2, h[:, 1, 1] / 2, h[:, 2, 2] / 2
    q[:, 3], q[:, 4], q[:, 5] = h[:, 0, 1], h[:, 1, 2], h[:, 0, 2]
    return q


def _hold_covariance(q, score, n_res, cost):
    """The port's ``_covariance_from_fit`` against the reference's
    expression on the same fits: covariances bit-equal, flags equal."""
    p2l = cost == treg.COST_P2L
    want = jax.jit(jax.vmap(lambda a, b, c: _jax_covariance(a, b, c, p2l,
                                                           np.float32(4.0))))(
        q, score, n_res)
    got = treg._covariance_from_fit(torch.as_tensor(q), cost,
                                    torch.as_tensor(score),
                                    torch.as_tensor(n_res).long(), 4.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    g, w = got[0].numpy(), np.asarray(want[0])
    same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g)
                                                     & np.isnan(w))
    assert same.all(), np.argwhere(~same.all((1, 2)))[:5].ravel()
    return got[1].numpy()


@pytest.mark.parametrize("cost", [treg.COST_P2L, treg.COST_P2P])
def test_covariance_from_fit_rounds_as_the_reference(cost):
    """``_covariance_from_fit`` (the eigenvalue decision and the guarded
    inverse written out as jaxlib's LAPACK computes them) against the
    reference's expression on the same fits: 10,000 seeded Hessians,
    convex, indefinite, near-singular and general; the covariances bit for
    bit and the convexity flags equal.  The eigenvalues themselves equal
    ``jnp.linalg.eigvalsh``'s, and the inverse ``jnp.linalg.inv``'s."""
    rng = np.random.default_rng(40 + cost)
    n = 10000
    q = seeded_hessian_fits(rng, n)
    score = rng.uniform(0.0, 100.0, n).astype(np.float32)
    n_res = rng.integers(0, 400, n).astype(np.int32)
    flags = _hold_covariance(q, score, n_res, cost)
    assert 0.2 < flags.mean() < 0.8
    hs = np.stack([np.stack([2 * q[:, 0], q[:, 3], q[:, 5]], -1),
                   np.stack([q[:, 3], 2 * q[:, 1], q[:, 4]], -1),
                   np.stack([q[:, 5], q[:, 4], 2 * q[:, 2]], -1)], -2)
    want = np.asarray(jax.jit(jax.vmap(jnp.linalg.eigvalsh))(hs))
    got = plain.eigvalsh3(torch.as_tensor(hs)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (
        (got == 0) & (want == 0)) | (np.isnan(got) & np.isnan(want))
    assert same.all()
    want = np.asarray(jax.jit(jax.vmap(jnp.linalg.inv))(hs))
    got = plain.inv3(torch.as_tensor(hs)).numpy()
    assert ((got.view(np.int32) == want.view(np.int32))
            | (np.isnan(got) & np.isnan(want))).all()


def test_covariance_of_the_held_wave_rounds_as_the_reference():
    """The fits of ``tests/test_torch_refmath.py``'s held wave (64 loop
    pairs of simulated keyframes, P2L, the plain sampled costs and fit):
    their covariances bit-equal to the reference's expression on the same
    fits, and the same convexity flags."""
    from tbv_slam_public_tpu.core.config import FeatureConfig as JFC
    from tbv_slam_public_tpu.core.config import RadarConfig as JRC
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import features as jfeat
    from tbv_slam_public_tpu.ops import radar as jradar
    from tbv_slam_public_torch.io.convert import cells_from_numpy

    seq = simulate.make_sequence(
        num_frames=3, seed=1, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7, laps=0.12))
    rc = JRC(num_azimuths=200, num_range_bins=256, range_res=0.3,
             k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = JFC(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    jc = [jfeat.compute_cells(jradar.kstrongest_filter(jnp.asarray(im),
                                                       rc)[0], fc)
          for im in seq.images[1:]]
    rng = np.random.default_rng(8)
    b = 64
    theta = np.stack([0.7 + rng.uniform(-0.3, 0.3, b),
                      rng.uniform(-0.3, 0.3, b),
                      0.01 + rng.uniform(-0.02, 0.02, b)],
                     -1).astype(np.float32)
    score = rng.uniform(1.0, 50.0, b).astype(np.float32)
    n_res = rng.integers(20, 200, b).astype(np.int32)
    fields = ("mean", "cov", "normal", "nsamples", "planarity",
              "avg_intensity", "valid")
    to_t = lambda c: cells_from_numpy({f: np.array(getattr(c, f))
                                       for f in fields})
    ts = to_t(jc[1]).map(lambda x: x[None].expand((b,) + x.shape))
    tt = to_t(jc[0]).map(lambda x: x[None, None].expand((b, 1) + x.shape))
    _, q = treg._sampled_fit_reference(
        ts, torch.as_tensor(theta), tt, torch.zeros(b, 1, 3),
        torch.ones(b, 1, dtype=torch.bool), RegistrationConfig(cost="P2L"),
        *GRID)
    flags = _hold_covariance(q.numpy(), score, n_res, treg.COST_P2L)
    assert flags.any()
