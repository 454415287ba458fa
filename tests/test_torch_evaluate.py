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
            src.valid, tgt.mean, tgt.normal, None, tgt.valid, tgt.nsamples,
            tgt.planarity, cost=treg.COST_P2L, loss=treg.LOSS_HUBER,
            delta=0.1, radius=2.0, angle_gate_cos=0.8, weight_option=0,
            regularization=0.01, cov_scale=1.0)
