"""Port parity: pose-graph optimization (dense cholesky LM) against JAX."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import PGOConfig
from tbv_slam_public_tpu.eval import trajectory as tj
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.ops import posegraph as jpg
from tbv_slam_public_torch.core.types import GraphEdges
from tbv_slam_public_torch.ops import posegraph as tpg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _instance(n, seed):
    inst = simulate.make_pgo_instance(n, seed=seed)
    m = inst.mask
    return inst, m


@pytest.mark.parametrize("n,seed,line_search", [(120, 0, True),
                                                (300, 1, True),
                                                (120, 2, False)])
def test_cholesky_lm_matches(n, seed, line_search):
    inst, m = _instance(n, seed)
    cfg = dataclasses.replace(PGOConfig(), line_search=line_search)
    si = np.asarray(jpg.default_sqrt_info(jnp.asarray(inst.etype), cfg))
    want = jpg.optimize(jnp.asarray(inst.poses), jnp.ones(n, bool),
                        jpg.make_edges(inst.idx, inst.meas, si, inst.etype,
                                       inst.mask), cfg, solver="cholesky")
    edges = tpg.make_edges(inst.idx[m], inst.meas[m], si[m], inst.etype[m],
                           m[m])
    got = tpg.optimize(torch.as_tensor(inst.poses), torch.ones(
        n, dtype=torch.bool), edges, cfg)
    np.testing.assert_allclose(float(got.cost0), float(want.cost0), rtol=1e-5)
    # float32 normal equations assembled in another order: the optimum to
    # the LM's own tolerance, and the ATE it lands on to 1 cm
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    ate_t = tj.ate_rmse(got.poses.numpy(), inst.gt)
    ate_j = tj.ate_rmse(np.asarray(want.poses), inst.gt)
    assert abs(ate_t - ate_j) < 1e-2, (ate_t, ate_j)
    assert ate_t < tj.ate_rmse(inst.poses, inst.gt)


def test_lago_and_sqrt_info_match(rng):
    inst, m = _instance(200, 3)
    cfg = PGOConfig()
    et = inst.etype[m]
    np.testing.assert_allclose(
        tpg.default_sqrt_info(torch.as_tensor(et), cfg).numpy(),
        np.asarray(jpg.default_sqrt_info(jnp.asarray(et), cfg)), rtol=1e-6)
    a = rng.normal(size=(len(et), 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3)) * 1e-3  # SPD
    cov[0] = 0.0  # degenerate: falls back to the default diagonal
    # bit for bit: jaxlib's LAPACK inverse and Cholesky factor written out
    # (core/refmath.py::measured_sqrt_info)
    np.testing.assert_array_equal(
        tpg.measured_sqrt_info(torch.as_tensor(cov), torch.as_tensor(et),
                               cfg).numpy(),
        np.asarray(jpg.measured_sqrt_info(jnp.asarray(cov), jnp.asarray(et),
                                          cfg)))
    si = np.asarray(jpg.default_sqrt_info(jnp.asarray(et), cfg))
    jedges = jpg.make_edges(inst.idx[m], inst.meas[m], si, et, m[m])
    tedges = tpg.make_edges(inst.idx[m], inst.meas[m], si, et, m[m])
    gauge = np.arange(200) != 0
    want = np.asarray(jpg._lago_initialize(jnp.asarray(inst.poses),
                                           jnp.asarray(gauge), jedges))
    got = tpg._lago_initialize(torch.as_tensor(inst.poses),
                               torch.as_tensor(gauge), tedges).numpy()
    # two dense float32 Laplacian solves of a 200-node chain
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(
        float(tpg.graph_cost(torch.as_tensor(got), tedges, cfg)),
        float(jpg.graph_cost(jnp.asarray(want), jedges, cfg)), rtol=1e-3)


def test_other_solvers_raise():
    """schur without a loop_cap, a loop_cap below the loop count, and an
    unknown solver name are refused; cg needs no extra argument."""
    inst, m = _instance(20, 0)
    edges = tpg.make_edges(inst.idx[m], inst.meas[m], np.ones((m.sum(), 3)),
                           inst.etype[m], m[m])
    run = lambda **kw: tpg.optimize(torch.as_tensor(inst.poses), torch.ones(
        20, dtype=torch.bool), edges, PGOConfig(), **kw)
    with pytest.raises(ValueError, match="requires loop_cap"):
        run(solver="schur")
    with pytest.raises(ValueError, match="loop_cap=0"):
        run(solver="schur", loop_cap=0)
    with pytest.raises(ValueError, match="unknown solver"):
        run(solver="auto")
    assert float(run(solver="cg").cost) <= float(run(solver="cg").cost0)


def test_graph_sums_add_in_index_order():
    """``_GraphSums`` adds each node's values one at a time in index order,
    the begin values first: bit for bit two sequential ``index_add_``, on
    nodes with many edges, one or none, and again with the order kept."""
    rng = np.random.default_rng(3)
    n, e = 40, 300
    idx = torch.as_tensor(rng.integers(0, n - 5, (e, 2)))  # 5 nodes unused
    edges = GraphEdges(idx=idx, meas=None, sqrt_info=None, etype=None,
                       mask=None)
    sums = tpg._GraphSums(n, edges)
    for _ in range(2):
        vb, ve = (torch.as_tensor(rng.normal(size=(e, 3)).astype(np.float32))
                  for _ in range(2))
        want = torch.zeros((n, 3)).index_add_(0, idx[:, 0], vb).index_add_(
            0, idx[:, 1], ve)
        assert torch.equal(sums.nodes(vb, ve), want)
    empty = tpg._GraphSums(n, GraphEdges(idx=idx[:0], meas=None,
                                         sqrt_info=None, etype=None,
                                         mask=None))
    assert torch.equal(empty.nodes(vb[:0], ve[:0]), torch.zeros((n, 3)))
