"""Port parity: the structured (schur) and cg pose-graph solvers, the solver
dispatch and ``auto`` against the JAX package, on inputs made from a numpy
seed.  Single solves are compared tightly on the reference's own blocks;
whole optimisations by final cost and poses, since two LM paths part on the
last bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_posegraph import _build_edges, _simulated_loop_graph
from tbv_slam_public_tpu.core.config import PGOConfig, TBVConfig
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import slam as jslam
from tbv_slam_public_tpu.ops import posegraph as jpg
from tbv_slam_public_torch.io import convert
from tbv_slam_public_torch.models import slam as tslam
from tbv_slam_public_torch.ops import posegraph as tpg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.asarray(a))


def _tedges(jedges):
    """The reference's (padded) edge store as the port's record."""
    return convert.edges_from_numpy({
        f: np.asarray(getattr(jedges, f))
        for f in ("idx", "meas", "sqrt_info", "etype", "mask")})


def _chain(rng, n):
    D = np.zeros((n, 3, 3), np.float32)
    O = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        a = rng.normal(size=(3, 3))
        D[i] = a @ a.T + 5 * np.eye(3)
    O[:n - 1] = 0.3 * rng.normal(size=(n - 1, 3, 3))
    T_ = np.zeros((3 * n, 3 * n))
    for i in range(n):
        T_[3 * i:3 * i + 3, 3 * i:3 * i + 3] = D[i]
        if i < n - 1:
            T_[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6] = O[i]
            T_[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = O[i].T
    return D, O, T_


@pytest.mark.parametrize("seg", [4, 8, 16])
def test_partitioned_tridiag_solve_matches(rng, seg):
    n = 32
    D, O, dense = _chain(rng, n)
    b = rng.normal(size=(n, 3, 4)).astype(np.float32)
    want = np.asarray(jpg._partitioned_tridiag_solve(
        jnp.asarray(D), jnp.asarray(O), jnp.asarray(b), seg=seg))
    got = tpg._partitioned_tridiag_solve(T(D), T(O), T(b), seg).numpy()
    # the same float32 algorithm in both packages: 1e-5; against the float64
    # dense solve the reference's own test allows 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        got.reshape(3 * n, 4), np.linalg.solve(dense, b.reshape(3 * n, 4)),
        atol=1e-3)
    with pytest.raises(ValueError, match="multiple of seg"):
        tpg._partitioned_tridiag_solve(T(D[:30]), T(O[:30]), T(b[:30]), seg)


def _linearized(n, seed):
    """One LM linearisation by the reference: padded edges, gauge mask,
    gradient and weighted blocks at the (LAGO-free) initial poses."""
    inst = simulate.make_pgo_instance(n, seed=seed)
    cfg = PGOConfig()
    si = np.asarray(jpg.default_sqrt_info(jnp.asarray(inst.etype), cfg))
    edges = jpg.make_edges(inst.idx, inst.meas, si, inst.etype, inst.mask)
    poses = jnp.asarray(inst.poses)
    gauge = np.arange(n) != 0
    _, g, (wJb, wJe) = jpg._gradient_and_blocks(poses, edges, cfg)
    return inst, cfg, edges, gauge, np.asarray(g), np.asarray(wJb), \
        np.asarray(wJe)


def _dense_step(n, edges, wJb, wJe, gauge, lam_diag, g):
    """float64 solve of the same damped, gauge-fixed normal equations."""
    H = np.zeros((3 * n, 3 * n))
    idx, mask = np.asarray(edges.idx), np.asarray(edges.mask)
    for e in np.nonzero(mask)[0]:
        b, en = idx[e]
        J = np.zeros((3, 3 * n))
        J[:, 3 * b:3 * b + 3] = wJb[e]
        J[:, 3 * en:3 * en + 3] = wJe[e]
        H += J.T @ J
    free = np.repeat(gauge, 3)
    H = H[np.ix_(free, free)] + np.diag(lam_diag.reshape(-1)[free])
    x = np.zeros(3 * n)
    x[free] = np.linalg.solve(H, -g.reshape(-1)[free])
    return x.reshape(n, 3)


@pytest.mark.parametrize("n,seed,lam", [(100, 0, 1e-6), (203, 1, 1e-2)])
def test_schur_step_matches_reference(n, seed, lam):
    """One ``_schur_solve`` on the reference's own (blocks, g, lam): the step
    agrees with the reference's to 1e-4 of its norm and with the float64
    dense solve of the same system to 1e-3 (float32 Woodbury after two
    refinement levels)."""
    inst, cfg, edges, gauge, g, wJb, wJe = _linearized(n, seed)
    hdiag = np.zeros((n, 3), np.float32)
    idx = np.asarray(edges.idx)
    np.add.at(hdiag, idx[:, 0], np.einsum("eri,eri->ei", wJb, wJb))
    np.add.at(hdiag, idx[:, 1], np.einsum("eri,eri->ei", wJe, wJe))
    gm = np.where(gauge[:, None], g, 0.0).astype(np.float32)
    is_loop = np.asarray(edges.mask) & ~(
        (idx[:, 1] == idx[:, 0] + 1) & (np.asarray(edges.etype) == 0))
    loop_idx = np.argsort(~is_loop, kind="stable")[:inst.loop_cap]
    want = np.asarray(jpg._schur_solve(
        n, edges, (jnp.asarray(wJb), jnp.asarray(wJe)), jnp.asarray(gauge),
        jnp.asarray(lam * hdiag), jnp.asarray(gm), jnp.asarray(loop_idx),
        refine_level=cfg.schur_refine, seg_cap=cfg.schur_seg))
    got = tpg._schur_solve(
        n, _tedges(edges), (T(wJb), T(wJe)), T(gauge), T(lam * hdiag), T(gm),
        T(loop_idx), refine_level=cfg.schur_refine,
        seg_cap=cfg.schur_seg).numpy()
    scale = np.linalg.norm(want)
    assert np.linalg.norm(got - want) < 1e-4 * scale
    dense = _dense_step(n, edges, wJb, wJe, gauge, lam * hdiag, g)
    assert np.linalg.norm(got - dense) < 1e-3 * np.linalg.norm(dense)


def test_chain_preconditioner_matches(rng):
    """``_chain_blocks`` + ``_chain_precond_prepare|apply`` on the reference's
    blocks.  The blocks agree to float32 rounding; T^-1 v is ONE unrefined
    float32 solve of a weakly damped chain (condition number ~N^3), so the
    two packages agree to 1e-3 of its norm (seen: 1e-4)."""
    n = 70  # not a multiple of the segment size: exercises the padding
    _, _, edges, gauge, g, wJb, wJe = _linearized(n, 2)
    gb = gauge[np.asarray(edges.idx)]
    wJb = np.where(gb[:, 0, None, None], wJb, 0.0).astype(np.float32)
    wJe = np.where(gb[:, 1, None, None], wJe, 0.0).astype(np.float32)
    jD, jO = jpg._chain_blocks(n, edges, jnp.asarray(wJb), jnp.asarray(wJe),
                               jnp.asarray(gauge))
    tD, tO = tpg._chain_blocks(n, _tedges(edges), T(wJb), T(wJe), T(gauge))
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tO.numpy(), np.asarray(jO), rtol=1e-5,
                               atol=1e-4)
    lam_diag = (1e-3 * np.abs(rng.normal(size=(n, 3)))).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jpg._chain_precond_apply(jpg._chain_precond_prepare(
        jD, jO, jnp.asarray(gauge), jnp.asarray(lam_diag), seg=16),
        jnp.asarray(v)))
    prep = tpg._chain_precond_prepare(T(np.asarray(jD)), T(np.asarray(jO)),
                                      T(gauge), T(lam_diag), seg=16)
    got = tpg._chain_precond_apply(prep, T(v)[:, :, None])[..., 0].numpy()
    assert np.linalg.norm(got - want) < 1e-3 * np.linalg.norm(want)


def test_cg_pieces_match(rng):
    """``_hvp``, ``_block_diag`` and one ``_pcg_solve`` on the reference's
    own Jacobians: products to float32 rounding, the 100-iteration solve to
    1e-3 of its norm."""
    n = 60
    inst, cfg, edges, gauge, g, wJb, wJe = _linearized(n, 3)
    r, Jb, Je = jpg._edge_jacobians(jnp.asarray(inst.poses), edges)
    _, w = jpg._cauchy_weights(r, edges, cfg)
    te = _tedges(edges)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    args_j = (edges, w, Jb, Je, jnp.asarray(gauge))
    args_t = (te, T(w), T(Jb), T(Je), T(gauge))
    want = np.asarray(jpg._hvp(jnp.asarray(v), *args_j))
    np.testing.assert_allclose(tpg._hvp(T(v), *args_t).numpy(), want,
                               rtol=1e-4, atol=1e-3 * np.abs(want).max())
    jdiag = jpg._block_diag(n, edges, (jnp.asarray(wJb), jnp.asarray(wJe)),
                            jnp.asarray(gauge))
    tdiag = tpg._block_diag(n, te, (T(wJb), T(wJe)), T(gauge))
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), rtol=1e-5,
                               atol=1e-3)
    gm = np.where(gauge[:, None], g, 0.0).astype(np.float32)
    want = np.asarray(jpg._pcg_solve(jnp.asarray(gm), *args_j[:4], jdiag,
                                     jnp.asarray(gauge), 1e-4,
                                     cfg.cg_iterations, cfg.cg_tol))
    got = tpg._pcg_solve(T(gm), *args_t[:4], tdiag, T(gauge), 1e-4,
                         cfg.cg_iterations, cfg.cg_tol).numpy()
    assert np.linalg.norm(got - want) < 1e-3 * np.linalg.norm(want)


def _loop_graph(rng, loop_pairs):
    cfg = PGOConfig()
    gt, poses, rels = _simulated_loop_graph(rng)
    n = len(poses)
    jedges = _build_edges(rels, gt, n, cfg, loop_pairs=loop_pairs)
    run = lambda **kw: tpg.optimize(T(poses.astype(np.float32)), torch.ones(
        n, dtype=torch.bool), _tedges(jedges), cfg, **kw)
    return cfg, gt, poses, jedges, run


def test_schur_solver_matches_cholesky(rng):
    """schur == cholesky within the port, at the tolerance of the
    reference's own test (tests/test_posegraph.py:150): cost to 1e-3
    relative, positions to 2 cm; and against the reference's schur run."""
    cfg, gt, poses, jedges, run = _loop_graph(rng, [(0, 39), (3, 36)])
    a = run(solver="cholesky")
    b = run(solver="schur", loop_cap=4)
    assert abs(float(a.cost) - float(b.cost)) < 1e-3 * max(float(a.cost), 1.0)
    np.testing.assert_allclose(a.poses.numpy()[:, :2], b.poses.numpy()[:, :2],
                               atol=0.02)
    want = jpg.optimize(jnp.asarray(poses, jnp.float32), jnp.ones(40, bool),
                        jedges, cfg, solver="schur", loop_cap=4)
    assert abs(float(b.cost) - float(want.cost)) < \
        1e-3 * max(float(want.cost), 1.0)
    np.testing.assert_allclose(b.poses.numpy()[:, :2],
                               np.asarray(want.poses)[:, :2], atol=0.02)


def test_cg_reduces_cost_and_agrees(rng):
    """cg lowers the cost and lands where cholesky does, at the tolerance of
    the reference's test_solvers_agree (cost 1e-2 relative, 5 cm)."""
    cfg, gt, poses, jedges, run = _loop_graph(rng, [(0, 39), (3, 36)])
    a, b = run(solver="cholesky"), run(solver="cg")
    assert float(b.cost) < float(b.cost0)
    assert abs(float(a.cost) - float(b.cost)) < 1e-2 * max(float(a.cost), 1.0)
    np.testing.assert_allclose(a.poses.numpy()[:, :2], b.poses.numpy()[:, :2],
                               atol=0.05)
    err = lambda p: np.linalg.norm(p[:, :2] - gt[:, :2], axis=1).mean()
    assert err(b.poses.numpy()) < 0.5 * err(poses)


def test_schur_loop_cap_guard(rng):
    _, _, _, _, run = _loop_graph(rng, [(0, 39), (3, 36), (5, 34)])
    with pytest.raises(ValueError, match="loop_cap"):
        run(solver="schur", loop_cap=2)
    with pytest.raises(ValueError, match="requires loop_cap"):
        run(solver="schur")


@pytest.mark.parametrize("kind", ["chain_plus_loops", "dense"])
def test_auto_picks_what_the_reference_picks(rng, monkeypatch, kind):
    """The same graph in both packages' PoseGraph: ``auto`` resolves to the
    same solver (schur on a chain with sparse loops, cholesky on a graph
    dense in non-chain edges), and both land on the same cost (1e-3)."""
    gt, poses, rels = _simulated_loop_graph(rng)
    n = len(poses)
    pairs = [(0, n - 1), (3, n - 4)] if kind == "chain_plus_loops" else \
        [(i, j) for i in range(0, n, 4) for j in range(i + 6, n, 5)]
    cfg = TBVConfig()
    jg = jslam.PoseGraph(cfg)
    tg = tslam.PoseGraph(cfg, device="cpu")
    for g in (jg, tg):
        for i in range(n):
            g.add_node(poses[i].astype(np.float32), gt=gt[i])
        for i, rel in enumerate(rels):
            g.add_odometry_constraint(i, i + 1, rel.astype(np.float32))
    from tbv_slam_public_tpu.core import se2 as jse2
    for a, b in pairs:
        t_be = jse2.relative_np(gt[a].astype(np.float32),
                                gt[b].astype(np.float32))
        for g, lc in ((jg, jslam.LoopConstraint), (tg, tslam.LoopConstraint)):
            g.add_loop_constraint(lc(id_from=a, id_to=b, t_be=t_be, prob=1.0))

    seen = {}
    real = jslam.posegraph.optimize

    def spy(*a, solver, **kw):
        seen["solver"] = solver
        return real(*a, solver=solver, **kw)

    monkeypatch.setattr(jslam.posegraph, "optimize", spy)
    want = jg.optimize(solver="auto")
    got = tg.optimize(solver="auto")
    assert tg.last_solver == seen["solver"] == \
        ("schur" if kind == "chain_plus_loops" else "cholesky")
    assert abs(float(got.cost) - float(want.cost)) < \
        1e-3 * max(float(want.cost), 1.0)
    np.testing.assert_allclose(tg.poses_array()[:, :2],
                               jg.poses_array()[:, :2], atol=0.02)
