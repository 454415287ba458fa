"""The reference's float32 math in the port (``core/refmath.py``, the plain
versions of ``csrc/refmath.cu``) against the JAX package's own functions.

Each function is held bit-equal to a function of the JAX package that
computes it in one of its sites, jitted as the package runs it, on 2^20
seeded inputs over the range the sites see and on special values (zeros,
subnormals, infinities, NaN, the range reductions' boundaries): XLA's
inline exp, log and log1p, and the C library's sinf, cosf and atan2f
(glibc 2.36; sinf and cosf in their FMA variant).  Then the sites of the
two other repairs: the sampled covariance's quadratic fit (one fused
multiply-add a sample, as the reference's matrix kernel adds them for a
wave of 64 pairs) and the CorAl radius gate on clouds with neighbours
within an ulp of it.  NaN compares equal to NaN (its payload is not
held).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig,
                                             RegistrationConfig)
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.io import simulate
from tbv_slam_public_tpu.models import strategies as jstrategies
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.ops import features as jfeat
from tbv_slam_public_tpu.ops import logistic as jlogistic
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_tpu.ops import registration as jreg
from tbv_slam_public_torch.core import refmath
from tbv_slam_public_torch.core import se2 as tse2
from tbv_slam_public_torch.core.types import PointCloud as TPointCloud
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.kernels.checks import (REFMATH_SPECIAL,
                                                  lu_systems, on_gate_clouds)
from tbv_slam_public_torch.models import strategies as tstrategies
from tbv_slam_public_torch.ops import coral as tcoral
from tbv_slam_public_torch.ops import logistic as tlogistic
from tbv_slam_public_torch.ops import radar as tradar
from tbv_slam_public_torch.ops import registration as treg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

N = 1 << 20
TINY = np.float32(1e-40)  # subnormal: the reference flushes it
SPECIAL = REFMATH_SPECIAL


def _assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    same = (got.view(np.int32) == want.view(np.int32)) | \
        (np.isnan(got) & np.isnan(want))
    assert same.all(), (int((~same).sum()), np.argwhere(~same)[:5])


def _uniform(rng, lo, hi, n=N):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _logu(rng, lo, hi, n=N):
    return np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.float32)


def test_log_as_the_coral_entropy_computes_it():
    """``_entropy_from_moments`` of two-point neighbourhoods whose
    covariance is diag(a, 1): 0.5 log(2 pi e a + eps) over a in
    [1e-30, 1e30] and at 0, negative, subnormal and infinite a."""
    rng = np.random.default_rng(0)
    a = np.concatenate([_logu(rng, 1e-30, 1e30), _uniform(rng, 0.0, 4.0),
                        SPECIAL, -SPECIAL])
    n = np.full(a.shape, 2.0, np.float32)
    s1 = np.zeros(a.shape + (2,), np.float32)
    s2 = np.zeros(a.shape + (2, 2), np.float32)
    s2[:, 0, 0], s2[:, 1, 1] = a, 1.0
    want = jax.jit(lambda *x: jcoral._entropy_from_moments(*x, 1e-8))(
        n, s1, s2)
    got = tcoral._entropy_from_moments(*map(torch.as_tensor, (n, s1, s2)),
                                       1e-8)
    for g, w in zip(got, want):
        _assert_bits(g.numpy(), w)


def test_log1p_as_the_robust_loss_computes_it():
    """The Cauchy loss of ``_rho_and_weight`` at delta = 1, rho = log1p(s):
    both of XLA's branches (|s| below and above sqrt(2) - 1) and the
    special values (the IRLS weight has no log1p)."""
    rng = np.random.default_rng(2)
    s = np.concatenate([_uniform(rng, -0.99, 0.99), _logu(rng, 1e-30, 1e30),
                        _uniform(rng, 0.4, 0.45, 1 << 16), SPECIAL])
    code = jreg.loss_code("cauchy")
    want = jax.jit(lambda v: jreg._rho_and_weight(v, code, 1.0))(s)
    got = treg._rho_and_weight(torch.as_tensor(s), code, 1.0)
    _assert_bits(got[0].numpy(), want[0])


def test_sqrt_as_the_huber_loss_and_the_p2d_whitening_compute_it():
    """The IEEE square root (torch's vectorised CPU sqrt is not) at two of
    its sites: the default Huber loss, rho (2 delta sqrt(s) - delta^2 in
    one rounding) and the weight delta / sqrt(s), on squared residuals over
    [1e-8, 1e4] and the special values (and the Cauchy loss beside it,
    whose s / delta^2 is a product by the reciprocal); and the P2D
    sqrt-information of regularised 2x2 covariances over five decades of
    scale."""
    rng = np.random.default_rng(12)
    s = np.concatenate([_logu(rng, 1e-8, 1e4), SPECIAL])
    for loss in ("huber", "cauchy"):
        code = jreg.loss_code(loss)
        want = jax.jit(lambda v: jreg._rho_and_weight(v, code, 0.1))(s)
        got = treg._rho_and_weight(torch.as_tensor(s), code, 0.1)
        for g, w in zip(got, want):
            _assert_bits(g.numpy(), w)
    a = rng.normal(size=(1 << 18, 2, 2)) * np.exp(
        rng.uniform(-3, 2, (1 << 18, 1, 1)))
    m = (0.01 * np.eye(2) + a @ a.transpose(0, 2, 1)).astype(np.float32)
    _assert_bits(treg._chol2x2_inv_sqrt(torch.as_tensor(m)).numpy(),
                 jax.jit(jreg._chol2x2_inv_sqrt)(m))


def _lm_body_step(theta, H, g, lam):
    """The first lines of the reference's LM iteration (``_lm_solve``'s
    body): the damped solve and theta + step."""
    damp = lam * jnp.diag(jnp.diagonal(H)) + 1e-12 * jnp.eye(3)
    return theta + (-jreg._solve3x3(H + damp, g))


def test_lm_update_as_the_odometry_step_computes_it():
    """The LM step on damped normal matrices: for one system (the reference
    compiles its unbatched odometry step's solve into scalar code) every
    component bit-equal; vmapped over a batch, x0 and x2 bit-equal and x1
    at most at its measured share (about 8 % of these random systems; its
    fusion was not found)."""
    rng = np.random.default_rng(13)
    n = 2048
    j = rng.normal(size=(n, 8, 3)).astype(np.float32)
    h = np.einsum("nki,nkj->nij", j, j).astype(np.float32)
    g, theta = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    lam = np.exp(rng.uniform(np.log(1e-9), np.log(1e6), n)).astype(
        np.float32)
    th, ht, gt, lt = map(torch.as_tensor, (theta, h, g, lam))
    a = ht + torch.diag_embed(refmath.fma(
        lt[:, None], torch.diagonal(ht, dim1=-2, dim2=-1),
        torch.full_like(gt, 1e-12)))
    one = jax.jit(_lm_body_step)
    want = np.stack([np.asarray(one(theta[i], h[i], g[i], lam[i]))
                     for i in range(n)])
    _assert_bits(refmath.lm_update(th, a, gt, one_system=True).numpy(), want)
    want = np.asarray(jax.jit(jax.vmap(_lm_body_step))(theta, h, g, lam))
    got = refmath.lm_update(th, a, gt).numpy()
    _assert_bits(got[:, 0::2], want[:, 0::2])
    assert (got[:, 1].view(np.int32) != want[:, 1].view(np.int32)).sum() \
        <= 0.09 * n


@pytest.mark.parametrize("k", [7, 4])
def test_loop_dot_as_the_logistic_gradient_adds_it(k):
    """``loop_dot`` bit-equal to the reference's compiled xb^T v, a row of
    k = 7 (the alignment model's six features and the intercept) or 4 (the
    loop model's three) outputs, at every n from 1 to 128 (every remainder
    class of the 2- and 4-accumulator loops, the unrolled chain) and at 13
    rows a training pair up to 120 pairs (the unrolled and the rolled
    loop)."""
    rng = np.random.default_rng(k)
    fn = jax.jit(lambda a, b: a.T @ b)
    ns = list(range(1, 129)) + list(range(13 * 10, 13 * 121, 13 if k == 7
                                          else 130))
    for n in ns:
        x = (rng.normal(size=(n, k)) * np.exp(rng.uniform(-4, 4, (n, 1)))
             ).astype(np.float32)
        v = rng.normal(size=n).astype(np.float32)
        got = refmath.loop_dot(torch.as_tensor(x.T.copy()), torch.as_tensor(v))
        _assert_bits(got.numpy(), fn(x, v))


@pytest.mark.parametrize("k", range(1, 8))
def test_lu_solve_as_jnp_linalg_solve_computes_it(k):
    """``lu_solve`` bit-equal to the reference's ``jnp.linalg.solve`` (on
    the CPU: SciPy's OpenBLAS sgetrf and strsm through jaxlib), a system at
    a time, on 90 systems of each size up to the alignment model's 7: the
    fit's Newton matrices, general matrices that pivot, and matrices with a
    zero column (an unswapped zero pivot: infinities and NaN); the batched
    call gives each system's own bits."""
    h, g = lu_systems(np.random.default_rng(100 + k), 90, k)
    solve = jax.jit(jnp.linalg.solve)
    want = np.stack([np.asarray(solve(a, b)) for a, b in zip(h, g)])
    _assert_bits(refmath.lu_solve(torch.as_tensor(h), torch.as_tensor(g))
                 .numpy(), want)
    _assert_bits(refmath.lu_solve(torch.as_tensor(h[7]), torch.as_tensor(
        g[7])).numpy(), want[7])


def test_lu_solve_refuses_the_sizes_it_does_not_write_out():
    with pytest.raises(ValueError):
        refmath.lu_solve(torch.eye(8), torch.ones(8))
    with pytest.raises(ValueError):
        refmath.lu_solve(torch.eye(3), torch.ones(4))


def test_exp_as_the_odometry_check_computes_it():
    """``verify_by_odometry``'s 1 - exp(-rel^2 / (2 sigma^2)), with the
    exponent in [-ln 2, 0] (where 1 - exp is exact, so every bit of the
    exp shows) and over [-100, 0].  The reference is called as its
    pipeline calls it (``models/strategies.py``, from host code): sigma is
    an operand of its jitted function, so 2 sigma^2 is computed at run time
    and divided by, not folded into a constant's reciprocal as it is when
    sigma is a constant of an enclosing trace."""
    rng = np.random.default_rng(3)
    d = np.concatenate([_uniform(rng, 0.0, 1.0), _uniform(rng, 0.0, 20.0),
                        np.array([0.0, 1e-3, 1e3], np.float32)])
    m = d.shape[0]
    poses = np.zeros((m + 1, 3), np.float32)
    poses[1:, 0] = 5.0 + d  # |p_i - p_0| - 5 = d
    travel = np.concatenate([[0.0], np.full(m, 1.0)]).astype(np.float32)
    ids = np.arange(1, m + 1)
    zeros = np.zeros(m, np.int64)
    want = jstrategies.verify_by_odometry(poses, travel, ids, zeros, 0.6)
    got = tstrategies.verify_by_odometry(
        *map(torch.as_tensor, (poses, travel, ids, zeros)), 0.6)
    _assert_bits(got.numpy(), want)


def test_sigmoid_as_the_logistic_model_computes_it():
    """``predict_proba`` of a one-feature model: 1 / (exp(-z) + 1) over
    z in [-100, 100] and the special values."""
    rng = np.random.default_rng(4)
    x = np.concatenate([_uniform(rng, -100, 100), _uniform(rng, -4, 4),
                        SPECIAL])[:, None]
    model = jlogistic.LogisticModel(intercept=jnp.float32(0.0),
                                    coef=jnp.ones(1, jnp.float32))
    want = jax.jit(jlogistic.predict_proba)(model, x)
    got = tlogistic.predict_proba(tlogistic.LogisticModel(
        torch.tensor(0.0), torch.ones(1)), torch.as_tensor(x))
    _assert_bits(got.numpy(), want)


def test_sin_cos_as_the_pose_algebra_computes_them():
    """``se2.rotmat`` (cos and sin of each angle) over the angles of poses
    and motions, the fast reduction's range (|t| < 120), the large one
    beyond it, and the special values; ``se2.compose`` on pose pairs."""
    rng = np.random.default_rng(5)
    t = np.concatenate([_uniform(rng, -7.0, 7.0), _uniform(rng, -0.02, 0.02),
                        _uniform(rng, -200.0, 200.0, 1 << 17),
                        _logu(rng, 120.0, 1e30, 1 << 16), SPECIAL])
    want = np.asarray(jax.jit(jse2.rotmat)(t))
    _assert_bits(tse2.rotmat(torch.as_tensor(t)).numpy(), want)
    s, c = refmath.sincos(torch.as_tensor(t))
    _assert_bits(c.numpy(), want[:, 0, 0])
    _assert_bits(s.numpy(), want[:, 1, 0])
    a = np.stack([_uniform(rng, -50, 50, 1 << 16), _uniform(rng, -50, 50,
                                                            1 << 16),
                  _uniform(rng, -3.2, 3.2, 1 << 16)], -1)
    b = np.stack([_uniform(rng, -3, 3, 1 << 16), _uniform(rng, -3, 3, 1 << 16),
                  _uniform(rng, -0.2, 0.2, 1 << 16)], -1)
    _assert_bits(tse2.compose(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                 jax.jit(jse2.compose)(a, b))


def test_atan2_as_the_motion_compensation_computes_it():
    """``radar.motion_compensate``: each point's azimuth (atan2), its
    in-sweep time d / (2 pi) - 0.5 (one fused multiply-add by the
    reciprocal), cos and sin of its share of the motion and the moved point,
    on points over the sensor's disc, near the origin, on the axes and at
    the special values."""
    rng = np.random.default_rng(6)
    xy = np.concatenate([
        np.stack([_uniform(rng, -80, 80), _uniform(rng, -80, 80)], -1),
        np.stack([_logu(rng, 1e-30, 1e30, 1 << 16) * np.sign(
            rng.normal(size=1 << 16)).astype(np.float32),
            _logu(rng, 1e-30, 1e30, 1 << 16)], -1),
        np.stack(np.meshgrid(SPECIAL, SPECIAL), -1).reshape(-1, 2)])
    motion = np.asarray([0.7, -0.05, 0.02], np.float32)
    inten = np.ones(len(xy), np.float32)
    mask = np.ones(len(xy), bool)
    for ccw in (False, True):
        want = jax.jit(lambda c, m: jradar.motion_compensate(c, m, ccw))(
            JPointCloud(xy=xy, intensity=inten, mask=mask), motion)
        got = tradar.motion_compensate(TPointCloud(
            *map(torch.as_tensor, (xy, inten, mask))),
            torch.as_tensor(motion), ccw)
        _assert_bits(got.xy.numpy(), np.asarray(want.xy))


def test_wrap_angle_as_the_pose_algebra_computes_it():
    """``se2.wrap_angle``: atan2(sin t, cos t)."""
    rng = np.random.default_rng(7)
    t = np.concatenate([_uniform(rng, -12.0, 12.0), SPECIAL])
    _assert_bits(tse2.wrap_angle(torch.as_tensor(t)).numpy(),
                 jax.jit(jse2.wrap_angle)(t))


CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")


def test_sampled_covariance_fit_of_a_wave():
    """The sampled covariance of a wave of 64 pose pairs, the reference's
    ``sampled_covariance`` vmapped over the wave as its loop closure runs
    it.  Its fit is then one product of the constant f32[10, 27]
    pseudo-inverse and the f32[64, 27] costs (``dot_general`` of
    ``register_and_verify_pairs``), which adds each coefficient's 27 terms
    one fused multiply-add at a time: the port's fit of the same costs is
    bit-equal to that product.  The covariances agree to 1e-3 of their
    scale (measured 2.4e-4) and the convexity flags are equal: the costs
    themselves are summed over the cells in another order than the
    reference's (``ROADMAP.md`` §3)."""
    seq = simulate.make_sequence(
        num_frames=3, seed=1, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7, laps=0.12))
    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    jc = [jfeat.compute_cells(jradar.kstrongest_filter(jnp.asarray(im),
                                                       rc)[0], fc)
          for im in seq.images]
    src, tgt = jc[2], jax.tree.map(lambda x: x[None], jc[1])
    cfg = RegistrationConfig(cost="P2L")
    rng = np.random.default_rng(8)
    b = 64
    theta = np.stack([0.7 + rng.uniform(-0.3, 0.3, b), rng.uniform(-0.3, 0.3,
                                                                   b),
                      0.01 + rng.uniform(-0.02, 0.02, b)],
                     -1).astype(np.float32)
    score = rng.uniform(1.0, 50.0, b).astype(np.float32)
    n_res = rng.integers(20, 200, b).astype(np.int32)
    tposes = np.zeros((1, 3), np.float32)
    want = jax.jit(jax.vmap(lambda th, sc, nr: jreg.sampled_covariance(
        src, th, tgt, jnp.asarray(tposes), jnp.ones(1, bool), cfg, sc, nr)))(
        theta, score, n_res)
    to_t = lambda c: cells_from_numpy(
        {f: np.array(getattr(c, f)) for f in CELL_FIELDS})
    ts = to_t(src).map(lambda x: x[None].expand((b,) + x.shape))
    tt = to_t(jax.tree.map(lambda x: x[0], tgt)).map(
        lambda x: x[None, None].expand((b, 1) + x.shape))
    got = treg.sampled_covariance(
        ts, torch.as_tensor(theta), tt,
        torch.as_tensor(tposes)[None].expand(b, 1, 3),
        torch.ones(b, 1, dtype=torch.bool), cfg, torch.as_tensor(score),
        torch.as_tensor(n_res).long())
    assert bool(np.asarray(want[1]).any())
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    cj = np.asarray(want[0])
    np.testing.assert_allclose(got[0].numpy(), cj, rtol=0,
                               atol=1e-3 * np.abs(cj).max())
    # the fit: the reference's wave product on costs of the wave's scale
    pinv, _ = treg._quad_fit_pinv(0.4, 0.0043625, 3, torch.device("cpu"))
    costs = rng.uniform(0.0, 100.0, (b, 27)).astype(np.float32)
    want_q = jax.jit(lambda c: jax.lax.dot_general(
        jnp.asarray(pinv.numpy()), c, (((1,), (1,)), ((), ()))))(costs)
    _assert_bits(refmath.dot(torch.as_tensor(costs), pinv).numpy().T,
                 want_q)


def test_coral_gate_rounds_as_the_reference_on_the_gate():
    """Counts of the plain CorAl moments on clouds whose neighbours lie
    within an ulp of the radius: bit-equal to the reference's (its
    sum of squares is fma(dy, dy, dx*dx)), on clouds where two roundings
    would have counted differently."""
    rng = np.random.default_rng(9)
    q, p = on_gate_clouds(rng, 4, 256, 1.0)
    mask = np.ones(q.shape[:2], bool)
    rel = p[:, None] - q[:, :, None]
    two_roundings = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
                     <= np.float32(1.0)).sum(-1)
    for i in range(q.shape[0]):
        want = jax.jit(jcoral._neighbor_moments)(q[i], mask[i], p[i],
                                                 mask[i], np.float32(1.0))
        got = tmoments.neighbor_moments_reference(
            *(torch.as_tensor(x[i:i + 1]) for x in (q, mask, p, mask)), 1.0)
        np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        assert (two_roundings[i] != np.asarray(want[0])).any()


def _kernel_gather(layout, ts, n):
    """The values csrc/refmath.cu's strided path reads for each operand:
    value i's index in the 4-d output shape, each input's offset from its
    strides, read from the input's storage."""
    from tbv_slam_public_torch.kernels.refmath import OP_DIMS

    shape = layout[:OP_DIMS]
    out = []
    for k, t in enumerate(ts):
        stride = layout[OP_DIMS * (k + 1):OP_DIMS * (k + 2)]
        i = np.arange(n, dtype=np.int64)
        off = np.zeros(n, np.int64)
        for d in range(OP_DIMS - 1, -1, -1):
            if shape[d] == 1:
                continue
            off += (i % shape[d]) * stride[d]
            i //= shape[d]
        flat = t.as_strided((t.untyped_storage().nbytes() // 4,), (1,), 0)
        out.append(flat.numpy()[t.storage_offset() + off])
    return out


@pytest.mark.parametrize("case", range(8))
def test_op_layout_reads_every_operand_as_broadcast(case):
    """The strided path's description (``kernels/refmath.py::_op_layout``:
    dimensions of one dropped, neighbours merged, broadcast strides 0),
    emulated as the kernel indexes it, reads each operand's values as
    ``torch.broadcast_to`` gives them: transposed, sliced, expanded and
    offset operands of up to 7 dimensions."""
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(case)
    nd = int(rng.integers(1, 8))
    shape = tuple(int(d) for d in rng.integers(1, 5, nd))
    ts = []
    for k in range(int(rng.integers(1, 4))):
        full = torch.as_tensor(rng.normal(size=tuple(
            2 * d + 1 for d in shape)).astype(np.float32))
        t = full[tuple(slice(1, 1 + 2 * d, 2) for d in shape)]
        if k > 0 and nd > 1:  # drop and size-1 some leading dimensions
            keep = int(rng.integers(0, nd))
            t = t[(0,) * keep]
            t = t[tuple(slice(0, 1) if rng.uniform() < 0.4 else slice(None)
                        for _ in range(t.dim()))]
        if t.dim() > 1 and rng.uniform() < 0.5:
            t = t.transpose(0, -1).contiguous().transpose(0, -1)
        ts.append(t)
    out = torch.broadcast_shapes(*(t.shape for t in ts))
    try:
        layout = rm._op_layout(out, ts)
    except ValueError:  # more strided dimensions than the kernel reads
        assert nd > rm.OP_DIMS
        return
    n = int(np.prod(out))
    for t, got in zip(ts, _kernel_gather(layout, ts, n)):
        np.testing.assert_array_equal(
            got, torch.broadcast_to(t, out).reshape(-1).numpy())
