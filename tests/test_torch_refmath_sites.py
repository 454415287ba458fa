"""The refmath kernel's site entries: each site's plain version (the port's
eager body of the site, kernels/refmath.py's ``_PLAIN``) held two ways on
the CPU:

- bit-equal to the op-by-op composition it replaced, written out here as
  the site's body was before it became one launch (``_before_*``), at
  broadcast shapes, strided operands and special values;
- bit-equal to the JAX package's function, where the port already held it
  (``se2``'s functions, ``motion_compensate``, the two-value norm).

The kernel itself is held to these plain versions on the card by the
``cuda`` cases of ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.core import refmath as plain
from tbv_slam_public_torch.core import se2 as tse2
from tbv_slam_public_torch.core.types import Cells
from tbv_slam_public_torch.core.types import PointCloud as TPointCloud
from tbv_slam_public_torch.kernels import refmath
from tbv_slam_public_torch.ops import radar as tradar
from tbv_slam_public_torch.ops import registration as treg

# one intra-op thread per worker process (the suite runs several)
torch.set_num_threads(1)

SPECIAL = np.array([0.0, -0.0, 1e-40, 1.0, -1.0, 0.5, 3.1415927, -3.1415927,
                    1e10, np.inf, -np.inf, np.nan], np.float32)


def _same(got, want):
    """Bit-equal float32 arrays (a NaN equals any NaN), or equal bools."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype != np.float32:
        np.testing.assert_array_equal(got, want)
        return
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), f"{(~same).sum()} of {same.size} values differ"


# ---- the sites' bodies before they were one launch each ------------------
# (with se2's flushes of a subnormal sine, coordinate or angle in its lone
# products and sums, as the reference's DAZ / FTZ threads compute them)

def _mul(a, b):
    return refmath.mul(refmath.ftz(a), refmath.ftz(b))


def _add(a, b):
    return refmath.ftz(refmath.ftz(a) + refmath.ftz(b))


def _before_compose(a, b):
    sa, ca = refmath.sincos(a[..., 2])
    x = refmath.fma(-sa, b[..., 1], refmath.fma(ca, b[..., 0], a[..., 0]))
    y = refmath.fma(ca, b[..., 1], refmath.fma(sa, b[..., 0], a[..., 1]))
    t = refmath.wrap_angle(_add(a[..., 2], b[..., 2]))
    return torch.stack([x, y, t], -1)


def _before_inverse(a):
    s, c = refmath.sincos(a[..., 2])
    x = -refmath.fma(c, a[..., 0], _mul(s, a[..., 1]))
    y = -refmath.fma(c, a[..., 1], -_mul(s, a[..., 0]))
    return torch.stack([x, y, -a[..., 2]], -1)


def _before_rotated(c, s, vx, vy):
    return refmath.fma(c, vx, -_mul(s, vy)), refmath.fma(s, vx, _mul(c, vy))


def _before_apply(pose, points):
    s, c = refmath.sincos(pose[..., 2][..., None])
    x, y = _before_rotated(c, s, points[..., 0], points[..., 1])
    return torch.stack([_add(x, pose[..., 0][..., None]),
                        _add(y, pose[..., 1][..., None])], -1)


def _before_rotate(pose, vecs):
    s, c = refmath.sincos(pose[..., 2][..., None])
    return torch.stack(_before_rotated(c, s, vecs[..., 0], vecs[..., 1]), -1)


def _before_interpolate(a, b, factor):
    f = torch.as_tensor(factor, dtype=a.dtype)
    dt = refmath.wrap_angle(_add(b[..., 2], -a[..., 2]))
    x = refmath.fma(_add(b[..., 0], -a[..., 0]), f, a[..., 0])
    y = refmath.fma(_add(b[..., 1], -a[..., 1]), f, a[..., 1])
    t = refmath.wrap_angle(refmath.fma(dt, f, a[..., 2]))
    return torch.stack([x, y, t], -1)


def _before_rotmat(theta):
    s, c = refmath.sincos(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _before_norm2(v):
    return refmath.sqrt(refmath.fma(v[..., 1], v[..., 1],
                                    v[..., 0] * v[..., 0]))


def _before_world_targets(poses, mean, normal, cov, valid, scan_mask):
    tmw = _before_apply(poses, mean)
    tnw = _before_rotate(poses, normal)
    tcw = None
    if cov is not None:
        rot = _before_rotmat(poses[..., 2])[..., None, :, :]
        tcw = rot @ cov @ rot.transpose(-1, -2)
    return tmw, tnw, tcw, valid & scan_mask[..., None]


def _before_motion_compensate(xy, motion, ccw):
    x, y = xy[..., 0], xy[..., 1]
    ang = refmath.atan2(y, x)
    ang = torch.where(ang > 1e-5, ang, 2.0 * math.pi + ang)
    factor = refmath.fma(ang, torch.full_like(
        ang, plain.recip(2.0 * math.pi)), torch.full_like(ang, -0.5))
    factor = -factor if ccw else factor
    s, c = refmath.sincos(motion[2] * factor)
    nx = refmath.fma(motion[0], factor, refmath.fma(c, x, -(s * y)))
    ny = refmath.fma(motion[1], factor, refmath.fma(s, x, c * y))
    return torch.stack([nx, ny], -1)


# ---- inputs ---------------------------------------------------------------

def _poses(rng, shape, extent=50.0, angle=3.2, special=True):
    p = np.stack([rng.uniform(-extent, extent, shape),
                  rng.uniform(-extent, extent, shape),
                  rng.uniform(-angle, angle, shape)], -1).astype(np.float32)
    if not special:
        return torch.as_tensor(p)
    flat = p.reshape(-1, 3)
    k = min(len(SPECIAL), len(flat))
    flat[:k, 2] = SPECIAL[:k]  # special angles
    flat[k:2 * k, 0] = SPECIAL[:min(k, len(flat) - k)]
    return torch.as_tensor(p)


def _points(rng, shape, extent=80.0):
    return torch.as_tensor(rng.uniform(-extent, extent, shape + (2,))
                           .astype(np.float32))


# pose shapes against pose shapes: equal, broadcast against one pose, a
# column against a row, and a strided slice (kf_poses[:, -1])
POSE_PAIRS = [((300,), (300,)), ((300,), ()), ((4, 1), (1, 60)),
              ((2, 5), (2, 5))]


@pytest.mark.parametrize("site", ["compose", "relative"])
@pytest.mark.parametrize("shapes", POSE_PAIRS, ids=str)
def test_binary_pose_sites_as_before(site, shapes):
    rng = np.random.default_rng(1)
    a, b = _poses(rng, shapes[0]), _poses(rng, shapes[1], 3.0, 0.3)
    before = {"compose": _before_compose,
              "relative": lambda a, b: _before_compose(_before_inverse(a),
                                                       b)}[site]
    _same(getattr(tse2, site)(a, b), before(a, b))
    # a strided operand: the last of a window of poses
    win = _poses(rng, (6, 4))
    _same(getattr(tse2, site)(win[:, -1], win[:, 0]),
          before(win[:, -1], win[:, 0]))


def test_unary_pose_sites_as_before():
    rng = np.random.default_rng(2)
    a = _poses(rng, (7, 50))
    _same(tse2.inverse(a), _before_inverse(a))
    _same(tse2.rotmat(a[..., 2]), _before_rotmat(a[..., 2]))
    _same(tse2.rotmat(-a[:, 0, 2]), _before_rotmat(-a[:, 0, 2]))
    b = _poses(rng, (7, 50), 3.0, 0.5)
    for f in (0.0, 0.37, 1.0, torch.as_tensor(rng.uniform(
            0, 1, (7, 50)).astype(np.float32))):
        _same(tse2.interpolate(a, b, f), _before_interpolate(a, b, f))


@pytest.mark.parametrize("site", ["apply", "rotate"])
@pytest.mark.parametrize("shapes", [((), (500,)), ((3,), (3, 40)),
                                    ((2, 4), (2, 4, 30)), ((5, 1), (5, 3, 8)),
                                    ((2, 3), (3, 16))], ids=str)
def test_point_sites_as_before(site, shapes):
    rng = np.random.default_rng(3)
    pose, pts = _poses(rng, shapes[0]), _points(rng, shapes[1])
    before = {"apply": _before_apply, "rotate": _before_rotate}[site]
    _same(getattr(tse2, site)(pose, pts), before(pose, pts))


def test_norm2_as_before():
    rng = np.random.default_rng(4)
    v = torch.as_tensor(np.concatenate([
        rng.normal(size=(4000, 2)) * np.exp(rng.uniform(-30, 30, (4000, 1))),
        np.stack(np.meshgrid(SPECIAL, SPECIAL), -1).reshape(-1, 2)])
        .astype(np.float32))
    _same(refmath.norm2(v), _before_norm2(v))
    pos = _poses(rng, (64,))
    _same(refmath.norm2(pos[:, :2] - pos[7, :2]),
          _before_norm2(pos[:, :2] - pos[7, :2]))


@pytest.mark.parametrize("p2d", [False, True])
@pytest.mark.parametrize("shape", [(1, 4, 64), (3, 2, 40), (12, 1, 32)],
                         ids=str)
def test_world_targets_as_before(p2d, shape):
    """The scans' targets in the world frame; the covariances (P2D) as
    torch's CPU matrix product rounds ``rot @ cov @ rot^T``, zero and
    negative-zero covariances (invalid cells) included."""
    rng = np.random.default_rng(5)
    b, t, c = shape
    poses = _poses(rng, (b, t))
    mean, normal = _points(rng, shape), _points(rng, shape, 1.0)
    cov = torch.as_tensor((rng.normal(size=shape + (2, 2)) * np.exp(
        rng.uniform(-6, 3, shape + (1, 1)))).astype(np.float32))
    cov[:, :, ::5] = 0.0
    cov[:, :, 1::7] = -0.0
    valid = torch.as_tensor(rng.uniform(size=shape) < 0.8)
    smask = torch.as_tensor(rng.uniform(size=(b, t)) < 0.7)
    cells = Cells(mean=mean, cov=cov, normal=normal,
                  nsamples=torch.ones(shape), planarity=torch.ones(shape),
                  avg_intensity=torch.ones(shape), valid=valid)
    cost = treg.COST_P2D if p2d else treg.cost_code("P2P")
    got = treg._world_targets(cells, poses, smask, cost)
    want = _before_world_targets(poses, mean, normal, cov if p2d else None,
                                 valid, smask)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _same(g, w)


@pytest.mark.parametrize("ccw", [False, True])
def test_motion_compensate_as_before_and_as_the_reference(ccw):
    """The cloud's de-skew: bit-equal to the op-by-op body and to the JAX
    package's ``motion_compensate`` on points over the sensor's disc, near
    the origin and at the special values."""
    rng = np.random.default_rng(6)
    xy = np.concatenate([
        rng.uniform(-80, 80, (3000, 2)), rng.uniform(-1e-4, 1e-4, (200, 2)),
        np.stack(np.meshgrid(SPECIAL, SPECIAL), -1).reshape(-1, 2)]).astype(
        np.float32)
    motion = np.asarray([0.7, -0.05, 0.02], np.float32)
    inten, mask = np.ones(len(xy), np.float32), np.ones(len(xy), bool)
    got = tradar.motion_compensate(TPointCloud(
        *map(torch.as_tensor, (xy, inten, mask))), torch.as_tensor(motion),
        ccw).xy
    _same(got, _before_motion_compensate(torch.as_tensor(xy),
                                         torch.as_tensor(motion), ccw))
    want = jax.jit(lambda c, m: jradar.motion_compensate(c, m, ccw))(
        JPointCloud(xy=xy, intensity=inten, mask=mask), motion)
    _same(got, np.asarray(want.xy))


def test_pose_sites_as_the_reference():
    """se2's sites bit-equal to the JAX package's jitted functions on
    finite poses."""
    rng = np.random.default_rng(7)
    a = _poses(rng, (2000,), special=False)
    b = _poses(rng, (2000,), 3.0, 0.3, special=False)
    pts = _points(rng, (2000, 5))
    an, bn, pn = a.numpy(), b.numpy(), pts.numpy()
    _same(tse2.compose(a, b), jax.jit(jse2.compose)(an, bn))
    _same(tse2.relative(a, b), jax.jit(jse2.relative)(an, bn))
    _same(tse2.inverse(a), jax.jit(jse2.inverse)(an))
    _same(tse2.rotmat(a[:, 2]), jax.jit(jse2.rotmat)(an[:, 2]))
    _same(tse2.apply(a, pts), jax.jit(jax.vmap(jse2.apply))(an, pn))
    _same(tse2.rotate(a, pts), jax.jit(jax.vmap(jse2.rotate))(an, pn))
    _same(tse2.interpolate(a, b, 0.3),
          jax.jit(lambda a, b: jse2.interpolate(a, b, 0.3))(an, bn))
    _same(refmath.norm2(pts),
          jax.jit(lambda v: jnp.linalg.norm(v, axis=-1))(pn))


def test_register_site_refuses_an_unknown_site():
    """Only a site entry of ``csrc/refmath_sites.cu`` can be registered."""
    with pytest.raises(ValueError, match="no site entry"):
        refmath.register_site("no_such_site", lambda x: x,
                              lambda x: ([(x, (), False)], [()], 0, ()))
    assert "no_such_site" not in refmath._PLAIN


def test_blocked_cumsum_as_jnp_cumsum():
    """``refmath.cumsum`` (plain: ``core/refmath.py::blocked_cumsum``)
    bit-equal to the reference's compiled ``jnp.cumsum`` at lengths around
    each level of its blocked order."""
    rng = np.random.default_rng(8)
    f = jax.jit(jnp.cumsum)
    for n in (1, 15, 16, 17, 255, 256, 257, 1000, 4097):
        x = rng.uniform(0.0, 3.0, n).astype(np.float32)
        _same(refmath.cumsum(torch.as_tensor(x)), f(x))


# ---- the site kernels' launch layout -----------------------------------------

def _layout_cases():
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g)
    big = r(6, 40, 5)
    return [
        ("compose", (r(7, 3), r(7, 3)), {}),
        ("compose", (r(1, 3), r(5, 3)), {}),           # a broadcast pose
        ("relative", (big[:, :3, 0], big[:, 1:4, 2]), {}),  # strided views
        ("inverse", (r(3, 4, 3)[:, 1:],), {}),         # an offset view
        ("apply", (r(12, 3), r(12, 33, 2)), {}),       # one pose a cloud
        ("rotate", (r(3), r(50, 2)), {}),
        ("interpolate", (r(4, 3), r(4, 3), r(4)), {}),
        ("rotmat", (r(9)[::2],), {}),
        ("norm2", (r(2, 30, 2).transpose(0, 1),), {}),
        ("world_targets", (r(2, 4, 3), r(2, 4, 9, 2), r(2, 4, 9, 2),
                           r(2, 4, 9, 2, 2), r(2, 4, 9) > 0, r(2, 4) > 0),
         {}),
        ("world_targets", (r(1, 4, 3), r(1, 4, 9, 2), r(1, 4, 9, 2), None,
                           r(1, 4, 9) > 0, r(1, 4) > 0), {}),
        ("motion_compensate", (r(40, 2), r(3)), dict(ccw=True)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_site_launch_layout_reads_every_operand(case):
    """A site's packed launch (``csrc/refmath_sites.cu``'s ``SiteArgs``:
    the merged batch shape and 32-bit strides), its offsets computed as
    the kernel computes them, reads each operand's element at every batch
    index: the operand broadcast over the batch, element by element; the
    packed bytes are the site's struct size."""
    op, ts, opts = _layout_cases()[case]
    # the sites' owners register their layouts
    from tbv_slam_public_torch.ops import radar, registration  # noqa: F401
    layout = refmath._KERNEL_ARGS[op].args[0]
    operands, outs, flags, consts = layout(*ts, **opts)
    batch, n, fields, out_shapes = refmath._site_plan(op, operands, outs,
                                                      flags, consts)
    n_in = refmath.SITE_IO[op][0]
    dims = refmath.SITE_DIMS
    assert fields[0] == n and fields[2] == flags
    ndim, shape = fields[1], fields[3:3 + dims]
    stride = [fields[3 + dims + 6 * k:3 + dims + 6 * (k + 1)]
              for k in range(n_in)]
    i = torch.arange(n)
    outer = dims - ndim
    rest, off = i.clone(), [torch.zeros(n, dtype=torch.long)
                            for _ in range(n_in)]
    for d in range(dims - 1, outer, -1):
        c = rest % shape[d]
        rest = rest // shape[d]
        for k in range(n_in):
            off[k] += c * stride[k][d]
    for k in range(n_in):
        off[k] += rest * stride[k][outer]
    if all(t is None or t.is_contiguous() for t, _, _ in operands) and \
            all(t is None or t.shape[:t.dim() - len(c)] == batch
                for t, c, _ in operands):
        assert ndim == 1  # dense operands: no division
    for k, (t, comp, _) in enumerate(operands):
        if t is None:
            continue
        want = t.expand(batch + comp).reshape((n,) + comp)
        idx = off[k]
        for q, d in enumerate(comp):
            idx = idx[..., None] + torch.arange(d) * stride[k][dims + q]
        base = t.as_strided((t.untyped_storage().nbytes()
                             // t.element_size() - t.storage_offset(),),
                            (1,))
        assert torch.equal(base[idx], want), (op, k)
    args = refmath.SITE_ARGS[op].pack(*([0] * len(operands)),
                                      *([0] * len(outs)), *fields)
    assert len(args) == refmath.SITE_ARG_SIZES[op]
    assert [None if s is None else s[0] for s in out_shapes] == [
        None if o is None else batch + (() if o == "bool" else o)
        for o in outs]
