"""The refmath site chains on the CPU: each chain's plain version against
the JAX functions it replaces, bit for bit, and its recorded program (what
``csrc/refmath_sites.cu``'s chain kernel runs) emulated step by step and
held to the plain version.

A chain runs an ordered list of sites and their elementwise glue in one
launch on the card (``kernels/refmath.py::chain``); its plain version is
its body run on tensors, each site's plain arithmetic in order, so it is
the port's unfused code.  The inputs include poses at the gates'
thresholds (the sanity check's speed and acceleration limits, the keyframe
distance and angle) and angles near +-pi.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core import se2 as jse2
from tbv_slam_public_tpu.core.config import OdometryConfig as JOdometryConfig
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.ops import radar as jradar
from tbv_slam_public_torch.core import refmath as plain
from tbv_slam_public_torch.core import se2
from tbv_slam_public_torch.kernels import refmath
from tbv_slam_public_torch.models import loopclosure  # noqa: F401
from tbv_slam_public_torch.models import odometry  # noqa: F401
from tbv_slam_public_torch.models import verification  # noqa: F401
from tbv_slam_public_torch.ops import radar

# one intra-op thread per test worker (the suite runs several on one host)
torch.set_num_threads(1)

OCFG = JOdometryConfig()


def _bits(x):
    x = np.asarray(x)
    return x if x.dtype == bool else x.astype(np.float32).view(np.int32)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _angles(rng, n):
    """Angles over the circle, a third of them within 1e-6 of +-pi."""
    a = rng.uniform(-np.pi, np.pi, n)
    near = rng.uniform(size=n) < 1 / 3
    a[near] = np.sign(a[near]) * (np.pi - rng.uniform(0, 1e-6, near.sum()))
    return a.astype(np.float32)


def _poses(rng, n, scale=20.0):
    p = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    p[:, 2] = _angles(rng, n)
    return p


def _ulps(x, k):
    """x moved by k float32 ulps."""
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf))
    return x


# ---- the odometry frame's pose tail -----------------------------------------

TAIL_OPTS = odometry.pose_tail_options(OCFG)


@jax.jit
def _jax_tail(pose, success, guess, t_prev, tmot_prev, last_kf):
    """The reference's ``odometry_step`` after its registration
    (``tbv_slam_public_tpu/models/odometry.py``), for one sequence."""
    tcur = jnp.where(success, pose, guess)
    tmot_curr = jse2.relative(t_prev, tcur)
    dt = OCFG.sensor_period
    vel = jnp.linalg.norm(tmot_curr[:2]) / dt
    acc = jnp.linalg.norm(tmot_curr[:2] - tmot_prev[:2]) / (dt * dt)
    sane = (vel <= OCFG.vel_limit) & (acc <= OCFG.acc_limit)
    tcur = jnp.where(sane, tcur, guess)
    tmot = jse2.relative(t_prev, tcur)
    diff = jse2.relative(last_kf, tcur)
    fuse = ((jnp.linalg.norm(diff[:2]) > OCFG.min_keyframe_dist)
            | (jnp.abs(diff[2]) > jnp.deg2rad(OCFG.min_keyframe_rot_deg)))
    return tcur, tmot, diff, fuse & success, jse2.rotmat(-last_kf[2])


def _tail_inputs(rng, n):
    """n frames: registered poses, success flags, guesses, previous poses
    and motions, newest keyframes; a quarter put the speed, the
    acceleration, the keyframe distance or its angle within a few ulps of
    its gate."""
    dt = OCFG.sensor_period
    t_prev = _poses(rng, n)
    pose = t_prev.copy()
    pose[:, :2] += rng.normal(size=(n, 2)).astype(np.float32) * 2
    pose[:, 2] = _angles(rng, n)
    tmot_prev = _poses(rng, n, 0.5)
    last_kf = _poses(rng, n)
    success = rng.uniform(size=n) < 0.85
    guess = (pose + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    for i in range(0, n, 4):
        kind, k = (i // 4) % 4, int(rng.integers(-3, 4))
        success[i] = True
        th = np.float32(rng.uniform(-np.pi, np.pi))
        if kind == 0:  # speed at its limit
            r = _ulps(OCFG.vel_limit * dt, k)
            pose[i] = t_prev[i]
            pose[i, :2] += np.float32([np.cos(th), np.sin(th)]) * r
            tmot_prev[i] = 0.0
        elif kind == 1:  # acceleration at its limit
            r = _ulps(OCFG.acc_limit * dt * dt, k)
            pose[i], tmot_prev[i] = t_prev[i], 0.0
            t_prev[i, 2] = 0.0
            pose[i, :2] += np.float32([r, 0.0])
        elif kind == 2:  # keyframe distance at its threshold
            last_kf[i, 2] = 0.0
            pose[i] = last_kf[i]
            pose[i, 0] += _ulps(OCFG.min_keyframe_dist, k)
        else:  # keyframe angle at its threshold, around +-pi too
            last_kf[i, :2] = pose[i, :2]
            a = _ulps(math.radians(OCFG.min_keyframe_rot_deg), k)
            last_kf[i, 2] = np.float32(np.pi - 1e-7) if k % 2 else 0.0
            pose[i, 2] = np.float32(last_kf[i, 2] + a)
    return pose, success, guess, t_prev, tmot_prev, last_kf


def test_pose_tail_bit_equal_to_the_reference():
    """The pose tail's plain version (the odometry step's unfused code) on
    160 frames against the reference's step tail, row by row: Tcurrent,
    Tmot, the constraint, the keyframe decision and the rotation bit-equal,
    with frames on both sides of every gate."""
    rng = np.random.default_rng(130)
    ins = _tail_inputs(rng, 160)
    got = refmath.chain("odometry_pose_tail", *map(torch.as_tensor, ins),
                        **TAIL_OPTS)
    want = [jax.device_get(_jax_tail(*(x[i] for x in ins)))
            for i in range(len(ins[0]))]
    want = tuple(np.stack([w[k] for w in want]) for k in range(5))
    _same(got, want)
    fuse = want[3]
    assert 0 < fuse[2::16].sum() < fuse[2::16].size  # both sides of a gate


def test_pose_tail_equals_the_unfused_step():
    """The chain's plain version is the odometry step's code before the
    chain: ``motion_rates`` and the sites one by one."""
    rng = np.random.default_rng(131)
    pose, success, guess, t_prev, tmot_prev, last_kf = map(
        torch.as_tensor, _tail_inputs(rng, 64))
    got = refmath.chain("odometry_pose_tail", pose, success, guess, t_prev,
                        tmot_prev, last_kf, **TAIL_OPTS)
    tcur = torch.where(success[:, None], pose, guess)
    vel, acc = odometry.motion_rates(se2.relative(t_prev, tcur), tmot_prev,
                                     OCFG.sensor_period)
    sane = (vel <= OCFG.vel_limit) & (acc <= OCFG.acc_limit)
    tcur = torch.where(sane[:, None], tcur, guess)
    diff = se2.relative(last_kf, tcur)
    fuse = ((refmath.norm2(diff[:, :2]) > OCFG.min_keyframe_dist)
            | (torch.abs(diff[:, 2])
               > math.radians(OCFG.min_keyframe_rot_deg))) & success
    _same(got, (tcur, se2.relative(t_prev, tcur), diff, fuse,
                se2.rotmat(-last_kf[:, 2])))


# ---- the frame's two motion compensations -----------------------------------

def _cloud(rng, n):
    xy = (rng.normal(size=(n, 2)) * 40).astype(np.float32)
    k = n // 8  # azimuths at the 1e-5 branch and at +-pi
    xy[:k, 1] = (xy[:k, 0] * rng.uniform(-2e-5, 2e-5, k)).astype(np.float32)
    xy[:k, 0] = np.abs(xy[:k, 0])
    xy[k:2 * k, 0] = -np.abs(xy[k:2 * k, 0])
    xy[k:2 * k, 1] = (xy[k:2 * k, 0] * rng.uniform(-1e-6, 1e-6, k)
                      ).astype(np.float32)
    return xy


@pytest.mark.parametrize("ccw", [False, True])
def test_motion_compensate_pair_bit_equal_to_the_reference(ccw):
    """Both clouds of a frame compensated in one chain against the
    reference's ``motion_compensate`` of each."""
    rng = np.random.default_rng(132 + ccw)
    cloud, peaks = _cloud(rng, 700), _cloud(rng, 300)
    motion = np.float32([0.8, -0.05, rng.uniform(-0.2, 0.2)])
    f = jax.jit(lambda xy, m: jradar.motion_compensate(
        JPointCloud(xy, jnp.ones(xy.shape[0]), jnp.ones(xy.shape[0], bool)),
        m, ccw).xy)
    got = refmath.chain("motion_compensate_pair", torch.as_tensor(cloud),
                        torch.as_tensor(peaks), torch.as_tensor(motion),
                        ccw=ccw)
    _same(got, (f(cloud, motion), f(peaks, motion)))
    one = lambda xy: radar.motion_compensate(
        radar.PointCloud(torch.as_tensor(xy), torch.ones(len(xy)),
                         torch.ones(len(xy), dtype=torch.bool)),
        torch.as_tensor(motion), ccw).xy
    _same(got, (one(cloud), one(peaks)))


# ---- the loop closure's chains ----------------------------------------------

def test_loop_guess_bit_equal_to_the_reference():
    """Taug^-1 * R(yaw) of a candidate wave against the reference's (its
    pairs vmapped)."""
    rng = np.random.default_rng(134)
    taug, yaw = _poses(rng, 96, 5.0), _angles(rng, 96)
    want = jax.jit(jax.vmap(lambda t, y: jse2.compose(
        jse2.inverse(t), jnp.stack([jnp.zeros_like(y), jnp.zeros_like(y),
                                    y], -1))))(taug, yaw)
    got = refmath.chain("loop_guess", torch.as_tensor(taug),
                        torch.as_tensor(yaw))
    _same(got, want)
    rot = torch.stack([torch.zeros(96), torch.zeros(96),
                       torch.as_tensor(yaw)], -1)
    _same(got, se2.compose(se2.inverse(torch.as_tensor(taug)), rot))


def test_local_map_bit_equal_to_the_reference():
    """Each window keyframe's peaks moved into the query's frame
    (relative, then apply) against the reference's ``gather_kf``."""
    rng = np.random.default_rng(135)
    b, k, p = 3, 5, 64
    odom = _poses(rng, 12, 30.0)
    q_idx = np.array([2, 7, 11])
    idxs = np.clip(q_idx[:, None] + np.arange(-2, 3), 0, 11)
    xy = (rng.normal(size=(12, p, 2)) * 30).astype(np.float32)
    want = jax.jit(lambda o, pts, qi, ii: jax.vmap(lambda q, row: jax.vmap(
        lambda i: jse2.apply(jse2.relative(o[q], o[i]), pts[i]))(row))(
        qi, ii))(odom, xy, q_idx, idxs)
    to = torch.as_tensor
    got = refmath.chain("local_map", to(odom)[to(q_idx)][:, None, None],
                        to(odom)[to(idxs)][:, :, None], to(xy)[to(idxs)])
    _same(got, want)
    rel = se2.relative(to(odom)[to(q_idx)][:, None], to(odom)[to(idxs)])
    _same(got, se2.apply(rel, to(xy)[to(idxs)]))
    assert got.shape == (b, k, p, 2)


def test_alignment_apply_bit_equal_to_the_reference():
    """Both clouds of M verification pairs moved by their poses in one
    chain against the reference's ``_transform_cloud`` of each."""
    rng = np.random.default_rng(136)
    m, p = 13, 96
    sp, rp = _poses(rng, m), _poses(rng, m)
    sxy, rxy = ((rng.normal(size=(m, p, 2)) * 30).astype(np.float32)
                for _ in range(2))
    f = jax.jit(jax.vmap(jse2.apply))
    to = torch.as_tensor
    got = refmath.chain("alignment_apply", to(sp)[:, None], to(sxy),
                        to(rp)[:, None], to(rxy))
    _same(got, (f(sp, sxy), f(rp, rxy)))
    _same(got, (se2.apply(to(sp), to(sxy)), se2.apply(to(rp), to(rxy))))


# ---- the recorded programs --------------------------------------------------

_NAMES = {v: k for k, v in refmath._OPCODE.items()}


def _emulate(name, ts, options):
    """The chain kernel's work on CPU tensors, step by step from its
    recorded program and its launch's packed arguments (``csrc/
    refmath_chains.cu``'s ``ChainArgs`` and ``chain_offsets``), each site
    step its per-element plain version, each glue step one float32
    operation."""
    fields, n, outputs = refmath._chain_plan(name, ts, options)
    segs, _, _ = refmath._record(name, options)
    n_in = sum(len(idx) for idx, _, _ in segs)
    dims = refmath.SITE_DIMS
    total, start1, flags = fields[:3]
    ndim = fields[3:3 + refmath.CHAIN_SEGS]
    at = 3 + refmath.CHAIN_SEGS
    shape = [fields[at + dims * g:at + dims * (g + 1)]
             for g in range(refmath.CHAIN_SEGS)]
    at += dims * refmath.CHAIN_SEGS
    stride = [fields[at + (dims + 1) * k:at + (dims + 1) * (k + 1)]
              for k in range(n_in)]
    consts = fields[at + (dims + 1) * n_in:]
    slots = [i for idx, _, _ in segs for i in idx]
    outs = [torch.zeros(math.prod(sh), dtype=torch.bool if b else
                        torch.float32) for sh, b in outputs]
    el = refmath._ELEMENT_PLAIN
    first = 0
    for s, (idx, steps, _) in enumerate(segs):
        lo, hi = (0, start1) if s == 0 else (start1, total)
        m = hi - lo
        li = torch.arange(m)
        outer = dims - ndim[s]
        rest = li.clone()
        off = [torch.zeros(m, dtype=torch.long) for _ in idx]
        for d in range(dims - 1, outer, -1):
            c = rest % shape[s][d]
            rest = rest // shape[s][d]
            for q in range(len(idx)):
                off[q] += c * stride[first + q][d]
        for q in range(len(idx)):
            off[q] += rest * stride[first + q][outer]
        r = {}

        def vec(a, w):
            return torch.stack([r[a + i] for i in range(w)], -1)

        def put(dst, v):
            v = v.reshape(m, -1)
            for i in range(v.shape[1]):
                r[dst + i] = v[:, i]
        for op, dst, a, b, c, k, j, nc in steps:
            name_ = _NAMES[op]
            if name_ in ("load", "load_bool"):
                t = ts[slots[k]]
                o = off[k - first] + j * stride[k][dims]
                flat = torch.as_strided(t, (int(o.max()) + 1,), (1,))
                v = flat[o]
                r[dst] = v.float() if name_ == "load_bool" else v
            elif name_ == "const":
                r[dst] = torch.full((m,), consts[k], dtype=torch.float32)
            elif name_ in ("store", "store_bool"):
                o = outs[k].view(-1)
                o[li * nc + j] = r[a] != 0 if name_ == "store_bool" else r[a]
            elif name_ in ("mul", "sub"):
                r[dst] = {"mul": torch.mul, "sub": torch.sub}[name_](r[a],
                                                                    r[b])
            elif name_ == "neg":
                r[dst] = -r[a]
            elif name_ == "abs":
                r[dst] = r[a].abs()
            elif name_ in ("le", "lt"):
                r[dst] = (r[a] <= r[b] if name_ == "le" else r[a] < r[b]
                          ).float()
            elif name_ in ("and_", "or_"):
                x, y = r[a] != 0, r[b] != 0
                r[dst] = (x & y if name_ == "and_" else x | y).float()
            elif name_ == "where":
                r[dst] = torch.where(r[c] != 0, r[a], r[b])
            elif name_ in ("compose", "relative"):
                put(dst, el[name_](vec(a, 3), vec(b, 3)))
            elif name_ == "inverse":
                put(dst, el[name_](vec(a, 3)))
            elif name_ == "apply":
                put(dst, el[name_](vec(a, 3), vec(b, 2)))
            elif name_ == "rotmat":
                put(dst, el[name_](r[a]))
            elif name_ == "norm2":
                put(dst, el[name_](vec(a, 2)))
            elif name_ == "motion_compensate":
                assert tuple(consts[k:k + 3]) == plain.motion_constants()
                put(dst, el[name_](vec(a, 2), vec(b, 3), ccw=bool(flags & 1)))
            else:
                raise AssertionError(name_)
        first += len(idx)
    return tuple(o.view(sh) for o, (sh, _) in zip(outs, outputs))


def _chain_cases(rng):
    to = torch.as_tensor
    ins = tuple(map(to, _tail_inputs(rng, 48)))
    window = to(_poses(rng, 48 * 4)).reshape(48, 4, 3)
    odom = to(_poses(rng, 9))
    return [
        ("odometry_pose_tail", ins, TAIL_OPTS),
        # the newest keyframe read through the window's strides
        ("odometry_pose_tail", ins[:5] + (window[:, -1],), TAIL_OPTS),
        ("odometry_pose_tail", tuple(x[:1] for x in ins), TAIL_OPTS),
        ("motion_compensate_pair", (to(_cloud(rng, 200)), to(_cloud(rng, 40)),
                                    to(_poses(rng, 1, 0.5)[0])),
         dict(ccw=True)),
        ("loop_guess", (to(_poses(rng, 12)), to(_angles(rng, 12))), {}),
        ("local_map", (odom[[1, 4]][:, None, None],
                       odom[torch.tensor([[0, 1, 2], [3, 4, 5]])][:, :, None],
                       to(rng.normal(size=(2, 3, 16, 2)).astype(np.float32))),
         {}),
        ("alignment_apply", (to(_poses(rng, 3))[:, None],
                             to(rng.normal(size=(3, 20, 2))).float(),
                             to(_poses(rng, 3))[:, None],
                             to(rng.normal(size=(3, 20, 2))).float()), {}),
    ]


def test_every_chain_is_tested():
    assert {c[0] for c in _chain_cases(np.random.default_rng(0))} \
        == set(refmath.CHAINS)


@pytest.mark.parametrize("case", range(7))
def test_recorded_program_equals_the_plain_chain(case):
    """The description the card's launch reads, run step by step on the
    CPU: bit-equal to the chain's plain version (so the kernel, which runs
    the same steps with the same device functions, is held by the card's
    cases to the same bits)."""
    name, ts, opts = _chain_cases(np.random.default_rng(137))[case]
    _same(_emulate(name, ts, opts), refmath.chain(name, *ts, **opts))


def test_chain_launch_arguments_are_small():
    """A launch passes its pointers, 32-bit shapes and strides and the
    body's constants, 128-288 bytes (a chain) and 72-256 bytes (a site)
    against the single site kernel's 432; no description lives on the
    card."""
    sizes = {n: refmath.chain_struct(n).size for n in refmath.CHAIN_KERNELS}
    assert sizes == {"alignment_apply": 184, "local_map": 152,
                     "loop_guess": 128, "motion_compensate_pair": 208,
                     "odometry_pose_tail": 288}
    assert refmath.SITE_ARG_SIZES["compose"] == 104
    assert max(refmath.SITE_ARG_SIZES.values()) == 256
    assert min(refmath.SITE_ARG_SIZES.values()) == 72


def _committed_chains() -> str:
    with open(os.path.join(os.path.dirname(refmath.__file__), os.pardir,
                           "csrc", "refmath_chains.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", refmath.CHAIN_KERNELS)
def test_chain_source_is_current(name):
    """``csrc/refmath_chains.cu`` holds each chain's kernel as its body
    records it now (``scripts/gen_refmath_chains.py`` writes it), and the
    whole file is what the generator makes."""
    text = _committed_chains()
    assert refmath.chain_source(name) in text
    if name == refmath.CHAIN_KERNELS[-1]:
        assert text == refmath.chains_source()
