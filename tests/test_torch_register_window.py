"""``register_window`` as one kernel launch a call (``csrc/lm_solve.cu``) on
the CPU: the decomposition of its sums over a cluster of K CTAs, its
association in the order the kernel runs it, the cluster-size chooser, the
early exit the kernel takes once a row is inactive, and the dispatch.  The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import math

import numpy as np
import pytest
import torch

from tbv_slam_public_torch.core import refmath as plain
from tbv_slam_public_torch.core.config import RegistrationConfig
from tbv_slam_public_torch.core.types import Cells
from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
from tbv_slam_public_torch.kernels.checks import window_problem
from tbv_slam_public_torch.ops import registration as treg

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

F32 = np.float32
THREADS = 256  # the kernel's CTA
CHAINS = 4  # the kernel's independent argmin chains a thread


def cta_tree(leaves: np.ndarray) -> np.ndarray:
    """One CTA's root of float32 [rows, Wk] leaves (Wk a power of two):
    thread t of min(256, Wk) reduces its aligned run of L = Wk / threads
    leaves in order with a stack of partial sums (one a level), then
    __shfl_xor_sync levels 1, 2, .., 16 below the thread count, then a
    pairwise tree over the warps' sums."""
    rows, wk = leaves.shape
    nthr = min(THREADS, wk)
    run = wk // nthr
    x = leaves.reshape(rows, nthr, run)
    stack = {}
    for k in range(run):
        v = x[:, :, k]
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


def cluster_tree(x: np.ndarray, k: int) -> np.ndarray:
    """Sums over the last axis of float32 [rows, N] in the kernel's
    decomposition over a cluster of k CTAs: the leaves padded with zeros to
    a power of two W, CTA r's root over leaves [r W / k, (r + 1) W / k)
    (``cta_tree``), then the top log2 k levels of the pairwise tree over the
    roots, which every CTA adds itself from distributed shared memory."""
    rows, n = x.shape
    w = 1 << max(n - 1, 0).bit_length()
    leaves = np.zeros((rows, w), F32)
    leaves[:, :n] = x
    roots = np.stack([cta_tree(c) for c in np.split(leaves, k, axis=1)], 1)
    while roots.shape[1] > 1:
        roots = (roots[:, 0::2] + roots[:, 1::2]).astype(F32)
    return roots[:, 0]


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_cluster_reduction_tree_is_the_row_sums_tree(k):
    """The kernel's sums over k CTAs a row equal ``_row_sums`` bit for bit
    at every leaf count from 2 to 2^15 (padded widths k to 2^15; the
    chooser keeps at least one leaf a CTA): so the sums, and the solve, do
    not depend on the cluster size.  Leaves spread over 24 binades, signed
    zeros among them (a level past a CTA's root would add a zero and turn
    a -0.0 into +0.0)."""
    rng = np.random.default_rng(k)
    counts = sorted({n for e in range(1, 16) for n in
                     (1 << e, (1 << e) - 1, (1 << e) + 1, 3 << (e - 1))
                     if k <= 1 << max(n - 1, 0).bit_length() <= 1 << 15})
    for n in counts:
        x = (rng.normal(size=(3, n)) * np.exp(rng.uniform(-8, 8, (3, n))))
        x = x.astype(F32)
        x[0] = -0.0
        x[1, ::3] = -0.0
        want = treg._row_sums(torch.as_tensor(x)).numpy()
        got = cluster_tree(x, k)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"N={n}")


def warp_scatter(v: np.ndarray, nthr: int) -> np.ndarray:
    """``csrc/lm_solve.cu``'s ``scatter_level`` on a warp's float32 values
    v [32 lanes, NP sums], NP a power of two <= 32: at lane offset o = 1,
    2, 4, .. a lane keeps half of its sums (the upper half where its bit o
    is set), each its own plus lane ^ o's (or, at o >= nthr, passed on
    unadded), until one is left, which the remaining levels add across the
    lanes.  Returns each lane's one sum [32]."""
    v = v.copy()
    lanes = np.arange(32)
    n, o = v.shape[1], 1
    while n > 1:
        h = n // 2
        up = ((lanes & o) != 0)[:, None]
        mine = np.where(up, v[:, h:n], v[:, :h])
        other = np.where(up, v[:, :h], v[:, h:n])[lanes ^ o]
        v[:, :h] = (mine + other).astype(F32) if o < nthr else \
            np.where(up, other, mine)
        n, o = h, o << 1
    while o < 32:
        if o < nthr:
            v[:, 0] = (v[:, 0] + v[lanes ^ o, 0]).astype(F32)
        o <<= 1
    return v[:, 0]


def scatter_index(lane: int, npad: int) -> int:
    """The sum lane ends with in ``warp_scatter``."""
    idx, h, o = 0, npad // 2, 1
    while h >= 1:
        idx += h if lane & o else 0
        h, o = h // 2, o << 1
    return idx


@pytest.mark.parametrize("npad", [16, 32])
def test_warp_scatter_sums_are_the_butterfly(npad):
    """The scattered warp reduction gives lane l the sum scatter_index(l)
    as the former butterfly (every sum over __shfl_xor_sync levels 1, 2,
    .., 16 below the thread count) gives it to lane 0, bit for bit, at
    every thread count, signed zeros included: the lanes' pairs are the
    tree's and each add is commutative."""
    rng = np.random.default_rng(npad)
    lanes = np.arange(32)
    for nthr in (1, 2, 4, 8, 16, 32, 64, 256):
        for kind in ("random", "zeros"):
            v = (rng.normal(0, 1, (32, npad)) * 10.0 ** rng.integers(
                -30, 30, (32, npad))).astype(F32)
            if kind == "zeros":
                v = np.where(rng.uniform(size=v.shape) < 0.5, F32(-0.0),
                             F32(0.0))
            v[min(nthr, 32):] = 0.0  # lanes past the CTA's threads
            want = v.copy()
            o = 1
            while o < 32:
                if o < nthr:
                    want = (want + want[lanes ^ o]).astype(F32)
                o <<= 1
            got = warp_scatter(v, nthr)
            for lane in range(npad):
                i = scatter_index(lane, npad)
                assert got[lane].view(np.int32) == \
                    want[0, i].view(np.int32), (nthr, kind, lane)
            assert sorted(scatter_index(l, npad) for l in range(npad)) == \
                list(range(npad))


def _cells(prob, side):
    t = lambda k: torch.as_tensor(prob[f"{side}_{k}"])
    return Cells(mean=t("mean"), cov=t("cov"), normal=t("normal"),
                 nsamples=t("nsamples"), planarity=t("planarity"),
                 avg_intensity=torch.zeros_like(t("nsamples")),
                 valid=t("valid"))


def _similarity(x, y):
    mn = np.where(np.isnan(x) | np.isnan(y), F32(np.nan), np.minimum(x, y))
    den = (x + y).astype(F32)
    den = np.where(den < F32(1e-12), F32(1e-12), den)
    return ((F32(2.0) * mn).astype(F32) / den).astype(F32)


def _fma(a, b, c):
    return plain.fma(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(c)).numpy()


def _mul(a, b):
    """refmath.cuh's mul_ftz of flushed operands (core/se2.py::_mul)."""
    return plain.mul(torch.as_tensor(np.asarray(a, F32)),
                     torch.as_tensor(np.asarray(b, F32))).numpy()


def _add(a, b):
    """refmath.cuh's add_ftz (core/se2.py::_add)."""
    f = lambda x: plain.ftz(torch.as_tensor(np.asarray(x, F32)))
    return plain.ftz(f(a) + f(b)).numpy()


def se2_rotated(c, s, vx, vy):
    """refmath.cuh's se2_rotated."""
    return _fma(c, vx, -_mul(s, vy)), _fma(s, vx, _mul(c, vy))


def se2_applied(c, s, px, py, vx, vy):
    """refmath.cuh's se2_applied."""
    x, y = se2_rotated(c, s, vx, vy)
    return _add(x, px), _add(y, py)


def mm2(a0, b0, a1, b1):
    """refmath.cuh's mm2: (0 + a0 b0) + a1 b1, unfused."""
    return ((F32(0) + (a0 * b0).astype(F32)).astype(F32)
            + (a1 * b1).astype(F32)).astype(F32)


def kernel_placement(prob, cost):
    """The target scans placed in the world as ``csrc/lm_solve.cu``'s
    ``associate`` places them inside the launch, in NumPy float32: each
    scan's pose's sine and cosine once, each mean moved (``se2_applied``)
    and its validity and the scan mask as it stages the scan, and for a
    winner its normal rotated and, for P2D, rot cov rot^T's entries 00, 01,
    11 in the kernel's order of ``mm2`` calls.  Here for every cell:
    (means, normals, covariances or None, validity), as
    ``_world_targets_plain`` returns them."""
    poses = prob["tgt_poses"]
    s, c = (x.numpy()[..., None] for x in plain.sincos(
        torch.as_tensor(poses[..., 2])))
    px, py = poses[..., 0:1], poses[..., 1:2]
    mean, normal = prob["tgt_mean"], prob["tgt_normal"]
    mx, my = se2_applied(c, s, px, py, mean[..., 0], mean[..., 1])
    nx, ny = se2_rotated(c, s, normal[..., 0], normal[..., 1])
    valid = prob["tgt_valid"] & prob["scan_mask"][..., None]
    cov = None
    if cost == treg.COST_P2D:
        cv = prob["tgt_cov"].reshape(mean.shape[:-1] + (4,))
        r = [[c, -s], [s, c]]
        m = [[mm2(r[i][0], cv[..., k], r[i][1], cv[..., 2 + k])
              for k in range(2)] for i in range(2)]
        w00 = mm2(m[0][0], r[0][0], m[0][1], r[0][1])
        w01 = mm2(m[0][0], r[1][0], m[0][1], r[1][1])
        w11 = mm2(m[1][0], r[1][0], m[1][1], r[1][1])
        cov = np.stack([np.stack([w00, w01], -1), np.stack([w01, w11], -1)],
                       -2)
    return (np.stack([mx, my], -1), np.stack([nx, ny], -1), cov, valid)


@pytest.mark.parametrize("cost", ["P2L", "P2P", "P2D"])
def test_kernel_target_placement_is_world_targets(cost):
    """The kernel's placement of the target scans in the world
    (``kernel_placement``) equals ``_world_targets_plain`` (the
    ``world_targets`` site's plain version) bit for bit: means, normals,
    validity with the scan mask and, for P2D, the covariance's entries 00,
    01 and 11 (the ones the association reads; 10 is 01 by symmetry of the
    plain product here), on scans with subnormal angles, translations,
    means, normals and covariance entries and with masked-out scans."""
    code = treg.cost_code(cost)
    prob = window_problem(np.random.default_rng(31 + code), 3, 4, 24, 20)
    prob["tgt_poses"][0, 1, 2] = F32(1e-40)
    prob["tgt_poses"][1, 2] = F32([3e-39, -1e-40, -3e-39])
    prob["tgt_mean"][2, 0, :4] = F32([[1e-39, 0.0], [0.0, -2e-40],
                                      [2.0 ** -126, 1e-38], [5e3, -1e-40]])
    prob["tgt_normal"][0, 3, :2] = F32([[1e-40, 1.0], [-1.0, 3e-39]])
    prob["tgt_cov"][1, 1, :2] = F32([[[1e-39, 2e-40], [2e-40, 0.5]],
                                     [[0.25, 1e-38], [1e-38, 3e-39]]])
    got = kernel_placement(prob, code)
    t = lambda k: torch.as_tensor(prob[k])
    want = treg._world_targets_plain(
        t("tgt_poses"), t("tgt_mean"), t("tgt_normal"),
        t("tgt_cov") if code == treg.COST_P2D else None, t("tgt_valid"),
        t("scan_mask"))
    for name, g, w in zip(("mean", "normal", "cov"), got[:3], want[:3]):
        if w is None:
            assert g is None
            continue
        w = w.numpy()
        if name == "cov":  # the entries the kernel computes
            g, w = g[..., [0, 0, 1], [0, 1, 1]], w[..., [0, 0, 1], [0, 1, 1]]
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=name)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    assert (~got[3]).any() and got[3].any()


def kernel_associate(prob, theta, radius, k, cfg):
    """``associate`` as the kernel computes it, in NumPy float32: CTA r of
    the k CTAs of a row computes the associations q = t C + j of its leaves
    (q in [r Q, r Q + Q), Q = W / k / R), a target scan at a time (padded
    to a multiple of 4 invalid targets at the origin); each
    source cell moved by theta (``se2_applied`` / ``se2_rotated``), the
    target scans placed in the world (``kernel_placement``), a loop over
    the target cells in 4 chains (target k in chain k % 4), each keeping
    the first NaN, else the
    first minimum, of where(valid, fma(dy, dy, dx*dx), inf) (the product
    and the sum flushed where subnormal), the chains merged by (NaN first,
    the distance, the index), then the gates and weights of the winner
    (its attributes, products and sums flushed where subnormal)).
    Returns the records
    [B, T, C] (target mean and normal, weight, mask, P2D sqrt-information)
    and which CTA computed each."""
    fma = lambda a, b, c: plain.fma(torch.as_tensor(a), torch.as_tensor(b),
                                    torch.as_tensor(c)).numpy()
    sqrt = lambda x: plain.sqrt(torch.as_tensor(x)).numpy()
    clamp = lambda x, lo: np.where(x < F32(lo), F32(lo), x).astype(F32)
    cost = treg.cost_code(cfg.cost)
    b, t, ct = prob["tgt_valid"].shape
    c = prob["src_valid"].shape[1]
    _, w, r = lm_kernel.row_leaves(t, c, cost)
    qk = w // k // r
    tmw, tnw, tcw, tvalid = kernel_placement(prob, cost)
    # the staged scan padded to a multiple of 4 targets: invalid, at the
    # origin
    ct4 = -(-ct // CHAINS) * CHAINS
    tmw = np.concatenate([tmw, np.zeros((b, t, ct4 - ct, 2), F32)], 2)
    tvalid = np.concatenate([tvalid, np.zeros((b, t, ct4 - ct), bool)], 2)
    r2 = F32(plain.f32_ftz(radius * radius))
    ftz = lambda x: plain.ftz(torch.as_tensor(np.asarray(x, F32))).numpy()
    sqd = lambda ex, ey: fma(ey, ey, ftz(ex * ex))
    gate = F32(math.cos(math.radians(cfg.angle_gate_deg)))
    out = dict(mean=np.zeros((b, t, c, 2), F32), normal=np.zeros(
        (b, t, c, 2), F32), weight=np.zeros((b, t, c), F32),
        mask=np.zeros((b, t, c), bool), si=np.zeros((b, t, c, 2, 2), F32),
        cta=np.full((b, t, c), -1))
    for row in range(b):
        s, co = (x.numpy() for x in plain.sincos(torch.as_tensor(
            theta[row, 2:3])))
        for rank in range(k):
            q0 = rank * qk
            nq = max(0, min(qk, t * c - q0))
            if nq == 0:
                continue
            for scan in range(q0 // c, (q0 + nq - 1) // c + 1):
                q = np.arange(max(q0, scan * c), min(q0 + nq, (scan + 1) * c))
                j = q - scan * c
                ux, uy = (prob["src_mean"][row, j, i] for i in (0, 1))
                vx, vy = (prob["src_normal"][row, j, i] for i in (0, 1))
                wx, wy = se2_applied(co, s, theta[row, 0], theta[row, 1], ux,
                                     uy)
                nwx, nwy = se2_rotated(co, s, vx, vy)
                best = np.full((CHAINS, len(q)), np.inf, F32)
                nn_c = np.full((CHAINS, len(q)), -1)
                for kk in range(ct4):
                    u = kk % CHAINS
                    ex = (wx - tmw[row, scan, kk, 0]).astype(F32)
                    ey = (wy - tmw[row, scan, kk, 1]).astype(F32)
                    d2 = sqd(ex, ey)
                    d2 = np.where(tvalid[row, scan, kk], d2.astype(F32),
                                  F32(np.inf))
                    take = (nn_c[u] < 0) | (~np.isnan(best[u]) & (
                        np.isnan(d2) | (d2 < best[u])))
                    best[u] = np.where(take, d2, best[u])
                    nn_c[u] = np.where(take, kk, nn_c[u])
                bd, nn = best[0], nn_c[0]
                for u in range(1, min(CHAINS, ct)):
                    d, i = best[u], nn_c[u]
                    first = np.where(np.isnan(d), ~np.isnan(bd) | (i < nn),
                                     ~np.isnan(bd) & ((d < bd) | (
                                         (d == bd) & (i < nn))))
                    bd, nn = np.where(first, d, bd), np.where(first, i, nn)
                mq = ftz(tmw[row, scan, nn])
                ex, ey = (wx - mq[:, 0]).astype(F32), (wy - mq[:, 1]).astype(
                    F32)
                inr = (sqd(ex, ey) < r2) & tvalid[row, scan, nn]
                tn = ftz(tnw[row, scan, nn])
                dirs = ftz(ftz((nwx * tn[:, 0]).astype(F32))
                           + ftz((nwy * tn[:, 1]).astype(F32)))
                dirs = np.where(dirs < 0, F32(0), dirs)
                ok = inr & (dirs > gate) & prob["src_valid"][row, j]
                sn = _similarity(prob["src_nsamples"][row, j],
                                 prob["tgt_nsamples"][row, scan, nn])
                sp = _similarity(prob["src_planarity"][row, j],
                                 prob["tgt_planarity"][row, scan, nn])
                wt = {0: np.ones_like(dirs), 1: sn, 2: dirs, 3: sp}.get(
                    cfg.weight_option, ((sn + dirs).astype(F32) + sp))
                o = (row, scan, j)
                out["mean"][o] = mq
                out["normal"][o] = tn
                out["weight"][o] = np.where(ok, wt.astype(F32), F32(0))
                out["mask"][o] = ok
                out["cta"][o] = rank
                if cost == treg.COST_P2D:
                    cv = tcw[row, scan, nn]
                    reg, sc = F32(cfg.regularization), F32(cfg.cov_scale)
                    a = (((reg * F32(1)) + cv[:, 0, 0]).astype(F32) * sc)
                    bb = (((reg * F32(0)) + cv[:, 0, 1]).astype(F32) * sc)
                    cc = (((reg * F32(1)) + cv[:, 1, 1]).astype(F32) * sc)
                    a, bb, cc = (x.astype(F32) for x in (a, bb, cc))
                    det = clamp(fma(a, cc, -(bb * bb)), 1e-20)
                    ia, ic = (cc / det).astype(F32), (a / det).astype(F32)
                    u22 = sqrt(clamp(ic, 1e-20))
                    u12 = (-bb / (det * u22).astype(F32)).astype(F32)
                    u11 = sqrt(clamp(fma(-u12, u12, ia), 1e-20))
                    out["si"][o] = np.stack([np.stack([u11, u12], -1),
                                             np.stack([0 * u11, u22], -1)],
                                            -2)
    return out


@pytest.mark.parametrize("cost,weight_option,k", [
    ("P2P", 4, 8), ("P2L", 4, 2), ("P2D", 4, 4), ("P2P", 0, 1),
    ("P2L", 1, 8), ("P2D", 2, 2), ("P2P", 3, 4)])
def test_kernel_association_is_the_plain_association(cost, weight_option,
                                                      k):
    """The kernel's association (``kernel_associate``: its split over the
    cluster's CTAs and the target scans, its argmin loop, its gates and
    weights in its order of operations) equals the plain ``associate`` bit
    for bit, with every association computed by exactly one CTA; on scans
    with repeated targets (ties), masked-out scans, invalid cells, a
    source cell at NaN and a valid target at NaN (the argmin's first NaN),
    42 targets a scan (the kernel pads them to 44), at both radii of the
    outer loop."""
    rng = np.random.default_rng(weight_option + 10 * k)
    prob = window_problem(rng, 3, 3, 48, 42)
    prob["src_mean"][0, 5] = np.nan
    prob["tgt_mean"][2, 1, 7] = np.nan
    prob["tgt_valid"][2, 1, 7] = True
    cfg = RegistrationConfig(cost=cost, weight_option=weight_option,
                             regularization=0.03, cov_scale=1.5)
    make = treg._associator(_cells(prob, "src"), _cells(prob, "tgt"),
                            torch.as_tensor(prob["tgt_poses"]),
                            torch.as_tensor(prob["scan_mask"]), cfg)
    theta = prob["pose0"]
    for radius in (2.0 * cfg.radius, cfg.radius):
        want = make(torch.as_tensor(theta), radius)
        got = kernel_associate(prob, theta, radius, k, cfg)
        assert (got["cta"] >= 0).all()
        pairs = [(got["mean"], want.tgt_mean_w), (got["weight"], want.weight),
                 (got["normal"], want.tgt_normal_w)]
        if cost == "P2D":
            pairs.append((got["si"], want.tgt_sqrtinfo))
        for g, w in pairs:
            w = w.numpy()
            same = (g.view(np.int32) == w.view(np.int32)) | \
                (np.isnan(g) & np.isnan(w))
            assert same.all(), int((~same).sum())
        np.testing.assert_array_equal(got["mask"], want.mask.numpy())
        assert got["mask"].sum() > 50


def test_cluster_size_chooser():
    """K CTAs a row: 8 for the odometry's one row and B = 4, for an online
    wave of 12 and ``register_joint``'s 5; 2 for a 64-pair loop wave; 1
    past 132 rows; never more CTAs than association slots; raised until a
    CTA's records fit its shared memory (B = 128 at C = 2048, P2D); and a
    row no cluster holds raises."""
    choose = lm_kernel.cluster_size
    assert choose(1, 4, 512, 512, treg.COST_P2P, True) == 8
    assert choose(4, 4, 512, 512, treg.COST_P2P, True) == 8
    assert choose(12, 1, 512, 512, treg.COST_P2L, True) == 8
    assert choose(5, 5, 512, 512, treg.COST_P2P, False) == 8
    assert choose(64, 1, 512, 512, treg.COST_P2L, True) == 2
    assert choose(200, 1, 512, 512, treg.COST_P2L, True) == 1
    assert choose(1, 1, 2, 2, treg.COST_P2P, True) == 2
    assert choose(1, 1, 1, 1, treg.COST_P2L, True) == 1
    assert choose(128, 4, 2048, 2048, treg.COST_P2D, True) == 2
    for b, t, c, cost in ((1, 4, 512, treg.COST_P2P),
                          (2, 4, 2048, treg.COST_P2D),
                          (64, 4, 2048, treg.COST_P2D)):
        k = choose(b, t, c, c, cost, True)
        assert lm_kernel.shared_bytes(k, t, c, c, cost, True) <= \
            lm_kernel.SHARED_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        choose(1, 64, 4096, 4096, treg.COST_P2D, True)


@pytest.mark.parametrize("cost,prior", [("P2P", False), ("P2L", True),
                                        ("P2D", False)])
def test_an_inactive_row_is_final(cost, prior):
    """Once a row is inactive the plain ``register_window`` changes none of
    its outputs again: rows that stopped before outer iteration n give the
    same pose, score, residual count and iterations bit for bit at
    ``max_outer_iterations`` = n and at 8.  The kernel leaves its outer
    loop there."""
    rng = np.random.default_rng(3)
    prob = window_problem(rng, 6, 3, 64, 64, with_prior=prior)
    t = lambda k: torch.as_tensor(prob[k])
    kw = dict(guess=t("guess"), guess_sqrt_info=t("sqrt_info")) if prior \
        else {}
    run = lambda n: treg.register_window(
        _cells(prob, "src"), t("pose0"), _cells(prob, "tgt"), t("tgt_poses"),
        t("scan_mask"), RegistrationConfig(cost=cost, score_tolerance=1e-3,
                                           max_outer_iterations=n,
                                           max_inner_iterations=8), **kw)
    full = run(8)
    stopped = 0
    for n in (4, 5, 6):
        part = run(n)
        done = part.iterations < n
        stopped += int(done.sum())
        for f in ("pose", "score", "num_residuals", "iterations"):
            g, w = getattr(part, f)[done], getattr(full, f)[done]
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w), f
    assert stopped > 0
    assert (full.iterations > 3).any()


def test_a_cuda_tensor_never_reaches_the_plain_window():
    """The plain ``register_window`` refuses any tensor not on the CPU
    (here a meta tensor) outside ``plain_on_card``, and the kernel's
    wrapper refuses a CPU tensor: a CUDA tensor goes to the kernel or
    raises."""
    prob = window_problem(np.random.default_rng(2), 1, 1, 16, 16)
    meta = lambda cells: cells.map(lambda x: x.to("meta"))
    t = lambda k: torch.as_tensor(prob[k])
    cfg = RegistrationConfig()
    with pytest.raises(RuntimeError, match="plain register_window"):
        treg._register_window_reference(
            meta(_cells(prob, "src")), t("pose0").to("meta"),
            meta(_cells(prob, "tgt")), t("tgt_poses").to("meta"),
            t("scan_mask").to("meta"), cfg)
    src, tgt = _cells(prob, "src"), _cells(prob, "tgt")
    with pytest.raises(RuntimeError, match="no kernel"):
        lm_kernel.register_window(
            t("pose0"), src.mean, src.normal, src.nsamples, src.planarity,
            src.valid, t("tgt_poses"), tgt.mean, tgt.normal, None, tgt.valid,
            t("scan_mask"), tgt.nsamples, tgt.planarity, cost=treg.COST_P2P, loss=treg.LOSS_HUBER,
            delta=0.1, max_inner=2, init_lambda=1e-4, max_outer=2,
            min_outer=1, radius=2.0, angle_gate_cos=0.8, weight_option=4,
            regularization=0.01, cov_scale=1.0, score_tolerance=1e-5)
    # the CPU path is the plain version, and runs
    got = treg.register_window(src, t("pose0"), tgt, t("tgt_poses"),
                               t("scan_mask"), cfg)
    assert got.pose.shape == (1, 3) and torch.isfinite(got.pose).all()
    assert isinstance(got.iterations, torch.Tensor)


def test_launch_plan_reads_broadcast_rows_in_place():
    """The window and evaluation entries' launch plan: the cells' and
    scans' inputs (1-13) are read by row through their batch strides, so a
    row broadcast over the batch (stride 0, the online loop closure's query)
    or a dense row of a wider tensor is passed as it is; a row that is not
    dense, target means whose batch stride is odd (read as float2) and any
    other input that is not contiguous are copied, with the copy's
    stride."""
    rng = np.random.default_rng(9)
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(F32))
    src = t(1, 16, 2).expand(5, 16, 2)  # one query for 5 candidates
    wide = t(5, 40)[:, 4:36].reshape(5, 16, 2)  # dense rows, stride 40
    tmean_odd = t(5, 1 * 8 * 2 + 1)[:, :16].reshape(5, 1, 8, 2)
    ins = [t(5, 3), src, wide, t(16, 5).t(), None, None, None, tmean_odd,
           t(5, 1, 8, 2), None, None, None, None, t(3, 5).t(), None]
    plan = lm_kernel._Plan(ins, [], [], [], torch.device("cpu"), None, "")
    assert plan.copy[:4] == (False, False, False, True)
    assert plan.copy[7] and not plan.copy[8] and plan.copy[13]
    assert plan.strides[:3] == [0, 40, 16]  # src, normal, nsamples (copy)
    assert plan.strides[6] == 16 and plan.strides[7] == 16
