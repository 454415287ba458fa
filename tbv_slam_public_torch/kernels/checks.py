"""Inputs that hold the hand kernels to their plain versions, shared by
``chip_smoke.py`` and the tests: the value ranges of each refmath op, its
special values, a bit-for-bit comparison, CorAl clouds whose neighbours
lie within an ulp of the radius gate, the logistic fit's Newton systems,
LM-solve problems (and ones that stress the solve's schedule), window
registration problems and the registration configurations that the cost
evaluation is held at.
"""
from __future__ import annotations

import numpy as np

#: each elementwise op of ``csrc/refmath.cu`` and the range its sites see
REFMATH_RANGES = {"exp": (-90.0, 90.0), "log": (1e-3, 1e3),
                  "log1p": (-0.99, 10.0), "sigmoid": (-90.0, 90.0),
                  "sincos": (-200.0, 200.0), "wrap_angle": (-10.0, 10.0),
                  "atan2": (-80.0, 80.0), "sqrt": (0.0, 1e4),
                  "ftz": (-3e-38, 3e-38)}
#: the operands of each op (1 where not listed)
REFMATH_ARITY = {"atan2": 2, "fma": 3, "mul": 2}
#: the ops whose operands span magnitudes 2^-60 to 2^60 (products that
#: overflow, reach the subnormal range or nearly cancel)
REFMATH_SPREAD = ("fma", "mul")
#: every elementwise op of ``csrc/refmath.cu``
REFMATH_OPS = tuple(sorted(REFMATH_RANGES)) + REFMATH_SPREAD
#: operand layouts an op is held at: contiguous and aligned (the vector
#: path), offset by one value (not 16-byte aligned), every second value,
#: and broadcast (a [1] operand against [n], or one value expanded)
REFMATH_LAYOUTS = ("contiguous", "offset", "strided", "broadcast")

#: zeros, subnormals (the reference flushes them), the range reductions'
#: boundaries, large values, infinities and NaN
REFMATH_SPECIAL = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 1.2e-38, 1e-30, -1e-30, 1.0, -1.0, 0.5,
     2.0 ** -12, -(2.0 ** -12), 0.78539813, 0.78539819, -0.78539819,
     119.99999, 120.0, -120.0, 1e10, -1e10, 3.4e38, np.inf, -np.inf, np.nan],
    np.float32)


def op_values(rng, op: str, n: int) -> np.ndarray:
    """n float32 values in op's range (or spread over magnitudes), every
    97th a special value."""
    if op in REFMATH_SPREAD:
        v = rng.normal(size=n) * np.exp(rng.uniform(-42.0, 42.0, n))
    else:
        v = rng.uniform(*REFMATH_RANGES[op], n)
    v = v.astype(np.float32)
    k = len(v[::97])
    v[::97] = np.resize(REFMATH_SPECIAL, k)
    return v


def op_operands(rng, op: str, n: int, layout: str):
    """The operands (CPU float32 tensors) of one call of op at n values in
    ``layout`` (:data:`REFMATH_LAYOUTS`)."""
    import torch

    k = REFMATH_ARITY.get(op, 1)
    if layout == "contiguous":
        return [torch.as_tensor(op_values(rng, op, n)) for _ in range(k)]
    if layout == "offset":
        return [torch.as_tensor(op_values(rng, op, n + 1))[1:]
                for _ in range(k)]
    if layout == "strided":
        return [torch.as_tensor(op_values(rng, op, 2 * n))[::2]
                for _ in range(k)]
    if layout != "broadcast":
        raise ValueError(f"unknown layout {layout!r}")
    if k == 1:
        return [torch.as_tensor(op_values(rng, op, 1)).expand(n)]
    return [torch.as_tensor(op_values(rng, op, n))] + [
        torch.as_tensor(op_values(rng, op, 1)) for _ in range(k - 1)]


def tie_products(rng, n: int):
    """n float32 pairs (a, b), both positive and near 2^-63, whose exact
    product lies strictly inside [2^-126 - 2^-150, 2^-126 - 2^-151): the
    products that the reference's FTZ threads (and mul.rn.ftz) flush and
    gradual underflow rounds up to 2^-126."""
    from fractions import Fraction

    lo = Fraction(2) ** -126 - Fraction(2) ** -150
    hi = Fraction(2) ** -126 - Fraction(2) ** -151
    out = []
    while len(out) < n:
        b = np.float32(np.ldexp(rng.uniform(1.0, 2.0), -63))
        a0 = np.float32(float((lo + hi) / 2 / Fraction(float(b))))
        for a in (a0, np.nextafter(a0, np.float32(0)),
                  np.nextafter(a0, np.float32(1))):
            if lo < Fraction(float(a)) * Fraction(float(b)) < hi:
                out.append((a, b))
                break
    return tuple(np.asarray(x, np.float32) for x in zip(*out))


def bits_differ(a, b) -> int:
    """Values of two float32 arrays or tensors whose bits differ (a NaN
    equals any NaN: its payload is not held), or of two bool or integer
    arrays that differ; a shape mismatch raises."""
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{a.shape} {a.dtype} against {b.shape} {b.dtype}")
    if a.dtype != np.float32:
        return int((a != b).sum())
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    return int((~same).sum())


def cell_gate_cloud(rng, c: int, r: float):
    """A cloud and the centroids of c cells for ``cell_stats`` (xy [P, 2],
    intensity [P], mask [P], centroid [C, 2], occupied [C], float32 and
    bool numpy) in which each cell has 8 neighbours within r / 2 and one
    point within a few ulp of its radius r (``on_gate_clouds``: in half the
    cells the fused and the unfused sum of squares fall on opposite sides of
    r^2), so the gate's rounding decides each cell's statistics; a tenth of
    the points masked out, a few cells unoccupied."""
    q, edge = on_gate_clouds(rng, 1, c, r)
    q, edge = q[0].astype(np.float64), edge[0]
    unset = (q == 0).all(-1)  # slots the search left empty: off the line
    q[unset] = np.stack([3.0 * np.flatnonzero(unset),
                         np.full(unset.sum(), 5.0 * r)], -1)
    edge[unset] = q[unset] + [0.75 * r, 0.0]
    ang = rng.uniform(0, 2 * np.pi, (c, 8))
    rad = rng.uniform(0.05, 0.5, (c, 8)) * r
    inner = q[:, None] + rad[..., None] * np.stack([np.cos(ang),
                                                     np.sin(ang)], -1)
    xy = np.concatenate([inner.reshape(-1, 2), edge]).astype(np.float32)
    p = len(xy)
    intensity = rng.integers(61, 200, p).astype(np.float32)
    mask = rng.uniform(size=p) > 0.1
    mask[8 * c:] = True
    occupied = rng.uniform(size=c) > 0.05
    return xy, intensity, mask, q.astype(np.float32), occupied


def on_gate_clouds(rng, m: int, n: int, r: float):
    """Query and point clouds [m, n, 2]: query k at about (3k, 0), point k
    within a few ulp of the circle of radius r around it, so far from the
    others that each query sees its own point only.  In half the slots the
    fused and the unfused sum of squares fall on opposite sides of r^2."""
    r2 = np.float32(r * r)
    q = np.zeros((m, n, 2), np.float32)
    p = np.zeros((m, n, 2), np.float32)
    split = np.zeros((m, n), bool)
    for _ in range(4000):
        qq = np.stack([3.0 * np.arange(n) + rng.uniform(-1, 1, (m, n)),
                       rng.uniform(-1, 1, (m, n))], -1).astype(np.float32)
        a = rng.uniform(0, 2 * np.pi, (m, n))
        pp = (qq + r * np.stack([np.cos(a), np.sin(a)], -1)).astype(
            np.float32)
        pp += (rng.integers(-3, 4, pp.shape) * np.spacing(pp)).astype(
            np.float32)
        sq = (pp - qq).astype(np.float64) ** 2
        fused = (sq[..., 1] + np.float64(np.float32(sq[..., 0]))).astype(
            np.float32)
        unfused = np.float32(sq[..., 0]) + np.float32(sq[..., 1])
        differ = (fused <= r2) != (unfused <= r2)
        take = (differ & ~split) | ((q == 0).all(-1) & (rng.uniform(
            size=(m, n)) < 0.5))
        take &= (np.arange(n) % 2 == 0)[None] == differ
        q[take], p[take] = qq[take], pp[take]
        split |= take & differ
        if split.sum() >= m * n // 2 and not (q == 0).all(-1).any():
            break
    if split.sum() < m * n // 8:
        raise RuntimeError(f"only {split.sum()} of {m * n} slots split")
    return q, p


def lu_systems(rng, n: int, k: int):
    """n float32 systems (h [n, k, k], g [n, k]) for ``refmath.lu_solve``:
    a third the logistic fit's Newton matrices (xb^T diag(r) xb over 52
    rows of widely scaled features, plus the ridge and 1e-8 I), a third
    general matrices that pivot, a third general with a zero column (a
    zero pivot: the factor stays unswapped and unscaled)."""
    xb = (rng.normal(size=(n, 52, k)) * np.exp(rng.uniform(-3, 3, (n, 1, k)))
          ).astype(np.float32)
    r = np.exp(rng.uniform(-8, 0, (n, 52, 1))).astype(np.float32)
    h = (np.einsum("nri,nrj->nij", xb * r, xb) + np.diag(
        np.r_[0.0, np.ones(k - 1)]) + 1e-8 * np.eye(k)).astype(np.float32)
    general = rng.normal(size=(n, k, k)).astype(np.float32)
    h[n // 3:] = general[n // 3:]
    h[2 * n // 3:, :, rng.integers(0, k)] = 0.0
    g = (10.0 * rng.normal(size=(n, k))).astype(np.float32)
    return h, g


def lu_subnormal_systems(rng, n: int, k: int):
    """n float32 systems (h [n, k, k], g [n, k]) for ``refmath.lu_solve``
    that reach the subnormal range, a fifth of each kind: subnormal entries
    in h; subnormal entries in g; h and g scaled by 1e-19 and 1e-20 (the
    products and the solution subnormal); a first column of subnormals (a
    pivot that a DAZ thread sees as zero); entries spread over e^+-40."""
    h = rng.normal(size=(n, k, k))
    g = rng.normal(size=(n, k))
    kind = np.arange(n) % 5
    tiny = lambda shape: rng.uniform(-1, 1, shape) * 1e-39
    m = (rng.uniform(size=(n, k, k)) < 0.3) & (kind == 0)[:, None, None]
    h[m] = tiny(m.sum())
    m = (rng.uniform(size=(n, k)) < 0.5) & (kind == 1)[:, None]
    g[m] = tiny(m.sum())
    h[kind == 2] *= 1e-19
    g[kind == 2] *= 1e-20
    h[kind == 3, :, 0] = tiny(((kind == 3).sum(), k))
    h[kind == 4] *= np.exp(rng.uniform(-40, 40, ((kind == 4).sum(), k, k)))
    g[kind == 4] *= np.exp(rng.uniform(-40, 40, ((kind == 4).sum(), k)))
    return h.astype(np.float32), g.astype(np.float32)


def ceres_hessians(rng, n: int):
    """Inputs of ``refmath.ceres_covariance`` (h [n, 3, 3], final_score
    [n], n_res [n] int64): symmetric Hessians a fifth each convex (J^T J of
    2-400 residuals), indefinite, near-singular (a rank-2 J^T J plus a
    third eigenvalue of 1e-12, 1e-9, 1.01e-9, 0 or -1e-10), singular (two
    equal columns) and scaled by 1e-36 (subnormal entries), every kind at
    scales 1e-6 to 1e6, with a few NaN and infinite entries; scores with a
    few subnormal ones, residual counts 0-300 (the gate's denominator
    non-positive below 2)."""
    kind = np.arange(n) % 5
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    ev = rng.normal(size=(n, 3)) * 10
    near = np.stack([np.abs(rng.normal(size=n)) * 100,
                     np.abs(rng.normal(size=n)),
                     rng.choice([1e-12, 1e-9, 1.01e-9, 0.0, -1e-10], n)], -1)
    ev = np.where((kind == 2)[:, None], near, ev)
    h = np.einsum("nij,nj,nkj->nik", q, ev, q)
    m = rng.integers(2, 400, n)
    j = rng.normal(size=(n, 400, 3)) * (np.arange(400)[None, :, None]
                                        < m[:, None, None])
    jtj = np.einsum("nki,nkj->nij", j, j)
    h = np.where(np.isin(kind, (0, 3, 4))[:, None, None], jtj, h)
    h[kind == 3, 2] = h[kind == 3, 1]
    h[kind == 3, :, 2] = h[kind == 3, :, 1]
    h = (h + h.transpose(0, 2, 1)) / 2 * 10.0 ** rng.uniform(-6, 6, (n, 1, 1))
    h[kind == 4] *= 1e-36
    h = h.astype(np.float32)
    h[5::101, 0, 0] = np.nan
    h[7::103, 1, 2] = np.inf
    score = rng.uniform(0.01, 50.0, n).astype(np.float32)
    score[::50] = np.float32(1e-39)
    return h, score, rng.integers(0, 300, n).astype(np.int64)


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def lm_problem(rng, b: int, t: int, c: int, cost: str, with_prior: bool):
    """B rows of T x C associations for the LM solve, float32 numpy:
    (theta0 [B, 3], source means [B, C, 2], target means and unit normals
    [B, T, C, 2], weights [B, T, C] (zero where masked), mask [B, T, C]
    (85 % set), P2D sqrt-information [B, T, C, 2, 2] or None, prior (guess
    [B, 3], sqrt_info [3, 3], weight [B]) or None).  The targets are the
    source cells moved by a pose within 0.3 m and 0.02 rad of theta0, with
    5 cm of noise."""
    f32 = np.float32
    theta0 = np.stack([rng.uniform(-0.5, 0.5, b), rng.uniform(-0.5, 0.5, b),
                       rng.uniform(-0.05, 0.05, b)], -1).astype(f32)
    true = theta0 + np.stack([rng.uniform(-0.3, 0.3, b),
                              rng.uniform(-0.3, 0.3, b),
                              rng.uniform(-0.02, 0.02, b)], -1)
    src = rng.uniform(-30, 30, (b, c, 2)).astype(f32)
    world = np.einsum("bij,bcj->bci", _rot(true[:, 2]), src) + \
        true[:, None, :2]
    tm = (world[:, None] + rng.normal(0, 0.05, (b, t, c, 2))).astype(f32)
    ang = rng.uniform(0, 2 * np.pi, (b, t, c))
    tn = np.stack([np.cos(ang), np.sin(ang)], -1).astype(f32)
    mask = rng.uniform(size=(b, t, c)) < 0.85
    weight = np.where(mask, rng.uniform(0.2, 2.5, (b, t, c)), 0.0).astype(f32)
    si = None
    if cost == "P2D":
        si = np.zeros((b, t, c, 2, 2), f32)
        si[..., 0, 0] = rng.uniform(0.5, 3.0, (b, t, c))
        si[..., 1, 1] = rng.uniform(0.5, 3.0, (b, t, c))
        si[..., 0, 1] = rng.uniform(-0.4, 0.4, (b, t, c))
    prior = None
    if with_prior:
        s = np.diag([10.0, 10.0, 31.6]) + rng.uniform(-1, 1, (3, 3))
        prior = ((true + rng.normal(0, 0.02, (b, 3))).astype(f32),
                 s.astype(f32), np.sqrt(mask.sum((1, 2))).astype(f32))
    return theta0, src, tm, tn, weight, mask, si, prior


def schedule_problem(rng, b: int, t: int, c: int, cost: str):
    """``lm_problem`` rows (no prior) that stress the LM solve's schedule:
    the starts moved off by 0.3 to 10 times the problem's spread, so that
    rows accept then reject, reject for long runs and accept after them,
    and the last row with a NaN weight where its mask holds (every cost
    NaN: every candidate rejected)."""
    theta0, src, tm, tn, weight, mask, si, _ = lm_problem(rng, b, t, c,
                                                          cost, False)
    spread = np.geomspace(0.3, 10.0, b)[:, None]
    theta0 = (theta0 + spread * rng.normal(0, 0.3, theta0.shape)
              * np.float32([1.0, 1.0, 0.1])).astype(np.float32)
    weight[-1][mask[-1]] = np.nan
    return theta0, src, tm, tn, weight, mask, si


def pass_slots(pattern: str, k: int):
    """The passes that a serial accept / reject string ("A" accepted, "r"
    rejected, "n" a NaN cost) takes with k candidates a pass: (candidates,
    accepted slot or None) for each pass after the first."""
    out, it = [], 0
    while it < len(pattern):
        nb = min(k, len(pattern) - it)
        run = pattern[it:it + nb]
        j = run.find("A")
        out.append((nb, None if j < 0 else j))
        it += nb if j < 0 else j + 1
    return out


def window_problem(rng, b: int, t: int, c: int, ct: int,
                   with_prior: bool = False):
    """B registration windows, float32 / bool numpy: a dict of the source
    cells ("src_*": mean, cov, normal, nsamples, planarity, valid [B, C]),
    the target scans ("tgt_*" [B, T, Ct]), their poses "tgt_poses"
    [B, T, 3] and "scan_mask" [B, T] (a row's last scan masked out in a
    third of the rows), the start "pose0" [B, 3], and with the prior
    "guess" [B, 3] and "sqrt_info" [3, 3].  Every cell is a point of one
    world cloud seen from its scan's pose with 3-20 cm of noise (more in
    later rows, so rows stop at different outer iterations); 15 % of the
    cells are invalid (zero mean and normal), a few targets are repeated
    (a tie in the nearest-neighbour search), and the start is within
    0.4 m and 0.03 rad of the truth."""
    f32 = np.float32
    world = rng.uniform(-40, 40, (b, max(c, ct) * 2, 2))
    ang = rng.uniform(0, 2 * np.pi, world.shape[:2])
    wnorm = np.stack([np.cos(ang), np.sin(ang)], -1)

    def scans(poses, n, noise):  # poses [B, S, 3] -> cells [B, S, n]
        bs, sc = poses.shape[:2]
        pick = np.stack([rng.choice(world.shape[1], n, replace=False)
                         for _ in range(bs * sc)]).reshape(bs, sc, n)
        pw = np.take_along_axis(world[:, None], pick[..., None], 2)
        nw = np.take_along_axis(wnorm[:, None], pick[..., None], 2)
        pw = pw + rng.normal(0, 1, pw.shape) * noise[:, None, None, None]
        rot = _rot(-poses[..., 2])[:, :, None]  # world -> scan frame
        mean = np.einsum("bsnij,bsnj->bsni", rot, pw - poses[..., None, :2])
        normal = np.einsum("bsnij,bsnj->bsni", rot, nw)
        evals = rng.uniform(0.01, 0.5, (bs, sc, n, 2))
        er = _rot(rng.uniform(0, np.pi, (bs, sc, n)))
        cov = np.einsum("...ij,...j,...kj->...ik", er, evals, er)
        valid = rng.uniform(size=(bs, sc, n)) < 0.85
        mean[~valid] = 0.0
        normal[~valid] = 0.0
        return dict(mean=mean.astype(f32), cov=cov.astype(f32),
                    normal=normal.astype(f32),
                    nsamples=rng.integers(3, 40, (bs, sc, n)).astype(f32),
                    planarity=rng.uniform(0.0, 3.0, (bs, sc, n)).astype(f32),
                    valid=valid)

    noise = np.linspace(0.03, 0.2, b)
    truth = np.stack([rng.uniform(-2, 2, b), rng.uniform(-2, 2, b),
                      rng.uniform(-0.2, 0.2, b)], -1)
    tposes = truth[:, None] + np.stack(
        [rng.uniform(-3, 3, (b, t)), rng.uniform(-3, 3, (b, t)),
         rng.uniform(-0.3, 0.3, (b, t))], -1)
    src = {k: v[:, 0] for k, v in scans(truth[:, None], c, noise).items()}
    tgt = scans(tposes, ct, noise)
    copies = len(range(1, ct, 17))
    for k in tgt:  # repeated targets: ties for the argmin
        tgt[k][:, :, 1::17] = tgt[k][:, :, 0::17][:, :, :copies]
    mask = np.ones((b, t), bool)
    mask[::3, -1] = t == 1
    out = {f"src_{k}": v for k, v in src.items()}
    out.update({f"tgt_{k}": v for k, v in tgt.items()})
    out.update(tgt_poses=tposes.astype(f32), scan_mask=mask,
               pose0=(truth + np.stack(
                   [rng.uniform(-0.4, 0.4, b), rng.uniform(-0.4, 0.4, b),
                    rng.uniform(-0.03, 0.03, b)], -1)).astype(f32))
    if with_prior:
        s = np.diag([10.0, 10.0, 31.6]) + rng.uniform(-1, 1, (3, 3))
        out.update(guess=(truth + rng.normal(0, 0.05, (b, 3))).astype(f32),
                   sqrt_info=s.astype(f32))
    return out


def evaluation_configs():
    """The ``RegistrationConfig``s at which the registration kernel's
    evaluation entry is held to its plain version: every cost x loss, the
    weight option 0-4 in turn, then the CFEAR feature's configuration
    (``models/verification.py::_cfear_eval_cfg``) and the loop
    registration's (``models/loopclosure.py::_loop_registration_cfg``)."""
    import itertools

    from ..core.config import RegistrationConfig, TBVConfig
    from ..models import loopclosure, verification

    grid = itertools.product(("P2L", "P2D", "P2P"), ("none", "huber",
                                                     "cauchy", "softlone",
                                                     "tukey", "combined"))
    tbv = TBVConfig()
    return [RegistrationConfig(cost=cost, loss=loss, weight_option=i % 5,
                               loss_limit=0.3)
            for i, (cost, loss) in enumerate(grid)] + [
        verification._cfear_eval_cfg(tbv.verification),
        loopclosure._loop_registration_cfg(tbv)]
