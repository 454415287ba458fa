"""The registration's window solve, LM solve and cost evaluation as CUDA
kernel launches.

The kernel is ``csrc/lm_solve.cu``, with three entries over the same device
code:

* ``register_window``: ``ops/registration.py::register_window``, whole,
  in one launch a call: the target scans placed in the world (the
  ``world_targets`` site's arithmetic), every outer iteration's
  association of the source cells into them, the LM solve (the initial
  cost, gradient and Hessian, then ``max_iter`` damped steps, a run of
  rejections evaluated in one pass: the candidates' residuals, robust
  loss, weights, pairwise row sums and the accept / reject) and the outer
  guards, bit-equal to the plain version
  ``ops/registration.py::_register_window_reference``;
* ``lm_solve``: ``_lm_solve`` alone on given associations (``register_joint``),
  one launch a solve, bit-equal to ``_lm_solve_reference``;
* ``evaluate``: ``evaluate_cost`` and ``sampled_covariance`` in one launch
  a call: the targets placed as the window's, the association at each
  row's pose, then the cost-only pass at all S poses over it in one pass
  (and the sampled covariance's quadratic fit and its 3 x 3 covariance and
  convexity, with nothing read on the host), bit-equal to
  ``_evaluate_cost_reference`` and ``_sampled_covariance_reference``.

A batch row runs on a thread-block cluster of K CTAs (``cluster_size``),
each owning an aligned 1/K of the row's ``_row_sums`` leaves; the sums do
not depend on K.  Neither entry has a Pallas counterpart: the JAX package
leaves the registration to XLA's fusions.

Dispatch is in ``ops/registration.py``: a CPU tensor takes the plain
version, a CUDA tensor launches this kernel or raises.  A window or
evaluation call's launch description (``ENTRY_ARGS``) is planned once per
shapes, strides and options (``_PLANS``), so a call's host work is a
lookup, the outputs' allocation, a pack and the launch.  ``LAUNCHES`` counts
kernel launches and nothing else (``LAUNCHES_BY_ENTRY`` splits them).
``plain_on_card`` lets a test or ``chip_smoke.py`` run the plain versions on
CUDA tensors, to hold the kernel to them; nothing else uses it.
"""
from __future__ import annotations

import collections
import contextlib
import struct
from typing import Optional

import numpy as np
import torch

from ..core.refmath import f32_ftz, recip
from .refmath import _entry, _launch_on

#: number of kernel launches made by ``register_window`` and ``lm_solve``
LAUNCHES = 0
#: launches by entry ("window", "solve", "evaluate")
LAUNCHES_BY_ENTRY: collections.Counter = collections.Counter()

_PLAIN_ON_CARD = False

# ops/registration.py's cost and loss codes
_P2L, _P2D = 0, 1
_HUBER, _CAUCHY, _SOFTLONE, _TUKEY = 1, 2, 3, 4

# csrc/lm_solve.cu's limits: SMs of the card, the portable cluster size,
# threads and leaves a CTA, dynamic shared memory a CTA
SMS = 132
MAX_CLUSTER = 8
THREADS = 256
MAX_LEAVES_PER_THREAD = 128
SHARED_BYTES = 200 * 1024
#: the evaluation entry's most poses S (steps^3 <= 64)
MAX_POSES = 64


def _f32(x: float) -> float:
    return float(np.float32(x))


def loss_constants(loss: int, delta: float):
    """The float32 constants of ``_rho_and_weight`` for ``loss`` at
    ``delta``, as its tensor operations round them: Huber (delta^2,
    2 delta, -delta^2, delta), Cauchy (1 / b, b), SoftLOne (1 / b, 2 b),
    Tukey (1 / b, b / 3), with b = delta^2; zeros elsewhere."""
    b = delta * delta
    if loss == _HUBER:
        return _f32(b), _f32(2.0 * delta), _f32(-b), _f32(delta)
    if loss == _CAUCHY:
        return recip(b), _f32(b), 0.0, 0.0
    if loss == _SOFTLONE:
        return recip(b), _f32(2.0 * b), 0.0, 0.0
    if loss == _TUKEY:
        return recip(b), _f32(b / 3.0), 0.0, 0.0
    return 0.0, 0.0, 0.0, 0.0


def row_leaves(t: int, c: int, cost: int):
    """(leaves N, padded width W, residuals a cell R) of one row of T x C
    associations: ``_row_sums``'s tree over W = the power of two >= N."""
    r = 1 if cost == _P2L else 2
    n = t * c * r
    return n, 1 << max(n - 1, 0).bit_length(), r


def shared_bytes(k: int, t: int, c: int, ct: int, cost: int,
                 window: bool) -> int:
    """Dynamic shared memory of one CTA at cluster size k: its records (the
    associations of its W / k leaves) and, in the window, one staged target
    scan; ``csrc/lm_solve.cu::layout`` computes the same."""
    _, w, r = row_leaves(t, c, cost)
    qk = w // k // r
    q = -(-qk // 4) * 4
    floats = 5 * q + (2 * q if cost == _P2L else 4 * q if cost == _P2D else 0)
    if window:  # the staged scan, padded to a multiple of 4 targets
        floats += 2 * (-(-ct // 4) * 4)
    return 4 * floats + -(-qk // 16) * 16 + (-(-ct // 16) * 16 if window
                                             else 0)


def cluster_size(rows: int, t: int, c: int, ct: int, cost: int,
                 window: bool) -> int:
    """CTAs a row: the largest power of two K <= 8 with K rows' clusters
    side by side on the card (K B <= 132) and at least R leaves a CTA,
    raised until a CTA's records fit its shared memory.  B = 1 and 4, an
    online wave of 12 and ``register_joint``'s 5 rows get 8; a 64-pair loop
    wave 2."""
    _, w, r = row_leaves(t, c, cost)
    most = min(MAX_CLUSTER, max(1, w // r))
    k = 1
    while 2 * k <= min(most, max(1, SMS // max(rows, 1))):
        k *= 2
    while shared_bytes(k, t, c, ct, cost, window) > SHARED_BYTES and \
            k < most:
        k *= 2
    if shared_bytes(k, t, c, ct, cost, window) > SHARED_BYTES or \
            w // k > THREADS * MAX_LEAVES_PER_THREAD:
        raise ValueError(f"lm_solve: a row of T={t} x C={c} (Ct={ct}) does "
                         f"not fit {MAX_CLUSTER} CTAs")
    return k


@contextlib.contextmanager
def plain_on_card():
    """Inside the block ``register_window``, ``_lm_solve``,
    ``evaluate_cost`` and ``sampled_covariance`` run their plain versions
    on CUDA tensors too (the kernel's yardstick in tests and
    ``chip_smoke.py``)."""
    global _PLAIN_ON_CARD
    was, _PLAIN_ON_CARD = _PLAIN_ON_CARD, True
    try:
        yield
    finally:
        _PLAIN_ON_CARD = was


def plain_on_card_enabled() -> bool:
    return _PLAIN_ON_CARD


def _check(name, dev, floats, bools, shapes):
    """Device, type and shape checks of an entry's tensors."""
    if any(x is None for x in floats):
        raise ValueError(f"{name}: the cost's target normals (P2L), "
                         "covariances or sqrt-information (P2D) are missing")
    if any(x.dtype != torch.float32 or x.device != dev for x in floats) or \
            any(x.dtype != torch.bool or x.device != dev for x in bools):
        raise TypeError(f"{name}: float32 tensors and bool masks on {dev}")
    for what, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{name}: {what} has shape {tuple(x.shape)}, "
                             f"expected {want}")


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _count(entry: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1


def lm_solve(theta0: torch.Tensor, src_mean: torch.Tensor,
             tgt_mean_w: torch.Tensor, tgt_normal_w: Optional[torch.Tensor],
             weight: torch.Tensor, mask: torch.Tensor,
             tgt_sqrtinfo: Optional[torch.Tensor], *, cost: int, loss: int,
             delta: float, max_iter: int, init_lambda: float, prior=None,
             one_system: bool = False, batch: Optional[int] = None,
             cluster: Optional[int] = None):
    """(theta [B, 3], cost [B], rel_dec [B]) of the LM solve of B rows of
    [T, C] associations, one launch on CUDA tensors (float32; ``mask``
    bool).  ``prior`` is (guess [B, 3], sqrt_info [3, 3], pw [B]) or None;
    ``batch`` forces the candidates a pass along a run of rejections
    (default: the kernel's), ``cluster`` the CTAs a row (default
    ``cluster_size``)."""
    dev = theta0.device
    if dev.type != "cuda":
        raise RuntimeError(f"lm_solve: no kernel for device {dev}")
    bsz = theta0.shape[0]
    t, c = weight.shape[1:]
    floats = [theta0, src_mean, tgt_mean_w, weight]
    shapes = {"theta0": (theta0, (bsz, 3)), "src_mean": (src_mean, (bsz, c, 2)),
              "tgt_mean_w": (tgt_mean_w, (bsz, t, c, 2)),
              "mask": (mask, (bsz, t, c))}
    if cost == _P2L:
        floats.append(tgt_normal_w)
        if tgt_normal_w is not None:
            shapes["tgt_normal_w"] = (tgt_normal_w, (bsz, t, c, 2))
    if cost == _P2D:
        floats.append(tgt_sqrtinfo)
        if tgt_sqrtinfo is not None:
            shapes["tgt_sqrtinfo"] = (tgt_sqrtinfo, (bsz, t, c, 2, 2))
    if prior is not None:
        floats.extend(prior)
        shapes.update(guess=(prior[0], (bsz, 3)),
                      sqrt_info=(prior[1], (3, 3)), pw=(prior[2], (bsz,)))
    _check("lm_solve", dev, floats, [mask], shapes)
    out_theta = torch.empty((bsz, 3), dtype=torch.float32, device=dev)
    out_cost = torch.empty((bsz,), dtype=torch.float32, device=dev)
    out_rel = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out_theta, out_cost, out_rel
    k = cluster or cluster_size(bsz, t, c, c, cost, False)
    keep = [x.contiguous() for x in (theta0, src_mean, tgt_mean_w, weight,
                                     mask)]
    opt = lambda x, on: x.contiguous() if on else None
    tn = opt(tgt_normal_w, cost == _P2L)
    si = opt(tgt_sqrtinfo, cost == _P2D)
    guess, sqrt_info, pw = (None,) * 3 if prior is None else \
        (x.contiguous() for x in prior)
    err = _launch_on(dev, _entry("lm_solve_launch"), _ptr(keep[0]),
                     _ptr(keep[1]), _ptr(keep[2]), _ptr(tn), _ptr(keep[3]),
                     _ptr(keep[4]), _ptr(si), _ptr(guess), _ptr(sqrt_info),
                     _ptr(pw), out_theta.data_ptr(), out_cost.data_ptr(),
                     out_rel.data_ptr(), bsz, t, c, cost, loss,
                     *loss_constants(loss, delta), max_iter,
                     _f32(init_lambda), int(one_system), batch or 0, k)
    if err != 0:
        raise RuntimeError(f"lm_solve_launch failed: CUDA error {err} "
                           f"(B={bsz}, T={t}, C={c}, cost={cost}, K={k})")
    _count("solve")
    return out_theta, out_cost, out_rel


#: ``csrc/lm_solve.cu``'s ``EntryArgs``: 24 pointers, 16 ints, 16 floats,
#: 16 batch strides
ENTRY_ARGS = struct.Struct("<24Q16i16f16q")
_PACK = ENTRY_ARGS.pack
#: (entry, each tensor's shape, strides, type and device, the options) ->
#: the launch's plan (the ints and floats packed after the pointers, which
#: inputs need a dense copy, the outputs' shapes and types): a call's host
#: work is then a lookup, the outputs' allocation, a pack and the launch
_PLANS: dict = {}


def _row_dense(x: torch.Tensor) -> bool:
    """Whether each row x[b] is dense (its batch stride may be anything,
    0 where one row is broadcast over the batch)."""
    want = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


class _Plan:
    __slots__ = ("copy", "outs", "ints", "floats", "strides", "dev", "fn",
                 "what")

    def __init__(self, ins, outs, ints, floats, dev, entry, what):
        # inputs 1-13 (the cells and scans) are read by row with their
        # batch strides, so a row broadcast over the batch is not copied;
        # any other input must be dense
        # (the target means' rows read as float2: an even batch stride)
        self.copy = tuple(
            x is not None and not (
                _row_dense(x) and (i != 7 or x.stride(0) % 2 == 0)
                if 1 <= i <= 13 else x.is_contiguous())
            for i, x in enumerate(ins))
        self.strides = [0 if x is None else
                        (x[0].numel() if c else x.stride(0))
                        for x, c in zip(ins[1:14], self.copy[1:14])]
        self.strides += [0] * (16 - len(self.strides))
        self.outs = outs
        self.ints = list(ints) + [0] * (16 - len(ints))
        self.floats = list(floats) + [0.0] * (16 - len(floats))
        self.dev = dev
        self.fn = entry
        self.what = what


def _key(entry, ins, options):
    return (entry, options) + tuple(
        None if x is None else (x.shape, x.stride(), x.dtype, x.device)
        for x in ins)


def _run(plan: _Plan, ins, entry: str, more=()):
    """One launch of ``entry`` on the plan's inputs (``more``: pointers
    after the outputs'); returns the outputs."""
    ins = [x.contiguous() if c else x for x, c in zip(ins, plan.copy)]
    # the target means are read as float2: 8-byte aligned
    if ins[7].data_ptr() & 7:
        ins[7] = ins[7].clone()
    outs = [torch.empty(shape, dtype=dt, device=plan.dev)
            for shape, dt in plan.outs]
    ptrs = [0 if x is None else x.data_ptr() for x in ins] + [
        o.data_ptr() for o in outs] + list(more)
    ptrs += [0] * (24 - len(ptrs))
    err = _launch_on(plan.dev, plan.fn, _PACK(*ptrs, *plan.ints,
                                              *plan.floats, *plan.strides))
    if err != 0:
        raise RuntimeError(f"{entry}_launch failed: CUDA error {err} "
                           f"({plan.what})")
    _count(entry)
    return outs


def _target_shapes(bsz, c, t, ct, cost):
    return {"src_mean": (bsz, c, 2), "src_normal": (bsz, c, 2),
            "src_nsamples": (bsz, c), "src_planarity": (bsz, c),
            "tgt_poses": (bsz, t, 3), "tgt_mean": (bsz, t, ct, 2),
            "tgt_normal": (bsz, t, ct, 2), "tgt_valid": (bsz, t, ct),
            "tgt_scan_mask": (bsz, t), "tgt_nsamples": (bsz, t, ct),
            "tgt_planarity": (bsz, t, ct),
            **({"tgt_cov": (bsz, t, ct, 2, 2)} if cost == _P2D else {})}


_TARGET_NAMES = ("src_mean", "src_normal", "src_nsamples", "src_planarity",
                 "src_valid", "tgt_poses", "tgt_mean", "tgt_normal",
                 "tgt_cov", "tgt_valid", "tgt_scan_mask", "tgt_nsamples",
                 "tgt_planarity")


def _check_targets(name, dev, first, ins, cost, extra_floats, extra_shapes):
    """Device, type and shape checks of an entry's first 14 inputs (the
    pose or start [B, 3], the source cells, the target scans in their own
    frames) and of its extra float inputs."""
    bsz, c = ins[5].shape
    t, ct = ins[10].shape[1:]
    named = dict(zip(_TARGET_NAMES, ins[1:]))
    if cost != _P2D:
        named.pop("tgt_cov")
    want = _target_shapes(bsz, c, t, ct, cost)
    shapes = {k: (named[k], v) for k, v in want.items()}
    shapes[first] = (ins[0], (bsz, 3))
    shapes.update(extra_shapes)
    floats = [ins[0]] + [named[k] for k in want
                         if k not in ("tgt_valid", "tgt_scan_mask")] + \
        extra_floats
    _check(name, dev, floats, [ins[5], ins[10], ins[11]], shapes)
    if ct < 1:
        raise ValueError(f"{name}: the target scans hold no cell")
    return bsz, c, t, ct


def register_window(theta0: torch.Tensor, src_mean: torch.Tensor,
                    src_normal: torch.Tensor, src_nsamples: torch.Tensor,
                    src_planarity: torch.Tensor, src_valid: torch.Tensor,
                    tgt_poses: torch.Tensor, tgt_mean: torch.Tensor,
                    tgt_normal: torch.Tensor,
                    tgt_cov: Optional[torch.Tensor],
                    tgt_valid: torch.Tensor, tgt_scan_mask: torch.Tensor,
                    tgt_nsamples: torch.Tensor, tgt_planarity: torch.Tensor,
                    *, cost: int, loss: int, delta: float, max_inner: int,
                    init_lambda: float, max_outer: int, min_outer: int,
                    radius: float, angle_gate_cos: float, weight_option: int,
                    regularization: float, cov_scale: float,
                    score_tolerance: float, guess=None, sqrt_info=None,
                    one_system: bool = False, batch: Optional[int] = None,
                    cluster: Optional[int] = None,
                    passes: Optional[torch.Tensor] = None):
    """(pose [B, 3], score [B], num_residuals [B], iterations [B]) of
    ``register_window`` for B source scans of C cells against T target
    scans of Ct cells given in their own frames (``Cells`` fields), their
    poses ``tgt_poses`` [B, T, 3] and the scan mask [B, T], one launch on
    CUDA tensors; the kernel places the targets in the world as
    ``_world_targets`` does.  ``guess`` [B, 3] with ``sqrt_info`` [3, 3] is
    the motion prior (its weight, the root of each row's valid source
    cells, is computed in the kernel); ``batch`` forces the candidates a
    pass along a run of rejections (default: the kernel's), ``cluster`` the
    CTAs a row (default ``cluster_size``); into ``passes`` (int32 [B] on the
    card), when given, the kernel writes each row's passes over its
    records (the serial loop makes 1 + max_inner an outer iteration)."""
    dev = theta0.device
    if dev.type != "cuda":
        raise RuntimeError(f"register_window: no kernel for device {dev}")
    ins = [theta0, src_mean, src_normal, src_nsamples, src_planarity,
           src_valid, tgt_poses, tgt_mean, tgt_normal,
           tgt_cov if cost == _P2D else None, tgt_valid, tgt_scan_mask,
           tgt_nsamples, tgt_planarity, guess, sqrt_info]
    options = (cost, loss, delta, max_inner, init_lambda, max_outer,
               min_outer, radius, angle_gate_cos, weight_option,
               regularization, cov_scale, score_tolerance, bool(one_system),
               batch, cluster)
    key = _key("window", ins, options)
    plan = _PLANS.get(key)
    if plan is None:
        if cost == _P2D and tgt_cov is None:
            raise ValueError("register_window: the cost's target "
                             "covariances (P2D) are missing")
        bsz = src_valid.shape[0]
        extra, extra_shapes = [], {}
        if guess is not None:
            extra = [guess, sqrt_info]
            extra_shapes = dict(guess=(guess, (bsz, 3)),
                                sqrt_info=(sqrt_info, (3, 3)))
        bsz, c, t, ct = _check_targets("register_window", dev, "theta0", ins,
                                       cost, extra, extra_shapes)
        k = cluster or (cluster_size(bsz, t, c, ct, cost, True) if bsz
                        else 1)
        r0 = 2.0 * radius  # the first outer iteration's doubled radius
        plan = _Plan(
            ins, [((bsz, 3), torch.float32), ((bsz,), torch.float32),
                  ((bsz,), torch.long), ((bsz,), torch.long)],
            [bsz, t, c, ct, cost, loss, max_inner, int(one_system),
             max_outer, min_outer, weight_option, k, batch or 0],
            [*loss_constants(loss, delta), _f32(init_lambda),
             f32_ftz(r0 * r0), f32_ftz(radius * radius),
             _f32(angle_gate_cos), _f32(regularization), _f32(cov_scale),
             _f32(score_tolerance)],
            dev, _entry("register_window_launch"),
            f"B={bsz}, T={t}, C={c}, Ct={ct}, cost={cost}, K={k}")
        _PLANS[key] = plan
    if plan.ints[0] == 0:
        return tuple(torch.empty(shape, dtype=dt, device=dev)
                     for shape, dt in plan.outs)
    if passes is not None and (passes.dtype != torch.int32 or
                               passes.device != dev or
                               tuple(passes.shape) != (plan.ints[0],)):
        raise ValueError("register_window: passes must be int32 [B] on "
                         f"{dev}")
    return tuple(_run(plan, ins, "window",
                      () if passes is None else (passes.data_ptr(),)))


def evaluate(pose: torch.Tensor, src_mean: torch.Tensor,
             src_normal: torch.Tensor, src_nsamples: torch.Tensor,
             src_planarity: torch.Tensor, src_valid: torch.Tensor,
             tgt_poses: torch.Tensor, tgt_mean: torch.Tensor,
             tgt_normal: torch.Tensor, tgt_cov: Optional[torch.Tensor],
             tgt_valid: torch.Tensor, tgt_scan_mask: torch.Tensor,
             tgt_nsamples: torch.Tensor, tgt_planarity: torch.Tensor, *,
             cost: int, loss: int, delta: float, radius: float,
             angle_gate_cos: float, weight_option: int,
             regularization: float, cov_scale: float,
             offsets: Optional[torch.Tensor] = None,
             pinv: Optional[torch.Tensor] = None,
             covariance=None,
             cluster: Optional[int] = None):
    """(costs [B, S], association counts [B], fit [B, 10] or None, cov
    [B, 3, 3] or None, convex [B] or None) of B source scans of C cells at
    their poses ``pose`` [B, 3] against T target scans of Ct cells given
    in their own frames with their poses [B, T, 3] and the scan mask
    [B, T] (placed in the world in the launch, as ``_world_targets``
    places them), one launch on CUDA tensors: one association at each
    row's pose within ``radius``, then the cost-only pass at ``pose +
    offsets[s]`` for each of the S <= 64 offsets [S, 3] (none: S = 1 at the
    pose itself), all S in one pass; with ``pinv`` [10, S] also the sampled
    covariance's fit, one fused multiply-add a sample in order; with
    ``covariance`` = (final_score [B] float32, n_res [B] int64, cov_scaler,
    default diagonal (3 floats)) also the covariance of the fit and its
    convexity (``_covariance_from_fit``), read from nothing on the host.
    ``cluster`` forces the CTAs a row (default ``cluster_size``)."""
    dev = pose.device
    if dev.type != "cuda":
        raise RuntimeError(f"evaluate: no kernel for device {dev}")
    final_score, n_res = (None, None) if covariance is None else \
        covariance[:2]
    ins = [pose, src_mean, src_normal, src_nsamples, src_planarity,
           src_valid, tgt_poses, tgt_mean, tgt_normal,
           tgt_cov if cost == _P2D else None, tgt_valid, tgt_scan_mask,
           tgt_nsamples, tgt_planarity, offsets, pinv, final_score, n_res]
    options = (cost, loss, delta, radius, angle_gate_cos, weight_option,
               regularization, cov_scale, cluster,
               None if covariance is None else (
                   covariance[2], tuple(covariance[3])))
    key = _key("evaluate", ins, options)
    plan = _PLANS.get(key)
    if plan is None:
        if cost == _P2D and tgt_cov is None:
            raise ValueError("evaluate: the cost's target covariances "
                             "(P2D) are missing")
        s = 1 if offsets is None else offsets.shape[0]
        bsz = src_valid.shape[0]
        extra, extra_shapes = [], {}
        if offsets is not None:
            extra.append(offsets)
            extra_shapes["offsets"] = (offsets, (s, 3))
        if pinv is not None:
            extra.append(pinv)
            extra_shapes["pinv"] = (pinv, (10, s))
        scaler, diag = 0.0, (0.0, 0.0, 0.0)
        if covariance is not None:
            if pinv is None:
                raise ValueError("evaluate: the covariance needs the fit "
                                 "(pinv)")
            extra.append(final_score)
            extra_shapes["final_score"] = (final_score, (bsz,))
            extra_shapes["n_res"] = (n_res, (bsz,))
            if n_res.dtype != torch.long or n_res.device != dev:
                raise TypeError(f"evaluate: n_res must be int64 on {dev}")
            scaler, diag = _f32(covariance[2]), tuple(map(_f32,
                                                          covariance[3]))
        bsz, c, t, ct = _check_targets("evaluate", dev, "pose", ins, cost,
                                       extra, extra_shapes)
        if not 1 <= s <= MAX_POSES:
            raise ValueError(f"evaluate: S = {s} poses (1 to {MAX_POSES})")
        k = cluster or (cluster_size(bsz, t, c, ct, cost, True) if bsz
                        else 1)
        outs = [((bsz, s), torch.float32), ((bsz,), torch.long)]
        if pinv is not None:
            outs.append(((bsz, 10), torch.float32))
        if covariance is not None:
            outs += [((bsz, 3, 3), torch.float32), ((bsz,), torch.bool)]
        plan = _Plan(
            ins, outs, [bsz, t, c, ct, cost, loss, s, weight_option, 0, 0,
                        0, k],
            [*loss_constants(loss, delta), 0.0, 0.0,
             f32_ftz(radius * radius), _f32(angle_gate_cos),
             _f32(regularization), _f32(cov_scale), 0.0, 0.0, scaler,
             *diag], dev, _entry("evaluate_cost_launch"),
            f"B={bsz}, T={t}, C={c}, Ct={ct}, S={s}, cost={cost}, K={k}")
        _PLANS[key] = plan
    if plan.ints[0] == 0:
        outs = [torch.empty(shape, dtype=dt, device=dev)
                for shape, dt in plan.outs]
    else:
        outs = _run(plan, ins, "evaluate")
    costs, count = outs[:2]
    q = outs[2] if pinv is not None else None
    cov, convex = outs[-2:] if covariance is not None else (None, None)
    return costs, count, q, cov, convex
