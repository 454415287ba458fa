"""The reference's float32 math: CUDA kernel wrapper + plain versions.

The kernel is ``csrc/refmath.cu``: one elementwise launch per call, which
runs XLA's inline exp / log / log1p, the C library's sinf / cosf / sincosf
/ atan2f, the IEEE square root, the fused multiply-add and the flush of
subnormal values with the reference's operations and roundings; ``dot``,
the small matrix product whose terms the reference adds one at a time;
``loop_dot``, the logistic gradient's sum in the order of the reference's
vectorised loop; and
``lm_update``, the LM step theta - H^{-1} g; ``lu_solve``, the logistic
fit's Newton step as the reference's LAPACK and BLAS routines round it.
The plain versions are
``core/refmath.py``.  What the reference computes at each site, and how
that was read from its compiled program, is the table in
``core/refmath.py``.

The site entries (``csrc/refmath_sites.cu``, :data:`SITES`) compute one
whole site of the main path in one launch: ``se2``'s compose, inverse,
relative, apply, rotate, interpolate and rotmat, ``norm2``, registration's
world-frame targets and the radar's motion compensation, a thread an
element, broadcast operands read through their strides.  The module that
owns a site registers it where it defines it (:func:`register_site`): its
plain version, the port's eager body of that site kept under a ``_plain``
name, and its operands' layout.  ``cumsum`` is ``detect``'s travelled
distance in the reference's blocked order.

Dispatch is by tensor device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel launches
and nothing else; ``LAUNCHES_BY_OP`` splits them by op.
"""
from __future__ import annotations

import collections
import functools
import struct

import torch

from ..core import refmath as plain

#: number of kernel launches made by this module's functions
LAUNCHES = 0
#: launches by op name
LAUNCHES_BY_OP: collections.Counter = collections.Counter()

OPS = {"exp": 0, "log": 1, "log1p": 2, "sigmoid": 3, "sincos": 4,
       "atan2": 5, "wrap_angle": 6, "fma": 7, "sqrt": 8, "ftz": 9}

#: site entries of ``csrc/refmath_sites.cu``: name -> site code
SITES = {"compose": 0, "inverse": 1, "relative": 2, "apply": 3,
         "rotate": 4, "interpolate": 5, "rotmat": 6, "norm2": 7,
         "world_targets": 8, "motion_compensate": 9}
_PLAIN = dict(
    exp=plain.exp, log=plain.log, log1p=plain.log1p, sigmoid=plain.sigmoid,
    sincos=plain.sincos, atan2=plain.atan2, wrap_angle=plain.wrap_angle,
    fma=plain.fma, sqrt=plain.sqrt, ftz=plain.ftz, dot=plain.dot,
    loop_dot=plain.loop_dot, lm_update=plain.lm_update,
    lu_solve=plain.lu_solve, cumsum=plain.blocked_cumsum)


_ENTRIES: dict = {}


def _entry(name: str):
    """The library's C entry ``name``, looked up once (the library is built
    at the first launch)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from .build import library

        fn = _ENTRIES[name] = getattr(library(), name)
    return fn


def _launch_on(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) on ``dev``'s current stream, with ``dev`` the
    current card while it launches (switched only when it is not)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _elementwise(op: str, x: torch.Tensor, *more: torch.Tensor):
    """(result, C entry, its arguments, values) of op on x (and y for atan2,
    y and z for fma), broadcast together."""
    ts = (x,) + more
    if any(t.shape != x.shape for t in more):
        ts = torch.broadcast_tensors(*ts)
    x, *more = (t.contiguous() for t in ts)
    y = more[0] if more else x
    z = more[1] if len(more) > 1 else x
    two = op == "sincos"
    out = torch.empty((2 if two else 1,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    return ((out[0], out[1]) if two else out[0], "refmath_launch",
            (OPS[op], x.data_ptr(), y.data_ptr(), z.data_ptr(),
             out[0].data_ptr(), out[-1].data_ptr(), x.numel()), x.numel())


def _dot(op: str, a: torch.Tensor, b: torch.Tensor):
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    b2 = b.contiguous()
    if b2.dim() != 2 or b2.shape[1] != a2.shape[1]:
        raise ValueError(f"refmath.dot: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    out = torch.empty((a2.shape[0], b2.shape[0]), dtype=a.dtype,
                      device=a.device)
    return (out.reshape(lead + (b2.shape[0],)), "refmath_dot_launch",
            (a2.data_ptr(), b2.data_ptr(), out.data_ptr(), a2.shape[0],
             b2.shape[0], a2.shape[1]), out.numel())


_LOOP_MODES = {"in_order": 0, "unrolled": 1, "loop": 2}


def _loop_dot(op: str, x: torch.Tensor, v: torch.Tensor):
    if x.dim() != 2 or v.shape != x.shape[1:]:
        raise ValueError(f"refmath.loop_dot: shapes {tuple(x.shape)}, "
                         f"{tuple(v.shape)}")
    rows, n = x.shape
    mode, ic, vf = plain.loop_dot_shape(n)
    x, v = x.contiguous(), v.contiguous()
    out = torch.empty(rows, dtype=x.dtype, device=x.device)
    return (out, "refmath_loop_dot_launch",
            (x.data_ptr(), v.data_ptr(), out.data_ptr(), rows, n,
             _LOOP_MODES[mode], ic, vf), rows)


def _lm_update(op: str, theta: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, one_system: bool = False):
    if a.shape[-2:] != (3, 3) or b.shape != a.shape[:-1] or \
            theta.shape != b.shape:
        raise ValueError(f"refmath.lm_update: shapes {tuple(theta.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    t2 = theta.reshape(-1, 3).contiguous()
    a2 = a.reshape(-1, 9).contiguous()
    b2 = b.reshape(-1, 3).contiguous()
    out = torch.empty_like(t2)
    return (out.reshape(theta.shape), "refmath_lm_update_launch",
            (t2.data_ptr(), a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
             t2.shape[0], int(one_system)), out.numel())


def _lu_solve(op: str, h: torch.Tensor, g: torch.Tensor):
    k = h.shape[-1]
    if h.shape[-2:] != (k, k) or g.shape != h.shape[:-1] or \
            not 1 <= k <= plain.LU_SOLVE_MAX_K:
        raise ValueError(f"refmath.lu_solve: shapes {tuple(h.shape)}, "
                         f"{tuple(g.shape)} (K <= {plain.LU_SOLVE_MAX_K})")
    h2 = h.reshape(-1, k, k).contiguous()
    g2 = g.reshape(-1, k).contiguous()
    out = torch.empty_like(g2)
    return (out.reshape(g.shape), "refmath_lu_solve_launch",
            (h2.data_ptr(), g2.data_ptr(), out.data_ptr(), g2.shape[0], k),
            out.numel())


#: the longest vector ``cumsum`` scans in one block's registers and shared
#: memory (``csrc/refmath_sites.cu``: 1,024 rows of 16); longer ones keep
#: their levels in a scratch buffer in device memory
CUMSUM_BLOCK_MAX = 16 * 1024


def _cumsum(op: str, x: torch.Tensor):
    if x.dim() != 1:
        raise ValueError(f"refmath.cumsum: a vector, got {tuple(x.shape)}")
    x = x.contiguous()
    n, rows, levels = x.numel(), 0, x.numel()
    out = torch.empty_like(x)
    scratch = None
    if n > CUMSUM_BLOCK_MAX:
        while levels > plain.CUMSUM_BLOCK:
            levels = -(-levels // plain.CUMSUM_BLOCK)
            rows += levels
        scratch = torch.empty(rows, dtype=x.dtype, device=x.device)
    return (out, "refmath_cumsum_launch",
            (x.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n), n)


#: batch dimensions a site's operand may have (csrc/refmath_sites.cu kDims)
SITE_DIMS = 4
#: ``csrc/refmath_sites.cu``'s ``SiteArgs``: site, flags, elements, the
#: batch shape (left-padded with 1), 6 operand pointers, their strides (4
#: batch, 2 component each), 4 output pointers, 4 float32 constants
SITE_ARGS = struct.Struct("<2iq4q6Q36q4Q4f")


def _broadcast(shapes) -> tuple:
    """The broadcast of several shapes (torch's rule, without its cost)."""
    nd = max(len(sh) for sh in shapes)
    out = [1] * nd
    for sh in shapes:
        for i, d in enumerate(sh, nd - len(sh)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _site(layout, op: str, *ts, **options):
    """One launch of site ``op`` over the operands' broadcast batch: the
    launch's description (``csrc/refmath_sites.cu``'s ``SiteArgs``) packed
    by :data:`SITE_ARGS`, from the site's registered ``layout``."""
    operands, outs, flags, consts = layout(*ts, **options)
    live = [(t, comp) for t, comp, is_bool in operands if t is not None]
    for t, comp, is_bool in operands:
        if t is None:
            continue
        if t.dtype != (torch.bool if is_bool else torch.float32):
            raise TypeError(f"refmath.{op}: float32 operands and bool "
                            f"masks, got {t.dtype}")
        if t.dim() < len(comp) or tuple(t.shape[t.dim() - len(comp):]) \
                != comp:
            raise ValueError(f"refmath.{op}: an operand of shape "
                             f"{tuple(t.shape)}, expected [..., "
                             f"{', '.join(map(str, comp))}]")
    batch = _broadcast([tuple(t.shape[:t.dim() - len(comp)])
                        for t, comp in live])
    if len(batch) > SITE_DIMS:
        raise ValueError(f"refmath.{op}: batch {batch} has more than "
                         f"{SITE_DIMS} dimensions")
    n = 1
    for d in batch:
        n *= d
    ptrs, strides = [0] * 6, [0] * 36
    for k, (t, comp, _) in enumerate(operands):
        if t is None:
            continue
        shape, stride = t.shape, t.stride()
        nb = t.dim() - len(comp)
        row = strides[6 * k:6 * k + 6]
        for j in range(nb):  # right-aligned with the batch, in 4 dims
            if shape[j] != 1:
                row[SITE_DIMS - nb + j] = stride[j]
        row[SITE_DIMS:SITE_DIMS + len(comp)] = stride[nb:]
        strides[6 * k:6 * k + 6] = row
        ptrs[k] = t.data_ptr()
    results, out_ptrs = [], [0] * 4
    dev = ts[0].device
    for k, shape in enumerate(outs):
        if shape is None:
            results.append(None)
            continue
        out = torch.empty(batch + (() if shape == "bool" else shape),
                          dtype=torch.bool if shape == "bool" else
                          torch.float32, device=dev)
        out_ptrs[k] = out.data_ptr()
        results.append(out)
    args = SITE_ARGS.pack(SITES[op], flags, n,
                          *((1,) * (SITE_DIMS - len(batch)) + batch), *ptrs,
                          *strides, *out_ptrs,
                          *(tuple(consts) + (0.0,) * (4 - len(consts))))
    result = tuple(results) if len(results) > 1 else results[0]
    return result, "refmath_site_launch", (args,), n


_KERNEL_ARGS = dict.fromkeys(OPS, _elementwise)
_KERNEL_ARGS.update(dot=_dot, loop_dot=_loop_dot, lm_update=_lm_update,
                    lu_solve=_lu_solve, cumsum=_cumsum)


def register_site(name: str, plain_fn, layout) -> None:
    """Register site ``name`` of :data:`SITES`: ``plain_fn(*ts, **options)``
    is its plain version, and ``layout(*ts, **options)`` gives its launch's
    operands, as (operands: a list of (tensor or None, its component shape,
    whether it is a bool mask), the outputs' component shapes (None: not
    written; "bool": a bool per element), flags, float32 constants)."""
    if name not in SITES:
        raise ValueError(f"refmath: no site entry {name!r}")
    _PLAIN[name] = plain_fn
    _KERNEL_ARGS[name] = functools.partial(_site, layout)


register_site("norm2", plain.norm2,
              lambda v: ([(v, (2,), False)], [()], 0, ()))


def _call(op: str, *ts: torch.Tensor, **options):
    """op's plain version on CPU tensors; on CUDA tensors one launch of its
    kernel, counted; on any other device an error.  ``options`` are the
    op's non-tensor arguments."""
    global LAUNCHES
    dev = ts[0].device
    if op in SITES and op not in _PLAIN:
        raise ValueError(f"refmath: site {op!r} is not registered (its "
                         f"module registers it when imported)")
    if dev.type == "cpu":
        return _PLAIN[op](*ts, **options)
    if dev.type != "cuda":
        raise RuntimeError(f"refmath.{op}: no kernel for device {dev}")
    if op not in SITES and any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"refmath.{op}: float32 tensors only, got "
                        f"{[t.dtype for t in ts]}")
    if any(t is not None and t.device != dev for t in ts):
        raise ValueError(f"refmath.{op}: operands on "
                         f"{[str(t.device) for t in ts if t is not None]}")
    result, entry, args, n = _KERNEL_ARGS[op](op, *ts, **options)
    if n == 0:
        return result
    err = _launch_on(dev, _entry(entry), *args)
    if err != 0:
        raise RuntimeError(f"{entry}({op}) failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_OP[op] += 1
    return result


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 exp."""
    return _call("exp", x)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log."""
    return _call("log", x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p."""
    return _call("log1p", x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as compiled: 1 / (exp(-x) + 1)."""
    return _call("sigmoid", x)


def sincos(x: torch.Tensor):
    """(sinf(x), cosf(x)) of the C library, from one launch."""
    return _call("sincos", x)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C library's atan2f."""
    return _call("atan2", y, x)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """atan2f(sinf(t), cosf(t)) in one launch."""
    return _call("wrap_angle", theta)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding, the operands broadcast together."""
    return _call("fma", a, b, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE float32 square root, subnormal operands flushed."""
    return _call("sqrt", x)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values flushed to signed zeros, as the
    reference's threads flush a subnormal result (FTZ) or operand (DAZ),
    one launch."""
    return _call("ftz", x)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """The length of [..., 2] vectors as the reference's program computes
    ``jnp.linalg.norm`` over two values: its two-term reduction fused,
    fma(y, y, x * x), then the IEEE square root (one launch, a site)."""
    return _call("norm2", v)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a vector in the order of the reference's
    compiled ``jnp.cumsum`` (``core/refmath.py::blocked_cumsum``), one
    launch."""
    return _call("cumsum", x)


def site(name: str, *ts, **options):
    """Site ``name`` of :data:`SITES` on its operands: the plain version on
    CPU tensors, one launch of ``csrc/refmath_sites.cu`` on CUDA tensors."""
    return _call(name, *ts, **options)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[..., c] = sum_k a[..., k] * b[c, k], one fused multiply-add a
    term in k order (the reference's small matrix product), one launch."""
    return _call("dot", a, b)


def loop_dot(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[c] = sum_k x[c, k] v[k] for x [K, n], v [n], added in the order
    of the reference's vectorised loop (``core/refmath.py::loop_dot``), one
    launch."""
    return _call("loop_dot", x, v)


def lm_update(theta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              one_system: bool = False) -> torch.Tensor:
    """theta - a^{-1} b for [..., 3], [..., 3, 3], [..., 3], the LM step in
    the reference's closed form with its roundings (``one_system``: as its
    unbatched odometry step rounds it), one launch."""
    return _call("lm_update", theta, a, b, one_system=one_system)


def lu_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """h^{-1} g for [..., K, K], [..., K], K <= 7, as the reference's
    ``sgetrf`` and ``strsm`` round it (``core/refmath.py::lu_solve``), a
    thread a system, one launch."""
    return _call("lu_solve", h, g)
