"""The reference's float32 math: CUDA kernel wrapper + plain versions.

The kernels are ``csrc/refmath.cu``'s: one launch per call of one kernel
an op (:data:`OPS`), which runs XLA's inline exp / log / log1p, the C
library's sinf / cosf / sincosf / atan2f, the IEEE square root, the fused
multiply-add, a lone product (``mul``) and the flush of subnormal values
with the reference's operations and roundings, its operands read as float4
vectors where they are contiguous and aligned, else through their strides
(broadcast operands included: no copy before the launch); ``dot``,
the small matrix product whose terms the reference adds one at a time;
``loop_dot``, the logistic gradient's sum in the order of the reference's
vectorised loop; and
``lm_update``, the LM step theta - H^{-1} g; ``lu_solve``, the logistic
fit's Newton step as the reference's LAPACK and BLAS routines round it;
``ceres_covariance``, ``ops/registration.py::ceres_covariance`` after its
Hessian (eigenvalues, guarded inverse, scale) a thread a row.
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
import math
import struct

import torch

from ..core import refmath as plain

#: number of kernel launches made by this module's functions
LAUNCHES = 0
#: launches by op name
LAUNCHES_BY_OP: collections.Counter = collections.Counter()

OPS = {"exp": 0, "log": 1, "log1p": 2, "sigmoid": 3, "sincos": 4,
       "atan2": 5, "wrap_angle": 6, "fma": 7, "sqrt": 8, "ftz": 9,
       "mul": 10}
#: operands of op calls that took the strided path on the card, by op:
#: each was a copy kernel before the op while the wrapper made every
#: operand contiguous (a broadcast or non-contiguous operand)
STRIDED_OPERANDS: collections.Counter = collections.Counter()

#: site entries of ``csrc/refmath_sites.cu``: name -> site code
SITES = {"compose": 0, "inverse": 1, "relative": 2, "apply": 3,
         "rotate": 4, "interpolate": 5, "rotmat": 6, "norm2": 7,
         "world_targets": 8, "motion_compensate": 9}
_PLAIN = dict(
    exp=plain.exp, log=plain.log, log1p=plain.log1p, sigmoid=plain.sigmoid,
    sincos=plain.sincos, atan2=plain.atan2, wrap_angle=plain.wrap_angle,
    fma=plain.fma, sqrt=plain.sqrt, ftz=plain.ftz, mul=plain.mul,
    dot=plain.dot,
    loop_dot=plain.loop_dot, lm_update=plain.lm_update,
    lu_solve=plain.lu_solve, cumsum=plain.blocked_cumsum,
    ceres_covariance=plain.ceres_covariance)


_ENTRIES: dict = {}


def _entry(name: str):
    """The library's C entry ``name``, looked up once (the library is built
    at the first launch)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from .build import library

        fn = _ENTRIES[name] = getattr(library(), name)
    return fn


# the current card and its current stream's handle, without the Python
# layers of torch.cuda (the same calls they make)
_CURRENT_DEVICE = getattr(torch._C, "_cuda_getDevice", None)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev: torch.device) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_on(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) on ``dev``'s current stream, with ``dev`` the
    current card while it launches (switched only when it is not)."""
    current = _CURRENT_DEVICE() if _CURRENT_DEVICE is not None else \
        torch.cuda.current_device()
    if dev.index == current:
        return fn(*args, _stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, _stream(dev))


#: dimensions an op's strided path reads (csrc/refmath.cu kOpDims)
OP_DIMS = 6
#: ``csrc/refmath.cu``'s ``OpArgs``: 3 input and 2 output pointers, the
#: values, the output's shape (6 dimensions) and each input's strides
OP_ARGS = struct.Struct("<3Q2Qq6q18q")
_OP_PACK = OP_ARGS.pack
_F32 = torch.float32
#: (operand shapes and strides) -> (result shape, every operand dense, the
#: operands that are not, the strided layout): a call's host work is then a
#: lookup, an allocation, a pack and the launch
_OP_PLANS: dict = {}


def _op_layout(shape, ts) -> tuple:
    """The output's shape and each input's strides in elements (0 where it
    is broadcast), dimensions of one dropped and neighbours that every
    input walks as one merged, left-padded to :data:`OP_DIMS`."""
    nd = len(shape)
    dims = [int(d) for d in shape]
    rows = []
    for t in ts:
        row = [0] * nd
        for j, (d, st) in enumerate(zip(t.shape, t.stride()),
                                    nd - t.dim()):
            row[j] = st if d != 1 else 0
        rows.append(row)
    keep = [j for j in range(nd) if dims[j] != 1]
    dims = [dims[j] for j in keep]
    rows = [[r[j] for j in keep] for r in rows]
    j = len(dims) - 2
    while j >= 0:  # merge j into j + 1 where every input allows it
        if all(r[j] == r[j + 1] * dims[j + 1] for r in rows):
            dims[j + 1] *= dims[j]
            del dims[j]
            for r in rows:
                del r[j]
        j -= 1
    if len(dims) > OP_DIMS:
        raise ValueError(f"refmath: operands of shapes "
                         f"{[tuple(t.shape) for t in ts]} need more than "
                         f"{OP_DIMS} strided dimensions")
    pad = OP_DIMS - len(dims)
    strides = []
    for k in range(3):
        strides += [0] * pad + rows[k] if k < len(rows) else \
            [0] * OP_DIMS
    return (1,) * pad + tuple(dims) + tuple(strides)


def _op_plan(ts) -> tuple:
    """(result shape, all operands dense, the count that are not, strided
    layout) of operands ``ts``, from the cache where they were seen."""
    key = tuple((t.shape, t.stride()) for t in ts)
    plan = _OP_PLANS.get(key)
    if plan is None:
        shape = ts[0].shape
        if any(t.shape != shape for t in ts):
            shape = torch.Size(_broadcast([tuple(t.shape) for t in ts]))
        dense = [t.shape == shape and t.is_contiguous() for t in ts]
        plan = (shape, all(dense), dense.count(False),
                _op_layout(shape, ts))
        if len(_OP_PLANS) < 4096:
            _OP_PLANS[key] = plan
    return plan


def _op(op: str, *ts: torch.Tensor):
    """Elementwise op ``op`` of :data:`OPS` on its operands, broadcast
    together: the plain version on CPU tensors; on CUDA tensors one launch
    of the op's kernel, its vector path where every operand is contiguous,
    of the result's shape and 16-byte aligned, else its strided path (no
    copy), counted; on any other device an error."""
    global LAUNCHES
    x = ts[0]
    if not x.is_cuda:
        if x.device.type == "cpu":
            return _PLAIN[op](*ts)
        raise RuntimeError(f"refmath.{op}: no kernel for device {x.device}")
    idx = x.get_device()
    for t in ts:
        if t.dtype is not _F32 or t.get_device() != idx:
            raise TypeError(f"refmath.{op}: float32 operands on one card, "
                            f"got {[(t.dtype, str(t.device)) for t in ts]}")
    shape, dense, n_strided, layout = _op_plan(ts)
    out0 = x.new_empty(shape)
    out1 = x.new_empty(shape) if op == "sincos" else None
    n = out0.numel()
    if n == 0:
        return (out0, out1) if out1 is not None else out0
    ptrs = [t.data_ptr() for t in ts]
    if dense and not any(p & 15 for p in ptrs):
        strided = 0
    else:
        strided = 1
        if n_strided:
            STRIDED_OPERANDS[op] += n_strided
    ptrs += [0] * (3 - len(ts))
    desc = _OP_PACK(*ptrs, out0.data_ptr(),
                    0 if out1 is None else out1.data_ptr(), n, *layout)
    launch = _OP_ENTRY[0] if _OP_ENTRY else _op_entry()
    if _RAW_STREAM is not None and _CURRENT_DEVICE() == idx:
        err = launch(OPS[op], strided, desc, _RAW_STREAM(idx))
    else:
        err = _launch_on(x.device, launch, OPS[op], strided, desc)
    if err != 0:
        raise RuntimeError(f"refmath_op_launch({op}) failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_OP[op] += 1
    return (out0, out1) if out1 is not None else out0


_OP_ENTRY: list = []


def _op_entry():
    _OP_ENTRY.append(_entry("refmath_op_launch"))
    return _OP_ENTRY[0]


#: an op's kernels (``csrc/refmath.cu``'s ``OpPath``)
OP_PATHS = ("vector", "flat", "strided")


def op_info(op: str, path: str = "vector"):
    """(registers a thread, blocks of 256 a multiprocessor holds) of op's
    kernel ``path`` (:data:`OP_PATHS`) on the current card."""
    import ctypes

    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = _entry("refmath_op_info")(OPS[op], OP_PATHS.index(path),
                                    ctypes.byref(regs), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"refmath_op_info({op}) failed: CUDA error {err}")
    return regs.value, blocks.value


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


def _ceres_covariance(op: str, h: torch.Tensor, final_score: torch.Tensor,
                      n_res: torch.Tensor, p2l: bool = True,
                      fallback=(0.1 ** 2, 0.1 ** 2, 0.01 ** 2)):
    b = h.shape[0]
    if h.shape != (b, 3, 3) or final_score.shape != (b,) or \
            n_res.shape != (b,):
        raise ValueError(f"refmath.ceres_covariance: shapes "
                         f"{tuple(h.shape)}, {tuple(final_score.shape)}, "
                         f"{tuple(n_res.shape)}")
    if h.dtype != torch.float32 or final_score.dtype != torch.float32 or \
            n_res.dtype.is_floating_point or n_res.dtype == torch.bool:
        raise TypeError(f"refmath.ceres_covariance: float32 h and scores, "
                        f"integer counts, got {h.dtype}, "
                        f"{final_score.dtype}, {n_res.dtype}")
    h, final_score = h.contiguous(), final_score.contiguous()
    n_res = n_res.to(torch.int64).contiguous()
    cov = torch.empty_like(h)
    ok = torch.empty(b, dtype=torch.bool, device=h.device)
    return ((cov, ok), "refmath_ceres_covariance_launch",
            (h.data_ptr(), final_score.data_ptr(), n_res.data_ptr(),
             cov.data_ptr(), ok.data_ptr(), b, int(p2l), *fallback), b)


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


_KERNEL_ARGS = dict(dot=_dot, loop_dot=_loop_dot, lm_update=_lm_update,
                    lu_solve=_lu_solve, cumsum=_cumsum,
                    ceres_covariance=_ceres_covariance)


def register_site(name: str, plain_fn, layout, element=None) -> None:
    """Register site ``name`` of :data:`SITES`: ``plain_fn(*ts, **options)``
    is its plain version, and ``layout(*ts, **options)`` gives its launch's
    operands, as (operands: a list of (tensor or None, its component shape,
    whether it is a bool mask), the outputs' component shapes (None: not
    written; "bool": a bool per element), flags, float32 constants).
    ``element`` (default ``plain_fn``) is the same arithmetic on operands of
    equal rank broadcast element by element, as a chain's plain version
    calls it."""
    if name not in SITES:
        raise ValueError(f"refmath: no site entry {name!r}")
    _PLAIN[name] = plain_fn
    if name in CHAIN_SITES:
        _ELEMENT_PLAIN[name] = element or plain_fn
    _KERNEL_ARGS[name] = functools.partial(_site, layout)


# ---- site chains (csrc/refmath_sites.cu's refmath_chain_kernel) -----------

#: ``csrc/refmath_sites.cu``'s ``ChainDesc``: segment starts, their batch
#: shapes, the operand slots' strides, the segments' first steps, the
#: segment count, float32 constants, steps of 8 bytes
CHAIN_SEGS, CHAIN_IN, CHAIN_OUT, CHAIN_REGS, CHAIN_STEPS, CHAIN_CONSTS = \
    2, 10, 6, 96, 80, 16
CHAIN_DESC = struct.Struct("<3q8q50q3iii16f640s4x")
#: ``ChainArgs``: the description's device pointer, elements, operand and
#: output pointers
CHAIN_ARGS = struct.Struct("<Qq10Q6Q")
_OPCODE = dict(load=0, load_bool=1, const=2, store=3, store_bool=4, mul=5,
               sub=6, neg=7, abs=8, le=9, lt=10, and_=11, or_=12, where=13,
               compose=32, inverse=33, relative=34, apply=35, rotmat=36,
               norm2=37, motion_compensate=38)
#: the sites a chain may run: name -> (operand widths, result shape)
CHAIN_SITES = {"compose": ((3, 3), (3,)), "inverse": ((3,), (3,)),
               "relative": ((3, 3), (3,)), "apply": ((3, 2), (2,)),
               "rotmat": ((1,), (2, 2)),
               "norm2": ((2,), ()), "motion_compensate": ((2, 3), (2,))}
#: chain name -> (segments: [(body, operand indices)], operand component
#: shapes)
CHAINS: dict = {}
#: per-element plain versions of the sites a chain runs (operands of equal
#: rank, broadcast together): each site's plain arithmetic
_ELEMENT_PLAIN: dict = {}


class _Eager:
    """A chain body's operations on tensors: its plain version."""

    @staticmethod
    def site(name, *ts, **options):
        return _ELEMENT_PLAIN[name](*ts, **options)

    @staticmethod
    def norm2(v):
        return _ELEMENT_PLAIN["norm2"](v)

    @staticmethod
    def where(cond, a, b):
        if isinstance(a, torch.Tensor) and a.dim() > cond.dim():
            cond = cond[..., None]
        return torch.where(cond, a, b)

    @staticmethod
    def stack(values):
        return torch.stack(values, -1)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)


class _Value:
    """A value of a chain being recorded: its registers (a component each,
    row-major over ``shape``), ``shape`` the component shape."""
    __slots__ = ("rec", "regs", "shape", "is_bool")

    def __init__(self, rec, regs, shape, is_bool=False):
        self.rec, self.regs, self.shape, self.is_bool = \
            rec, tuple(regs), tuple(shape), is_bool

    def __getitem__(self, idx):
        if not (isinstance(idx, tuple) and len(idx) == 2 and
                idx[0] is Ellipsis and len(self.shape) == 1):
            raise IndexError("a chain value is indexed as v[..., j]")
        sel = self.regs[idx[1]]
        if isinstance(idx[1], slice):
            return _Value(self.rec, sel, (len(sel),), self.is_bool)
        return _Value(self.rec, (sel,), (), self.is_bool)

    def _binary(self, other, op, is_bool=False, swap=False):
        other = self.rec.operand(other)
        a, b = (other, self) if swap else (self, other)
        n = max(len(a.regs), len(b.regs))
        if {len(a.regs), len(b.regs)} - {1, n}:
            raise ValueError("chain values of different widths")
        pick = lambda v, i: v.regs[i if len(v.regs) == n else 0]
        out = [self.rec.emit(op, a=pick(a, i), b=pick(b, i))
               for i in range(n)]
        return _Value(self.rec, out, a.shape if len(a.regs) == n else b.shape,
                      is_bool)

    def _unary(self, op, is_bool=False):
        return _Value(self.rec, [self.rec.emit(op, a=r) for r in self.regs],
                      self.shape, is_bool)

    def __mul__(self, o): return self._binary(o, "mul")
    def __sub__(self, o): return self._binary(o, "sub")
    def __le__(self, o): return self._binary(o, "le", True)
    def __gt__(self, o): return self._binary(o, "lt", True, swap=True)
    def __and__(self, o): return self._binary(o, "and_", True)
    def __or__(self, o): return self._binary(o, "or_", True)
    def __neg__(self): return self._unary("neg")
    def __abs__(self): return self._unary("abs")


class _Recorder:
    """A chain body's operations recorded as ``csrc/refmath_sites.cu``
    steps, for one segment: registers allocated in order, never reused (an
    element's registers are its own; a site never writes over its
    operands)."""

    def __init__(self, consts):
        self.steps, self.consts, self.nregs = [], consts, 0

    def _reg(self, n=1):
        r = self.nregs
        self.nregs += n
        if self.nregs > CHAIN_REGS:
            raise ValueError(f"refmath chain: more than {CHAIN_REGS} "
                             "registers")
        return r

    def emit(self, op, a=0, b=0, c=0, k=0, j=0, n=0, width=1):
        dst = self._reg(width) if op not in ("store", "store_bool") else 0
        self.steps.append((_OPCODE[op], dst, a, b, c, k, j, n))
        return dst

    def const(self, x: float) -> int:
        """A register holding the float32 nearest x (as torch rounds a
        Python number against a float32 tensor)."""
        v = float(torch.tensor(float(x), dtype=torch.float32))
        if v not in self.consts:
            if len(self.consts) == CHAIN_CONSTS:
                raise ValueError("refmath chain: too many constants")
            self.consts.append(v)
        return self.emit("const", k=self.consts.index(v))

    def operand(self, x) -> _Value:
        if isinstance(x, _Value):
            return x
        if isinstance(x, bool):
            return _Value(self, [self.const(float(x))], (), True)
        return _Value(self, [self.const(x)], ())

    # the body's operations
    def site(self, name, *vals, **options):
        widths, shape = CHAIN_SITES[name]
        vals = [self.operand(v) for v in vals]
        if tuple(len(v.regs) for v in vals) != widths:
            raise ValueError(f"refmath chain: {name} of operands of widths "
                             f"{[len(v.regs) for v in vals]}")
        vals = [self._contiguous(v) for v in vals]
        width = max(1, math.prod(shape))
        a = vals[0].regs[0]
        b = vals[1].regs[0] if len(vals) > 1 else 0
        k = j = 0
        if name == "motion_compensate":
            k = len(self.consts)
            if k + 3 > CHAIN_CONSTS:
                raise ValueError("refmath chain: too many constants")
            self.consts.extend(plain.motion_constants())
            j = int(bool(options.get("ccw", False)))
        dst = self.emit(name, a=a, b=b, k=k, j=j, width=width)
        return _Value(self, range(dst, dst + width), shape)

    def norm2(self, v):
        return self.site("norm2", v)

    def _contiguous(self, v: _Value) -> _Value:
        """v's registers in consecutive order (a site reads an operand from
        its first register on): each copied as x * 1, which rounds to x."""
        regs = list(v.regs)
        if regs == list(range(regs[0], regs[0] + len(regs))):
            return v
        one = self.const(1.0)
        first = self.nregs
        for r in regs:
            self.emit("mul", a=r, b=one)
        return _Value(self, range(first, first + len(regs)), v.shape,
                      v.is_bool)

    def where(self, cond, a, b):
        cond, a, b = (self.operand(v) for v in (cond, a, b))
        n = max(len(a.regs), len(b.regs))
        pick = lambda v, i: v.regs[i if len(v.regs) == n else 0]
        out = [self.emit("where", a=pick(a, i), b=pick(b, i),
                         c=cond.regs[0]) for i in range(n)]
        return _Value(self, out, a.shape if len(a.regs) == n else b.shape,
                      a.is_bool and b.is_bool)

    def stack(self, values):
        values = [self.operand(v) for v in values]
        return _Value(self, [v.regs[0] for v in values], (len(values),))

    def zeros_like(self, v):
        return _Value(self, [self.const(0.0)] * len(v.regs), v.shape)


def register_chain(name: str, segments, operand_shapes) -> None:
    """Register chain ``name``: ``segments`` a list of (body, operand
    indices), each body ``body(k, *operands, **options)`` written once for
    both runs (``k`` is the plain version's tensor operations or the
    kernel's recorder) returning its outputs; ``operand_shapes`` each
    operand's component shape ((3,) a pose, (2,) a point, () a scalar or
    bool)."""
    if len(segments) > CHAIN_SEGS or any(len(s) > 1 for s in operand_shapes):
        raise ValueError(f"refmath chain {name}: more than {CHAIN_SEGS} "
                         "segments, or an operand of more than one "
                         "component dimension")
    CHAINS[name] = (tuple(segments), tuple(tuple(s) for s in operand_shapes))


_CHAIN_CACHE: dict = {}


def _chain_plan(name, ts, options):
    """The chain's description for these operands' shapes, strides and
    types: (``CHAIN_DESC``'s bytes, element count, the operand of each
    slot, each output's (shape, is_bool))."""
    segments, shapes = CHAINS[name]
    consts, steps, firsts, starts, seg_shapes = [], [], [], [0], []
    slots, strides, outputs = [], [], []
    for body, idx in segments:
        rec = _Recorder(consts)
        vals, batch = [], []
        for i in idx:
            t, comp = ts[i], shapes[i]
            batch.append(tuple(t.shape[:t.dim() - len(comp)]))
        bshape = _broadcast(batch)
        if len(bshape) > SITE_DIMS:
            raise ValueError(f"refmath chain {name}: batch {bshape}")
        for i in idx:
            t, comp = ts[i], shapes[i]
            nb = t.dim() - len(comp)
            row = [0] * (SITE_DIMS + 1)
            for q in range(nb):
                if t.shape[q] != 1:
                    row[SITE_DIMS - nb + q] = t.stride(q)
            if comp:
                row[SITE_DIMS] = t.stride(-1)
            k = len(slots)
            if k == CHAIN_IN:
                raise ValueError(f"refmath chain {name}: too many operands")
            slots.append(i)
            strides.extend(row)
            is_bool = t.dtype == torch.bool
            width = max(1, math.prod(comp))
            regs = [rec.emit("load_bool" if is_bool else "load", k=k, j=j)
                    for j in range(width)]
            vals.append(_Value(rec, regs, comp, is_bool))
        outs = body(rec, *vals, **options)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for v in outs:
            k = len(outputs)
            if k == CHAIN_OUT or (v.is_bool and v.shape):
                raise ValueError(f"refmath chain {name}: more than "
                                 f"{CHAIN_OUT} outputs, or a bool one "
                                 "with components")
            outputs.append((bshape + v.shape, v.is_bool))
            for j, r in enumerate(v.regs):
                rec.emit("store_bool" if v.is_bool else "store", a=r, k=k,
                         j=j, n=len(v.regs))
        firsts.append(len(steps))
        steps.extend(rec.steps)
        n = math.prod(bshape)
        starts.append(starts[-1] + n)
        seg_shapes.append((1,) * (SITE_DIMS - len(bshape)) + bshape)
    if len(steps) > CHAIN_STEPS or starts[-1] >= 2 ** 31:
        raise ValueError(f"refmath chain {name}: {len(steps)} steps (at "
                         f"most {CHAIN_STEPS}) over {starts[-1]} elements "
                         "(fewer than 2^31)")
    firsts.append(len(steps))
    nseg = len(segments)
    seg_shapes += [(1,) * SITE_DIMS] * (CHAIN_SEGS - nseg)
    starts += [starts[-1]] * (CHAIN_SEGS + 1 - len(starts))
    firsts += [firsts[-1]] * (CHAIN_SEGS + 1 - len(firsts))
    strides += [0] * ((SITE_DIMS + 1) * CHAIN_IN - len(strides))
    blob = CHAIN_DESC.pack(
        *starts, *(d for sh in seg_shapes for d in sh), *strides, *firsts,
        nseg, 0, *(consts + [0.0] * (CHAIN_CONSTS - len(consts))),
        b"".join(bytes(st) for st in steps))
    return blob, starts[nseg], slots, outputs


def _chain_key(name, ts, options):
    """The key of a chain's description: the chain, its options, the card
    (the description lives in that card's memory) and each operand's shape,
    strides and dtype."""
    return (name, tuple(sorted(options.items())), ts[0].device.index,
            tuple((t.shape, t.stride(), t.dtype) for t in ts))


def chain_plain(name: str, *ts: torch.Tensor, **options):
    """Chain ``name``'s plain version: each segment's body on the tensors,
    its sites' per-element plain versions in order (their refmath ops one
    launch each on CUDA tensors)."""
    outs = []
    for body, idx in CHAINS[name][0]:
        r = body(_Eager, *(ts[i] for i in idx), **options)
        outs.extend(r if isinstance(r, tuple) else (r,))
    return tuple(outs) if len(outs) > 1 else outs[0]


def chain(name: str, *ts: torch.Tensor, **options):
    """Chain ``name`` of :data:`CHAINS` on its operands: on CPU tensors its
    plain version (each segment's body on the tensors, its sites' plain
    versions in order), on CUDA tensors one launch of
    ``csrc/refmath_sites.cu``'s chain kernel, counted under the chain's
    name.  Returns the outputs of every segment in order (a tuple, or the
    one output)."""
    global LAUNCHES
    dev = ts[0].device
    if dev.type == "cpu":
        return chain_plain(name, *ts, **options)
    if dev.type != "cuda":
        raise RuntimeError(f"refmath.{name}: no kernel for device {dev}")
    key = _chain_key(name, ts, options)
    plan = _CHAIN_CACHE.get(key)
    if plan is None:
        if any(t.device != dev for t in ts) or any(
                t.dtype not in (torch.float32, torch.bool) for t in ts):
            raise TypeError(f"refmath.{name}: float32 operands and bool "
                            f"masks on {dev}")
        blob, n, slots, outputs = _chain_plan(name, ts, options)
        host = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        if torch.cuda.is_available():
            host = host.pin_memory()
        desc = host.to(dev, non_blocking=True)
        plan = _CHAIN_CACHE[key] = (desc, host, n, tuple(slots),
                                    tuple(outputs), desc.data_ptr())
    desc, _, n, slots, outputs, desc_ptr = plan
    outs = [torch.empty(shape, dtype=torch.bool if is_bool else
                        torch.float32, device=dev)
            for shape, is_bool in outputs]
    if n:
        ptrs = [ts[i].data_ptr() for i in slots]
        args = CHAIN_ARGS.pack(
            desc_ptr, n, *ptrs, *([0] * (CHAIN_IN - len(ptrs))),
            *(o.data_ptr() for o in outs), *([0] * (CHAIN_OUT - len(outs))))
        err = _launch_on(dev, _entry("refmath_chain_launch"), args)
        if err != 0:
            raise RuntimeError(f"refmath_chain_launch({name}) failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_OP[name] += 1
    return tuple(outs) if len(outs) > 1 else outs[0]


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
    if op not in SITES and op != "ceres_covariance" and any(
            t.dtype != torch.float32 for t in ts):
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
    return _op("exp", x)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log."""
    return _op("log", x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p."""
    return _op("log1p", x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as compiled: 1 / (exp(-x) + 1)."""
    return _op("sigmoid", x)


def sincos(x: torch.Tensor):
    """(sinf(x), cosf(x)) of the C library, from one launch."""
    return _op("sincos", x)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C library's atan2f."""
    return _op("atan2", y, x)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """atan2f(sinf(t), cosf(t)) in one launch."""
    return _op("wrap_angle", theta)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with one rounding, the operands broadcast together."""
    return _op("fma", a, b, c)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A lone float32 product a * b of operands that are normal or zero
    (flushed by the caller, as the reference's DAZ threads read them), its
    result flushed by its exact value as its FTZ threads flush it: on the
    CPU ``core/refmath.py::mul_ftz`` (the op's plain version,
    ``core/refmath.py::mul``, flushes the operands again: the same result
    for such operands), on the card one launch of the op ``mul``; the
    operands broadcast together."""
    if a.device.type == "cpu":
        return plain.mul_ftz(a, b)
    return _op("mul", a, b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE float32 square root, subnormal operands flushed."""
    return _op("sqrt", x)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values flushed to signed zeros, as the
    reference's threads flush a subnormal result (FTZ) or operand (DAZ),
    one launch."""
    return _op("ftz", x)


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


def ceres_covariance(h: torch.Tensor, final_score: torch.Tensor,
                     n_res: torch.Tensor, p2l: bool = True,
                     fallback=(0.1 ** 2, 0.1 ** 2, 0.01 ** 2)):
    """(cov [B, 3, 3], ok [B]) of ``ops/registration.py::ceres_covariance``
    from its Hessian h [B, 3, 3], final_score [B] and residual counts n_res
    [B] (``core/refmath.py::ceres_covariance``): the reference's 3 x 3
    eigenvalues and guarded inverse, a thread a row, one launch."""
    return _call("ceres_covariance", h, final_score, n_res, p2l=p2l,
                 fallback=tuple(fallback))
