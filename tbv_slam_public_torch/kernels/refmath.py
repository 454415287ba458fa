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
world-frame targets and the radar's motion compensation, one kernel a
site, a thread an element, broadcast operands read through their 32-bit
strides over the merged batch.  The module that owns a site registers it
where it defines it (:func:`register_site`): its plain version, the port's
eager body of that site kept under a ``_plain`` name, and its operands'
layout.  ``cumsum`` is ``detect``'s travelled distance in the reference's
blocked order.  The chains (:func:`chain`) run an ordered list of sites
and their glue in one launch of a kernel generated from the chain's body
(:func:`chains_source`, ``csrc/refmath_chains.cu``).  The ScanContext ops
(``sc_key``, ``sc_ring_distance``, ``sc_distance``; ``csrc/scancontext.cu``)
and ``measured_sqrt_info`` are written out in ``core/refmath.py``.

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
    ceres_covariance=plain.ceres_covariance,
    measured_sqrt_info=plain.measured_sqrt_info, sc_key=plain.sc_key,
    sc_ring_distance=plain.sc_ring_distance, sc_distance=plain.sc_distance)


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
    dims, rows = _merge_batch(dims, rows)
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


def _measured_sqrt_info(op: str, cov: torch.Tensor, scale: torch.Tensor,
                        fallback: torch.Tensor):
    e = cov.shape[0]
    if cov.shape != (e, 3, 3) or scale.shape != (e,) or \
            fallback.shape != (e, 3, 3):
        raise ValueError(f"refmath.measured_sqrt_info: shapes "
                         f"{tuple(cov.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(fallback.shape)}")
    cov, scale, fallback = (t.contiguous() for t in (cov, scale, fallback))
    out = torch.empty_like(cov)
    return (out, "refmath_sqrt_info_launch",
            (cov.data_ptr(), scale.data_ptr(), fallback.data_ptr(),
             out.data_ptr(), e), e)


# ---- ScanContext (csrc/scancontext.cu) -------------------------------------

#: leading dimensions a ScanContext operand may have (kLead)
SC_LEAD = 4
#: ``csrc/scancontext.cu``'s ``RingArgs``: query keys, database keys, mask,
#: odometry similarity and output pointers, rows, database size, rings,
#: the leading shape and three operands' leading strides, the mask's and
#: the similarity's last strides
SC_RING_ARGS = struct.Struct("<5Q4i4i4i4i4i2i")
#: ``PairArgs``: query, candidate, distance and shift pointers, pairs, R,
#: S, the search radius, the leading shape, both operands' leading, ring
#: and sector strides, 1 / R
SC_PAIR_ARGS = struct.Struct("<4Q4i4i4i4i4i2f")


def _lead_strides(t: torch.Tensor, lead: tuple, inner: int) -> list:
    """t's strides over the broadcast leading shape ``lead`` (0 where
    broadcast), left-padded to :data:`SC_LEAD`."""
    nb = t.dim() - inner
    row = [0] * len(lead)
    for j in range(nb):
        if t.shape[j] != 1:
            row[len(lead) - nb + j] = t.stride(j)
    return [0] * (SC_LEAD - len(lead)) + row


def _sc_lead(op: str, *shapes) -> tuple:
    lead = _broadcast(shapes)
    if len(lead) > SC_LEAD:
        raise ValueError(f"refmath.{op}: leading shape {lead} has more than "
                         f"{SC_LEAD} dimensions")
    return lead


def _sc_key(op: str, desc: torch.Tensor, ring: bool = True):
    nr, ns = desc.shape[-2:]
    desc = desc.contiguous()
    out = desc.new_empty(desc.shape[:-2] + ((nr,) if ring else (ns,)))
    rows = desc.numel() // max(nr * ns, 1)
    return (out, "sc_key_launch",
            (desc.data_ptr(), out.data_ptr(), rows, nr, ns, int(ring),
             plain.recip(nr if not ring else ns)), out.numel())


def _sc_ring_distance(op: str, query_key: torch.Tensor, db_key: torch.Tensor,
                      db_mask: torch.Tensor, odom=None):
    floats = [query_key, db_key] + ([] if odom is None else [odom])
    if db_mask.dtype != torch.bool or any(t.dtype != torch.float32
                                          for t in floats):
        raise TypeError(f"refmath.sc_ring_distance: float32 keys and "
                        f"similarity, a bool mask, got "
                        f"{[t.dtype for t in floats]}, {db_mask.dtype}")
    n, nr = db_key.shape
    if query_key.shape[-1] != nr or db_mask.shape[-1] != n or \
            (odom is not None and odom.shape[-1] != n):
        raise ValueError(f"refmath.sc_ring_distance: shapes "
                         f"{tuple(query_key.shape)}, {tuple(db_key.shape)}, "
                         f"{tuple(db_mask.shape)}")
    shapes = [tuple(query_key.shape[:-1]), tuple(db_mask.shape[:-1])]
    if odom is not None:
        shapes.append(tuple(odom.shape[:-1]))
    lead = _sc_lead(op, *shapes)
    db_key = db_key.contiguous()
    if query_key.stride(-1) != 1:  # a key's rings are read in a row
        query_key = query_key.contiguous()
    out = query_key.new_empty(lead + (n,))
    o = odom if odom is not None else db_mask
    args = SC_RING_ARGS.pack(
        query_key.data_ptr(), db_key.data_ptr(), db_mask.data_ptr(),
        0 if odom is None else odom.data_ptr(), out.data_ptr(),
        out.numel() // max(n, 1), n, nr, 0,
        *([1] * (SC_LEAD - len(lead)) + list(lead)),
        *_lead_strides(query_key, lead, 1), *_lead_strides(db_mask, lead, 1),
        *_lead_strides(o, lead, 1), db_mask.stride(-1), o.stride(-1))
    return out, "sc_ring_distance_launch", (args,), out.numel()


def _sc_distance(op: str, query: torch.Tensor, candidate: torch.Tensor,
                 search_ratio: float = 0.1):
    nr, ns = query.shape[-2:]
    if candidate.shape[-2:] != (nr, ns):
        raise ValueError(f"refmath.sc_distance: shapes {tuple(query.shape)}, "
                         f"{tuple(candidate.shape)}")
    lead = _sc_lead(op, tuple(query.shape[:-2]), tuple(candidate.shape[:-2]))
    dist = query.new_empty(lead)
    shift = torch.empty(lead, dtype=torch.int64, device=query.device)
    radius = int(round(0.5 * search_ratio * ns))
    args = SC_PAIR_ARGS.pack(
        query.data_ptr(), candidate.data_ptr(), dist.data_ptr(),
        shift.data_ptr(), dist.numel(), nr, ns, radius,
        *([1] * (SC_LEAD - len(lead)) + list(lead)),
        *_lead_strides(query, lead, 2), *_lead_strides(candidate, lead, 2),
        query.stride(-2), query.stride(-1), candidate.stride(-2),
        candidate.stride(-1), plain.recip(nr), 0.0)
    return (dist, shift), "sc_distance_launch", (args,), dist.numel()


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


#: batch dimensions of a site's launch after merging (csrc/refmath_sites.cu
#: kDims)
SITE_DIMS = 4
#: each site's (operands, outputs, float32 constants): ``csrc/refmath_sites.cu``
#: SiteIO
SITE_IO = {"compose": (2, 1, 0), "inverse": (1, 1, 0), "relative": (2, 1, 0),
           "apply": (2, 1, 0), "rotate": (2, 1, 0), "interpolate": (3, 1, 0),
           "rotmat": (1, 1, 0), "norm2": (1, 1, 0),
           "world_targets": (6, 4, 0), "motion_compensate": (2, 1, 3)}


def _site_struct(n_in: int, n_out: int, n_const: int) -> struct.Struct:
    """``csrc/refmath_sites.cu``'s ``SiteArgs`` of a site: input and output
    pointers, element count, merged dimensions, flags, the batch shape, each
    input's 4 batch and 2 component strides (32-bit), the constants (one
    at least), padded to 8 bytes."""
    fmt = f"<{n_in}Q{n_out}Q3i{SITE_DIMS}i{6 * n_in}i{max(n_const, 1)}f"
    return struct.Struct(fmt + ("4x" if struct.calcsize(fmt) % 8 else ""))


SITE_ARGS = {name: _site_struct(*io) for name, io in SITE_IO.items()}
#: a site launch's argument bytes, by site
SITE_ARG_SIZES = {name: st.size for name, st in SITE_ARGS.items()}


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


def _merge_batch(batch, rows) -> tuple:
    """(merged shape, merged rows of strides): dimensions of one dropped and
    neighbours that every operand walks as one merged (innermost last); at
    least one dimension."""
    keep = [j for j, d in enumerate(batch) if d != 1]
    dims = [batch[j] for j in keep]
    rows = [[r[j] for j in keep] for r in rows]
    j = len(dims) - 2
    while j >= 0:
        if all(r[j] == r[j + 1] * dims[j + 1] for r in rows):
            dims[j + 1] *= dims[j]
            del dims[j]
            for r in rows:
                del r[j]
        j -= 1
    if not dims:
        dims, rows = [1], [[0] for _ in rows]
    return dims, rows


#: (site, flags, constants, each operand's shape, strides and dtype) ->
#: (batch, element count, the packed layout fields, output shapes)
_SITE_PLANS: dict = {}


def _site_plan(op, operands, outs, flags, consts):
    key = (op, flags, tuple(consts), tuple(
        None if t is None else (t.shape, t.stride(), t.dtype, comp)
        for t, comp, _ in operands))
    plan = _SITE_PLANS.get(key)
    if plan is not None:
        return plan
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
                        for t, comp, _ in operands if t is not None])
    rows, comps = [], []
    for t, comp, _ in operands:
        row, cst = [0] * len(batch), [0, 0]
        if t is not None:
            nb = t.dim() - len(comp)
            for j in range(nb):
                if t.shape[j] != 1:
                    row[len(batch) - nb + j] = t.stride(j)
            cst[:len(comp)] = t.stride()[nb:]
        rows.append(row)
        comps.append(cst)
    dims, rows = _merge_batch(batch, rows)
    if len(dims) > SITE_DIMS:
        raise ValueError(f"refmath.{op}: batch {batch} has more than "
                         f"{SITE_DIMS} dimensions after merging")
    n = math.prod(batch)
    if n >= 2 ** 31 or any(t is not None and t.numel() >= 2 ** 31
                           for t, _, _ in operands):
        raise ValueError(f"refmath.{op}: more than 2^31 elements")
    pad = SITE_DIMS - len(dims)
    strides = []
    for row, cst in zip(rows, comps):
        strides += [0] * pad + row + cst
    fields = (n, len(dims), flags, *([1] * pad + dims), *strides,
              *(tuple(consts) or (0.0,)))
    out_shapes = [None if sh is None else
                  (batch, torch.bool) if sh == "bool" else
                  (batch + sh, torch.float32) for sh in outs]
    plan = (batch, n, fields, out_shapes)
    if len(_SITE_PLANS) < 4096:
        _SITE_PLANS[key] = plan
    return plan


def _site(layout, op: str, *ts, **options):
    """One launch of site ``op``'s kernel over the operands' broadcast
    batch: its ``SiteArgs`` (:data:`SITE_ARGS`) packed from the site's
    registered ``layout`` and the plan cached by shapes and strides."""
    operands, outs, flags, consts = layout(*ts, **options)
    _, n, fields, out_shapes = _site_plan(op, operands, outs, flags, consts)
    dev = ts[0].device
    results = [None if sh is None else torch.empty(sh[0], dtype=sh[1],
                                                   device=dev)
               for sh in out_shapes]
    args = SITE_ARGS[op].pack(
        *(0 if t is None else t.data_ptr() for t, _, _ in operands),
        *(0 if r is None else r.data_ptr() for r in results), *fields)
    result = tuple(results) if len(results) > 1 else results[0]
    return result, "refmath_site_launch", (SITES[op], args), n


_KERNEL_ARGS = dict(dot=_dot, loop_dot=_loop_dot, lm_update=_lm_update,
                    lu_solve=_lu_solve, cumsum=_cumsum,
                    ceres_covariance=_ceres_covariance,
                    measured_sqrt_info=_measured_sqrt_info, sc_key=_sc_key,
                    sc_ring_distance=_sc_ring_distance,
                    sc_distance=_sc_distance)
#: ops whose operands are not all float32
_MIXED = frozenset({"ceres_covariance", "sc_ring_distance"})


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


# ---- site chains (csrc/refmath_chains.cu, made by chain_source) ------------

#: segments (index spaces) of one chain launch
CHAIN_SEGS = 2
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
#: shapes, the indices of the bool operands)
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
    """A chain body's operations recorded as steps (op, dst, a, b, c, k, j,
    n), for one segment: registers (a float value of the element each)
    numbered in order, never reused; a constant a slot of the launch's
    constants per use, so that the steps do not depend on the options'
    values (``flags``: the options that select code, bit 0 the motion's
    ccw)."""

    def __init__(self, consts):
        self.steps, self.consts, self.nregs, self.flags = [], consts, 0, 0

    def emit(self, op, a=0, b=0, c=0, k=0, j=0, n=0, width=1):
        dst = self.nregs if op not in ("store", "store_bool") else 0
        if op not in ("store", "store_bool"):
            self.nregs += width
        self.steps.append((_OPCODE[op], dst, a, b, c, k, j, n))
        return dst

    def const(self, x: float) -> int:
        """A register holding the float32 nearest x (as torch rounds a
        Python number against a float32 tensor)."""
        self.consts.append(float(torch.tensor(float(x), dtype=torch.float32)))
        return self.emit("const", k=len(self.consts) - 1)

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
        k = 0
        if name == "motion_compensate":
            k = len(self.consts)
            self.consts.extend(plain.motion_constants())
            self.flags |= int(bool(options.get("ccw", False)))
        dst = self.emit(name, a=a, b=b, k=k, width=width)
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


def register_chain(name: str, segments, operand_shapes, bools=()) -> None:
    """Register chain ``name``: ``segments`` a list of (body, operand
    indices), each body ``body(k, *operands, **options)`` written once for
    both runs (``k`` is the plain version's tensor operations or the
    kernel's recorder) returning its outputs; ``operand_shapes`` each
    operand's component shape ((3,) a pose, (2,) a point, () a scalar or
    bool); ``bools`` the indices of the bool operands."""
    if len(segments) > CHAIN_SEGS or any(len(s) > 1 for s in operand_shapes):
        raise ValueError(f"refmath chain {name}: more than {CHAIN_SEGS} "
                         "segments, or an operand of more than one "
                         "component dimension")
    CHAINS[name] = (tuple(segments), tuple(tuple(s) for s in operand_shapes),
                    frozenset(bools))


def _record(name, options):
    """Chain ``name``'s program: (per segment (the operand indices, the
    steps, the outputs' (component shape, is_bool))), the constants'
    values, the flags), recorded from its body with ``options``."""
    segments, shapes, bools = CHAINS[name]
    consts, segs, flags = [], [], 0
    slot = 0
    for body, idx in segments:
        rec = _Recorder(consts)
        vals = []
        for i in idx:
            comp = shapes[i]
            width = max(1, math.prod(comp))
            op = "load_bool" if i in bools else "load"
            vals.append(_Value(rec, [rec.emit(op, k=slot, j=j)
                                     for j in range(width)], comp,
                               i in bools))
            slot += 1
        outs = body(rec, *vals, **options)
        outs = outs if isinstance(outs, tuple) else (outs,)
        kinds = []
        for v in outs:
            if v.is_bool and v.shape:
                raise ValueError(f"refmath chain {name}: a bool output with "
                                 "components")
            k = sum(len(s[2]) for s in segs) + len(kinds)
            kinds.append((v.shape, v.is_bool))
            for j, r in enumerate(v.regs):
                rec.emit("store_bool" if v.is_bool else "store", a=r, k=k,
                         j=j, n=len(v.regs))
        segs.append((tuple(idx), tuple(rec.steps), tuple(kinds)))
        flags |= rec.flags
    return tuple(segs), tuple(consts), flags


def _canonical_options(name) -> dict:
    """Options to record a chain's code with: each keyword-only parameter of
    its bodies 0 (the steps do not depend on their values)."""
    import inspect

    opts = {}
    for body, _ in CHAINS[name][0]:
        for p in inspect.signature(body).parameters.values():
            if p.kind is p.KEYWORD_ONLY:
                opts[p.name] = 0.0
    return opts


@functools.lru_cache(maxsize=None)
def _program(name):
    """Chain ``name``'s steps as the kernel was made from them."""
    return _record(name, _canonical_options(name))[0]


@functools.lru_cache(maxsize=None)
def _chain_sizes(name):
    """(operands, outputs, constants) of chain ``name``'s kernel."""
    segs, consts, _ = _record(name, _canonical_options(name))
    return (sum(len(s[0]) for s in segs), sum(len(s[2]) for s in segs),
            max(len(consts), 1))


def chain_struct(name) -> struct.Struct:
    """``csrc/refmath_chains.cu``'s ``ChainArgs`` of chain ``name``: operand
    and output pointers, the element count, segment 1's first element, the
    flags, each segment's merged dimensions and batch shape, each
    operand's 4 batch and 1 component strides (32-bit), the constants (one
    at least); padded to 8 bytes."""
    n_in, n_out, n_const = _chain_sizes(name)
    fmt = (f"<{n_in}Q{n_out}Q3i{CHAIN_SEGS}i{CHAIN_SEGS * SITE_DIMS}i"
           f"{5 * n_in}i{n_const}f")
    return struct.Struct(fmt + ("4x" if struct.calcsize(fmt) % 8 else ""))


#: chain kernels of csrc/refmath_chains.cu, in their ids' order
CHAIN_KERNELS = ("alignment_apply", "local_map", "loop_guess",
                 "motion_compensate_pair", "odometry_pose_tail")

#: (chain, options, each operand's shape, strides and dtype, card) -> plan
_CHAIN_CACHE: dict = {}


def _chain_plan(name, ts, options):
    """Chain ``name``'s launch for these operands: (the ``ChainArgs``
    fields after the pointers, element count, each output's (shape,
    is_bool)); the recorded steps must be those the kernel was made from."""
    segments, shapes, bools = CHAINS[name]
    segs, consts, flags = _record(name, options)
    if tuple(s[:2] for s in segs) != tuple(s[:2] for s in _program(name)):
        raise RuntimeError(f"refmath chain {name}: its body records other "
                           "steps than csrc/refmath_chains.cu runs (run "
                           "scripts/gen_refmath_chains.py)")
    starts, dims_all, shape_all, strides, outputs = [0], [], [], [], []
    for (idx, _, kinds) in segs:
        batch = _broadcast([tuple(ts[i].shape[:ts[i].dim() - len(shapes[i])])
                            for i in idx])
        rows, comps = [], []
        for i in idx:
            t, comp = ts[i], shapes[i]
            if (t.dtype == torch.bool) != (i in bools):
                raise TypeError(f"refmath.{name}: operand {i} of type "
                                f"{t.dtype}")
            nb = t.dim() - len(comp)
            row = [0] * len(batch)
            for q in range(nb):
                if t.shape[q] != 1:
                    row[len(batch) - nb + q] = t.stride(q)
            rows.append(row)
            comps.append(t.stride(-1) if comp else 0)
        dims, rows = _merge_batch(batch, rows)
        if len(dims) > SITE_DIMS:
            raise ValueError(f"refmath chain {name}: batch {batch}")
        pad = SITE_DIMS - len(dims)
        dims_all.append(len(dims))
        shape_all += [1] * pad + dims
        for row, cst in zip(rows, comps):
            strides += [0] * pad + row + [cst]
        n = math.prod(batch)
        starts.append(starts[-1] + n)
        outputs += [(batch + sh, b) for sh, b in kinds]
    if starts[-1] >= 2 ** 31 or any(t.numel() >= 2 ** 31 for t in ts):
        raise ValueError(f"refmath chain {name}: more than 2^31 elements")
    nseg = len(segs)
    dims_all += [1] * (CHAIN_SEGS - nseg)
    shape_all += [1] * (SITE_DIMS * (CHAIN_SEGS - nseg))
    fields = (starts[-1], starts[1], flags, *dims_all, *shape_all, *strides,
              *(consts or (0.0,)))
    return fields, starts[-1], outputs


def _chain_key(name, ts, options):
    """The key of a chain's launch plan: the chain, its options and each
    operand's shape, strides and dtype."""
    return (name, tuple(sorted(options.items())),
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
    versions in order), on CUDA tensors one launch of its kernel in
    ``csrc/refmath_chains.cu``, counted under the chain's name.  Returns
    the outputs of every segment in order (a tuple, or the one output)."""
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
        fields, n, outputs = _chain_plan(name, ts, options)
        slots = tuple(i for idx, _, _ in _program(name) for i in idx)
        plan = (fields, n, outputs, slots, chain_struct(name))
        if len(_CHAIN_CACHE) < 4096:
            _CHAIN_CACHE[key] = plan
    fields, n, outputs, slots, st = plan
    outs = [torch.empty(shape, dtype=torch.bool if is_bool else
                        torch.float32, device=dev)
            for shape, is_bool in outputs]
    if n:
        args = st.pack(*(ts[i].data_ptr() for i in slots),
                       *(o.data_ptr() for o in outs), *fields)
        err = _launch_on(dev, _entry("refmath_chain_launch"),
                         CHAIN_KERNELS.index(name), args)
        if err != 0:
            raise RuntimeError(f"refmath_chain_launch({name}) failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_OP[name] += 1
    return tuple(outs) if len(outs) > 1 else outs[0]


# ---- the chain kernels' source ---------------------------------------------

_GLUE = {"mul": "__fmul_rn(r{a}, r{b})", "sub": "__fsub_rn(r{a}, r{b})",
         "neg": "-r{a}", "abs": "fabsf(r{a})",
         "le": "r{a} <= r{b} ? 1.0f : 0.0f",
         "lt": "r{a} < r{b} ? 1.0f : 0.0f",
         "and_": "(r{a} != 0.0f && r{b} != 0.0f) ? 1.0f : 0.0f",
         "or_": "(r{a} != 0.0f || r{b} != 0.0f) ? 1.0f : 0.0f",
         "where": "r{c} != 0.0f ? r{a} : r{b}"}

_CHAIN_PREAMBLE = '''\
// The refmath site chains: one kernel a chain, straight-line code from the
// chain's body (kernels/refmath.py::register_chain), each later site
// reading the earlier ones' results from registers.
//
// MADE BY kernels/refmath.py::chain_source; do not edit.  Regenerate with
// `python3 scripts/gen_refmath_chains.py` after changing a chain's body
// (tests/test_torch_chains.py::test_chain_source_is_current holds this
// file to its bodies).
//
// Not a TPU kernel: XLA fuses these pose-algebra tails.  A chain's body
// runs twice: on tensors (kernels/refmath.py::chain_plain, its plain
// version: each site's plain version in order) and on a recorder, whose
// steps are written out below one statement each: a value is a named
// float that nvcc keeps in a register, a site a call of its device
// function (refmath_sites.cuh), the glue one __fmul_rn / __fsub_rn /
// compare / select each, in the body's order, so the kernel's bits are
// the body's by construction.  A bool is 1.0f or 0.0f.  One thread an
// element of one of the chain's (at most two) segments; a segment's
// operands are read through their 32-bit strides over its merged batch
// shape (no division where it merged into one dimension), a site over a
// coarser index space than a later one recomputed for each element (the
// same function on the same inputs, so the same bits).  A launch passes
// the pointers, the shapes and strides and the body's float32 constants
// (ChainArgs, built by kernels/refmath.py::chain, no description in device
// memory).  Bound: a few hundred bytes and operations an element on 1 to
// a few hundred thousand elements, so a launch is latency.
#include "refmath_sites.cuh"

namespace {

constexpr int kChainDims = 4;

// kernels/refmath.py::chain_struct packs it
template <int NI, int NO, int NC>
struct ChainArgs {
  const void* in[NI];
  void* out[NO];
  int n;       // elements over both segments
  int start1;  // segment 1's first element (n with one segment)
  int flags;   // bit 0: the motion compensation's ccw
  int ndim[2];
  int shape[2][kChainDims];
  int stride[NI][kChainDims + 1];  // batch, then the component
  float c[NC];
};

// the element offsets of the segment's operands first .. first + NS - 1
// at its index li: the merged dimensions' coordinates by 32-bit division,
// innermost first, the outermost what is left
template <int NS, int NI, int NO, int NC>
__device__ __forceinline__ void chain_offsets(const ChainArgs<NI, NO, NC>& a,
                                              int seg, int first, int li,
                                              int* off) {
#pragma unroll
  for (int k = 0; k < NS; ++k) off[k] = 0;
  unsigned rest = (unsigned)li;
  const int outer = kChainDims - a.ndim[seg];
  // unrolled: every index into the arguments a constant, so they are read
  // where they lie and never copied to local memory
#pragma unroll
  for (int d = kChainDims - 1; d >= 0; --d) {
    if (d > outer) {
      const unsigned m = (unsigned)a.shape[seg][d];
      const int c = (int)(rest % m);
      rest /= m;
#pragma unroll
      for (int k = 0; k < NS; ++k) off[k] += c * a.stride[first + k][d];
    } else if (d == outer) {
#pragma unroll
      for (int k = 0; k < NS; ++k) off[k] += (int)rest * a.stride[first + k][d];
    }
  }
}

__device__ __forceinline__ float ld_f(const void* p, int o) {
  return static_cast<const float*>(p)[o];
}

__device__ __forceinline__ float ld_b(const void* p, int o) {
  return static_cast<const unsigned char*>(p)[o] ? 1.0f : 0.0f;
}
'''


def _chain_args_type(name) -> str:
    return "ChainArgs<{}, {}, {}>".format(*_chain_sizes(name))


def _segment_source(segs, s, first) -> list:
    idx, steps, _ = segs[s]
    ns = len(idx)
    li = "i" if s == 0 else "i - a.start1"
    lines = [f"const int li = {li};", f"int off[{ns}];",
             f"chain_offsets<{ns}>(a, {s}, {first}, li, off);"]
    names = {v: k for k, v in _OPCODE.items()}
    vec = lambda r, w: "{" + ", ".join(f"r{r + q}" for q in range(w)) + "}"
    for op, dst, a, b, c, k, j, n in steps:
        name = names[op]
        if name in ("load", "load_bool"):
            fn = "ld_b" if name == "load_bool" else "ld_f"
            o = f"off[{k - first}]" + (
                f" + {j} * a.stride[{k}][kChainDims]" if j else "")
            lines.append(f"const float r{dst} = {fn}(a.in[{k}], {o});")
        elif name == "const":
            lines.append(f"const float r{dst} = a.c[{k}];")
        elif name == "store":
            lines.append(f"static_cast<float*>(a.out[{k}])[li * {n} + {j}] "
                         f"= r{a};")
        elif name == "store_bool":
            lines.append(f"static_cast<unsigned char*>(a.out[{k}])[li] = "
                         f"r{a} != 0.0f;")
        elif name in _GLUE:
            lines.append(f"const float r{dst} = "
                         + _GLUE[name].format(a=a, b=b, c=c) + ";")
        elif name == "norm2":
            lines.append(f"const float r{dst} = norm2f(r{a}, r{a + 1});")
        else:
            width = max(1, math.prod(CHAIN_SITES[name][1]))
            outs = ", ".join(f"r{dst + q}" for q in range(width))
            body = {
                "compose": f"const float x[3] = {vec(a, 3)}, "
                           f"y[3] = {vec(b, 3)}; compose3(x, y, o);",
                "inverse": f"const float x[3] = {vec(a, 3)}; "
                           "inverse3(x, o);",
                "relative": f"const float x[3] = {vec(a, 3)}, "
                            f"y[3] = {vec(b, 3)}; float v[3]; "
                            "inverse3(x, v); compose3(v, y, o);",
                "apply": f"const float x[3] = {vec(a, 3)}; "
                         f"apply2(x, r{b}, r{b + 1}, true, o);",
                "rotmat": f"float sn, cs; ref_sincos(r{a}, &sn, &cs); "
                          "o[0] = cs; o[1] = -sn; o[2] = sn; o[3] = cs;",
                "motion_compensate":
                    f"const float m[3] = {vec(b, 3)}, k[3] = {{a.c[{k}], "
                    f"a.c[{k + 1}], a.c[{k + 2}]}}; motion2(r{a}, r{a + 1}, "
                    "m, k, (a.flags & 1) != 0, o);",
            }[name]
            lines.append(f"float {outs};")
            assign = " ".join(f"r{dst + q} = o[{q}];" for q in range(width))
            lines.append(f"{{ float o[{width}]; {body} {assign} }}")
    return lines


def chain_source(name: str) -> str:
    """The CUDA kernel of chain ``name``: its recorded steps written out
    (``csrc/refmath_chains.cu``'s section of that chain)."""
    segs = _program(name)
    out = [f"// ---- {name} " + "-" * max(0, 72 - len(name)),
           f"__global__ void __launch_bounds__(128)",
           f"    chain_{name}(const {_chain_args_type(name)} a) {{",
           "  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;",
           "       i += gridDim.x * blockDim.x) {"]
    first = 0
    for s in range(len(segs)):
        ind = "    "
        if len(segs) > 1:
            out.append(ind + ("if (i < a.start1) {" if s == 0 else
                              "} else {"))
            ind += "  "
        out += [ind + line for line in _segment_source(segs, s, first)]
        first += len(segs[s][0])
    if len(segs) > 1:
        out.append("    }")
    out += ["  }", "}",
            f"static_assert(sizeof({_chain_args_type(name)}) == "
            f"{chain_struct(name).size}, \"kernels/refmath.py::"
            "chain_struct\");", ""]
    return "\n".join(out)


def chains_source() -> str:
    """The whole of ``csrc/refmath_chains.cu``: every chain of
    :data:`CHAIN_KERNELS` (their owners' modules imported first) and the
    launch entry."""
    if set(CHAINS) != set(CHAIN_KERNELS):
        raise RuntimeError(f"refmath chains {sorted(CHAINS)} against the "
                           f"kernels {CHAIN_KERNELS}")
    parts = [_CHAIN_PREAMBLE] + [chain_source(n) for n in CHAIN_KERNELS]
    launch = ["}  // namespace", "",
              "template <class Args>",
              "int launch_chain(void (*kernel)(Args), const void* args, "
              "void* stream) {",
              "  const Args& a = *static_cast<const Args*>(args);",
              "  if (a.n <= 0) return 0;",
              "  const int threads = 128;",
              "  int blocks = (a.n + threads - 1) / threads;",
              "  if (blocks > 132 * 16) blocks = 132 * 16;",
              "  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);",
              "  return (int)cudaGetLastError();", "}", "",
              "// One launch of chain `chain` (kernels/refmath.py::"
              "CHAIN_KERNELS) whose",
              "// arguments (its ChainArgs) args points to.",
              "extern \"C\" int refmath_chain_launch(int chain, "
              "const void* args, void* stream) {",
              "  switch (chain) {"]
    for i, n in enumerate(CHAIN_KERNELS):
        launch.append(f"    case {i}: return launch_chain(chain_{n}, args, "
                      "stream);")
    launch += ["  }", "  return (int)cudaErrorInvalidValue;", "}", ""]
    return "\n".join(parts) + "\n" + "\n".join(launch)


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
    if op not in SITES and op not in _MIXED and any(
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


def measured_sqrt_info(cov: torch.Tensor, scale: torch.Tensor,
                       fallback: torch.Tensor) -> torch.Tensor:
    """``ops/posegraph.py::measured_sqrt_info``'s whitening of covariances
    cov [E, 3, 3] scaled by scale [E], ``fallback`` [E, 3, 3] where the
    factor fails (``core/refmath.py::measured_sqrt_info``: the reference's
    inverse and Cholesky factor as jaxlib's LAPACK rounds them), a thread
    an edge, one launch."""
    return _call("measured_sqrt_info", cov, scale, fallback)


def sc_key(desc: torch.Tensor, ring: bool = True) -> torch.Tensor:
    """ScanContext's ring key (``ring``) or sector key of descriptors [...,
    R, S] (``core/refmath.py::sc_key``), one launch."""
    return _call("sc_key", desc, ring=ring)


def sc_ring_distance(query_key: torch.Tensor, db_key: torch.Tensor,
                     db_mask: torch.Tensor, odom=None) -> torch.Tensor:
    """``retrieve``'s squared ring-key distances [..., N]
    (``core/refmath.py::sc_ring_distance``), one launch."""
    return _call("sc_ring_distance", query_key, db_key, db_mask, odom)


def sc_distance(query: torch.Tensor, candidate: torch.Tensor,
                search_ratio: float = 0.1):
    """(distance, shift) of ScanContext descriptor pairs [..., R, S]
    broadcast together (``core/refmath.py::sc_distance``), a block a pair,
    one launch."""
    return _call("sc_distance", query, candidate, search_ratio=search_ratio)
