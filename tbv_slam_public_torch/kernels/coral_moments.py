"""CorAl radius-neighbour moments: CUDA kernel wrappers + plain versions.

Replaces ``tbv_slam_public_tpu/pallas/coral_moments.py`` (``_moments_kernel``
launched by ``neighbor_moments``), batched over a leading pair axis M so one
launch covers a whole loop-verification wave instead of a ``vmap``.  The
kernel is ``csrc/coral_moments.cu``; its design notes (bound by float32
operations; live points and live queries only, compacted on the card;
register-tiled queries, a branch on the radius gate, the reference's fused
distance,
the points of a query block shared among its warps) are in that file.

:func:`neighbor_moments` is the TPU kernel's counterpart: one (query cloud,
point cloud) combination.  :func:`pair_moments` runs the same device code
over the four combinations that ``coral_quality`` needs of M (src, ref)
pairs, in one launch.

Dispatch is by tensor device: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel launches
and nothing else.  One launch is one call of a C entry point: the moments
kernel with, on the same stream, the small kernel that compacts the clouds
before it, which is not counted again.

:func:`coral_tail` launches the same file's ``coral_tail_kernel``: CorAl's
per-point terms and the pairs' sums after the moments (the CUDA side of
``ops/coral.py::coral_tail``, whose plain version is
``coral_tail_reference``); ``TAIL_LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from ..core.refmath import fma, ftz, sum_ftz
from .refmath import _launch_on

#: number of kernel launches made by :func:`neighbor_moments` and
#: :func:`pair_moments`
LAUNCHES = 0
#: number of launches of the ``coral_tail`` kernel (:func:`coral_tail`)
TAIL_LAUNCHES = 0

_MAX_ROWS = 65535  # gridDim.y


#: the reference's compiled CPU program splits every sum over a cloud's
#: slots into sums over windows of this many slots (the row padded evenly
#: on both ends to whole windows), then windows of those sums, until at most
#: this many remain
_WINDOW = 32


def neighbor_moments_reference(queries, qmask, points, pmask, radius,
                               chunk_bytes: int = 1 << 28):
    """Plain PyTorch version of the moments, summed as the reference's
    compiled CPU program sums them (``ops/coral._neighbor_moments`` of the
    reference with the pair axis written out).

    One row at a time, over its live slots only: a row's live queries and
    live points are gathered, the [Lq, Lp] relative positions are formed on
    them (chunked over the queries so a chunk stays under ``chunk_bytes``),
    and each query's neighbours are taken in slot order (the other slots'
    terms are exact zeros in the reference).  Σ(p−q)(p−q)ᵀ is the
    reference's dot loop: one fused multiply-add a neighbour, in slot
    order.  Σ(p−q) is its windowed sum (:data:`_WINDOW`): in slot order
    within a window, then over the windows in order.  So a row's moments
    depend on nothing but that row, as each pair of the reference's ``vmap``
    is independent.  The radius gate rounds as the reference's: its
    two-term sum of squares is one fused multiply-add, fma(dy, dy, dx*dx),
    as the kernel's.

    queries [M, Q, 2], qmask [M, Q], points [M, P, 2], pmask [M, P] ->
    (count [M, Q], sum_rel [M, Q, 2], sum_sq [M, Q, 2, 2]), float32."""
    m, q = qmask.shape
    n_slots = pmask.shape[1]
    dt, dev = queries.dtype, queries.device
    count = torch.zeros((m, q), dtype=dt, device=dev)
    sum_rel = torch.zeros((m, q, 2), dtype=dt, device=dev)
    sum_sq = torch.zeros((m, q, 2, 2), dtype=dt, device=dev)
    levels, width = [], n_slots  # each window level's leading padding
    while width > _WINDOW:
        nb = -(-width // _WINDOW)
        levels.append((nb * _WINDOW - width) // 2)
        width = nb
    for i in range(m):
        qi = torch.nonzero(qmask[i]).squeeze(1)
        pslot = torch.nonzero(pmask[i]).squeeze(1)
        lq, lp = qi.shape[0], pslot.shape[0]
        if lq == 0 or lp == 0:
            continue
        ps = points[i, pslot]
        step = max(1, chunk_bytes // (lp * 2 * 4))
        for lo in range(0, lq, step):
            idx = qi[lo:lo + step]
            n, s1, s2 = _ordered_moments(queries[i, idx], ps, pslot, radius,
                                         levels)
            count[i, idx], sum_rel[i, idx], sum_sq[i, idx] = n, s1, s2
    return count, sum_rel, sum_sq


def _ordered_moments(qs, ps, pslot, radius, levels):
    """Moments of queries qs [l, 2] over points ps [Lp, 2] (their slots
    ``pslot``), summed in the reference's order (see
    :func:`neighbor_moments_reference`)."""
    l, dt = qs.shape[0], qs.dtype
    # subnormal offsets, products and sums flushed (the reference's threads
    # run with DAZ and FTZ)
    rx = ftz(ps[None, :, 0] - qs[:, None, 0])  # [l, Lp]
    ry = ftz(ps[None, :, 1] - qs[:, None, 1])
    near = fma(ry, ry, rx * rx) <= radius * radius
    count = near.sum(1)
    k = int(count.max())
    # each query's neighbours in slot order: [l, K], zero terms past its count
    row, col = torch.nonzero(near, as_tuple=True)
    pos = torch.arange(row.shape[0], device=qs.device) \
        - (torch.cumsum(count, 0) - count)[row]
    rel = torch.zeros((l, k, 2), dtype=dt, device=qs.device)
    rel[row, pos] = torch.stack([rx[row, col], ry[row, col]], -1)
    slot = torch.zeros((l, k), dtype=pslot.dtype, device=qs.device)
    slot[row, pos] = pslot[col]
    # Σ(p−q)(p−q)ᵀ: xx, xy, yy, one rounding a step (the float64 products
    # are exact), flushed by the exact sum as the kernel's fma.rn.ftz
    prod = rel.double()[..., [0, 0, 1]] * rel.double()[..., [0, 1, 1]]
    sq = torch.zeros((l, 3), dtype=dt, device=qs.device)
    for j in range(k):
        sq = sum_ftz(prod[:, j], sq)
    # Σ(p−q): acc[0] sums within the current window, acc[v] the sums of
    # level-v windows; a neighbour in a new window first hands each finished
    # level's sum up.  window[v] [l, K]: each neighbour's level-v window.
    window = [slot]
    for pad in levels:
        window.append((window[-1] + pad) // _WINDOW)
    acc = [torch.zeros((l, 2), dtype=dt, device=qs.device)
           for _ in range(len(levels) + 1)]
    for j in range(k):
        if j:
            for v in range(1, len(levels) + 1):
                new = (window[v][:, j] != window[v][:, j - 1])[:, None]
                acc[v] = torch.where(new, ftz(acc[v] + acc[v - 1]), acc[v])
                acc[v - 1] = torch.where(new, torch.zeros_like(acc[v - 1]),
                                         acc[v - 1])
        acc[0] = ftz(acc[0] + rel[:, j])
    for v in range(1, len(levels) + 1):
        acc[v] = ftz(acc[v] + acc[v - 1])
    sum_sq = torch.stack([torch.stack([sq[:, 0], sq[:, 1]], -1),
                          torch.stack([sq[:, 1], sq[:, 2]], -1)], -2)
    return count.to(dt), acc[-1], sum_sq


def pair_moments_reference(src_xy, src_mask, ref_xy, ref_mask, radius):
    """Plain PyTorch version of :func:`pair_moments`: four calls of
    :func:`neighbor_moments_reference`, laid out as the kernel's outputs."""
    src, ref = (src_xy, src_mask), (ref_xy, ref_mask)
    own = zip(neighbor_moments_reference(*src, *src, radius),
              neighbor_moments_reference(*ref, *ref, radius))
    other = zip(neighbor_moments_reference(*src, *ref, radius),
                neighbor_moments_reference(*ref, *src, radius))
    return tuple(torch.stack([torch.cat(a, 1), torch.cat(b, 1)])
                 for a, b in zip(own, other))


def neighbor_moments(queries, qmask, points, pmask, radius):
    """Per-query radius-neighbourhood moments of (p - q) for a batch of M
    (query cloud, point cloud) pairs; shapes as the plain version."""
    dev = queries.device
    if dev.type == "cpu":
        return neighbor_moments_reference(queries, qmask, points, pmask,
                                          radius)
    if dev.type != "cuda":
        raise ValueError(f"coral moments: unsupported device {dev}")
    return _launch("coral_moments_launch", queries, qmask, points, pmask,
                   float(radius))


def pair_moments(src_xy, src_mask, ref_xy, ref_mask, radius):
    """The four moment sets CorAl needs of M (src [M, S], ref [M, R]) cloud
    pairs, in one kernel launch.

    Returns (count [2, M, S + R], sum_rel [2, M, S + R, 2], sum_sq
    [2, M, S + R, 2, 2]), float32: along the query axis the S src slots, then
    the R ref slots; index 0 of the leading axis holds a query's moments over
    the points of its own cloud, index 1 over the other cloud's."""
    dev = src_xy.device
    if dev.type == "cpu":
        return pair_moments_reference(src_xy, src_mask, ref_xy, ref_mask,
                                      radius)
    if dev.type != "cuda":
        raise ValueError(f"coral moments: unsupported device {dev}")
    return _launch("coral_pair_moments_launch", src_xy, src_mask, ref_xy,
                   ref_mask, float(radius))


def _points(x):
    """[M, N, 2] float32 with contiguous points, an even row stride and
    8-byte alignment (the kernel loads float2); converted only if it is not
    so already.  A row stride of 0 (a broadcast cloud) passes."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    s = x.stride()
    if s[2] != 1 or s[1] != 2 or s[0] % 2:
        x = x.contiguous()
    return x if x.data_ptr() % 8 == 0 else x.clone()


def _mask(x):
    """[M, N] bytes, contiguous along N: a bool mask is viewed, not copied."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    elif x.dtype != torch.uint8:
        x = (x != 0).view(torch.uint8)
    return x if x.stride(1) == 1 else x.contiguous()


def _launch(entry, a_xy, a_mask, b_xy, b_mask, radius: float):
    """``coral_moments_launch``: a = queries, b = points, outputs [M, Qa].
    ``coral_pair_moments_launch``: a = src, b = ref, outputs
    [2, M, Sa + Rb]."""
    global LAUNCHES
    from .build import library

    m, na = a_mask.shape
    nb = b_mask.shape[1]
    dev = a_xy.device
    if a_xy.shape != (m, na, 2) or b_xy.shape != (m, nb, 2) \
            or b_mask.shape != (m, nb):
        raise ValueError(f"coral moments: bad shapes {tuple(a_xy.shape)} "
                         f"{tuple(a_mask.shape)} {tuple(b_xy.shape)} "
                         f"{tuple(b_mask.shape)}")
    if m > _MAX_ROWS:
        raise ValueError(f"coral moments: {m} pair rows, at most {_MAX_ROWS}")
    for t in (a_mask, b_xy, b_mask):
        if t.device != dev:
            raise ValueError("coral moments: inputs on different devices")
    lead = (2, m, na + nb) if entry == "coral_pair_moments_launch" \
        else (m, na)
    n = math.prod(lead)
    # the kernel's scratch: live counts, slots and points of both clouds (the
    # layout is the kernel's, which checks the size)
    rows = m * (na + na % 2 + nb + nb % 2)
    scratch = 2 * m + 3 * rows + 16
    # one allocation: sum_sq, sum_rel, count (the kernel's layout), scratch
    at = -(-7 * n // 4) * 4
    buf = torch.empty(at + scratch, dtype=torch.float32, device=dev)
    sum_sq = buf.as_strided(lead + (2, 2), _strides(lead + (2, 2)))
    sum_rel = buf.as_strided(lead + (2,), _strides(lead + (2,)), 4 * n)
    count = buf.as_strided(lead, _strides(lead), 6 * n)
    if n == 0:
        return count, sum_rel, sum_sq
    ax, am, bx, bm = _points(a_xy), _mask(a_mask), _points(b_xy), \
        _mask(b_mask)
    with torch.cuda.device(dev):  # the launch goes to the tensors' card
        err = getattr(library(), entry)(
            ax.data_ptr(), am.data_ptr(), bx.data_ptr(), bm.data_ptr(),
            ax.stride(0) // 2, am.stride(0), bx.stride(0) // 2, bm.stride(0),
            m, na, nb, radius * radius, buf.data_ptr(),
            buf.data_ptr() + 4 * at, scratch,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("coral_moments kernel launch failed: " + (
            "scratch too small" if err < 0 else f"CUDA error {err}"))
    LAUNCHES += 1
    return count, sum_rel, sum_sq


def _strides(shape):
    """Contiguous strides of ``shape``."""
    out, step = [], 1
    for size in reversed(shape):
        out.append(step)
        step *= size
    return tuple(reversed(out))


#: the CTAs a pair (the thread-block cluster) of the last ``coral_tail``
#: launch
TAIL_CLUSTER = 0
#: ``csrc/coral_moments.cu``'s ``TailParams``: the moments' and masks'
#: pointers, the masks' row strides, M, S, R, kl, eps, 2 pi e and the four
#: outputs' pointers
TAIL_PARAMS = struct.Struct("<5Q2q4i2f4Q")


@functools.lru_cache(maxsize=64)
def _tail_constants(eps: float):
    """(eps, 2 pi e) rounded to float32, as the plain version's float32
    tensors hold them."""
    f32 = lambda x: struct.unpack("<f", struct.pack("<f", x))[0]
    return f32(eps), f32(2.0 * math.pi * math.e)


def coral_tail(n, s1, s2, src_mask, ref_mask, eps: float, mode: str,
               cluster: int = 0):
    """(joint, sep, overlap [M] float32, valid [M] bool) of CorAl from M
    pairs' moments (``pair_moments``' outputs: n [2, M, Q], s1
    [2, M, Q, 2], s2 [2, M, Q, 2, 2], Q = S + R) and masks (src [M, S],
    ref [M, R]), one launch of ``csrc/coral_moments.cu``'s
    ``coral_tail_kernel`` on CUDA tensors (``ops/coral.py::coral_tail``;
    its plain version ``coral_tail_reference``).  ``cluster``: the CTAs a
    pair (1-8; 0 lets the launch choose from M and Q)."""
    global TAIL_LAUNCHES, TAIL_CLUSTER
    if not n.is_cuda:
        raise RuntimeError(f"coral_tail: no kernel for device {n.device}")
    if mode != "entropy" and mode != "kl":
        raise ValueError(f"coral_tail: unknown mode {mode!r}")
    m, s = src_mask.shape
    r = ref_mask.shape[1]
    shapes = (n.shape, s1.shape, s2.shape, ref_mask.shape[0])
    if shapes != _tail_shapes(m, s, r):
        raise ValueError(f"coral_tail: moments {tuple(n.shape)}, "
                         f"{tuple(s1.shape)}, {tuple(s2.shape)} and masks "
                         f"{tuple(src_mask.shape)}, {tuple(ref_mask.shape)}"
                         f" (expected [2, M, Q] ... with Q = S + R)")
    idx = n.get_device()
    if n.dtype is not torch.float32 or s1.dtype is not torch.float32 or \
            s2.dtype is not torch.float32 or s1.get_device() != idx or \
            s2.get_device() != idx or src_mask.get_device() != idx or \
            ref_mask.get_device() != idx:
        raise TypeError(f"coral_tail: float32 moments and masks on "
                        f"{n.device}")
    dev = n.device
    # pair_moments' outputs are contiguous and aligned (float2, float4
    # loads); anything else is copied
    if not n.is_contiguous():
        n = n.contiguous()
    if not s1.is_contiguous() or s1.data_ptr() % 8:
        s1 = s1.clone(memory_format=torch.contiguous_format)
    if not s2.is_contiguous() or s2.data_ptr() % 16:
        s2 = s2.clone(memory_format=torch.contiguous_format)
    sm, rm = _mask(src_mask), _mask(ref_mask)
    out = n.new_empty((3, m))
    valid = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return (*out.unbind(0), valid)
    used = ctypes.c_int(0)
    p = out.data_ptr()
    params = TAIL_PARAMS.pack(
        n.data_ptr(), s1.data_ptr(), s2.data_ptr(), sm.data_ptr(),
        rm.data_ptr(), sm.stride(0), rm.stride(0), m, s, r,
        int(mode == "kl"), *_tail_constants(float(eps)), p, p + 4 * m,
        p + 8 * m, valid.data_ptr())
    err = _launch_on(dev, _tail_entry(), params, int(cluster),
                     ctypes.byref(used))
    if err != 0:
        raise RuntimeError(f"coral_tail_launch failed: CUDA error {err} "
                           f"(M={m}, S={s}, R={r}, mode={mode}, "
                           f"cluster={cluster})")
    TAIL_LAUNCHES += 1
    TAIL_CLUSTER = used.value
    return (*out.unbind(0), valid)


@functools.lru_cache(maxsize=256)
def _tail_shapes(m: int, s: int, r: int):
    """The moments' shapes and the ref mask's rows ``coral_tail`` takes for
    M pairs of S src and R ref slots."""
    q = s + r
    return (torch.Size((2, m, q)), torch.Size((2, m, q, 2)),
            torch.Size((2, m, q, 2, 2)), m)


_TAIL_ENTRY = []


def _tail_entry():
    if not _TAIL_ENTRY:
        from .build import library

        _TAIL_ENTRY.append(library().coral_tail_launch)
    return _TAIL_ENTRY[0]
