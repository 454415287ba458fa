"""The registration's LM solve as one CUDA kernel launch per solve.

The kernel is ``csrc/lm_solve.cu``: ``ops/registration.py::_lm_solve``
whole (the initial cost, gradient and Hessian, then ``max_iter`` damped
steps, each with the candidate's residuals, robust loss, weights, the 13
pairwise row sums and the accept / reject), one CTA a batch row, bit-equal
to the plain version ``ops/registration.py::_lm_solve_reference``.  It has
no Pallas counterpart: the JAX package leaves the solve to XLA's fusions.

Dispatch is in ``_lm_solve``: a CPU tensor takes the plain version, a CUDA
tensor launches this kernel or raises.  ``LAUNCHES`` counts kernel launches
and nothing else.  ``plain_on_card`` lets a test or ``chip_smoke.py`` run
the plain version on CUDA tensors, to hold the kernel to it; nothing else
uses it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..core.refmath import recip
from .refmath import _entry, _launch_on

#: number of kernel launches made by ``lm_solve``
LAUNCHES = 0

_PLAIN_ON_CARD = False

# ops/registration.py's cost and loss codes
_P2L, _P2D = 0, 1
_HUBER, _CAUCHY, _SOFTLONE, _TUKEY = 1, 2, 3, 4


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


@contextlib.contextmanager
def plain_on_card():
    """Inside the block ``_lm_solve`` runs its plain version on CUDA
    tensors too (the kernel's yardstick in tests and ``chip_smoke.py``)."""
    global _PLAIN_ON_CARD
    was, _PLAIN_ON_CARD = _PLAIN_ON_CARD, True
    try:
        yield
    finally:
        _PLAIN_ON_CARD = was


def plain_on_card_enabled() -> bool:
    return _PLAIN_ON_CARD


def lm_solve(theta0: torch.Tensor, src_mean: torch.Tensor,
             tgt_mean_w: torch.Tensor, tgt_normal_w: Optional[torch.Tensor],
             weight: torch.Tensor, mask: torch.Tensor,
             tgt_sqrtinfo: Optional[torch.Tensor], *, cost: int, loss: int,
             delta: float, max_iter: int, init_lambda: float, prior=None,
             one_system: bool = False):
    """(theta [B, 3], cost [B], rel_dec [B]) of the LM solve of B rows of
    [T, C] associations, one launch on CUDA tensors (float32; ``mask``
    bool).  ``prior`` is (guess [B, 3], sqrt_info [3, 3], pw [B]) or
    None."""
    global LAUNCHES
    dev = theta0.device
    if dev.type != "cuda":
        raise RuntimeError(f"lm_solve: no kernel for device {dev}")
    bsz = theta0.shape[0]
    t, c = weight.shape[1:]
    floats = [theta0, src_mean, tgt_mean_w, weight]
    if cost == _P2L:
        floats.append(tgt_normal_w)
    if cost == _P2D:
        floats.append(tgt_sqrtinfo)
    if prior is not None:
        floats.extend(prior)
    if any(x is None for x in floats):
        raise ValueError("lm_solve: the cost's target normals (P2L) or "
                         "sqrt-information (P2D) are missing")
    if any(x.dtype != torch.float32 or x.device != dev for x in floats) \
            or mask.dtype != torch.bool or mask.device != dev:
        raise TypeError("lm_solve: float32 tensors and a bool mask on "
                        f"{dev}")
    shapes = {"theta0": (theta0, (bsz, 3)), "src_mean": (src_mean, (bsz, c, 2)),
              "tgt_mean_w": (tgt_mean_w, (bsz, t, c, 2)),
              "mask": (mask, (bsz, t, c))}
    if cost == _P2L:
        shapes["tgt_normal_w"] = (tgt_normal_w, (bsz, t, c, 2))
    if cost == _P2D:
        shapes["tgt_sqrtinfo"] = (tgt_sqrtinfo, (bsz, t, c, 2, 2))
    if prior is not None:
        shapes.update(guess=(prior[0], (bsz, 3)),
                      sqrt_info=(prior[1], (3, 3)), pw=(prior[2], (bsz,)))
    for name, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"lm_solve: {name} has shape {tuple(x.shape)}, "
                             f"expected {want}")
    out_theta = torch.empty((bsz, 3), dtype=torch.float32, device=dev)
    out_cost = torch.empty((bsz,), dtype=torch.float32, device=dev)
    out_rel = torch.empty((bsz,), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out_theta, out_cost, out_rel
    keep = [x.contiguous() for x in (theta0, src_mean, tgt_mean_w, weight,
                                     mask)]
    ptr = lambda x: 0 if x is None else x.data_ptr()
    opt = lambda x, on: x.contiguous() if on else None
    tn = opt(tgt_normal_w, cost == _P2L)
    si = opt(tgt_sqrtinfo, cost == _P2D)
    guess, sqrt_info, pw = (None,) * 3 if prior is None else \
        (x.contiguous() for x in prior)
    k = loss_constants(loss, delta)
    err = _launch_on(dev, _entry("lm_solve_launch"), ptr(keep[0]),
                     ptr(keep[1]), ptr(keep[2]), ptr(tn), ptr(keep[3]),
                     ptr(keep[4]), ptr(si), ptr(guess), ptr(sqrt_info),
                     ptr(pw), out_theta.data_ptr(), out_cost.data_ptr(),
                     out_rel.data_ptr(), bsz, t, c, cost, loss, *k, max_iter,
                     _f32(init_lambda), int(one_system))
    if err != 0:
        raise RuntimeError(f"lm_solve_launch failed: CUDA error {err} "
                           f"(B={bsz}, T={t}, C={c}, cost={cost})")
    LAUNCHES += 1
    return out_theta, out_cost, out_rel
