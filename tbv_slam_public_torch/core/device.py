"""Device choice of the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None`` means
``cuda`` and fails where there is no card, and anything else (``"cpu"``,
``"cuda:1"``, a ``torch.device``) is taken as given.  Under ``torchrun``
(``LOCAL_RANK`` set) ``None`` is the card of that local rank, modulo the
number of cards, so ranks share the cards round robin.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> the CUDA card, with a
    ``RuntimeError`` where none is present; an explicit device is honoured."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found: the port runs on the card by default; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU")
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return torch.device("cuda", int(local) % torch.cuda.device_count())
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """A small read-only tensor of Python numbers (nested tuples), uploaded
    once per (values, dtype, device).  ``torch.tensor(..., device="cuda")`` is
    a blocking host->device copy: it waits for everything queued on the
    stream, so inside a frame loop it would be a host synchronisation per
    call.  Callers must not write into the result."""
    return _constant(values, dtype, torch.device(device))


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic CUDA kernels inside the block, the previous
    setting after it.  ``index_add_`` on a CUDA tensor then sorts its indices
    and adds each slot's values in index order, as the CPU does, instead of
    with float atomics in whatever order the threads arrive: the sums, and
    every decision taken on them, come out the same on every run."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
