"""float32 arithmetic rounded as the reference's compiled CPU program
rounds it.

``fma``: a*b + c with one rounding, the fused multiply-add that the
reference's compiler makes of a product feeding an add; emulated through
float64, the same on every device.
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with a single rounding (through float64)."""
    return (a.double() * b.double() + c.double()).float()
