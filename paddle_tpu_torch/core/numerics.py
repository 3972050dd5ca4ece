"""Arithmetic that must give the same bytes on the card, on the CPU and in
the JAX package."""
from __future__ import annotations

import torch


def ieee_div(a, b: float):
    """``a / b`` as an IEEE fp32 division of a's values, rounded to a's
    dtype, on every device. A CUDA division by a Python number multiplies
    by its reciprocal (torch's shortcut), which can differ in the last bit
    from the division the CPU computes, and so can the CPU's own shortcut
    for bf16 and fp16; the JAX package divides in fp32 and rounds. The
    divisor is a 0-d tensor on a's device (a fill kernel, no host copy:
    capturable in a CUDA graph)."""
    af = a.to(torch.float32)
    return (af / torch.full((), b, dtype=torch.float32,
                            device=a.device)).to(a.dtype)


__all__ = ["ieee_div"]
