"""Parameter initializers, each drawing from an explicit generator.
Counterpart of paddle_tpu/nn/initializer (Normal, Constant,
XavierNormal: the Linear default)."""
from __future__ import annotations

import math

import torch


class Normal:
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean = float(mean)
        self.std = float(std)

    @torch.no_grad()
    def __call__(self, p: torch.Tensor, generator=None) -> torch.Tensor:
        return p.normal_(self.mean, self.std, generator=generator)


class Constant:
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    @torch.no_grad()
    def __call__(self, p: torch.Tensor, generator=None) -> torch.Tensor:
        return p.fill_(self.value)


class XavierNormal:
    """N(0, sqrt(2 / (fan_in + fan_out))) over Paddle's [in, out] layout."""

    @torch.no_grad()
    def __call__(self, p: torch.Tensor, generator=None) -> torch.Tensor:
        fan_in = p.shape[0] if p.dim() >= 1 else 1
        fan_out = p.shape[1] if p.dim() >= 2 else fan_in
        return p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                         generator=generator)


__all__ = ["Constant", "Normal", "XavierNormal"]
