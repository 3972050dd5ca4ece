"""Activations. Counterpart of paddle_tpu/nn/functional/activation.py."""
from __future__ import annotations

import torch

from ...amp.state import autocast


def gelu(x, approximate: bool = False):
    """GELU; the exact erf form unless ``approximate`` (tanh form), as
    jax.nn.gelu."""
    (x,) = autocast("gelu", "promote", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


__all__ = ["gelu"]
