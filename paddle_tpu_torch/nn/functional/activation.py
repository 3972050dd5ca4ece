"""Activations. Counterpart of paddle_tpu/nn/functional/activation.py."""
from __future__ import annotations

import torch


def gelu(x, approximate: bool = False):
    """GELU; the exact erf form unless ``approximate`` (tanh form), as
    jax.nn.gelu."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


__all__ = ["gelu"]
