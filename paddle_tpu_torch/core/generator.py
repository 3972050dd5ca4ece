"""Random state. Counterpart of paddle_tpu/core/generator.py.

Where the JAX package splits PRNG keys out of a global stream, the port
passes an explicit ``torch.Generator``. The two give different numbers
for the same seed; tests make their inputs with numpy.
"""
from __future__ import annotations

import torch

from .place import resolve_device


def seed(s: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (default: the card) seeded
    with ``s`` (paddle.seed's counterpart)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(s))
    return g


__all__ = ["seed"]
