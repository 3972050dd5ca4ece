"""to_tensor. Counterpart of paddle_tpu/tensor.py ``to_tensor``.

The port has no Tensor wrapper class: ``torch.Tensor`` is the tensor, and
Paddle's ``stop_gradient`` is ``not requires_grad``. The JAX package's
``Tensor`` method surface (arithmetic, ``numpy()``, ``backward()`` and
the rest) waits for the public tensor API (ROADMAP queue A item 7); what
the ported paths need of it is torch's own.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.dtype import to_torch
from .core.place import resolve_device


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> torch.Tensor:
    """paddle.to_tensor: a new tensor holding ``data`` on ``place`` (the
    card unless the caller passes ``place="cpu"`` or a CPUPlace; raises
    without a card) with ``requires_grad = not stop_gradient``.

    Python scalars take Paddle's defaults: bool -> bool, int -> int64,
    float -> float32; so do lists of them. A numpy array or a tensor keeps
    its dtype (the JAX package narrows 64-bit types to 32 bits, as JAX
    does without x64). ``dtype`` is a name ``core.dtype`` knows or a
    torch.dtype."""
    device = resolve_device(place)
    dt = None if dtype is None else to_torch(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=device, dtype=dt, copy=True)
    elif isinstance(data, (np.ndarray, np.generic)):
        t = torch.as_tensor(np.array(data), dtype=dt, device=device)
    else:
        t = torch.tensor(data, dtype=dt, device=device)
    return t.requires_grad_(not stop_gradient)


__all__ = ["to_tensor"]
