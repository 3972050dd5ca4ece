"""Move weights from the JAX package into the port.

The port keeps the JAX package's parameter names and layouts, so its
``state_dict()`` (as numpy arrays) loads name for name.
"""
from __future__ import annotations

import numpy as np
import torch


def load_jax_state(model: torch.nn.Module, state: dict) -> None:
    """Copy ``{name: np.ndarray}`` (the JAX package's state_dict as numpy)
    into ``model``'s parameters, cast to each parameter's dtype and
    device. Raises KeyError unless the names match exactly and
    ValueError on any shape mismatch."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs "
                             f"{tuple(p.shape)}")
        if arr.dtype.name == "bfloat16":   # numpy has no bf16: widen first
            arr = arr.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.tensor(arr))


__all__ = ["load_jax_state"]
