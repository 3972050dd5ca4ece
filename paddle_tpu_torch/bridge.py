"""Move weights and optimizer state from the JAX package into the port.

The port keeps the JAX package's parameter names and layouts, so its
``state_dict()`` (as numpy arrays) loads name for name. The JAX
optimizers key their state by each parameter's ``p.name`` (a generated
name); the port's by its structured name (``param_name``, the
``state_dict`` key), so :func:`load_jax_optimizer_state` renames the
entries through the JAX model's ``named_parameters()``.
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


# the per-parameter entries of a JAX optimizer's state_dict()
_ACCUMULATORS = ("moment1", "moment2", "moment2_max", "beta1_pow",
                 "beta2_pow", "master_weight")


def _as_array(v):
    """A state-dict value (a JAX package Tensor, a numpy array or a
    number) as numpy."""
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


def load_jax_optimizer_state(optimizer, state: dict, named_parameters
                             ) -> None:
    """Load the JAX package optimizer's ``state_dict()`` into the port's
    ``optimizer``: ``{p.name}_{accumulator}`` entries become
    ``{structured name}_{accumulator}``, through ``named_parameters`` (the
    JAX model's ``named_parameters()``, or ``{p.name: structured name}``),
    with their dtypes (bf16 moments stay bf16); ``global_step`` and
    ``LR_Scheduler`` carry over. Raises KeyError if an entry names no
    parameter of the optimizer, or if the entries name some of its
    parameters and not all."""
    if isinstance(named_parameters, dict):
        rename = dict(named_parameters)
    else:
        rename = {p.name: n for n, p in named_parameters}
    ours = set(optimizer._names.values())
    # longest first, so a name that prefixes another cannot take its
    # entries
    jax_names = sorted(rename, key=len, reverse=True)
    out, per_param = {}, set()
    for key, value in state.items():
        if key == "LR_Scheduler":
            out[key] = dict(value)
            continue
        if key == "global_step":
            out[key] = int(_as_array(value))
            continue
        jname = next((n for n in jax_names if key.startswith(n + "_")
                      and key[len(n) + 1:] in _ACCUMULATORS), None)
        if jname is None or rename[jname] not in ours:
            raise KeyError(f"optimizer state entry {key!r} names no "
                           f"parameter of this optimizer")
        accum = key[len(jname) + 1:]
        name = rename[jname]
        per_param.add(name)
        out[f"{name}_{accum}"] = _as_array(value)
    missing = sorted(ours - per_param) if per_param else []
    if missing:
        raise KeyError(f"optimizer state has no entries for {missing}")
    optimizer.set_state_dict(out)


__all__ = ["load_jax_optimizer_state", "load_jax_state"]
