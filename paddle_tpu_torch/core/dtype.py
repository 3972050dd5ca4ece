"""Data types of the port: the framework's dtype names mapped to torch.

Counterpart of paddle_tpu/core/dtype.py, cut to the types the serving
slice uses (fp32, bf16, int32, int64).
"""
from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
}
_ALIASES = {"float": "float32", "int": "int32", "long": "int64"}


def to_torch(d) -> torch.dtype:
    """A dtype name ("float32", "bfloat16", "int32", "int64" or an alias)
    or a torch.dtype -> torch.dtype. Raises TypeError on anything else."""
    if isinstance(d, torch.dtype):
        if d not in _DTYPES.values():
            raise TypeError(f"unsupported dtype {d}")
        return d
    if isinstance(d, str):
        name = _ALIASES.get(d, d)
        if name in _DTYPES:
            return _DTYPES[name]
    raise TypeError(f"unsupported dtype {d!r}")


__all__ = ["to_torch"]
