"""Flags and environment knobs the port reads. Counterpart of
paddle_tpu/core/flags.py, cut to what the ported slices read: the FLAGS
the training slice and the op dispatch consult (``get_flag`` /
``set_flags``) and the PADDLE_* knob registry."""
from __future__ import annotations

import os
from typing import Any, Dict

PADDLE_ENV_KNOBS = frozenset({
    # live GenerationSessions kept per model by aot_generate (default 8)
    "PADDLE_SERVING_SESSION_CACHE",
})

_flags: Dict[str, Any] = {
    # route GPT self-attention through the whole-block fused op
    # (fused_self_attention: einsum projections around the head-major
    # flash kernels)
    "use_fused_attention": False,
    # flash kernels consume the projection's native [B,S,E] layout
    # directly; off = the head-major [B*H,S,D] route (grouped k, v
    # repeated to the q heads first)
    "flash_native_layout": True,
    # ops/registry.py apply_op: check every floating output for NaN/Inf;
    # level 0 raises FloatingPointError, any other level warns
    "check_nan_inf": False,
    "check_nan_inf_level": 0,
}


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _flags:
        raise KeyError(f"flag {name!r} is not registered")
    return key


def get_flag(name: str):
    return _flags[_key(name)]


def set_flags(flags: Dict[str, Any]) -> None:
    """Set registered flags, each converted to its default's type (bool
    or int)."""
    for n, v in flags.items():
        k = _key(n)
        _flags[k] = type(_flags[k])(v)


def env_int(name: str, default: int) -> int:
    """Integer value of a registered PADDLE_* knob, ``default`` if unset."""
    if name not in PADDLE_ENV_KNOBS:
        raise KeyError(f"{name} is not a registered PADDLE_* knob")
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else int(default)


__all__ = ["PADDLE_ENV_KNOBS", "env_int", "get_flag", "set_flags"]
