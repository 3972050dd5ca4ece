"""Environment knobs the port reads. Counterpart of the PADDLE_* knob
registry in paddle_tpu/core/flags.py, cut to what the serving slice
reads."""
from __future__ import annotations

import os

PADDLE_ENV_KNOBS = frozenset({
    # live GenerationSessions kept per model by aot_generate (default 8)
    "PADDLE_SERVING_SESSION_CACHE",
})


def env_int(name: str, default: int) -> int:
    """Integer value of a registered PADDLE_* knob, ``default`` if unset."""
    if name not in PADDLE_ENV_KNOBS:
        raise KeyError(f"{name} is not a registered PADDLE_* knob")
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else int(default)


__all__ = ["PADDLE_ENV_KNOBS", "env_int"]
