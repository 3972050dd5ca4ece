"""Flags and environment knobs the port reads. Counterpart of
paddle_tpu/core/flags.py, cut to what the ported slices read: the FLAGS
the training slice, the op dispatch and the serving observability
consult (``get_flag`` / ``set_flags``) and the PADDLE_* knob registry."""
from __future__ import annotations

import os
from typing import Any, Dict

PADDLE_ENV_KNOBS = frozenset({
    # live GenerationSessions kept per model by aot_generate (default 8)
    "PADDLE_SERVING_SESSION_CACHE",
    # serving: the bounded waiting queue, the replica label of metrics
    # and events (inference/scheduler.py, inference/serving.py)
    "PADDLE_SERVING_MAX_WAITING", "PADDLE_REPLICA_NAME",
    # the default KV pool byte budget of a ContinuousBatchingSession
    # (inference/serving.py; num_blocks wins over it)
    "PADDLE_SERVING_QUANT_KV_POOL_BYTES",
    # the serving sessions' quantization defaults (inference/serving.py
    # _resolve_quant_knobs): weights "int8"/"int4", KV pools "int8"/"1"
    "PADDLE_SERVING_QUANT_WEIGHTS", "PADDLE_SERVING_QUANT_KV",
    # crash forensics (observability/flight_recorder.py)
    "PADDLE_CRASH_DIR", "PADDLE_CRASH_DUMP_INTERVAL",
    # SLO monitor policy (observability/slo.py)
    "PADDLE_SLO_WINDOW_S", "PADDLE_SLO_FAST_WINDOW_S",
    "PADDLE_SLO_TTFT_MS", "PADDLE_SLO_TPOT_MS", "PADDLE_SLO_MIN_EVENTS",
    "PADDLE_SLO_EVAL_INTERVAL_S", "PADDLE_SLO_BURN_THRESHOLD",
    # device-memory budget of the HBM ledger (observability/memz.py)
    "PADDLE_MEMZ_HBM_BYTES",
    # speculative decoding in the continuous session
    # (inference/serving.py): 0 accepts on the host instead of in the
    # verify graph; 1 gives the n-gram proposer a tenant corpus of at
    # most the cap's tokens
    "PADDLE_SPEC_DEVICE_ACCEPT", "PADDLE_SPEC_TENANT_STATS",
    "PADDLE_SPEC_TENANT_CAP_TOKENS",
    # the continuous session's engine (inference/serving.py): 0 runs the
    # sequential engine instead of the overlapped one; 0 stops the
    # overlapped engine staging speculative windows
    "PADDLE_ENGINE_OVERLAP", "PADDLE_SPEC_STAGE_AHEAD",
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
    # metrics registry + structured events of the serving session; off
    # turns every instrumented site into one bool check
    "observability": True,
    # fraction of requests that record a full span tree while
    # observability is on (decided once per trace at its start)
    "trace_sample_rate": 1.0,
    # per-step host/dispatch/harvest/bubble attribution of the serving
    # session (observability/stepprof.py); needs observability
    "step_profile": True,
}


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _flags:
        raise KeyError(f"flag {name!r} is not registered")
    return key


def get_flag(name: str):
    return _flags[_key(name)]


def get_flags() -> Dict[str, Any]:
    """A copy of every flag's value (recompute replays a block under the
    flags of its forward)."""
    return dict(_flags)


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


def env_on(name: str, default: bool) -> bool:
    """Boolean value of a registered PADDLE_* knob: unset -> ``default``;
    "0", "false" or "off" -> False; anything else True (the JAX package's
    ``_env_on``)."""
    if name not in PADDLE_ENV_KNOBS:
        raise KeyError(f"{name} is not a registered PADDLE_* knob")
    raw = os.environ.get(name, "").strip().lower()
    return bool(default) if not raw else raw not in ("0", "false", "off")


__all__ = ["PADDLE_ENV_KNOBS", "env_int", "env_on", "get_flag",
           "get_flags", "set_flags"]
