"""paddle_tpu_torch.observability — metrics and structured event
telemetry of the serving path. Counterpart of paddle_tpu/observability
without the jax.monitoring bridge (jax_bridge.py has no counterpart: the
port compiles no XLA executables) and without the HTTP debug endpoint
(debug_server.py, ported with the serving front end, ROADMAP queue A
item 8).

One process-global :class:`MetricsRegistry` (Counter/Gauge/Histogram
with labels, Prometheus-text exposition, JSON dump) and one
:class:`EventLog` (JSONL structured events with monotonic timestamps and
span events), fed by the serving session (`inference.serving`):
queue-wait / TTFT / per-output-token latency histograms, admit/chunk
counters, live-slot + paged-KV-pool occupancy gauges, per-request
completion events, request span trees, per-step attribution.

Everything is gated by ``FLAGS_observability`` (default on): with the
flag off, instrumented hot paths reduce to one bool check and record
nothing. Exposition is pull-based and free until asked for::

    import paddle_tpu_torch as ptt
    print(ptt.observability.render_prometheus())
    ptt.observability.get_registry().dump_json("metrics.json")
"""
from __future__ import annotations

import os as _os

from ..core.flags import get_flag
from .events import EventLog, get_event_log, set_event_log
from .flight_recorder import (FlightRecorder, get_flight_recorder,
                              install_from_env)
from .memz import (device_memory, memz_payload, memz_snapshot,
                   register_memz_provider, unregister_memz_provider)
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, get_registry, lint_prometheus)
from .slo import (SLO_LATENCY_BUCKETS, SloMonitor, SloObjective,
                  SloPolicy, WindowedDigest, get_slo_monitor,
                  merge_serialized, serialized_counts,
                  serialized_quantile, set_slo_policy)
from .stepprof import StepProfiler, StepSpan
from .tracing import Trace, Tracer, get_tracer, phase_breakdown

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "EventLog", "get_registry", "get_event_log", "set_event_log",
           "enabled", "render_prometheus", "dump_json",
           "DEFAULT_BUCKETS", "lint_prometheus",
           "Trace", "Tracer", "get_tracer", "phase_breakdown",
           "FlightRecorder", "get_flight_recorder", "install_from_env",
           "SLO_LATENCY_BUCKETS", "WindowedDigest", "SloObjective",
           "SloPolicy", "SloMonitor", "get_slo_monitor",
           "set_slo_policy", "merge_serialized", "serialized_quantile",
           "serialized_counts", "StepProfiler", "StepSpan",
           "device_memory", "memz_payload", "memz_snapshot",
           "register_memz_provider", "unregister_memz_provider"]


def enabled() -> bool:
    """The FLAGS_observability gate — checked at record time by every
    instrumentation site (flag flips apply immediately)."""
    return bool(get_flag("observability"))


def render_prometheus() -> str:
    """Prometheus text exposition of the global registry."""
    return get_registry().render_prometheus()


def dump_json(path: str):
    """Write the global registry snapshot as JSON."""
    get_registry().dump_json(path)


# crash forensics are opt-in per process via the environment; a no-op
# otherwise
if _os.environ.get("PADDLE_CRASH_DIR"):
    install_from_env()
