"""Per-decode-step time attribution for the serving engine loop. Counterpart
of paddle_tpu/observability/stepprof.py.

Every `ContinuousBatchingSession.step()` becomes four spans:

- **plan**    — host-side scheduling/staging before the device call
                (scheduler plan, block allocation, token buffers)
- **dispatch**— the executable call itself (async enqueue; cheap)
- **harvest** — the ``np.asarray`` device->host sync: the device
                finishing the step while the host blocks
- **bubble**  — host bookkeeping after harvest (collect loops, metric
                commits) during which the device sits idle

``host_us = wall - dispatch - harvest - plan_ahead`` is the host
planning/bookkeeping time per step — the exact "host-side us/step at
batch 64" signal ROADMAP item 6's double-buffering overhaul is gated
on — and ``bubble_fraction = (plan + bubble) / wall`` is the idle
fraction overlap would reclaim. The dispatch span is the executable
call itself and counts as DEVICE time: an async enqueue on
accelerators, but on the CPU test platform donated-buffer programs
execute synchronously inside the call, so folding it into host_us
would drown the host signal in device compute on exactly the
platform the perf gate runs on.

Per step the profiler (when the ``step_profile`` + ``observability``
flags are on) emits one ``engine.step`` event, refreshes the
``engine_host_us_per_step`` / ``engine_device_bubble_fraction`` gauges
(EMA-smoothed), feeds windowed digests (``step_host`` / ``step_wall``
seconds, via the SLO monitor so they ride ``/sloz`` and fleet merges),
and appends to a bounded ring served by a flight-recorder provider and
``tools/trace_summary.py --steps``.

Purely host-side observation: token streams are byte-identical with the
profiler on or off.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Optional

from ..core.flags import get_flag
from .events import get_event_log
from .flight_recorder import register_state_provider
from .metrics import get_registry

__all__ = ["StepProfiler", "StepSpan"]

_EMA_ALPHA = 0.2


class StepSpan:
    """Mutable per-step mark carrier; created by StepProfiler.begin().

    Two legal mark orders. Sequential (r18): dispatch -> harvest ->
    harvested, host bookkeeping last. Overlapped (r19 fast path):
    harvest -> harvested (the PREVIOUS chunk's deferred copy) ->
    dispatch (the next chunk) -> plan_ahead, bookkeeping behind the
    running device. end() detects which order happened from the
    timestamps and attributes accordingly. Spec verify windows (r23)
    ride the same orders with ``kind = "spec"``: the deferred copy is
    the two i32 acceptance vectors and the plan-ahead region is window
    bookkeeping + staging window N+2's drafts."""

    __slots__ = ("kind", "t0", "t_dispatch", "t_harvest0", "t_harvest1",
                 "t_plan_ahead0", "mispredict", "overlapped")

    def __init__(self, t0: float):
        self.kind = "decode"
        self.t0 = t0
        self.t_dispatch = t0
        self.t_harvest0 = t0
        self.t_harvest1 = t0
        self.t_plan_ahead0 = 0.0
        self.mispredict = False
        self.overlapped = False

    def mark_dispatch(self):
        """Host planning done; about to call the executable."""
        self.t_dispatch = time.monotonic()

    def mark_harvest(self):
        """Executable call returned (async); about to block on the
        device->host copy."""
        self.t_harvest0 = time.monotonic()

    def mark_harvested(self):
        """Device->host sync complete; host bookkeeping begins."""
        self.t_harvest1 = time.monotonic()

    def mark_plan_ahead(self):
        """Overlapped engine only: the next chunk is dispatched; the
        bookkeeping/staging from here to end() runs while the device
        computes and steals no device time."""
        self.t_plan_ahead0 = time.monotonic()


class StepProfiler:
    """One per serving session; feeds process-global metrics/digests."""

    def __init__(self, replica: Optional[str] = None, ring: int = 512):
        self.replica = replica or ""
        self._ring = deque(maxlen=ring)
        self._lock = threading.Lock()
        self._steps = 0
        self._overlapped_steps = 0
        self._mispredicts = 0
        self._host_us_ema: Optional[float] = None
        self._bubble_ema: Optional[float] = None
        self._host_us_kind_ema: dict = {}
        ref = weakref.ref(self)
        def _provide():
            sp = ref()
            return None if sp is None else sp.summary(recent=16)
        register_state_provider(f"engine_stepprof_{id(self):x}", _provide)

    def begin(self) -> Optional[StepSpan]:
        """None when profiling is off — call sites guard on the result,
        so the flag-off cost is this one check per step."""
        if not (get_flag("observability") and get_flag("step_profile")):
            return None
        return StepSpan(time.monotonic())

    def end(self, span: StepSpan, tokens: int = 0, live: int = 0) -> None:
        t1 = time.monotonic()
        overlap_order = (span.t_harvest1 > span.t0
                         and span.t_dispatch >= span.t_harvest1)
        if overlap_order:
            # r19 fast path: harvest (deferred from the previous chunk)
            # FIRST, then reconcile/validate, then the next dispatch,
            # then bookkeeping behind the running device (plan-ahead)
            t_host_end = span.t_plan_ahead0 or t1
            plan_s = max(0.0, span.t_harvest0 - span.t0)
            harvest_s = max(0.0, span.t_harvest1 - span.t_harvest0)
            reconcile_s = max(0.0, span.t_dispatch - span.t_harvest1)
            dispatch_s = max(0.0, t_host_end - span.t_dispatch)
            bubble_s = 0.0
            plan_ahead_s = max(0.0, t1 - t_host_end)
        else:
            plan_s = max(0.0, span.t_dispatch - span.t0)
            dispatch_s = max(0.0, span.t_harvest0 - span.t_dispatch)
            harvest_s = max(0.0, span.t_harvest1 - span.t_harvest0)
            reconcile_s = 0.0
            bubble_s = max(0.0, t1 - max(span.t_harvest1, span.t_dispatch))
            plan_ahead_s = 0.0
        wall_s = max(1e-9, t1 - span.t0)
        # the host-steal signal: wall minus the executable call (device
        # work — async enqueue on accelerators, synchronous execution
        # for donated programs on CPU), minus the device-blocking
        # harvest, minus the bookkeeping the overlap hid behind the
        # device — what remains is host planning/collect/metric time
        host_s = max(0.0,
                     wall_s - dispatch_s - harvest_s - plan_ahead_s)
        bubble_frac = min(1.0, (plan_s + bubble_s) / wall_s)
        rec = {"kind": span.kind, "plan_us": plan_s * 1e6,
               "dispatch_us": dispatch_s * 1e6,
               "harvest_us": harvest_s * 1e6, "bubble_us": bubble_s * 1e6,
               "reconcile_us": reconcile_s * 1e6,
               "plan_ahead_us": plan_ahead_s * 1e6,
               "wall_us": wall_s * 1e6, "host_us": host_s * 1e6,
               "bubble_fraction": bubble_frac,
               "mispredict": bool(span.mispredict),
               "overlapped": bool(span.overlapped),
               "tokens": int(tokens), "live": int(live)}
        with self._lock:
            self._ring.append(rec)
            self._steps += 1
            n = self._steps
            if span.overlapped:
                self._overlapped_steps += 1
            if span.mispredict:
                self._mispredicts += 1
            overlap_frac = self._overlapped_steps / n
            if self._host_us_ema is None:
                self._host_us_ema = rec["host_us"]
                self._bubble_ema = bubble_frac
            else:
                a = _EMA_ALPHA
                self._host_us_ema += a * (rec["host_us"] - self._host_us_ema)
                self._bubble_ema += a * (bubble_frac - self._bubble_ema)
            kind_ema = self._host_us_kind_ema.get(span.kind)
            if kind_ema is None:
                kind_ema = rec["host_us"]
            else:
                kind_ema += _EMA_ALPHA * (rec["host_us"] - kind_ema)
            self._host_us_kind_ema[span.kind] = kind_ema
            host_ema, bubble_ema = self._host_us_ema, self._bubble_ema
            mispredicts = self._mispredicts
        reg = get_registry()
        reg.gauge("engine_host_us_per_step",
                  "EMA host-side us per engine step (wall - dispatch - "
                  "harvest - overlapped plan-ahead); the "
                  "double-buffering overhaul's target"
                  ).set(host_ema)
        # per-dispatch-kind EMA: admit/decode/spec host costs differ by
        # an order of magnitude — one blended number hides decode-loop
        # regressions behind admit noise (the r19 gate semantics fix)
        reg.gauge("engine_host_us_per_step_kind",
                  "EMA host-side us per engine step, split by dispatch "
                  "kind").set(kind_ema, kind=span.kind)
        reg.gauge("engine_device_bubble_fraction",
                  "EMA fraction of each step the device sits idle while "
                  "the host plans/collects").set(bubble_ema)
        reg.gauge("engine_overlap_fraction",
                  "fraction of engine steps dispatched straight from a "
                  "staged plan (host work hidden behind the device)"
                  ).set(overlap_frac)
        reg.gauge("engine_mispredicts",
                  "staged next-step plans invalidated before dispatch "
                  "(submit/cancel/eos/deadline arrived mid-chunk)"
                  ).set(mispredicts)
        from .slo import get_slo_monitor
        mon = get_slo_monitor()
        mon.observe("step_host", host_s)
        mon.observe("step_wall", wall_s)
        get_event_log().emit(
            "engine.step", step=n, kind=span.kind, live=int(live),
            tokens=int(tokens), plan_us=round(rec["plan_us"], 1),
            dispatch_us=round(rec["dispatch_us"], 1),
            harvest_us=round(rec["harvest_us"], 1),
            bubble_us=round(rec["bubble_us"], 1),
            reconcile_us=round(rec["reconcile_us"], 1),
            plan_ahead_us=round(rec["plan_ahead_us"], 1),
            wall_us=round(rec["wall_us"], 1),
            host_us=round(rec["host_us"], 1),
            bubble_fraction=round(bubble_frac, 4),
            mispredict=bool(span.mispredict),
            overlapped=bool(span.overlapped))

    # -- queries -----------------------------------------------------------
    def recent(self, n: Optional[int] = None) -> list:
        with self._lock:
            recs = list(self._ring)
        return recs if n is None else recs[-n:]

    def summary(self, recent: int = 0) -> dict:
        with self._lock:
            recs = list(self._ring)
            steps = self._steps
            host_ema, bubble_ema = self._host_us_ema, self._bubble_ema
            kind_ema = dict(self._host_us_kind_ema)
            overlapped = self._overlapped_steps
            mispredicts = self._mispredicts
        out = {"replica": self.replica, "steps": steps,
               "host_us_ema": host_ema, "bubble_fraction_ema": bubble_ema,
               "host_us_ema_by_kind": kind_ema,
               "overlapped_steps": overlapped,
               "mispredicts": mispredicts,
               "overlap_fraction": overlapped / steps if steps else 0.0}
        if recs:
            def _med(key, kind=None):
                vals = sorted(r[key] for r in recs
                              if kind is None or r["kind"] == kind)
                return vals[len(vals) // 2] if vals else None
            out["host_us_median"] = _med("host_us")
            out["host_us_median_decode"] = _med("host_us", "decode")
            out["host_us_median_spec"] = _med("host_us", "spec")
            out["wall_us_median"] = _med("wall_us")
        if recent:
            out["recent"] = recs[-recent:]
        return out
