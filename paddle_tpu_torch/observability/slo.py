"""Fleet SLO layer: sliding-window quantile digests + burn-rate alerts.
Counterpart of paddle_tpu/observability/slo.py.

The lifetime-cumulative :class:`~.metrics.Histogram`
answers "p99 since process start"; serving needs "p99 over the last 30 s"
and "p99 across the fleet".  This module provides both:

- :class:`WindowedDigest` — a ring of timestamped bucket histograms
  (one slot per time slice).  Quantiles are computed by bucket-summing
  the live slices; digests serialize to JSON and **merge by bucket-sum**
  (never by averaging percentiles), so a router can combine per-replica
  digests into exact fleet-wide quantiles at bucket resolution.
- :class:`SloPolicy` / :class:`SloObjective` — TTFT/TPOT/error-rate
  targets with a compliance window, env-tunable for chaos children.
- :class:`SloMonitor` — multi-window error-budget burn-rate alerting
  (an alert fires only when BOTH the fast and the slow window burn the
  budget faster than ``burn_rate_threshold``; it resolves as soon as
  the fast window is clean).  Transitions emit typed
  ``slo.alert_firing`` / ``slo.alert_resolved`` events; every
  evaluation refreshes ``slo_burn_rate`` / ``slo_compliance`` gauges
  and the ``slo_monitor`` flight-recorder state provider.

Compliance is derived from the same windowed digest that feeds the
quantiles: the fraction of observations ``<= threshold``.  That count is
exact only when the threshold is a bucket boundary — which is why the
serving histograms carry SLO-aligned ``SLO_LATENCY_BUCKETS``.

Epochs are wall-clock (``time.time() // slice_s``), so slices recorded
by different processes align and merge correctly.
"""
from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..analysis.sanitizers import race_track
from ..core.flags import get_flag
from .events import get_event_log
from .flight_recorder import register_state_provider
from .metrics import get_registry


def _enabled() -> bool:
    return bool(get_flag("observability"))

__all__ = [
    "SLO_LATENCY_BUCKETS", "WindowedDigest", "SloObjective", "SloPolicy",
    "SloMonitor", "get_slo_monitor", "set_slo_policy",
    "merge_serialized", "serialized_quantile", "serialized_counts",
]

# SLO-aligned upper bounds (seconds).  Includes the thresholds operators
# actually set (10/20/40 ms TPOT; 100/250/500 ms, 1/2 s TTFT) so
# windowed compliance counts are exact, plus enough in-between bounds
# for useful interpolated quantiles.
SLO_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.02, 0.03, 0.04, 0.05,
    0.075, 0.1, 0.15, 0.2, 0.25, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0,
    3.0, 5.0, 10.0, 30.0, 60.0)


def _interp_quantile(buckets: Sequence[float], counts: Sequence[int],
                     q: float) -> float:
    """Quantile with linear interpolation inside the crossing bucket.
    ``counts`` has ``len(buckets) + 1`` entries (last = +Inf overflow)."""
    total = sum(counts)
    if total <= 0:
        return float("nan")
    target = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo = buckets[i - 1] if 0 < i <= len(buckets) else 0.0
        if i >= len(buckets):          # +Inf bucket: report last bound
            return float(buckets[-1])
        acc_next = acc + c
        if acc_next >= target:
            frac = (target - acc) / c
            return lo + (buckets[i] - lo) * max(0.0, min(1.0, frac))
        acc = acc_next
    return float(buckets[-1])


@race_track
class WindowedDigest:
    """Sliding-window histogram: a ring of per-slice bucket counts.

    ``window_s`` is covered by ``slices`` equal slices; a slice is
    recycled lazily when its wall-clock epoch comes around again.
    Queries may narrow to a sub-window (``window_s=`` arg) for the
    fast/slow burn-rate windows, and may inject ``now=`` for
    deterministic tests.
    """

    __slots__ = ("buckets", "window_s", "slice_s", "_ring", "_lock")

    def __init__(self, buckets: Iterable[float] = SLO_LATENCY_BUCKETS,
                 window_s: float = 30.0, slices: int = 10):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("WindowedDigest needs at least one bucket")
        if slices < 1:
            raise ValueError("WindowedDigest needs at least one slice")
        self.buckets = bs
        self.window_s = float(window_s)
        self.slice_s = self.window_s / int(slices)
        # slot: [epoch, counts(list, len(buckets)+1), sum, count] | None
        self._ring: List[Optional[list]] = [None] * int(slices)
        self._lock = threading.Lock()

    def observe(self, value: float, count: int = 1,
                now: Optional[float] = None) -> None:
        if now is None:
            now = time.time()
        v = float(value)
        epoch = int(now // self.slice_s)
        i = epoch % len(self._ring)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            slot = self._ring[i]
            if slot is None or slot[0] != epoch:
                slot = self._ring[i] = [
                    epoch, [0] * (len(self.buckets) + 1), 0.0, 0]
            slot[1][idx] += count
            slot[2] += v * count
            slot[3] += count

    # -- queries -----------------------------------------------------------
    def _live_slices(self, now: float,
                     window_s: Optional[float]) -> List[list]:
        w = self.window_s if window_s is None else min(
            float(window_s), self.window_s)
        min_epoch = int((now - w) // self.slice_s) + 1
        max_epoch = int(now // self.slice_s)
        with self._lock:
            return [list(s) for s in self._ring
                    if s is not None and min_epoch <= s[0] <= max_epoch]

    def merged_counts(self, now: Optional[float] = None,
                      window_s: Optional[float] = None) -> List[int]:
        if now is None:
            now = time.time()
        out = [0] * (len(self.buckets) + 1)
        for s in self._live_slices(now, window_s):
            for j, c in enumerate(s[1]):
                out[j] += c
        return out

    def count(self, now: Optional[float] = None,
              window_s: Optional[float] = None) -> int:
        if now is None:
            now = time.time()
        return sum(s[3] for s in self._live_slices(now, window_s))

    def count_le(self, threshold: float, now: Optional[float] = None,
                 window_s: Optional[float] = None) -> Tuple[int, int]:
        """(observations <= threshold, total) over the window.  Exact
        only when ``threshold`` sits on a bucket boundary."""
        if now is None:
            now = time.time()
        counts = self.merged_counts(now, window_s)
        hi = bisect.bisect_right(self.buckets, float(threshold) * (1 + 1e-9))
        return sum(counts[:hi]), sum(counts)

    def quantile(self, q: float, now: Optional[float] = None,
                 window_s: Optional[float] = None) -> float:
        if now is None:
            now = time.time()
        return _interp_quantile(
            self.buckets, self.merged_counts(now, window_s), q)

    # -- wire format -------------------------------------------------------
    def serialize(self, now: Optional[float] = None) -> dict:
        if now is None:
            now = time.time()
        return {"v": 1, "buckets": list(self.buckets),
                "slice_s": self.slice_s, "window_s": self.window_s,
                "slices": [[s[0], list(s[1]), s[2], s[3]]
                           for s in self._live_slices(now, None)]}

    def merge(self, payload: dict, now: Optional[float] = None) -> None:
        """Fold a serialized digest into this one (bucket-sum by epoch)."""
        if list(payload["buckets"]) != list(self.buckets) or \
                abs(payload["slice_s"] - self.slice_s) > 1e-9:
            raise ValueError("digest schemes differ; refusing merge")
        if now is None:
            now = time.time()
        min_epoch = int((now - self.window_s) // self.slice_s) + 1
        with self._lock:
            for epoch, counts, sm, cnt in payload["slices"]:
                if epoch < min_epoch:
                    continue
                i = epoch % len(self._ring)
                slot = self._ring[i]
                if slot is None or slot[0] != epoch:
                    slot = self._ring[i] = [
                        epoch, [0] * (len(self.buckets) + 1), 0.0, 0]
                for j, c in enumerate(counts):
                    slot[1][j] += c
                slot[2] += sm
                slot[3] += cnt

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * len(self._ring)


def merge_serialized(payloads: Iterable[dict]) -> Optional[dict]:
    """Merge serialized digests from many replicas into one payload.
    Pure bucket-sum by epoch; all payloads must share one scheme."""
    payloads = [p for p in payloads if p]
    if not payloads:
        return None
    base = payloads[0]
    buckets = list(base["buckets"])
    slice_s = base["slice_s"]
    by_epoch: Dict[int, list] = {}
    for p in payloads:
        if list(p["buckets"]) != buckets or abs(p["slice_s"] - slice_s) > 1e-9:
            raise ValueError("digest schemes differ; refusing merge")
        for epoch, counts, sm, cnt in p["slices"]:
            slot = by_epoch.get(epoch)
            if slot is None:
                slot = by_epoch[epoch] = [
                    epoch, [0] * (len(buckets) + 1), 0.0, 0]
            for j, c in enumerate(counts):
                slot[1][j] += c
            slot[2] += sm
            slot[3] += cnt
    return {"v": 1, "buckets": buckets, "slice_s": slice_s,
            "window_s": base["window_s"],
            "slices": [by_epoch[e] for e in sorted(by_epoch)]}


def _payload_counts(payload: dict, now: float,
                    window_s: Optional[float]) -> List[int]:
    w = payload["window_s"] if window_s is None else min(
        float(window_s), payload["window_s"])
    slice_s = payload["slice_s"]
    min_epoch = int((now - w) // slice_s) + 1
    max_epoch = int(now // slice_s)
    out = [0] * (len(payload["buckets"]) + 1)
    for epoch, counts, _sm, _cnt in payload["slices"]:
        if min_epoch <= epoch <= max_epoch:
            for j, c in enumerate(counts):
                out[j] += c
    return out


def serialized_quantile(payload: Optional[dict], q: float,
                        now: Optional[float] = None,
                        window_s: Optional[float] = None) -> float:
    if not payload:
        return float("nan")
    if now is None:
        now = time.time()
    return _interp_quantile(
        payload["buckets"], _payload_counts(payload, now, window_s), q)


def serialized_counts(payload: Optional[dict],
                      now: Optional[float] = None,
                      window_s: Optional[float] = None) -> int:
    if not payload:
        return 0
    if now is None:
        now = time.time()
    return sum(_payload_counts(payload, now, window_s))


# -- policy -----------------------------------------------------------------

class SloObjective:
    """One objective: ``target`` fraction of observations of signal
    ``name`` must satisfy it.  Latency objectives carry ``threshold_s``
    (good = obs <= threshold); ``error_rate`` counts terminal request
    statuses (good = completed)."""

    __slots__ = ("name", "threshold_s", "target")

    def __init__(self, name: str, threshold_s: Optional[float],
                 target: float):
        self.name = name
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")

    def to_dict(self) -> dict:
        return {"name": self.name, "threshold_s": self.threshold_s,
                "target": self.target}


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class SloPolicy:
    """Objectives + compliance window + burn-rate alert knobs.

    ``window_s`` is the slow (compliance) window, ``fast_window_s`` the
    short confirmation window; an alert fires when the error budget
    burns faster than ``burn_rate_threshold``× on BOTH (with at least
    ``min_events`` fast-window observations), and resolves once the
    fast window's burn drops back under the threshold.
    """

    __slots__ = ("objectives", "window_s", "fast_window_s",
                 "burn_rate_threshold", "min_events", "slices")

    def __init__(self, objectives: Optional[Sequence[SloObjective]] = None,
                 *, window_s: float = 30.0, fast_window_s: float = 5.0,
                 burn_rate_threshold: float = 10.0, min_events: int = 8,
                 slices: int = 10):
        if objectives is None:
            objectives = [
                SloObjective("ttft", _env_f("PADDLE_SLO_TTFT_MS", 500.0)
                             / 1000.0, 0.99),
                SloObjective("tpot", _env_f("PADDLE_SLO_TPOT_MS", 40.0)
                             / 1000.0, 0.99),
                SloObjective("error_rate", None, 0.999),
            ]
        self.objectives = list(objectives)
        self.window_s = float(window_s)
        self.fast_window_s = float(fast_window_s)
        self.burn_rate_threshold = float(burn_rate_threshold)
        self.min_events = int(min_events)
        self.slices = int(slices)

    @classmethod
    def from_env(cls) -> "SloPolicy":
        """Default policy with every knob overridable from the
        environment — chaos children arm tight policies this way."""
        return cls(
            window_s=_env_f("PADDLE_SLO_WINDOW_S", 30.0),
            fast_window_s=_env_f("PADDLE_SLO_FAST_WINDOW_S", 5.0),
            burn_rate_threshold=_env_f("PADDLE_SLO_BURN_THRESHOLD", 10.0),
            min_events=int(_env_f("PADDLE_SLO_MIN_EVENTS", 8)),
        )

    def to_dict(self) -> dict:
        return {"objectives": [o.to_dict() for o in self.objectives],
                "window_s": self.window_s,
                "fast_window_s": self.fast_window_s,
                "burn_rate_threshold": self.burn_rate_threshold,
                "min_events": self.min_events}


# -- monitor ----------------------------------------------------------------

# error-rate is recorded into a two-bucket digest: good -> 0.0, bad -> 1.0
_ERROR_BUCKETS = (0.5,)


@race_track
class SloMonitor:
    """Windowed digests for every SLO signal + burn-rate alert state.

    One instance per process (see :func:`get_slo_monitor`); the serving
    session feeds it, ``/sloz`` serializes it, the router merges many of
    them into ``/fleetz``.
    """

    def __init__(self, policy: Optional[SloPolicy] = None,
                 replica: Optional[str] = None):
        self.policy = policy or SloPolicy.from_env()
        self.replica = replica or os.environ.get(
            "PADDLE_REPLICA_NAME") or f"pid{os.getpid()}"
        self._digests: Dict[str, WindowedDigest] = {}
        self._alerts: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._eval_interval_s = _env_f("PADDLE_SLO_EVAL_INTERVAL_S", 1.0)

    # -- feeding -----------------------------------------------------------
    def digest(self, name: str) -> WindowedDigest:
        with self._lock:
            d = self._digests.get(name)
            if d is None:
                buckets = (_ERROR_BUCKETS if name == "error_rate"
                           else SLO_LATENCY_BUCKETS)
                d = self._digests[name] = WindowedDigest(
                    buckets, window_s=self.policy.window_s,
                    slices=self.policy.slices)
            return d

    def observe(self, name: str, value: float, count: int = 1,
                now: Optional[float] = None) -> None:
        if not _enabled():
            return
        self.digest(name).observe(value, count, now=now)

    def observe_request(self, ok: bool,
                        now: Optional[float] = None) -> None:
        """Terminal request outcome for the error-rate objective."""
        self.observe("error_rate", 0.0 if ok else 1.0, now=now)

    # -- evaluation --------------------------------------------------------
    def _objective_stats(self, obj: SloObjective, now: float) -> dict:
        d = self.digest(obj.name)
        if obj.name == "error_rate":
            thr = 0.5
        else:
            thr = obj.threshold_s
        out = {}
        for label, w in (("fast", self.policy.fast_window_s),
                         ("slow", self.policy.window_s)):
            good, total = d.count_le(thr, now=now, window_s=w)
            bad_frac = 0.0 if total == 0 else (total - good) / total
            burn = bad_frac / max(1e-9, 1.0 - obj.target)
            out[label] = {"total": total, "good": good,
                          "compliance": 1.0 - bad_frac, "burn": burn}
        return out

    def maybe_evaluate(self, now: Optional[float] = None) -> None:
        """Rate-limited evaluate() — call from any hot-ish loop."""
        if not _enabled():
            return
        t = time.time() if now is None else now
        with self._lock:
            if t - self._last_eval < self._eval_interval_s:
                return
        self.evaluate(now=t)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Recompute compliance/burn per objective, update gauges,
        emit firing/resolved events on transitions."""
        t = time.time() if now is None else now
        with self._lock:
            self._last_eval = t
        thr = self.policy.burn_rate_threshold
        transitions = []
        alerts: Dict[str, dict] = {}
        for obj in self.policy.objectives:
            st = self._objective_stats(obj, t)
            fast, slow = st["fast"], st["slow"]
            with self._lock:
                cur = self._alerts.get(obj.name) or {
                    "state": "ok", "since": t, "transitions": 0}
                firing = cur["state"] == "firing"
                should_fire = (fast["burn"] >= thr and slow["burn"] >= thr
                               and fast["total"] >= self.policy.min_events)
                should_resolve = firing and fast["burn"] < thr
                if not firing and should_fire:
                    cur = {"state": "firing", "since": t,
                           "transitions": cur["transitions"] + 1}
                    transitions.append(("slo.alert_firing", obj, st, t))
                elif should_resolve:
                    dur = t - cur["since"]
                    cur = {"state": "ok", "since": t,
                           "transitions": cur["transitions"] + 1}
                    transitions.append(
                        ("slo.alert_resolved", obj, st, dur))
                cur.update({"burn_fast": fast["burn"],
                            "burn_slow": slow["burn"],
                            "compliance": slow["compliance"],
                            "events_fast": fast["total"],
                            "events_slow": slow["total"]})
                self._alerts[obj.name] = cur
                alerts[obj.name] = dict(cur)
        # gauges + events OUTSIDE the lock (blocking-under-lock)
        reg = get_registry()
        g_burn = reg.gauge(
            "slo_burn_rate",
            "error-budget burn-rate multiple per objective and window")
        g_comp = reg.gauge(
            "slo_compliance",
            "fraction of observations meeting the objective "
            "over the slow window")
        g_firing = reg.gauge(
            "slo_alert_firing", "1 while the objective's burn alert fires")
        for obj in self.policy.objectives:
            a = alerts[obj.name]
            g_burn.set(a["burn_fast"], objective=obj.name, window="fast")
            g_burn.set(a["burn_slow"], objective=obj.name, window="slow")
            g_comp.set(a["compliance"], objective=obj.name)
            g_firing.set(1.0 if a["state"] == "firing" else 0.0,
                         objective=obj.name)
        log = get_event_log()
        for event, obj, st, extra in transitions:
            fields = dict(
                objective=obj.name, target=obj.target,
                threshold_s=obj.threshold_s, replica=self.replica,
                burn_fast=round(st["fast"]["burn"], 3),
                burn_slow=round(st["slow"]["burn"], 3),
                compliance=round(st["slow"]["compliance"], 5),
                burn_threshold=thr)
            if event == "slo.alert_resolved":
                fields["duration_s"] = round(extra, 3)
            log.emit(event, **fields)
        return alerts

    # -- exposition --------------------------------------------------------
    def alerts(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._alerts.items()}

    def state(self) -> dict:
        """Flight-recorder state provider payload."""
        now = time.time()
        with self._lock:
            counts = {n: d.count(now=now) for n, d in self._digests.items()}
        return {"replica": self.replica, "policy": self.policy.to_dict(),
                "alerts": self.alerts(), "window_counts": counts}

    def sloz_payload(self, now: Optional[float] = None) -> dict:
        """The /sloz document: policy, live alert states, and every
        digest serialized for fleet-side merging."""
        t = time.time() if now is None else now
        alerts = self.evaluate(now=t) if _enabled() else self.alerts()
        with self._lock:
            digests = {n: d.serialize(now=t)
                       for n, d in self._digests.items()}
        return {"replica": self.replica, "ts": t,
                "policy": self.policy.to_dict(), "alerts": alerts,
                "digests": digests}

    def reset(self) -> None:
        with self._lock:
            self._digests.clear()
            self._alerts.clear()
            self._last_eval = 0.0


_MONITOR: Optional[SloMonitor] = None
_MONITOR_LOCK = threading.Lock()


def _provide_monitor_state():
    """Flight-recorder provider for the PROCESS-GLOBAL monitor — bound
    to the slot, not an instance, so short-lived monitors constructed
    directly (tests, tools) can never shadow the live one.  Never
    returns None: the recorder drops None-returning providers for
    good, and an idle-at-first-autodump process must still carry SLO
    state in its final dump."""
    mon = _MONITOR
    if mon is None:
        return {"status": "idle", "policy": {}, "alerts": {},
                "window_counts": {}}
    return mon.state()


register_state_provider("slo_monitor", _provide_monitor_state)


def get_slo_monitor() -> SloMonitor:
    """Process-global monitor (created on first use from env policy)."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = SloMonitor()
        return _MONITOR


def set_slo_policy(policy: SloPolicy) -> SloMonitor:
    """Swap the global monitor's policy; resets digests + alert state."""
    mon = get_slo_monitor()
    mon.reset()
    with mon._lock:
        mon.policy = policy
    return mon
