"""Request-level tracing: trace_id/span_id span trees over the serving,
speculative, checkpoint, and jit-compile paths. Counterpart of
paddle_tpu/observability/tracing.py (in the port, the serving session
is the one caller so far).

Where the EventLog keeps a flat narrative and the registry aggregates,
the tracer keeps CAUSALITY. Every request admitted to a serving session
owns a trace — queue_wait -> admit (prefix-cache match, CoW, tail
prefill) -> decode/spec windows (propose, verify, accept) -> done —
and background work attributes itself to the request that caused it:
compile durations land as spans of the active trace, and
the async checkpoint writer carries the caller's trace context across
threads via ``capture()``/``attach()``. Spans with no active trace
(training-loop compiles, ladder compiles between requests) fall into a
bounded process-span ring, so the whole-process export still tells one
story.

Cost model: every site is gated by ``FLAGS_observability`` (one bool
check when off) and traces are SAMPLED at start by
``FLAGS_trace_sample_rate`` — an unsampled request carries
``trace=None`` and every later site reduces to one ``is not None``
test. Instrumentation is host-side only; it never touches device
values, so token streams are byte-identical with tracing on or off
(asserted by tests/test_tracing.py for GPT and Llama, spec and
prefix-cache paths alike).

Export: Chrome trace-event JSON (``Tracer.export_chrome`` — loads in
Perfetto or chrome://tracing, one lane per trace), plus
``phase_breakdown()``, the per-phase wall-second dict serving attaches
to each ``serving.request_done`` event.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..analysis.sanitizers import race_track

__all__ = ["Trace", "Tracer", "get_tracer", "phase_breakdown",
           "TRACE_EPOCH", "format_traceparent", "parse_traceparent"]

# process trace epoch: the ts origin of every chrome event this process
# exports (monotonic — ordering survives wall-clock jumps), anchored to
# a wall time so dumps from different processes can be correlated
TRACE_EPOCH = time.monotonic()
_EPOCH_WALL = time.time()


def _now() -> float:
    return time.monotonic()


# -- cross-process trace context (W3C traceparent wire format) -------------
# One request through the disagg fleet crosses three processes (router ->
# prefill -> decode) plus the rpc KV ship; each hop adopts the router's
# FLEET trace id so the per-process fragments stitch into one timeline.
# The wire form is the W3C header: 00-<32hex trace-id>-<16hex span>-01.
# Span refs fold the emitting pid into the id (pid << 24 | sid) so sids
# from different fragments can't collide in the merged view.

def span_ref(sid: int, pid: Optional[int] = None) -> str:
    """Globally-unique 16-hex ref for a span of THIS process's tracer."""
    pid = os.getpid() if pid is None else pid
    return f"{((pid & 0xFFFFFFFF) << 24) | (sid & 0xFFFFFF):016x}"


def format_traceparent(fleet_id: str, sid: int = 0) -> str:
    """W3C-style traceparent for hop ``sid`` of fleet trace
    ``fleet_id`` (sid 0 = the minting root itself)."""
    return f"00-{fleet_id}-{span_ref(sid)}-01"


def parse_traceparent(header) -> Optional[tuple]:
    """(fleet_trace_id, parent_span_ref) from a traceparent header, or
    None when absent/malformed — propagation is best-effort and a bad
    header must never fail the request carrying it."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _, fleet_id, parent, _ = parts
    if len(fleet_id) != 32 or len(parent) != 16:
        return None
    try:
        int(fleet_id, 16), int(parent, 16)
    except ValueError:
        return None
    return fleet_id, parent


class Trace:
    """One span tree. Spans are plain dicts::

        {"sid": 3, "parent": 0, "name": "decode",
         "t0": <monotonic>, "t1": <monotonic or None while open>,
         "args": {...}}

    ``parent`` 0 is the trace root (the request itself); sids are
    per-trace and start at 1. The serving loop appends COMPLETED spans
    (``add_span`` — it knows both endpoints from its own step timing);
    context-manager sites open/close (``begin_span``/``end_span``). A
    per-trace lock makes either safe from any thread (submit thread,
    run() thread, and the checkpoint writer all touch one trace).
    """

    __slots__ = ("trace_id", "name", "req_id", "t0", "t1", "attrs",
                 "done", "dropped", "_spans", "_lock", "_next_sid")

    MAX_SPANS = 8192   # bound per-trace memory; overflow counts into
    # ``dropped`` instead of growing without limit

    def __init__(self, trace_id: str, name: str, req_id=None,
                 t0: Optional[float] = None, **attrs):
        self.trace_id = trace_id
        self.name = name
        self.req_id = None if req_id is None else str(req_id)
        self.t0 = _now() if t0 is None else float(t0)
        self.t1: Optional[float] = None
        self.attrs = dict(attrs)
        self.done = False
        self.dropped = 0
        self._spans: List[dict] = []
        self._lock = threading.Lock()
        self._next_sid = 1

    # -- span recording ----------------------------------------------------
    def add_span(self, name: str, t0: float, t1: Optional[float] = None,
                 parent: int = 0, **attrs) -> int:
        """Record a completed span; returns its sid (a parent for
        children the caller records next)."""
        rec = {"name": name, "t0": float(t0),
               "t1": _now() if t1 is None else float(t1),
               "parent": int(parent), "args": attrs}
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                self.dropped += 1
                return 0
            sid = self._next_sid
            self._next_sid += 1
            rec["sid"] = sid
            self._spans.append(rec)
        return sid

    def begin_span(self, name: str, parent: int = 0,
                   t0: Optional[float] = None) -> int:
        """Open a span (t1=None) — close it with ``end_span``. An open
        span in an export/dump means the work was in flight when the
        snapshot was taken: exactly what a flight-recorder dump wants
        to show."""
        rec = {"name": name, "t0": _now() if t0 is None else float(t0),
               "t1": None, "parent": int(parent), "args": {}}
        with self._lock:
            if len(self._spans) >= self.MAX_SPANS:
                self.dropped += 1
                return 0
            sid = self._next_sid
            self._next_sid += 1
            rec["sid"] = sid
            self._spans.append(rec)
        return sid

    def end_span(self, sid: int, t1: Optional[float] = None, **attrs):
        if sid <= 0:
            return
        t1 = _now() if t1 is None else float(t1)
        with self._lock:
            for rec in reversed(self._spans):
                if rec["sid"] == sid:
                    rec["t1"] = t1
                    if attrs:
                        rec["args"].update(attrs)
                    return

    def finish(self, t1: Optional[float] = None, **attrs):
        self.t1 = _now() if t1 is None else float(t1)
        if attrs:
            self.attrs.update(attrs)
        self.done = True

    # -- reads -------------------------------------------------------------
    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else _now()) - self.t0

    def spans(self) -> List[dict]:
        """Snapshot copy (records themselves are shared — treat them as
        read-only)."""
        with self._lock:
            return list(self._spans)

    def snapshot(self) -> dict:
        """JSON-able dump record (flight recorder, /traces listing)."""
        return {"trace_id": self.trace_id, "name": self.name,
                "req_id": self.req_id, "t0": self.t0, "t1": self.t1,
                "done": self.done, "dropped": self.dropped,
                "attrs": dict(self.attrs), "spans": self.spans()}

    # -- chrome export -----------------------------------------------------
    def chrome_events(self, lane: int, now: Optional[float] = None
                      ) -> List[dict]:
        """Complete ("ph": "X") events for this trace on chrome lane
        ``lane``; ts/dur are microseconds since TRACE_EPOCH. Open spans
        close at ``now`` so in-flight work renders with its true extent
        so far."""
        now = _now() if now is None else now
        pid = os.getpid()

        def us(t):
            return (t - TRACE_EPOCH) * 1e6

        root_args = {"trace_id": self.trace_id}
        if self.req_id is not None:
            root_args["req_id"] = self.req_id
        root_args.update(self.attrs)
        events = [{"name": self.name, "cat": "trace", "ph": "X",
                   "ts": us(self.t0),
                   "dur": max(0.0, us(self.t1 if self.t1 is not None
                                      else now) - us(self.t0)),
                   "pid": pid, "tid": lane, "args": root_args}]
        for s in self.spans():
            t1 = s["t1"] if s["t1"] is not None else now
            args = {"sid": s["sid"], "parent": s["parent"],
                    "trace_id": self.trace_id}
            args.update(s["args"])
            events.append({"name": s["name"], "cat": "span", "ph": "X",
                           "ts": us(s["t0"]),
                           "dur": max(0.0, us(t1) - us(s["t0"])),
                           "pid": pid, "tid": lane, "args": args})
        return events


def phase_breakdown(trace: Trace) -> Dict[str, float]:
    """Per-phase wall seconds from the trace's TOP-LEVEL spans only
    (children are drill-down detail of their parent — counting both
    would double-bill, e.g. spec.verify inside its decode window).
    Top-level spans tile the request's lifetime, so the values sum —
    up to host scheduling gaps between steps — to the request_done
    wall time; ``serving.request_done`` carries this dict as
    ``phases``."""
    out: Dict[str, float] = {}
    end = trace.t1 if trace.t1 is not None else _now()
    for s in trace.spans():
        if s["parent"] == 0:
            t1 = s["t1"] if s["t1"] is not None else end
            key = s["name"] + "_s"
            out[key] = out.get(key, 0.0) + max(0.0, t1 - s["t0"])
    return {k: round(v, 9) for k, v in out.items()}


@race_track
class Tracer:
    """Process-global trace store + thread-local context.

    - ``start_trace``/``finish_trace``: trace lifecycle. Finished (and
      evicted-live) traces stay resident in a bounded LRU ring keyed by
      trace_id, with a req_id index — ``get()`` accepts either, which
      is what ``/traces/<req_id>`` serves.
    - ``activate``/``span``: the thread-local context stack. ``span``
      nests under the innermost active span; with no active trace it
      records into the process-span ring instead.
    - ``capture``/``attach``: cross-thread propagation — capture on the
      caller thread, attach inside the worker (the async checkpoint
      writer carries its caller's context this way).
    - ``record_span``: the one-call API for after-the-fact sites that
      learn a duration when it is already over (profiler
      RecordEvent, ladder compiles).
    """

    def __init__(self, max_traces: int = 256,
                 max_process_spans: int = 4096):
        self.max_traces = int(max_traces)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Trace]" = OrderedDict()
        self._by_req: Dict[str, str] = {}
        # fleet_trace_id -> [trace_id, ...]: every local fragment that
        # adopted a remote context, so /traces/<fleet-id> on a replica
        # exports ALL of that request's fragments in one doc. Guarded
        # by self._lock like the other indexes.
        self._by_fleet: Dict[str, List[str]] = {}
        self._seq = 0
        # seeded: sampling must be reproducible in tests and must never
        # consume global random state the model paths could observe
        self._rng = random.Random(0x7A3E5)
        self._process_spans: deque = deque(maxlen=int(max_process_spans))
        self._local = threading.local()

    # -- gating ------------------------------------------------------------
    @staticmethod
    def active() -> bool:
        """The FLAGS_observability gate (tracing has no separate master
        switch; FLAGS_trace_sample_rate=0 disables traces while keeping
        metrics/events)."""
        from . import enabled

        return enabled()

    def _sample(self) -> bool:
        from ..core.flags import get_flag

        try:
            rate = float(get_flag("trace_sample_rate"))
        except KeyError:       # registry not populated (early import)
            rate = 1.0
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    # -- trace lifecycle ---------------------------------------------------
    def mint_fleet_id(self) -> str:
        """Fresh 32-hex fleet trace id (the router calls this once per
        proxied request; every hop's fragment adopts it). pid + seq keep
        it collision-free across the processes of one gate box even
        though the rng is seeded."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            bits = self._rng.getrandbits(64)
        return f"{os.getpid() & 0xFFFFFFFF:08x}{seq & 0xFFFFFFFF:08x}{bits:016x}"

    def start_trace(self, name: str, req_id=None,
                    t0: Optional[float] = None, parent=None,
                    **attrs) -> Optional[Trace]:
        """Begin a trace, or return None when tracing is off or the
        sampler skips this one — callers hold the result and gate every
        later site on ``is not None``. ``parent`` is an optional remote
        traceparent header (or a ``parse_traceparent`` pair): the new
        trace keeps its own local id but is indexed under the fleet id
        and records the cross-process parent link in its attrs."""
        if not self.active() or not self._sample():
            return None
        ctx = parent if isinstance(parent, tuple) \
            else parse_traceparent(parent)
        with self._lock:
            self._seq += 1
            trace_id = f"{os.getpid():x}-{self._seq}"
            tr = Trace(trace_id, name, req_id=req_id, t0=t0, **attrs)
            if ctx is not None:
                tr.attrs["fleet_trace_id"] = ctx[0]
                tr.attrs["parent_span"] = ctx[1]
                self._by_fleet.setdefault(ctx[0], []).append(trace_id)
            self._traces[trace_id] = tr
            if tr.req_id is not None:
                self._by_req[tr.req_id] = trace_id
            while len(self._traces) > self.max_traces:
                _, old = self._traces.popitem(last=False)
                if old.req_id is not None and \
                        self._by_req.get(old.req_id) == old.trace_id:
                    del self._by_req[old.req_id]
                fid = old.attrs.get("fleet_trace_id")
                frags = self._by_fleet.get(fid)
                if frags is not None:
                    try:
                        frags.remove(old.trace_id)
                    except ValueError:
                        pass
                    if not frags:
                        del self._by_fleet[fid]
        return tr

    def adopt_fleet(self, trace: Optional[Trace], fleet_id: str,
                    parent_span: Optional[str] = None):
        """Index an already-started trace under a fleet id (the router
        does this for its own route trace right after minting)."""
        if trace is None:
            return
        with self._lock:
            trace.attrs["fleet_trace_id"] = fleet_id
            if parent_span is not None:
                trace.attrs["parent_span"] = parent_span
            frags = self._by_fleet.setdefault(fleet_id, [])
            if trace.trace_id not in frags:
                frags.append(trace.trace_id)

    def fleet_fragments(self, fleet_id: str) -> List[Trace]:
        """Every resident local fragment of ``fleet_id``, in adoption
        order."""
        with self._lock:
            ids = list(self._by_fleet.get(str(fleet_id), ()))
            return [self._traces[t] for t in ids if t in self._traces]

    def finish_trace(self, trace: Optional[Trace],
                     t1: Optional[float] = None, **attrs):
        if trace is not None:
            trace.finish(t1, **attrs)

    def get(self, key) -> Optional[Trace]:
        """Lookup by trace_id OR req_id (str or anything str()-able)."""
        key = str(key)
        with self._lock:
            tr = self._traces.get(key)
            if tr is None:
                tid = self._by_req.get(key)
                if tid is not None:
                    tr = self._traces.get(tid)
            return tr

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._traces.values())

    def summaries(self) -> List[dict]:
        """One small dict per resident trace (the /traces listing)."""
        out = []
        for tr in self.traces():
            out.append({"trace_id": tr.trace_id, "name": tr.name,
                        "req_id": tr.req_id, "done": tr.done,
                        "n_spans": len(tr.spans()),
                        "duration_s": round(tr.duration_s, 9)})
        return out

    # -- thread-local context ----------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self):
        """(trace, span_sid) innermost on THIS thread, or None."""
        st = self._stack()
        return st[-1] if st else None

    @contextmanager
    def activate(self, trace: Optional[Trace], sid: int = 0):
        """Make ``trace`` the ambient trace for the block: nested
        ``span()``/``record_span()`` calls (including from code that
        never saw the trace object) attach to it.
        None passes through untouched."""
        if trace is None:
            yield None
            return
        st = self._stack()
        st.append((trace, sid))
        try:
            yield trace
        finally:
            st.pop()

    def capture(self):
        """Snapshot this thread's context for hand-off to a worker
        thread (None when no trace is active — attach(None) is free)."""
        return self.current()

    @contextmanager
    def attach(self, ctx):
        """Adopt a ``capture()`` result on the current thread."""
        if not ctx:
            yield
            return
        st = self._stack()
        st.append(ctx)
        try:
            yield
        finally:
            st.pop()

    @contextmanager
    def span(self, name: str, **attrs):
        """Context-managed span under the ambient trace (or into the
        process ring without one). Exceptions mark ok=False and
        propagate — a crash leaves its last span visible."""
        if not self.active():
            yield
            return
        cur = self.current()
        if cur is None:
            t0 = _now()
            ok = True
            try:
                yield
            except BaseException:
                ok = False
                raise
            finally:
                if not ok:
                    attrs["ok"] = False
                self.add_process_span(name, t0, _now(), **attrs)
            return
        trace, parent = cur
        sid = trace.begin_span(name, parent=parent)
        st = self._stack()
        st.append((trace, sid))
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            st.pop()
            if not ok:
                attrs["ok"] = False
            trace.end_span(sid, **attrs)

    def record_span(self, name: str, t0: float,
                    t1: Optional[float] = None, **attrs):
        """Completed span -> child of the ambient span, or the process
        ring. For sites that learn the duration after the fact (the
        bridge's compile durations arrive with dur only: pass
        t0 = now - dur)."""
        if not self.active():
            return
        t1 = _now() if t1 is None else float(t1)
        cur = self.current()
        if cur is not None:
            trace, parent = cur
            trace.add_span(name, t0, t1, parent=parent, **attrs)
        else:
            self.add_process_span(name, t0, t1, **attrs)

    def add_process_span(self, name: str, t0: float, t1: float, **attrs):
        rec = {"name": name, "t0": float(t0), "t1": float(t1),
               "args": attrs}
        with self._lock:
            self._process_spans.append(rec)

    def process_spans(self) -> List[dict]:
        with self._lock:
            return list(self._process_spans)

    # -- export ------------------------------------------------------------
    def export_chrome(self, key=None) -> Optional[dict]:
        """Chrome trace-event JSON: one trace (by trace_id/req_id) or,
        with key=None, the whole process — every resident trace on its
        own lane plus the process-span ring on lane 0. Returns None for
        an unknown key."""
        now = _now()
        pid = os.getpid()
        fleet_id = None
        if key is not None:
            tr = self.get(key)
            if tr is None:
                # a 32-hex fleet id exports EVERY local fragment of
                # that request (the router's stitcher fetches this from
                # each replica and merges)
                traces = self.fleet_fragments(key)
                if not traces:
                    return None
                fleet_id = str(key)
            else:
                traces = [tr]
            include_process = False
        else:
            traces = self.traces()
            include_process = True
        events: List[dict] = []
        if include_process:
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 0, "args": {"name": "process spans"}})
            for s in self.process_spans():
                args = {"process": True}
                args.update(s["args"])
                events.append({
                    "name": s["name"], "cat": "span", "ph": "X",
                    "ts": (s["t0"] - TRACE_EPOCH) * 1e6,
                    "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
                    "pid": pid, "tid": 0, "args": args})
        for lane, tr in enumerate(traces, start=1):
            label = tr.req_id if tr.req_id is not None else tr.trace_id
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": lane,
                           "args": {"name": f"{tr.name} {label}"}})
            events.extend(tr.chrome_events(lane, now=now))
        meta = {"pid": pid, "epoch_wall": _EPOCH_WALL,
                "format": "paddle_tpu chrome trace"}
        if fleet_id is not None:
            meta["fleet_trace_id"] = fleet_id
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": meta}

    # -- tests -------------------------------------------------------------
    def reset(self):
        """Drop every trace and process span (tests). Thread-local
        context stacks of OTHER threads are left alone — they unwind
        on their own."""
        with self._lock:
            self._traces.clear()
            self._by_req.clear()
            self._by_fleet.clear()
            self._process_spans.clear()
            self._seq = 0


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (serving, checkpoint writer,
    profiler, and the flight recorder all share it)."""
    return _TRACER
