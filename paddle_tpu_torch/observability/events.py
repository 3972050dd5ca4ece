"""Structured event log: JSONL records with monotonic timestamps and
span events. Counterpart of paddle_tpu/observability/events.py.

Where the metrics registry aggregates (counts, distributions), the
EventLog keeps the NARRATIVE: request completions, compile events,
watchdog timeouts, profiler spans — each one a dict with a monotonic
timestamp (``ts`` — ordering survives wall-clock jumps) plus wall time
(``wall`` — correlation with external logs). Events live in a bounded
in-memory ring and, when a path is attached, append to a JSONL file
(crash-safe: line-buffered, one record per line, same contract as
utils.log_writer).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..analysis.sanitizers import race_track

__all__ = ["EventLog", "get_event_log", "set_event_log"]


@race_track
class EventLog:
    """Bounded event ring + optional JSONL sink.

    Record schema (one JSON object per line)::

        {"event": "serving.request_done",   # dotted event name
         "ts": 12.345678,                   # monotonic seconds
         "wall": 1722800000.123,            # unix wall time
         ...fields}                         # event-specific payload

    Span events additionally carry ``"phase": "span"`` and ``dur_s``.
    """

    def __init__(self, path: Optional[str] = None, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._f = None
        self._t0 = time.monotonic()
        self._hooks: List = []
        if path is not None:
            self.attach_file(path)

    # -- sinks ---------------------------------------------------------
    def attach_file(self, path: str):
        """Tee every subsequent event to a JSONL file (line-buffered).
        The open/close happen OUTSIDE the lock (path resolution and
        buffer flushes can block); only the sink swap is locked."""
        f = open(path, "a", buffering=1)
        with self._lock:
            old, self._f = self._f, f
        if old is not None:
            old.close()
        return self

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def flush(self):
        """Push buffered sink bytes to the OS (the file is line-buffered
        already; this is the explicit barrier span() uses on exit so a
        reader tailing the JSONL always sees complete spans). The flush
        itself runs OUTSIDE the lock — it can block on disk, and a
        concurrent close() just turns it into a caught ValueError."""
        with self._lock:
            f = self._f
        if f is not None:
            try:
                f.flush()
            except (OSError, ValueError):
                pass

    # -- hooks ---------------------------------------------------------
    def add_hook(self, fn):
        """Call ``fn(rec)`` after every emit, OUTSIDE the log lock (a
        hook may read the ring — the flight recorder's watchdog-timeout
        trigger does). Hook exceptions are swallowed: observers must
        never take down the emitting path."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    def remove_hook(self, fn):
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    # -- emission ------------------------------------------------------
    def emit(self, event: str, **fields) -> dict:
        rec = {"event": event,
               "ts": round(time.monotonic() - self._t0, 9),
               "wall": time.time()}
        rec.update(fields)
        # serialize OUTSIDE the lock (dumps of a large payload must not
        # stall concurrent emitters); ring append + file write stay
        # under ONE lock so the ring order and the JSONL line order
        # agree even with the checkpoint writer thread and serving
        # callbacks emitting concurrently
        try:
            line = json.dumps(rec, default=str) + "\n"
        except (TypeError, ValueError):
            line = None
        with self._lock:
            self._ring.append(rec)
            if self._f is not None and line is not None:
                try:
                    self._f.write(line)
                except (OSError, ValueError):
                    pass  # a dead sink must never take down the hot path
            hooks = tuple(self._hooks)
        for fn in hooks:
            try:
                fn(rec)
            except Exception:
                pass
        return rec

    @contextmanager
    def span(self, event: str, **fields):
        """Span event: one record emitted at EXIT carrying the duration
        (phase="span", dur_s). Body exceptions propagate but still emit
        (with ok=False) so hangs/crashes leave a trace."""
        t0 = time.monotonic()
        try:
            yield self
        except BaseException:
            self.emit(event, phase="span",
                      dur_s=round(time.monotonic() - t0, 9), ok=False,
                      **fields)
            self.flush()
            raise
        self.emit(event, phase="span",
                  dur_s=round(time.monotonic() - t0, 9), **fields)
        self.flush()

    # -- reads ---------------------------------------------------------
    def events(self, name: Optional[str] = None,
               prefix: Optional[str] = None) -> List[Dict]:
        """Snapshot of the ring, optionally filtered by exact name or
        dotted prefix ("serving." matches "serving.request_done")."""
        with self._lock:
            recs = list(self._ring)
        if name is not None:
            recs = [r for r in recs if r["event"] == name]
        if prefix is not None:
            recs = [r for r in recs if r["event"].startswith(prefix)]
        return recs

    def tail(self, n: int = 20) -> List[Dict]:
        with self._lock:
            return list(self._ring)[-n:]

    def clear(self):
        with self._lock:
            self._ring.clear()

    def __len__(self):
        with self._lock:
            return len(self._ring)


_EVENT_LOG = EventLog()


def get_event_log() -> EventLog:
    """The process-global event log (serving, the scheduler, the
    step profiler and the SLO monitor all emit here)."""
    return _EVENT_LOG


def set_event_log(log: EventLog) -> EventLog:
    """Swap the global log (tests / file-backed deployments). Returns
    the previous one."""
    global _EVENT_LOG
    prev = _EVENT_LOG
    _EVENT_LOG = log
    return prev
