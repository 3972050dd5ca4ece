"""Flight recorder: last-moments forensics for crashed or preempted
processes. Counterpart of paddle_tpu/observability/flight_recorder.py.

The EventLog ring, the tracer's span trees, and the metrics registry
already hold "what was the engine doing" — but only in memory, which is
exactly what a crash destroys. The flight recorder snapshots all three
(plus every thread's stack) and writes the bundle ATOMICALLY (tmp +
fsync + rename — the same commit discipline as the checkpoint manager)
into a crash directory, triggered by:

- an unhandled exception (``sys.excepthook`` + ``threading.excepthook``,
  chained to the previous hooks);
- SIGTERM (chained — coexists with the checkpoint manager's preemption
  handler: whichever installed last dumps/saves first, then delegates);
- a ``watchdog.timeout`` event (via the EventLog emit hook — the
  collective watchdog already routes its verdicts through the log);
- a periodic autodump thread. SIGKILL and the OOM killer give no hook
  at all, so surviving them means having ALWAYS just written a dump:
  the chaos harness runs its training child with a sub-second interval
  and asserts the post-SIGKILL dump is readable
  (tests/test_tracing.py).

Opt-in per process: construct + ``install()``, or set
``PADDLE_CRASH_DIR`` in the environment (``install_from_env`` runs at
package import; ``PADDLE_CRASH_DUMP_INTERVAL`` tunes the autodump
period, default 1s). Dump files are ``flight_<pid>_<reason>.json`` —
one per reason, overwritten in place, so a crash dir stays small no
matter how long the process lives.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Optional

__all__ = ["FlightRecorder", "install_from_env", "get_flight_recorder",
           "register_state_provider", "unregister_state_provider"]


# Named live-state providers folded into every dump under "state": a
# subsystem (e.g. the serving scheduler) registers a zero-arg callable
# returning a JSON-able dict — post-mortems then show what that
# subsystem was doing at the kill instant, not just its event tail.
# Providers returning None (a weakref'd owner that died) are pruned.
_STATE_PROVIDERS: dict = {}
_STATE_LOCK = threading.Lock()


def register_state_provider(name: str, fn) -> None:
    """Register (or replace) a named state provider. ``fn`` must be a
    zero-arg callable returning a JSON-able dict, or None once its
    owner is gone (the registration is then dropped). It runs on the
    dump path — including inside signal handlers and the autodump
    thread — so it must not block or sync device state."""
    with _STATE_LOCK:
        _STATE_PROVIDERS[name] = fn


def unregister_state_provider(name: str) -> None:
    with _STATE_LOCK:
        _STATE_PROVIDERS.pop(name, None)


def _provider_states() -> dict:
    with _STATE_LOCK:
        items = list(_STATE_PROVIDERS.items())
    out, dead = {}, []
    for name, fn in items:
        try:
            state = fn()
        except Exception as e:   # a broken provider must not lose the dump
            out[name] = {"error": repr(e)}
            continue
        if state is None:
            dead.append(name)
        else:
            out[name] = state
    if dead:
        with _STATE_LOCK:
            for name in dead:
                _STATE_PROVIDERS.pop(name, None)
    return out


class FlightRecorder:
    def __init__(self, crash_dir: str, events_tail: int = 512,
                 traces_tail: int = 32, process_spans_tail: int = 256,
                 autodump_interval_s: Optional[float] = None):
        self.crash_dir = str(crash_dir)
        self.events_tail = int(events_tail)
        self.traces_tail = int(traces_tail)
        self.process_spans_tail = int(process_spans_tail)
        self.autodump_interval_s = autodump_interval_s
        os.makedirs(self.crash_dir, exist_ok=True)
        self._dump_lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._prev_signals = {}
        self._event_hook = None
        self._hooked_log = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_dump_path: Optional[str] = None

    # -- snapshot / dump ---------------------------------------------------
    def snapshot(self, reason: str) -> dict:
        """JSON-able last-moments bundle. Reads take each subsystem's
        own locks briefly; nothing here blocks emitters for the
        duration of the file write."""
        from .events import get_event_log
        from .metrics import get_registry
        from .tracing import TRACE_EPOCH, get_tracer

        tracer = get_tracer()
        return {
            "reason": reason,
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "wall": time.time(),
            "ts": time.monotonic() - TRACE_EPOCH,
            "events": get_event_log().tail(self.events_tail),
            "traces": [t.snapshot()
                       for t in tracer.traces()[-self.traces_tail:]],
            "process_spans":
                tracer.process_spans()[-self.process_spans_tail:],
            "metrics": get_registry().to_dict(),
            "threads": self._thread_stacks(),
            "state": _provider_states(),
        }

    @staticmethod
    def _thread_stacks() -> dict:
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for ident, frame in sys._current_frames().items():
            key = f"{names.get(ident, 'unknown')}-{ident}"
            out[key] = traceback.format_stack(frame, limit=24)
        return out

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write one atomic dump; returns its path. Never raises — a
        broken dump path must not mask the crash being recorded."""
        # _dump_lock is a dedicated lock whose ONLY job is serializing
        # whole dumps (signal handler, watchdog hook, and autodump
        # thread can race); nothing latency-sensitive ever contends on
        # it, so holding it across the atomic-write I/O is the design.
        try:
            with self._dump_lock:
                path = os.path.join(
                    self.crash_dir,
                    f"flight_{os.getpid()}_{reason}.json")
                tmp = path + ".tmp"
                snap = self.snapshot(reason)
                with open(tmp, "w") as f:
                    json.dump(snap, f, default=str)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                self.last_dump_path = path
                return path
        except Exception:
            return None

    # -- triggers ----------------------------------------------------------
    def install(self, signals=(signal.SIGTERM,)) -> "FlightRecorder":
        """Arm every trigger. Idempotent; pair with ``uninstall()``."""
        if self._installed:
            return self
        self._installed = True

        prev_hook = sys.excepthook

        def _excepthook(tp, val, tb):
            self.dump("exception")
            prev_hook(tp, val, tb)

        self._prev_excepthook = prev_hook
        sys.excepthook = _excepthook

        prev_thook = threading.excepthook

        def _thread_hook(args):
            self.dump("thread_exception")
            prev_thook(args)

        self._prev_thread_hook = prev_thook
        threading.excepthook = _thread_hook

        for sig in signals:
            try:
                prev = signal.getsignal(sig)
                signal.signal(sig, self._make_signal_handler(sig, prev))
                self._prev_signals[sig] = prev
            except (ValueError, OSError):
                pass   # not the main thread / unsupported signal

        from .events import get_event_log

        def _event_hook(rec):
            if rec.get("event") == "watchdog.timeout":
                self.dump("watchdog_timeout")

        self._event_hook = _event_hook
        self._hooked_log = get_event_log()
        self._hooked_log.add_hook(_event_hook)

        if self.autodump_interval_s:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._autodump_loop, name="flight-recorder",
                daemon=True)
            self._thread.start()
        return self

    def _make_signal_handler(self, sig, prev):
        def handler(signum, frame):
            self.dump(signal.Signals(signum).name.lower())
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                # re-deliver with the default disposition so the exit
                # status still says "killed by signal"
                try:
                    signal.signal(signum, signal.SIG_DFL)
                    signal.raise_signal(signum)
                except (ValueError, OSError):
                    raise SystemExit(128 + signum)
            # SIG_IGN: dump and keep running

        return handler

    def _autodump_loop(self):
        while not self._stop.wait(self.autodump_interval_s):
            self.dump("interval")

    def uninstall(self):
        if not self._installed:
            return
        self._installed = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_thread_hook is not None:
            threading.excepthook = self._prev_thread_hook
            self._prev_thread_hook = None
        for sig, prev in self._prev_signals.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_signals.clear()
        if self._hooked_log is not None and self._event_hook is not None:
            self._hooked_log.remove_hook(self._event_hook)
        self._hooked_log = self._event_hook = None


_AUTO: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The env-installed recorder, if any."""
    return _AUTO


def install_from_env() -> Optional[FlightRecorder]:
    """Install a recorder when ``PADDLE_CRASH_DIR`` is set (called at
    package import; idempotent — the chaos child calls it again
    explicitly and gets the same instance)."""
    global _AUTO
    if _AUTO is not None:
        return _AUTO
    crash_dir = os.environ.get("PADDLE_CRASH_DIR")
    if not crash_dir:
        return None
    try:
        interval = float(os.environ.get("PADDLE_CRASH_DUMP_INTERVAL",
                                        "1.0"))
    except ValueError:
        interval = 1.0
    _AUTO = FlightRecorder(
        crash_dir, autodump_interval_s=interval or None).install()
    return _AUTO
