"""Framework-wide metrics registry: Counter / Gauge / Histogram with
labels, zero-dependency Prometheus-text exposition. Counterpart of
paddle_tpu/observability/metrics.py.

Role parity: the reference operates production serving through external
collectors (Paddle Serving exports Prometheus metrics; the framework
itself only has ad-hoc stats dicts). Production LLM serving treats
per-request latency histograms and KV-pool occupancy as the primary
scheduler-tuning signals (Orca/vLLM), so paddle_tpu gives them a
first-class home: one process-global registry every subsystem (serving
sessions, the step profiler, the SLO monitor) reports
through, rendered with ``render_prometheus()`` or dumped as JSON for
tooling (``tools/perf_gate.py --from-metrics``).

Design: a metric FAMILY (name + help + type) holds one value per label
set (a sorted tuple of (key, value) pairs). All mutation is lock-guarded
(serving step threads + the watchdog daemon write concurrently); reads
take a snapshot. No third-party client library — exposition is the
Prometheus text format 0.0.4 written by hand.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from ..analysis.sanitizers import race_track

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_BUCKETS", "lint_prometheus"]

# latency-shaped default buckets: 100us .. 60s, roughly x2.5 spacing —
# wide enough for TTFT (ms..s) and compile times (s..min) alike
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


class _Metric:
    """Shared family plumbing: name, help, per-label-set cells."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._cells: Dict[LabelKey, object] = {}

    def _cell(self, labels: Dict[str, str]):
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = self._new_cell()
            return cell

    def _peek(self, labels: Dict[str, str]):
        """Read-only lookup: NEVER materializes a cell (a dashboard
        probing an unseen label set must not pollute the exposition)."""
        with self._lock:
            return self._cells.get(_label_key(labels))

    def labels(self, **labels):
        """Prometheus-client-style bound child: m.labels(model="gpt")."""
        return _Bound(self, labels)

    # snapshot for exposition / JSON
    def _items(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return list(self._cells.items())


class _Bound:
    __slots__ = ("_metric", "_labels")

    def __init__(self, metric, labels):
        self._metric = metric
        self._labels = labels

    def inc(self, amount: float = 1.0):
        return self._metric.inc(amount, **self._labels)

    def set(self, value: float):
        return self._metric.set(value, **self._labels)

    def observe(self, value: float):
        return self._metric.observe(value, **self._labels)


class Counter(_Metric):
    """Monotonically increasing count (events, tokens, steps)."""

    kind = "counter"

    def _new_cell(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        cell = self._cell(labels)
        with self._lock:
            cell[0] += amount

    def value(self, **labels) -> float:
        cell = self._peek(labels)
        return 0.0 if cell is None else cell[0]


class Gauge(_Metric):
    """Point-in-time value (live slots, pool occupancy, queue depth)."""

    kind = "gauge"

    def _new_cell(self):
        return [0.0]

    def set(self, value: float, **labels):
        cell = self._cell(labels)
        with self._lock:
            cell[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        cell = self._cell(labels)
        with self._lock:
            cell[0] += amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        cell = self._peek(labels)
        return 0.0 if cell is None else cell[0]


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * n_buckets   # cumulative on render, raw here
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Distribution with fixed upper-bound buckets (latencies)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self._buckets = bs

    def _new_cell(self):
        return _HistCell(len(self._buckets) + 1)   # +1 = +Inf

    def observe(self, value: float, **labels):
        self.observe_many(value, 1, **labels)

    def observe_many(self, value: float, count: int, **labels):
        """`count` observations of the same value in one locked update —
        the serving chunk path records per-token latencies this way
        (every token of a chunk shares dt/chunk)."""
        cell = self._cell(labels)
        v = float(value)
        idx = len(self._buckets)
        for i, b in enumerate(self._buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            cell.counts[idx] += count
            cell.sum += v * count
            cell.count += count

    def value(self, **labels) -> dict:
        cell = self._peek(labels)
        if cell is None:
            cell = self._new_cell()
        with self._lock:
            return {"sum": cell.sum, "count": cell.count,
                    "buckets": dict(zip([*map(str, self._buckets), "+Inf"],
                                        cell.counts))}

    def percentile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation) — good enough for gating/reporting."""
        cell = self._peek(labels)
        if cell is None:
            return float("nan")
        with self._lock:
            total = cell.count
            if total == 0:
                return float("nan")
            target = q * total
            acc = 0
            for i, c in enumerate(cell.counts):
                acc += c
                if acc >= target:
                    return (self._buckets[i] if i < len(self._buckets)
                            else float("inf"))
        return float("inf")


@race_track
class MetricsRegistry:
    """Name -> metric family. ``counter()``/``gauge()``/``histogram()``
    are get-or-create (idempotent; re-declaring with a different type
    raises — one name, one meaning)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        """``buckets=None`` means DEFAULT_BUCKETS; an explicit scheme is
        pinned to the family — re-declaring the same name with different
        boundaries raises (merged quantiles must never mix schemes)."""
        want = (None if buckets is None
                else sorted(float(b) for b in buckets))
        h = self._get_or_create(
            Histogram, name, help,
            buckets=DEFAULT_BUCKETS if want is None else want)
        if want is not None and want != h._buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h._buckets}, refusing buckets={want}")
        return h

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Drop every family (tests)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition --------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text format 0.0.4 of every family (no client lib)."""
        out: List[str] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, cell in m._items():
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m._buckets, cell.counts):
                        cum += c
                        le = 'le="%s"' % _fmt_value(b)
                        out.append(f"{m.name}_bucket"
                                   f"{_fmt_labels(key, le)} {cum}")
                    cum += cell.counts[-1]
                    inf = 'le="+Inf"'
                    out.append(f"{m.name}_bucket"
                               f"{_fmt_labels(key, inf)} {cum}")
                    out.append(f"{m.name}_sum{_fmt_labels(key)}"
                               f" {_fmt_value(cell.sum)}")
                    out.append(f"{m.name}_count{_fmt_labels(key)}"
                               f" {cell.count}")
                else:
                    out.append(f"{m.name}{_fmt_labels(key)}"
                               f" {_fmt_value(cell[0])}")
        return "\n".join(out) + ("\n" if out else "")

    def to_dict(self) -> dict:
        """JSON-able snapshot: {name: {"type", "help", "values": [
        {"labels": {...}, ...value fields}]}} — the dump perf tooling
        reads (tools/perf_gate.py --from-metrics)."""
        out = {}
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for m in metrics:
            vals = []
            for key, cell in m._items():
                entry = {"labels": dict(key)}
                if isinstance(m, Histogram):
                    entry.update({
                        "sum": cell.sum, "count": cell.count,
                        "buckets": dict(zip(
                            [*map(str, m._buckets), "+Inf"], cell.counts))})
                else:
                    entry["value"] = cell[0]
                vals.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "values": vals}
        return out

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every subsystem reports through."""
    return _REGISTRY


# -- exposition lint ----------------------------------------------------
def lint_prometheus(text: str) -> List[str]:
    """Validate a text-format 0.0.4 exposition the way a strict scraper
    would; returns a list of problems (empty = scrapeable). Checked:
    sample lines parse, label values use only legal escapes, counter
    families end in ``_total``, and every histogram label set carries a
    ``+Inf`` bucket with cumulative (non-decreasing) bucket counts
    whose ``+Inf`` count equals ``_count``. Run by the CI lint test
    against a fully-populated registry so ``/metrics`` stays
    scrapeable as new metrics land.

    The implementation lives in ``analysis.prometheus``; this wrapper
    keeps the historical ``List[str]`` surface."""
    from ..analysis.prometheus import lint_exposition

    return [(f"line {f.line}: {f.message}" if f.line else f.message)
            for f in lint_exposition(text)]
