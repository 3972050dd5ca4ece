"""Prometheus naming contract + exposition lint. Counterpart of
paddle_tpu/analysis/prometheus.py: :func:`lint_exposition` validates a
rendered text-format 0.0.4 exposition the way a strict scraper would
(``observability.metrics.lint_prometheus`` wraps it). The static
``metric-naming`` rule of the JAX package's linter is not ported; its
:class:`Finding` record is kept here.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Finding:
    """One diagnostic (the JAX package's ``analysis.linter.Finding``)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: Optional[str] = None


__all__ = ["Finding", "METRIC_NAME_RE", "LABEL_NAME_RE", "COUNTER_SUFFIX",
           "RESERVED_HISTOGRAM_SUFFIXES", "EXPOSITION_RULE_ID",
           "lint_exposition"]

# -- the contract -------------------------------------------------------
METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
#: counters must carry this suffix (OpenMetrics compatibility)
COUNTER_SUFFIX = "_total"
#: a histogram family name must not collide with its own sample roles
RESERVED_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")

EXPOSITION_RULE_ID = "prometheus-exposition"

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\["\\n])*)"')

_LabelKey = Tuple[Tuple[str, str], ...]


def _finding(line: int, message: str, path: str) -> Finding:
    return Finding(EXPOSITION_RULE_ID, path, line, 0, message)


def lint_exposition(text: str,
                    path: str = "<exposition>") -> List[Finding]:
    """Validate a text-format 0.0.4 exposition the way a strict scraper
    would.  Checked: sample lines parse, label values use only legal
    escapes, counter families end in ``_total``, and every histogram
    label set carries a ``+Inf`` bucket with cumulative (non-decreasing)
    bucket counts whose ``+Inf`` count equals ``_count``.  Aggregate
    (whole-family) problems are reported with ``line=0``."""
    problems: List[Finding] = []
    types: Dict[str, str] = {}
    # per (family, non-le label key): [(le, value)] in render order
    buckets: Dict[Tuple[str, _LabelKey], List[Tuple[float, float]]] = {}
    counts: Dict[Tuple[str, _LabelKey], float] = {}

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                problems.append(_finding(
                    lineno, f"malformed TYPE: {line}", path))
                continue
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(_finding(
                lineno, f"unparseable sample: {line}", path))
            continue
        name, labels_raw, value_raw = m.groups()
        try:
            value = (float("inf") if value_raw == "+Inf" else
                     float("-inf") if value_raw == "-Inf" else
                     float(value_raw))
        except ValueError:
            problems.append(_finding(
                lineno, f"bad sample value {value_raw!r}", path))
            continue
        labels: Dict[str, str] = {}
        if labels_raw:
            consumed = _LABEL_RE.sub("", labels_raw)
            if consumed.strip(", ") != "":
                problems.append(_finding(
                    lineno,
                    f"malformed/unescaped label block {{{labels_raw}}}",
                    path))
                continue
            labels = dict(_LABEL_RE.findall(labels_raw))
        # resolve the family behind suffixed histogram samples
        family, role = name, "value"
        for suffix, r in (("_bucket", "bucket"), ("_sum", "sum"),
                          ("_count", "count")):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family, role = base, r
                break
        kind = types.get(family)
        if kind is None:
            problems.append(_finding(
                lineno, f"sample {name} has no # TYPE line", path))
            continue
        if kind == "counter" and not family.endswith(COUNTER_SUFFIX):
            problems.append(_finding(
                lineno,
                f"counter {family} must carry the _total suffix", path))
        if kind == "histogram":
            key_labels = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"))
            key = (family, key_labels)
            if role == "bucket":
                le_raw = labels.get("le")
                if le_raw is None:
                    problems.append(_finding(
                        lineno, f"{name} bucket without le=", path))
                    continue
                le = float("inf") if le_raw == "+Inf" else float(le_raw)
                buckets.setdefault(key, []).append((le, value))
            elif role == "count":
                counts[key] = value
    for (family, key), series in buckets.items():
        les = [le for le, _ in series]
        vals = [v for _, v in series]
        where = f"histogram {family}{dict(key) or ''}"
        if not any(math.isinf(le) for le in les):
            problems.append(_finding(0, f"{where}: no +Inf bucket", path))
        if les != sorted(les):
            problems.append(_finding(
                0, f"{where}: buckets not in ascending le order", path))
        if any(v0 > v1 for v0, v1 in zip(vals, vals[1:])):
            problems.append(_finding(
                0, f"{where}: bucket counts not cumulative", path))
        total = counts.get((family, key))
        if total is not None and vals and vals[-1] != total:
            problems.append(_finding(
                0, f"{where}: +Inf bucket {vals[-1]} != _count {total}",
                path))
    for (family, key) in counts:
        if (family, key) not in buckets:
            problems.append(_finding(
                0,
                f"histogram {family}{dict(key) or ''}: _count without "
                f"buckets", path))
    return problems
