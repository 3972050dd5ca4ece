"""The race-sanitizer declarations: ``race_track``, ``race_exempt`` and
``race_handoff``. Counterpart of paddle_tpu/analysis/sanitizers.py:459-505,
the part the serving session, the scheduler, the prefix-block pool and
the observability modules import.

Owners declare which classes a race sanitizer would track and which
fields are single-writer or handed off between threads, with the
reviewed reason, next to the class. The sanitizers that read these
registries (RaceSanitizer, LockOrderWatcher) are not ported yet
(ROADMAP queue A item 8): here a declaration only records itself.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["race_exempt", "race_handoff", "race_track"]

#: classes declared for race tracking, in declaration order
_RACE_CLASSES: List[type] = []
#: "ClassName.attr" -> reason; declared next to the class by its owner
_RACE_EXEMPTIONS: Dict[str, str] = {}
#: "ClassName.attr" or "ClassName.*" -> reason; init-then-handoff
#: fields (born on the constructing thread, then owned by exactly one
#: other thread, e.g. an event loop or engine thread)
_RACE_HANDOFFS: Dict[str, str] = {}


def race_track(cls):
    """Class decorator: declare ``cls`` for race tracking. Returns the
    class unchanged."""
    _RACE_CLASSES.append(cls)
    return cls


def race_exempt(field: str, reason: str):
    """Declare ``"ClassName.attr"`` as intentionally unsynchronized, with
    the reviewed reason (e.g. published via an Event handshake, or a
    single-writer hint flag)."""
    if not reason:
        raise ValueError(f"race_exempt({field!r}) requires a reason")
    _RACE_EXEMPTIONS[field] = reason


def race_handoff(field: str, reason: str):
    """Declare an init-then-handoff field (``"Class.attr"`` or
    ``"Class.*"``): constructed on one thread, then owned by exactly ONE
    other thread."""
    if not reason:
        raise ValueError(f"race_handoff({field!r}) requires a reason")
    _RACE_HANDOFFS[field] = reason
