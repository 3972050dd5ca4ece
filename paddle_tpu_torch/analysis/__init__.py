"""Concurrency declarations and the Prometheus exposition lint the
serving and observability modules read. Counterpart of a part of
paddle_tpu/analysis (the sanitizers themselves, the linter and its
rules are not ported; ROADMAP queue A item 8)."""
from .prometheus import lint_exposition
from .sanitizers import race_exempt, race_handoff, race_track

__all__ = ["lint_exposition", "race_exempt", "race_handoff", "race_track"]
