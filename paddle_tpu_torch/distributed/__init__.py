"""paddle.distributed's counterpart, cut to ``fleet.recompute`` (the rest
is ROADMAP queue A item 10)."""
from . import fleet

__all__ = ["fleet"]
