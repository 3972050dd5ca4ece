"""The op registry, its dispatch pipeline and the custom-op API.
Counterpart of paddle_tpu/ops, cut to ``registry`` and ``custom``: the
built-in op modules (math, manipulation, creation, ...) wait for the
public tensor API (ROADMAP queue A item 7)."""
from .custom import deregister_op, register_op
from .registry import OPS, apply_op, op, raw, register

__all__ = ["OPS", "apply_op", "deregister_op", "op", "raw", "register",
           "register_op"]
