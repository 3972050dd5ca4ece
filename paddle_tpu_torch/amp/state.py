"""AMP runtime state and per-op dtype lists. Counterpart of
paddle_tpu/amp/state.py.

The functionals of the port call :func:`autocast` with the op name and
amp policy their JAX counterparts register, and the port's op dispatch
(``ops/registry.py`` ``apply_op``, step 1) does the same for every
registered op, so an op runs in the dtype the JAX package would give it.
"""
from __future__ import annotations

import threading

import torch

# Ops that are numerically safe & profitable in low precision
# (matmul-class). Parity: white list in python/paddle/amp/amp_lists.py.
WHITE_LIST = {
    "matmul", "mm", "bmm", "einsum", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "addmm", "attention",
    "scaled_dot_product_attention", "flash_attention",
}

# Ops that must run in fp32 for numeric safety. Parity: black list.
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "cumsum", "cumprod", "logsumexp", "erf", "erfinv", "sum", "mean", "prod",
    "norm", "p_norm", "reduce_sum", "sigmoid_cross_entropy_with_logits",
    "binary_cross_entropy", "nll_loss", "kl_div", "var", "std", "renorm",
    "cosine_similarity", "layer_norm_stats",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_cast_dtype(op_name: str, op_policy: str):
    """The dtype name an op's floating inputs are cast to, or None.

    The ``"block"`` policy forces fp32 as a black-listed op does, which is
    what the JAX package's ``OpDef`` documents (``ops/registry.py:38``);
    its ``amp_cast_dtype`` reads only the lists, so there a ``block`` op
    runs in bf16 under O2 (ROADMAP queue C, reference caveat 5)."""
    if op_policy == "keep":
        return None
    if op_name in _state.custom_black or (
            (op_name in BLACK_LIST or op_policy == "block")
            and op_name not in _state.custom_white):
        return "float32"
    if (op_policy == "allow" or op_name in WHITE_LIST
            or op_name in _state.custom_white):
        return _state.dtype
    if _state.level == "O2":
        return _state.dtype   # O2: everything not blacklisted
    return None               # O1 gray list: the input dtype


def autocast(op_name: str, op_policy: str, *tensors):
    """``tensors`` with each floating tensor cast as
    :func:`amp_cast_dtype` decides while amp is on; unchanged otherwise
    (None entries pass through)."""
    if not _state.enabled:
        return tensors
    target = amp_cast_dtype(op_name, op_policy)
    if target is None:
        return tensors
    dt = _DTYPES[target]
    return tuple(t.to(dt) if t is not None and t.is_floating_point() else t
                 for t in tensors)


def set_amp(enabled: bool, dtype: str = "bfloat16", level: str = "O1",
            custom_white=None, custom_black=None):
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be one of {sorted(_DTYPES)}, "
                         f"got {dtype!r}")
    prev = current_amp()
    _state.enabled = enabled
    _state.dtype = dtype
    _state.level = level
    _state.custom_white = set(custom_white or ())
    _state.custom_black = set(custom_black or ())
    return prev


def current_amp():
    """The amp state, as :func:`set_amp` returns it (for
    :func:`restore_amp`)."""
    return (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)


def restore_amp(prev) -> None:
    (_state.enabled, _state.dtype, _state.level,
     _state.custom_white, _state.custom_black) = prev


__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_cast_dtype", "autocast",
           "current_amp", "restore_amp", "set_amp"]
