"""paddle.amp.auto_cast and decorate. Counterpart of
paddle_tpu/amp/auto_cast.py.

The default amp dtype is bfloat16. O1/O2 set the per-op casting that the
port's functionals apply (amp/state.py); O2 ``decorate`` also casts the
model's fp32 parameters to the amp dtype, in place, and makes the
optimizers keep fp32 master weights, or, with ``master_weight=False``,
none (pure low-precision training).
"""
from __future__ import annotations

import contextlib

import torch

from . import state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level must be O0/O1/O2, got {level}")
    prev = state.set_amp(enable and level != "O0", dtype=dtype, level=level,
                         custom_white=custom_white_list,
                         custom_black=custom_black_list)
    try:
        yield
    finally:
        state.restore_amp(prev)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """O2 decoration: cast the models' fp32 parameters to ``dtype`` (in
    place: the optimizers keep the same Parameter objects) and give the
    optimizers fp32 master weights (``multi_precision``) unless
    ``master_weight=False``: then the low-precision parameters are
    updated without masters (pair it with ``AdamW(moment_dtype=
    "bfloat16", stochastic_rounding=True)``, the JAX package's plan for
    GPT-3 1.3B on one chip). ``master_grad`` raises (not ported; the JAX
    package records it and reads it nowhere)."""
    if master_grad:
        raise NotImplementedError("decorate(master_grad=True) is not ported")
    if dtype not in ("bfloat16", "float16"):
        raise ValueError(f"decorate dtype must be bfloat16/float16, "
                         f"got {dtype!r}")
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = getattr(torch, dtype)
        for m in model_list:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(dt)
    if optimizers is not None:
        opt_single = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if opt_single else list(optimizers)
        for o in opt_list:
            o._multi_precision = (True if master_weight is None
                                  else bool(master_weight))
        optimizers = opt_list[0] if opt_single else opt_list
    models = model_list[0] if single else model_list
    return (models, optimizers) if optimizers is not None else models


__all__ = ["auto_cast", "decorate"]
