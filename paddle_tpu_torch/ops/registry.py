"""Op registry and the eager dispatch pipeline. Counterpart of
paddle_tpu/ops/registry.py.

Every registered op is called through :func:`apply_op`, which does, in
the JAX package's order:
  1. the amp cast of the floating tensor arguments
     (``amp.state.amp_cast_dtype`` with the op's policy; ``.to`` is
     differentiable);
  2. with ``promote=True``, type promotion over the tensor arguments
     (``torch.promote_types``);
  3. the impl, on arguments that may hold tensors in nested lists and
     tuples. Autograd is PyTorch's own: the JAX package's tape and
     ``jax.vjp`` pullbacks have no counterpart here;
  4. under ``FLAGS_check_nan_inf``, a check of every floating output
     (``FloatingPointError`` at ``FLAGS_check_nan_inf_level`` 0, a
     warning otherwise);
and, while a torch profiler is recording, wraps the impl in
``torch.profiler.record_function("op:<name>")``, so each dispatch is a
span on its trace.

Not ported: the XLA eager-executable cache and its split pullbacks (the
JAX module's ``:279-416``: PyTorch runs every op eagerly, nothing is
compiled); the static-program record (``:417``; it comes with
``static`` and ``jit``, ROADMAP queue A item 9); ``direct_grad`` and
``allow_mesh_cache`` (``:100-127``; they come with recompute, queue A
item 4, and fleet, item 10).
"""
from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from ..amp.state import autocast
from ..core.flags import get_flag


class OpDef:
    __slots__ = ("name", "impl", "promote", "amp")

    def __init__(self, name: str, impl: Callable, promote: bool = False,
                 amp: str = "promote"):
        self.name = name
        self.impl = impl
        self.promote = promote
        # 'allow' (run in the amp dtype) | 'block' (force fp32) |
        # 'promote' (the lists and the level decide) | 'keep' (never cast)
        self.amp = amp


OPS: Dict[str, OpDef] = {}


def apply_op(opdef: OpDef, *args, **attrs):
    """The eager dispatch pipeline (see the module docstring). Keyword
    arguments are static attributes passed to the impl as they are."""
    leaves, spec = pytree.tree_flatten(args)
    t_pos = [i for i, leaf in enumerate(leaves)
             if isinstance(leaf, torch.Tensor)]
    tensors = autocast(opdef.name, opdef.amp, *(leaves[i] for i in t_pos))
    if opdef.promote and len({t.dtype for t in tensors}) > 1:
        common = functools.reduce(torch.promote_types,
                                  [t.dtype for t in tensors])
        tensors = [t.to(common) for t in tensors]
    for i, t in zip(t_pos, tensors):
        leaves[i] = t
    span = (torch.profiler.record_function("op:" + opdef.name)
            if torch.autograd._profiler_enabled()
            else contextlib.nullcontext())
    with span:
        out = opdef.impl(*pytree.tree_unflatten(leaves, spec), **attrs)
    multi = isinstance(out, (tuple, list))
    if get_flag("check_nan_inf"):
        _check_nan_inf(opdef.name, out if multi else (out,))
    return tuple(out) if multi else out


def _check_nan_inf(name: str, outs) -> None:
    for o in outs:
        if (isinstance(o, torch.Tensor) and o.is_floating_point()
                and not bool(torch.isfinite(o).all())):
            msg = f"op {name} produced NaN/Inf (FLAGS_check_nan_inf)"
            if get_flag("check_nan_inf_level") == 0:
                raise FloatingPointError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)


def register(name: str, impl: Callable, promote: bool = False,
             amp: str = "promote") -> Callable:
    """Register an op (replacing one of the same name) and return its
    public dispatcher."""
    opdef = OpDef(name, impl, promote=promote, amp=amp)
    OPS[name] = opdef

    @functools.wraps(impl)
    def dispatcher(*args, **kwargs):
        return apply_op(opdef, *args, **kwargs)

    dispatcher.__name__ = name
    dispatcher.op_def = opdef
    return dispatcher


def op(name: Optional[str] = None, promote: bool = False,
       amp: str = "promote"):
    """Decorator form of :func:`register`."""

    def deco(fn):
        return register(name or fn.__name__, fn, promote=promote, amp=amp)

    return deco


def raw(x):
    """The value behind a tensor. The port has no Tensor wrapper, so this
    is ``x`` itself (the JAX package unwraps its Tensor to a jax.Array)."""
    return x


__all__ = ["OPS", "OpDef", "apply_op", "op", "raw", "register"]
