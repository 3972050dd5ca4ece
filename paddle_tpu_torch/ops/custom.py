"""Public custom-op extension API: the PD_BUILD_OP analogue. Counterpart of
paddle_tpu/ops/custom.py.

A custom op is a callable over torch tensors: plain torch code, a
wrapper that launches a hand-written CUDA kernel, or a host C function
loaded by ``utils.cpp_extension``. ``register_op`` attaches it to the
same dispatch pipeline as every built-in op (``ops/registry.py``: amp
cast, type promotion, NaN/Inf check, profiler spans). An optional custom
VJP pair replaces PyTorch's autodiff through the impl.

    def sq(x): return x * x                      # impl
    def sq_fwd(x): return sq(x), x               # (out, residuals)
    def sq_bwd(x, g): return (2 * x * g,)        # one cotangent per input
    my_square = paddle_tpu_torch.ops.register_op(
        "my_square", sq, vjp=(sq_fwd, sq_bwd))

Not ported: ``out_sharding`` (a GSPMD output constraint in the JAX
package) raises until the distributed API is ported (ROADMAP queue A
item 10).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from . import registry


def register_op(name: str, impl: Callable,
                vjp: Optional[Tuple[Callable, Callable]] = None,
                out_sharding: Optional[Callable] = None,
                amp: str = "promote", promote: bool = False) -> Callable:
    """Register a user op; returns its public dispatcher.

    impl: callable over tensors (positional arguments may be nested lists
        and tuples of them); keyword arguments are static attributes.
    vjp: optional (fwd, bwd) pair in the ``jax.custom_vjp`` convention:
        ``fwd(*args, **attrs)`` returns ``(out, residuals)``, residuals any
        pytree of tensors and other values; ``bwd(residuals, g)`` returns
        one cotangent per positional input (None for a non-tensor input),
        with g a tuple when the op has several outputs. While a gradient
        is recorded (grad mode on and an input requiring grad) the op runs
        ``fwd`` as one ``torch.autograd.Function``; otherwise it runs
        ``impl``. Without a pair, PyTorch differentiates impl.
    out_sharding: not ported; raises NotImplementedError.
    amp/promote: the dispatch policies built-in ops declare.
    """
    if name in registry.OPS:
        raise ValueError(f"op {name!r} is already registered")
    if out_sharding is not None:
        raise NotImplementedError(
            "register_op(out_sharding=...) is not ported: it waits for the "
            "distributed API (ROADMAP queue A item 10)")
    fn = impl
    if vjp is not None:
        fwd, bwd = vjp
        # one Function per op, so a grad_fn names its op
        function = type(name, (_CustomVjp,), {})

        def fn(*args, **attrs):
            leaves, spec = pytree.tree_flatten(args)
            if torch.is_grad_enabled() and any(
                    isinstance(leaf, torch.Tensor) and leaf.requires_grad
                    for leaf in leaves):
                return function.apply(name, functools.partial(fwd, **attrs),
                                      bwd, spec, *leaves)
            return impl(*args, **attrs)

        functools.update_wrapper(fn, impl)
    return registry.register(name, fn, promote=promote, amp=amp)


_SAVED = object()   # a residual slot held by save_for_backward


class _CustomVjp(torch.autograd.Function):
    """An op's custom gradient: forward(op name, fwd bound to the op's
    attributes, bwd, the arguments' tree spec, *argument leaves)."""

    @staticmethod
    def forward(ctx, name, fwd, bwd, spec, *leaves):
        args = pytree.tree_unflatten(list(leaves), spec)
        out, residuals = fwd(*args)
        res_leaves, ctx.res_spec = pytree.tree_flatten(residuals)
        ctx.res_kept = [_SAVED if isinstance(r, torch.Tensor) else r
                        for r in res_leaves]
        ctx.save_for_backward(*(r for r in res_leaves
                                if isinstance(r, torch.Tensor)))
        # per positional argument, which of its leaves are tensors
        ctx.arg_tensors = [[isinstance(leaf, torch.Tensor)
                            for leaf in pytree.tree_leaves(a)] for a in args]
        ctx.name, ctx.bwd = name, bwd
        ctx.multi = isinstance(out, (tuple, list))
        return tuple(out) if ctx.multi else out

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        residuals = pytree.tree_unflatten(
            [next(saved) if r is _SAVED else r for r in ctx.res_kept],
            ctx.res_spec)
        cts = ctx.bwd(residuals, grads if ctx.multi else grads[0])
        if len(cts) != len(ctx.arg_tensors):
            raise ValueError(
                f"op {ctx.name!r}: bwd returned {len(cts)} cotangents for "
                f"{len(ctx.arg_tensors)} positional inputs")
        leaf_cts = []
        for ct, is_tensor in zip(cts, ctx.arg_tensors):
            parts = ([None] * len(is_tensor) if ct is None
                     else pytree.tree_leaves(ct))
            if len(parts) != len(is_tensor):
                raise ValueError(
                    f"op {ctx.name!r}: a cotangent's structure does not "
                    f"match its input's")
            leaf_cts += [c if t else None for c, t in zip(parts, is_tensor)]
        return (None, None, None, None, *leaf_cts)


def deregister_op(name: str) -> None:
    """Remove a user-registered op; the name may then be registered
    again (serving the new impl)."""
    registry.OPS.pop(name, None)


__all__ = ["deregister_op", "register_op"]
