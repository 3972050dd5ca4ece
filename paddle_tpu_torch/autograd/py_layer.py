"""PyLayer: user-defined autograd functions. Counterpart of
paddle_tpu/autograd/py_layer.py (Paddle's paddle.autograd.PyLayer).

A PyLayer supplies ``forward(ctx, *args)`` and ``backward(ctx, *grads)``
staticmethods; each subclass runs as its own ``torch.autograd.Function``.
``forward`` runs without recording a graph, and ``backward`` returns one
gradient per tensor input, in the JAX package's order: the positional
tensors, then the tensors passed by keyword. Keyword tensors reach the
Function as positional inputs, so autograd gives them their gradients.
"""
from __future__ import annotations

import torch


class PyLayerContext:
    """The ``ctx`` a PyLayer's forward and backward receive, over the
    Function's own context (which keeps the saved tensors)."""

    def __init__(self, fn_ctx):
        self._fn_ctx = fn_ctx
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        """Method form, as the reference API has it
        (``ctx.saved_tensor()``)."""
        return self._fn_ctx.saved_tensors

    @property
    def saved_tensors(self):
        return self._fn_ctx.saved_tensors

    def mark_not_inplace(self, *args):
        self.not_inplace_tensors = args


class _LayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(fn_ctx, layer, static, kw_names, *inputs):
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.layer_ctx, fn_ctx.layer = ctx, layer
        fn_ctx.tensor_args = [isinstance(a, torch.Tensor) for a in inputs]
        n_pos = len(inputs) - len(kw_names)
        kwargs = dict(static, **dict(zip(kw_names, inputs[n_pos:])))
        out = layer.forward(ctx, *inputs[:n_pos], **kwargs)
        return tuple(out) if isinstance(out, list) else out

    @staticmethod
    def backward(fn_ctx, *grads):
        gin = fn_ctx.layer.backward(fn_ctx.layer_ctx, *grads)
        gin = list(gin) if isinstance(gin, (tuple, list)) else [gin]
        n_tensors = sum(fn_ctx.tensor_args)
        if len(gin) != n_tensors:
            raise ValueError(
                f"{fn_ctx.layer.__name__}.backward returned {len(gin)} "
                f"gradients for {n_tensors} tensor inputs")
        it = iter(gin)
        return (None, None, None, *(next(it) if t else None
                                    for t in fn_ctx.tensor_args))


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # its own Function class, so grad_fn names the layer
        cls._function = type(cls.__name__, (_LayerFunction,), {})

    @classmethod
    def apply(cls, *args, **kwargs):
        kw_names = tuple(k for k, v in kwargs.items()
                         if isinstance(v, torch.Tensor))
        static = {k: v for k, v in kwargs.items() if k not in kw_names}
        return cls._function.apply(cls, static, kw_names, *args,
                                   *(kwargs[k] for k in kw_names))


def once_differentiable(fn):
    """Identity, as in the JAX package."""
    return fn


__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]
