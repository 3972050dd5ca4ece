"""Linear, Embedding, Dropout. Counterpart of paddle_tpu/nn/layer/common.py.

Parameters keep Paddle's layout and names: ``Linear.weight`` is
[in_features, out_features], so weights move across from the JAX
package name for name. Every layer takes ``device=`` (default: the
card), ``dtype=`` and the ``generator=`` its initializer draws from.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.dtype import to_torch
from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I


def name_parameters(module: nn.Module) -> None:
    """Give each parameter of ``module`` its structured name (its
    ``state_dict`` key, which the port shares with the JAX package) as
    ``.param_name``: the optimizers key a parameter's state by it, as the
    JAX package's key theirs by ``p.name`` (``torch.Tensor.name`` is a
    read-only attribute of its own)."""
    for name, p in module.named_parameters():
        p.param_name = name


def new_parameter(shape, init, device=None, dtype=None, generator=None):
    """A parameter of ``shape`` on ``device`` filled by ``init``."""
    t = torch.empty(tuple(int(s) for s in shape), device=resolve_device(device),
                    dtype=to_torch(dtype or "float32"))
    init(t, generator=generator)
    return nn.Parameter(t)


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = new_parameter([in_features, out_features],
                                    I.XavierNormal(), device, dtype, generator)
        if bias_attr is not False:
            self.bias = new_parameter([out_features], I.Constant(0.0), device,
                                      dtype, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.weight = new_parameter([num_embeddings, embedding_dim],
                                    I.Normal(0.0, 1.0), device, dtype,
                                    generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class Dropout(nn.Module):
    """``F.dropout`` with the layer's ``p``, ``axis`` and ``mode``, in
    training mode while the module trains."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


__all__ = ["Dropout", "Embedding", "Linear", "name_parameters",
           "new_parameter"]
