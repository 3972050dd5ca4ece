"""LayerNorm layer. Counterpart of paddle_tpu/nn/layer/norm.py."""
from __future__ import annotations

from torch import nn

from .. import functional as F
from .. import initializer as I
from .common import new_parameter


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = new_parameter(self._normalized_shape, I.Constant(1.0),
                                    device, dtype, generator)
        self.bias = new_parameter(self._normalized_shape, I.Constant(0.0),
                                  device, dtype, generator)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


__all__ = ["LayerNorm"]
