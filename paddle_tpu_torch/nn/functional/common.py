"""linear, embedding and matmul. Counterpart of
paddle_tpu/nn/functional/common.py and the matmul of ops/linalg.py."""
from __future__ import annotations

import torch

from ...amp.state import autocast


def linear(x, weight, bias=None):
    """Paddle's weight layout: ``weight`` is [in_features, out_features]."""
    x, weight, bias = autocast("linear", "allow", x, weight, bias)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    """Rows of ``weight`` [num_embeddings, dim] at the ids ``x``."""
    (weight,) = autocast("embedding_op", "promote", weight)
    return weight.index_select(0, x.reshape(-1)).reshape(*x.shape, -1)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle.matmul: x @ y, either operand transposed over its last two
    dims first."""
    x, y = autocast("matmul", "allow", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


__all__ = ["embedding", "linear", "matmul"]
