"""linear and embedding. Counterpart of paddle_tpu/nn/functional/common.py."""
from __future__ import annotations

import torch


def linear(x, weight, bias=None):
    """Paddle's weight layout: ``weight`` is [in_features, out_features]."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    """Rows of ``weight`` [num_embeddings, dim] at the ids ``x``."""
    return weight.index_select(0, x.reshape(-1)).reshape(*x.shape, -1)


__all__ = ["embedding", "linear"]
