"""linear, embedding, matmul and dropout. Counterpart of
paddle_tpu/nn/functional/common.py and the matmul of ops/linalg.py.

Dropout masks are drawn from ``core.generator.rng_tracker`` on the
input's device (the JAX package's ``_rng_tracker``): the same seed gives
the same masks within the port; the JAX package draws other ones
(threefry).
"""
from __future__ import annotations

import torch

from ...amp.state import autocast
from ...core.generator import rng_tracker


def linear(x, weight, bias=None):
    """Paddle's weight layout: ``weight`` is [in_features, out_features]."""
    x, weight, bias = autocast("linear", "allow", x, weight, bias)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight):
    """Rows of ``weight`` [num_embeddings, dim] at the ids ``x``. Its
    gradient sums the rows of repeated ids in a fixed order on a card
    (torch's sorted embedding backward; ``index_select``'s backward adds
    with atomics in no fixed order), so a training step's gradients are
    the same bytes on every run."""
    (weight,) = autocast("embedding_op", "promote", weight)
    return torch.nn.functional.embedding(x, weight)


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle.matmul: x @ y, either operand transposed over its last two
    dims first."""
    x, y = autocast("matmul", "allow", x, y)
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def keep_mask(shape, keep, device):
    """A boolean mask of ``shape``, each element true with probability
    ``keep`` (a uniform draw below it, as jax.random.bernoulli), from the
    dropout stream on ``device``."""
    g = rng_tracker.generator(device)
    return torch.rand(shape, generator=g, device=device) < keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (with ``axis``, one draw
    for each index along those axes, shared along the others).
    ``upscale_in_train`` scales the kept ones by 1/(1-p) in training;
    ``downscale_in_infer`` scales by (1-p) at inference instead. An amp
    "promote" op (bf16 under O2), as ``dropout_op`` is in the JAX
    package."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training:
        return x if mode == "upscale_in_train" or p == 0.0 else x * (1.0 - p)
    if p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    mask = keep_mask(shape, 1.0 - p, x.device).to(x.dtype)
    x, mask = autocast("dropout_op", "promote", x, mask)
    if mode == "upscale_in_train":
        return x * mask / (1.0 - p)
    return x * mask


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drop whole channels of [N, C, H, W] (or NHWC) input."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Drop whole channels of [N, C, D, H, W] (or NDHWC) input."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take the SELU saturation
    value, then an affine map restores zero mean and unit variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    mask = keep_mask(x.shape, 1.0 - p, x.device).to(x.dtype)
    x, mask = autocast("alpha_dropout_op", "promote", x, mask)
    return a * (x * mask + alpha_p * (1 - mask)) + b


__all__ = ["alpha_dropout", "dropout", "dropout2d", "dropout3d",
           "embedding", "linear", "matmul"]
