"""LayerNorm. Counterpart of paddle_tpu/nn/functional/norm.py.

``layer_norm`` sends a CUDA tensor to the hand-written Hopper kernel
(csrc/layer_norm.cu, which replaces the TPU kernel ``_ln_kernel``) and a
CPU tensor to the kernel's plain PyTorch version, ``_ln_ref``. Nothing
else: a tensor on any other device raises, and a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ...csrc import DTYPE_CODES, Kernel

# Replaces `_ln_kernel` (paddle_tpu/nn/functional/norm.py:42) driven by
# `_ln_pallas` (:79). Bound: bytes, rows*d*(in+out itemsize) + param
# bytes over the card's memory rate; the kernel reads each row from
# device memory once (later passes hit L1/L2) and the params once per CTA.
LAYER_NORM_KERNEL = Kernel(
    "layer_norm.cu", "ptt_layer_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int])


def _ln_ref(x, weight, bias, epsilon):
    """Plain version of the kernel over the last axis: fp32 stats AND
    fp32 scale/shift, output in x.dtype (the semantics of the JAX
    package's ``_ln_ref``)."""
    LAYER_NORM_KERNEL.plain_calls += 1
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def layer_norm_cuda(x, weight, bias, epsilon):
    """Launch the LayerNorm kernel on x [rows, d] (contiguous, fp32 or
    bf16, on a card) with optional weight/bias [d] of x's dtype.
    Returns a new [rows, d] tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"layer_norm_cuda takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"layer_norm_cuda takes [rows, d], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_cuda takes a contiguous x")
    d = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if (p.device != x.device or p.dtype != x.dtype
                or tuple(p.shape) != (d,) or not p.is_contiguous()):
            raise ValueError(
                f"layer_norm_cuda: {name} must be a contiguous [{d}] "
                f"{x.dtype} tensor on {x.device}, got {tuple(p.shape)} "
                f"{p.dtype} on {p.device}")
    out = torch.empty_like(x)
    LAYER_NORM_KERNEL.launch(
        x.device, x.data_ptr(),
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), x.shape[0], d, float(epsilon), DTYPE_CODES[x.dtype])
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """paddle.nn.functional.layer_norm over the trailing
    ``normalized_shape`` dims (flattened into one row of d values)."""
    ns = ([normalized_shape] if isinstance(normalized_shape, int)
          else list(normalized_shape))
    d = 1
    for s in ns:
        d *= int(s)
    if list(x.shape[x.dim() - len(ns):]) != ns:
        raise ValueError(f"layer_norm: shape {tuple(x.shape)} does not end "
                         f"in normalized_shape {ns}")
    w = None if weight is None else weight.reshape(d)
    b = None if bias is None else bias.reshape(d)
    x2 = x.reshape(-1, d)
    if x.device.type == "cuda":
        out = layer_norm_cuda(x2.contiguous(), w, b, epsilon)
    elif x.device.type == "cpu":
        out = _ln_ref(x2, w, b, epsilon)
    else:
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    return out.reshape(x.shape)


__all__ = ["LAYER_NORM_KERNEL", "layer_norm", "layer_norm_cuda"]
