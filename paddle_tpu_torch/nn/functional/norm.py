"""LayerNorm, forward and backward. Counterpart of
paddle_tpu/nn/functional/norm.py.

``layer_norm`` is a ``torch.autograd.Function`` (the JAX package's
``_ln_fused`` custom VJP). On a CUDA tensor its forward is the
hand-written Hopper kernel csrc/layer_norm.cu (replaces the TPU kernel
``_ln_kernel``) and its backward csrc/layer_norm_bwd.cu (replaces
``_ln_bwd_kernel``); on a CPU tensor they are the kernels' plain PyTorch
versions, ``_ln_ref`` and ``_ln_bwd_ref``. Nothing else: a tensor on any
other device raises, and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...amp.state import autocast
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


# Replaces `_ln_bwd_kernel` (paddle_tpu/nn/functional/norm.py:106) driven
# by `_ln_bwd_pallas` (:141). Bound: bytes, 3*rows*d*itemsize (x, g read,
# dx written) + param bytes over the card's memory rate. Each call (one
# counted launch) runs two kernels: fp32 dw/db partials of n_parts
# balanced runs of rows, then their fixed-order reduction
# (testing/ln_bwd_tiled.py mirrors both on the CPU).
LAYER_NORM_BWD_KERNEL = Kernel(
    "layer_norm_bwd.cu", "ptt_layer_norm_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_float, ctypes.c_int])
# CTAs of the backward's first pass per SM: enough that one CTA's row
# reductions overlap another's loads, few enough that the partials (n_parts
# = this many per SM) stay small; 2 was the fastest of 1, 2, 3, 4, 6 and
# 8 at GPT-3 1.3B's [8192, 2048] bf16 with the kernel's 4 stages and 2
# vectors a thread (tools/norm_scale_ab.py)
LN_BWD_CTAS_PER_SM = 2
LN_BWD_MAX_D = 28672


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ln_bwd_ref(x, weight, g, epsilon):
    """Plain version of the backward kernel over the last axis of x, g
    [rows, d]: stats recomputed in fp32, ``dx = inv*(a - mean(a) -
    x^*mean(a*x^))`` with ``a = g*w`` (``w = 1`` when weight is None),
    ``dw = sum g*x^``, ``db = sum g`` in fp32. Returns (dx in x.dtype, dw,
    db in the weight's dtype) (the JAX package's ``_ln_bwd_kernel``)."""
    LAYER_NORM_BWD_KERNEL.plain_calls += 1
    xf = x.float()
    gf = g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = xc.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + epsilon)
    xhat = xc * inv
    a = gf if weight is None else gf * weight.float()
    m1 = a.mean(dim=-1, keepdim=True)
    m2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (a - m1 - xhat * m2)).to(x.dtype)
    pdt = x.dtype if weight is None else weight.dtype
    return dx, (gf * xhat).sum(dim=0).to(pdt), gf.sum(dim=0).to(pdt)


def _check_rows(name, x, weight, bias=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} takes [rows, d], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous x")
    d = x.shape[1]
    for pname, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if (p.device != x.device or p.dtype != x.dtype
                or tuple(p.shape) != (d,) or not p.is_contiguous()):
            raise ValueError(
                f"{name}: {pname} must be a contiguous [{d}] "
                f"{x.dtype} tensor on {x.device}, got {tuple(p.shape)} "
                f"{p.dtype} on {p.device}")


def layer_norm_bwd_cuda(x, weight, g, epsilon):
    """Launch the LayerNorm backward kernel on x, g [rows, d] (contiguous,
    fp32 or bf16, on a card, d <= 28672) with an optional weight [d] of
    x's dtype. Returns new (dx [rows, d], dw [d], db [d])."""
    _check_rows("layer_norm_bwd_cuda", x, weight)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError("layer_norm_bwd_cuda: g must be a contiguous "
                         "tensor of x's shape, dtype and device")
    rows, d = x.shape
    if d > LN_BWD_MAX_D:
        raise ValueError(f"layer_norm_bwd_cuda takes d <= {LN_BWD_MAX_D}, "
                         f"got {d}")
    n_parts = min(rows, LN_BWD_CTAS_PER_SM * _sm_count(x.device))
    dx = torch.empty_like(x)
    part = torch.empty(n_parts, 2, d, dtype=torch.float32, device=x.device)
    dw = torch.empty(d, dtype=x.dtype, device=x.device)
    db = torch.empty_like(dw)
    LAYER_NORM_BWD_KERNEL.launch(
        x.device, x.data_ptr(),
        None if weight is None else weight.data_ptr(), g.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(), rows,
        d, n_parts, float(epsilon), DTYPE_CODES[x.dtype])
    return dx, dw, db


def layer_norm_cuda(x, weight, bias, epsilon):
    """Launch the LayerNorm kernel on x [rows, d] (contiguous, fp32 or
    bf16, on a card) with optional weight/bias [d] of x's dtype.
    Returns a new [rows, d] tensor."""
    _check_rows("layer_norm_cuda", x, weight, bias)
    d = x.shape[1]
    out = torch.empty_like(x)
    LAYER_NORM_KERNEL.launch(
        x.device, x.data_ptr(),
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), x.shape[0], d, float(epsilon), DTYPE_CODES[x.dtype])
    return out


class _LayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis of x [rows, d]: the kernels on a card,
    their plain versions on the CPU, in both directions."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        ctx.has_bias = bias is not None
        if x.device.type == "cuda":
            return layer_norm_cuda(x, weight, bias, epsilon)
        if x.device.type == "cpu":
            return _ln_ref(x, weight, bias, epsilon)
        raise ValueError(f"layer_norm: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        if x.device.type == "cuda":
            dx, dw, db = layer_norm_bwd_cuda(x, weight, g, ctx.epsilon)
        else:
            dx, dw, db = _ln_bwd_ref(x, weight, g, ctx.epsilon)
        return (dx, None if weight is None else dw,
                db if ctx.has_bias else None, None)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """paddle.nn.functional.layer_norm over the trailing
    ``normalized_shape`` dims (flattened into one row of d values).
    Differentiable in x, weight and bias."""
    ns = ([normalized_shape] if isinstance(normalized_shape, int)
          else list(normalized_shape))
    d = 1
    for s in ns:
        d *= int(s)
    if list(x.shape[x.dim() - len(ns):]) != ns:
        raise ValueError(f"layer_norm: shape {tuple(x.shape)} does not end "
                         f"in normalized_shape {ns}")
    x, weight, bias = autocast("layer_norm", "promote", x, weight, bias)
    w = None if weight is None else weight.reshape(d)
    b = None if bias is None else bias.reshape(d)
    out = _LayerNorm.apply(x.reshape(-1, d).contiguous(), w, b, epsilon)
    return out.reshape(x.shape)


__all__ = ["LAYER_NORM_BWD_KERNEL", "LAYER_NORM_KERNEL", "layer_norm",
           "layer_norm_bwd_cuda", "layer_norm_cuda"]
