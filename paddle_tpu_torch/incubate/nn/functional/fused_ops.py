"""RMSNorm, rotary position embedding, swiglu. Counterpart of
paddle_tpu/incubate/nn/functional/fused_ops.py. Rope and swiglu are amp
"allow" ops and RMSNorm an amp "keep" op, as the JAX package registers
them.

``fused_rms_norm`` is a ``torch.autograd.Function`` (the JAX package's
``_rms_norm_fused`` custom VJP). Its forward sends a CUDA tensor to the
hand-written Hopper kernel (csrc/rms_norm.cu, which replaces the TPU
kernel ``_rms_norm_kernel``) and a CPU tensor to the kernel's plain
PyTorch version, ``_rms_norm_ref``. Its backward on either device is the
plain VJP of ``_rms_norm_ref``, as the JAX package's ``_rms_bwd``: the
TPU has no backward kernel. Nothing else: a tensor on any other device
raises, and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ....amp.state import autocast
from ....csrc import DTYPE_CODES, Kernel

# Replaces `_rms_norm_kernel` (paddle_tpu/incubate/nn/functional/
# fused_ops.py:29) driven by `_rms_norm_pallas` (:36). Bound: bytes,
# rows*d*(in+out itemsize) + d*itemsize over the card's memory rate; the
# kernel reads each row from device memory once (the second pass hits
# L1/L2) and the weight once per CTA.
RMS_NORM_KERNEL = Kernel(
    "rms_norm.cu", "ptt_rms_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int64, ctypes.c_float, ctypes.c_int])


def _rms_norm_math(x, weight, epsilon):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + epsilon)
    y = y * weight.float()
    return y.to(x.dtype)


def _rms_norm_ref(x, weight, epsilon):
    """Plain version of the kernel: fp32 stats, the weight multiplied in
    fp32 before the cast to x.dtype (the JAX package's
    ``_rms_norm_ref``)."""
    RMS_NORM_KERNEL.plain_calls += 1
    return _rms_norm_math(x, weight, epsilon)


def _rms_norm_vjp(x, weight, g, epsilon):
    """(dx, dw): the VJP of ``_rms_norm_ref`` at (x, weight) against g, by
    autograd through the same ops (the JAX package's ``_rms_bwd``)."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        wd = weight.detach().requires_grad_()
        y = _rms_norm_math(xd, wd, epsilon)
        return torch.autograd.grad(y, (xd, wd), g)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm over the last axis of x [rows, d]: the kernel forward on a
    card, the plain forward on the CPU; the plain VJP backward on both."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        if x.device.type == "cuda":
            return rms_norm_cuda(x, weight, epsilon)
        if x.device.type == "cpu":
            return _rms_norm_ref(x, weight, epsilon)
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _rms_norm_vjp(x, weight, g, ctx.epsilon)
        return dx, dw, None


def rms_norm_cuda(x, weight, epsilon):
    """Launch the RMSNorm kernel on x [rows, d] (contiguous, fp32 or bf16,
    on a card) with weight [d] of x's dtype. Returns a new [rows, d]
    tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rms_norm_cuda takes float32/bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"rms_norm_cuda takes [rows, d], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("rms_norm_cuda takes a contiguous x")
    d = x.shape[1]
    if (weight.device != x.device or weight.dtype != x.dtype
            or tuple(weight.shape) != (d,) or not weight.is_contiguous()):
        raise ValueError(
            f"rms_norm_cuda: weight must be a contiguous [{d}] {x.dtype} "
            f"tensor on {x.device}, got {tuple(weight.shape)} "
            f"{weight.dtype} on {weight.device}")
    out = torch.empty_like(x)
    RMS_NORM_KERNEL.launch(x.device, x.data_ptr(), weight.data_ptr(),
                           out.data_ptr(), x.shape[0], d, float(epsilon),
                           DTYPE_CODES[x.dtype])
    return out


def fused_rms_norm(x, norm_weight, epsilon=1e-6):
    """paddle.incubate.nn.functional.fused_rms_norm over the last axis.
    Differentiable in x and norm_weight."""
    d = x.shape[-1]
    y = _RMSNorm.apply(x.reshape(-1, d).contiguous(), norm_weight, epsilon)
    return y.reshape(x.shape)


def _rope_rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos + rot * sin


def fused_rotary_position_embedding(q, k, position_ids=None,
                                    theta: float = 10000.0, pos_offset=0):
    """paddle.incubate.nn.functional.fused_rotary_position_embedding,
    neox style, with tables made from ``theta``: per-sequence positions
    ``position_ids`` [B, S] (the paged serving path), else positions
    ``pos_offset + arange(S)`` shared by the batch (the no-cache training
    path). q/k: [batch, seq, heads, dim]; k may hold fewer heads than q.
    An amp "allow" op, as in the JAX package, whose cos/sin tables are
    cast to q's dtype before the multiply. Returns (q', k')."""
    q, k = autocast("fused_rope", "allow", q, k)
    d = q.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=q.device) / d))
    if position_ids is not None:
        t = position_ids.to(torch.float32)         # [B, S]
    else:
        t = (torch.arange(q.shape[1], dtype=torch.float32, device=q.device)
             + pos_offset)[None, :]                # [1, S]
    freqs = t[..., None] * inv                     # [B or 1, S, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb)[:, :, None, :].to(q.dtype)
    sin = torch.sin(emb)[:, :, None, :].to(q.dtype)
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)


def swiglu(x, y):
    """silu(x) * y; an amp "allow" op, as in the JAX package."""
    x, y = autocast("swiglu", "allow", x, y)
    return torch.nn.functional.silu(x) * y


__all__ = ["RMS_NORM_KERNEL", "fused_rms_norm",
           "fused_rotary_position_embedding", "rms_norm_cuda", "swiglu"]
