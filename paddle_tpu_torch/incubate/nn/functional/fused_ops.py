"""RMSNorm, rotary position embedding, swiglu. Counterpart of
paddle_tpu/incubate/nn/functional/fused_ops.py.

``fused_rms_norm`` sends a CUDA tensor to the hand-written Hopper kernel
(csrc/rms_norm.cu, which replaces the TPU kernel ``_rms_norm_kernel``)
and a CPU tensor to the kernel's plain PyTorch version,
``_rms_norm_ref``. Nothing else: a tensor on any other device raises, and
a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

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


def _rms_norm_ref(x, weight, epsilon):
    """Plain version of the kernel: fp32 stats, the weight multiplied in
    fp32 before the cast to x.dtype (the JAX package's
    ``_rms_norm_ref``)."""
    RMS_NORM_KERNEL.plain_calls += 1
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + epsilon)
    y = y * weight.float()
    return y.to(x.dtype)


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
    """paddle.incubate.nn.functional.fused_rms_norm over the last axis."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x.device.type == "cuda":
        y = rms_norm_cuda(x2.contiguous(), norm_weight, epsilon)
    elif x.device.type == "cpu":
        y = _rms_norm_ref(x2, norm_weight, epsilon)
    else:
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")
    return y.reshape(x.shape)


def _rope_rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos + rot * sin


def fused_rotary_position_embedding(q, k, position_ids,
                                    theta: float = 10000.0):
    """paddle.incubate.nn.functional.fused_rotary_position_embedding,
    neox style, on the per-sequence ``position_ids`` [B, S] path that
    paged serving takes. q/k: [batch, seq, heads, dim]. The cos/sin
    tables are cast to q's dtype before the multiply, as in the JAX
    package. Returns (q', k')."""
    d = q.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=q.device) / d))
    t = position_ids.to(torch.float32)
    freqs = t[..., None] * inv                     # [B, S, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb)[:, :, None, :].to(q.dtype)
    sin = torch.sin(emb)[:, :, None, :].to(q.dtype)
    return _rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin)


def swiglu(x, y):
    """silu(x) * y."""
    return torch.nn.functional.silu(x) * y


__all__ = ["RMS_NORM_KERNEL", "fused_rms_norm",
           "fused_rotary_position_embedding", "rms_norm_cuda", "swiglu"]
