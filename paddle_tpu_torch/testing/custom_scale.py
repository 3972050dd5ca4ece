"""The custom-op API's example op with a hand-written kernel: o = x * factor.

Counterpart of the test-side kernel of the JAX package's custom-op tests
(``scale_kernel`` / ``scale_impl``, tests/test_custom_op.py:101-115),
which registers a Pallas kernel through ``ops.register_op`` with the
custom VJP ``g * 2``. Here the kernel is ``csrc/scale.cu`` (K9), and
``scale_vjp`` is the pair to register it with:

    op = paddle_tpu_torch.ops.register_op("custom_scale", scale,
                                          vjp=scale_vjp)
    op(x)                 # 2 * x;  op(x, factor=0.5) for 0.5 * x

Arithmetic, as the Pallas kernel's: ``factor`` rounded to x's dtype, the
product in fp32 (in x's dtype for wider types), one rounding to x's
dtype. PyTorch's ``x * factor`` keeps the factor in fp32 and differs for
bf16 x wherever the factor is not a bf16 value, such as 0.1.

``scale`` sends a CUDA tensor to the kernel (fp32 and bf16; other dtypes
raise) and a CPU tensor to the plain version ``scale_plain``; a tensor
on any other device raises. It is differentiable: the gradient is
``scale(g, factor)``.
"""
from __future__ import annotations

import ctypes

import torch

from ..csrc import DTYPE_CODES, Kernel

# Replaces `scale_kernel` (tests/test_custom_op.py:101) driven by
# `scale_impl` (:104 -> pl.pallas_call :105). Bound: bytes,
# 2 * n * itemsize over the card's memory rate.
SCALE_KERNEL = Kernel(
    "scale.cu", "ptt_scale",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
     ctypes.c_int])


# csrc/scale.cu's geometry (kThreads, kVecsInFlight): a CTA of
# SCALE_THREADS threads takes a chunk of SCALE_VECS_IN_FLIGHT *
# SCALE_THREADS 16-byte vectors, each thread loading its
# SCALE_VECS_IN_FLIGHT vectors before it stores any
SCALE_THREADS = 256
SCALE_VECS_IN_FLIGHT = 2


def scale_split(n, offset_bytes, itemsize):
    """How the kernel splits n elements whose first lies ``offset_bytes``
    past a 16-byte boundary: (scalar head, 16-byte vectors, scalar
    tail)."""
    mis = offset_bytes % 16
    head = min(n, (16 - mis) // itemsize if mis else 0)
    nvec = (n - head) * itemsize // 16
    return head, nvec, n - head - nvec * 16 // itemsize


def scale_plain(x, factor=2.0):
    """Plain version of the kernel: one ``torch.mul`` by the factor
    rounded to x's dtype. PyTorch multiplies a bf16 tensor by a Python
    float in fp32 and rounds once, so this is the kernel's arithmetic."""
    if not x.is_floating_point():
        raise TypeError(f"scale takes a floating tensor, got {x.dtype}")
    SCALE_KERNEL.plain_calls += 1
    return torch.mul(x, float(torch.tensor(factor, dtype=x.dtype)))


def _empty_at_offset_of(x):
    """An uninitialised contiguous tensor like x whose address has x's
    offset modulo 16 bytes, so the kernel's 16-byte vectors line up in
    both."""
    off = x.data_ptr() % 16 // x.element_size()
    if off == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape)


def scale_cuda(x, factor=2.0):
    """Launch K9 on x (fp32 or bf16, on a card; a non-contiguous x is
    made contiguous first). Returns a new contiguous tensor of x's shape
    and dtype; an empty x launches nothing."""
    if x.device.type != "cuda":
        raise ValueError(f"scale_cuda takes a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"scale_cuda takes float32/bfloat16, got {x.dtype}")
    x = x.contiguous()
    out = _empty_at_offset_of(x)
    if x.numel():
        SCALE_KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(),
                            x.numel(), float(factor), DTYPE_CODES[x.dtype])
    return out


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        if x.device.type == "cuda":
            return scale_cuda(x, factor)
        if x.device.type == "cpu":
            return scale_plain(x, factor)
        raise ValueError(f"scale: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g):
        return scale(g, ctx.factor), None


def scale(x, factor=2.0):
    """x * factor through K9 on a card, its plain version on the CPU."""
    return _Scale.apply(x, factor)


def _scale_fwd(x, factor=2.0):
    return scale(x, factor), factor


def _scale_bwd(factor, g):
    return (scale(g, factor),)


# the custom VJP pair for ops.register_op: the residual is the factor
scale_vjp = (_scale_fwd, _scale_bwd)

__all__ = ["SCALE_KERNEL", "SCALE_THREADS", "SCALE_VECS_IN_FLIGHT", "scale",
           "scale_cuda", "scale_plain", "scale_split", "scale_vjp"]
