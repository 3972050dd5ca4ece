"""Flash attention in the projection's native [B,S,E] layout, and the
dense grouped-query helpers. Counterpart of
paddle_tpu/incubate/nn/functional/flash_attention.py.

``flash_attention_packed`` (self-attention over a fused projection's
packed [B,S,3E] output), ``flash_attention_fused`` (the [B,S,H,D] entry
sdpa takes) and ``_flash_nl`` / ``_flash_nl_packed`` run through
``torch.autograd.Function``s (the JAX package's custom VJPs). On a CUDA
tensor the forward is the hand-written Hopper kernel ``ptt_flash_fwd``
and the backward ``ptt_flash_bwd`` (csrc/flash_fwd.cu and
csrc/flash_bwd.cu, replacing the TPU kernels ``_fwd_nl_single`` /
``_fwd_nl_stream`` and ``_bwd_nl_fused``); q, k and v are read in place
from the packed array by column offset and the backward writes d(qkv)
straight into one [B,S,3E] buffer. Grouped query (k, v [B,Sk,KVH*D] with
KVH dividing H) is native: q head h reads kv head h // (H/KVH) in place,
and dk, dv come out at the kv width; K and V are never repeated. On a
CPU tensor the same Functions run the kernels' plain versions
``_nl_forward_ref`` / ``_nl_backward_ref``. Nothing else: a tensor on
any other device raises, and a failed build or launch raises.

Not ported here (raise NotImplementedError): the head-major route
(``FLAGS_flash_native_layout=0``; K6-K8) with the GQA "ramp" into it, the
dense ``_reference_attention`` fallback of ``flash_attention_fused`` for
head dims other than 32, 64 and 128, and on the card any such head dim.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ....amp.state import autocast
from ....core.flags import get_flag
from ....csrc import DTYPE_CODES, Kernel

# Replaces `_fwd_nl_single` / `_fwd_nl_stream` (paddle_tpu/incubate/nn/
# functional/flash_attention.py:769,805) driven by `_nl_forward` (:944).
# Bound: operations, causal 2*B*H*Sq*Sk*D (half of 4*B*H*Sq*Sk*D) over the
# card's bf16 tensor-core rate.
FLASH_FWD_KERNEL = Kernel(
    "flash_fwd.cu", "ptt_flash_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 8)
# Replaces `_bwd_nl_fused` (flash_attention.py:873) driven by
# `_nl_backward` (:1021), and the grouped dk/dv fold of `_flash_nl_bwd`
# (:1115). Bound: operations, five products to the forward's two. One
# launch per call runs the delta, dk/dv and dq kernels (deterministic:
# no atomics).
FLASH_BWD_KERNEL = Kernel(
    "flash_bwd.cu", "ptt_flash_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 7
    + [ctypes.c_int64] * 2 + [ctypes.c_int] * 8)
HEAD_DIMS = (32, 64, 128)


def grouped_qk_logits(qh, kh):
    """[B,H,Sq,D] q against [B,KVH,Sk,D] k -> [B,H,Sq,Sk] logits. KVH < H
    (grouped query) contracts q grouped against the shared kv heads; the
    kv heads are never repeated."""
    b, h, sq, d = qh.shape
    kvh, sk = kh.shape[1], kh.shape[2]
    if kvh == h:
        return torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    q5 = qh.reshape(b, kvh, h // kvh, sq, d)
    return torch.einsum("bgrqd,bgkd->bgrqk", q5, kh).reshape(b, h, sq, sk)


def grouped_pv_out(probs, vh):
    """[B,H,Sq,Sk] probs against [B,KVH,Sk,D] v -> [B,H,Sq,D]."""
    b, h, sq, sk = probs.shape
    kvh, d = vh.shape[1], vh.shape[-1]
    if kvh == h:
        return torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    p5 = probs.reshape(b, kvh, h // kvh, sq, sk)
    return torch.einsum("bgrqk,bgkd->bgrqd", p5, vh).reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, for CPU tensors)
# ---------------------------------------------------------------------------

def _heads(x, heads):
    """[B,S,H*D] (any strides) -> fp32 [B,H,S,D]."""
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads).transpose(1, 2).float()


def _kv_heads(q, k, heads):
    """KVH of k [B,Sk,KVH*D] against q [B,Sq,H*D] over ``heads``."""
    return k.shape[-1] // (q.shape[-1] // heads)


def _masked_logits(qh, kh, causal):
    """fp32 logits * 1/sqrt(D) of q [B,H,Sq,D] against k [B,KVH,Sk,D]
    (grouped: KVH divides H), -inf where the bottom-right causal mask
    (q_pos + Sk - Sq >= k_pos) hides a key."""
    d = qh.shape[-1]
    logits = grouped_qk_logits(qh, kh) * (1.0 / math.sqrt(d))
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=logits.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    return logits


def _grouped_tn(a, x, kvh):
    """a [B,H,Sq,Sk] against x [B,H,Sq,D] -> [B,KVH,Sk,D]: a^T x summed
    over the q heads of each kv head (dk and dv of grouped query; per head
    when KVH == H)."""
    b, h, sq, sk = a.shape
    if kvh == h:
        return torch.matmul(a.transpose(-1, -2), x)
    rep = h // kvh
    return torch.einsum("bgrqk,bgrqd->bgkd", a.reshape(b, kvh, rep, sq, sk),
                        x.reshape(b, kvh, rep, sq, x.shape[-1]))


def _delta(out, dout, heads):
    """delta = rowsum(dO * O) per head, fp32 [B,H,Sq] (computed outside
    the backward products, as the JAX package's ``_nl_backward`` does)."""
    b, s, e = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, s, heads, e // heads).sum(-1).transpose(
        1, 2).contiguous()


def _nl_forward_ref(q, k, v, heads, causal):
    """Plain forward: q [B,Sq,H*D], k, v [B,Sk,KVH*D] -> (out [B,Sq,H*D]
    in q's dtype, lse fp32 [B,H,Sq]). fp32 logits and softmax statistics,
    p cast to the input dtype before the P.V product, out = acc /
    max(l, 1e-30), lse = m_safe + log(max(l, 1e-30))."""
    FLASH_FWD_KERNEL.plain_calls += 1
    b, sq, e = q.shape
    kvh = _kv_heads(q, k, heads)
    logits = _masked_logits(_heads(q, heads), _heads(k, kvh), causal)
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = grouped_pv_out(p.to(q.dtype).float(), _heads(v, kvh))
    out = (acc / l).to(q.dtype).transpose(1, 2).reshape(b, sq, e)
    return out, (m_safe + torch.log(l)).squeeze(-1)


def _nl_backward_ref(q, k, v, out, lse, dout, heads, causal):
    """Plain one-pass backward -> (dq [B,Sq,H*D], dk, dv [B,Sk,KVH*D]) in
    dout's dtype: p = exp(logits - lse), dv = p^T dO, dp = dO v^T,
    ds = p (dp - delta) cast to the input dtype, dk = ds^T q * scale,
    dq = ds k * scale, every product accumulated in fp32; a kv head's
    dk and dv sum over its q heads."""
    FLASH_BWD_KERNEL.plain_calls += 1
    b, sq, e = q.shape
    sk = k.shape[1]
    kvh = _kv_heads(q, k, heads)
    scale = 1.0 / math.sqrt(e // heads)
    dt = dout.dtype
    qh, doh = _heads(q, heads), _heads(dout, heads)
    kh, vh = _heads(k, kvh), _heads(v, kvh)
    p = torch.exp(_masked_logits(qh, kh, causal) - lse.unsqueeze(-1))
    dv = _grouped_tn(p.to(dt).float(), doh, kvh)
    dp = grouped_qk_logits(doh, vh)
    ds = (p * (dp - _delta(out, dout, heads).unsqueeze(-1))).to(dt).float()
    dk = _grouped_tn(ds, qh, kvh) * scale
    dq = grouped_pv_out(ds, kh) * scale

    def back(x, s):
        return x.to(dt).transpose(1, 2).reshape(b, s, -1)
    return back(dq, sq), back(dk, sk), back(dv, sk)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_operand(name, x, dtype, device, e):
    """x: a [B,S,e] view whose rows are 16-byte aligned and whose last dim
    is contiguous (a column slice of a packed array qualifies)."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"flash attention: {name} must be {dtype} on "
                         f"{device}, got {x.dtype} on {x.device}")
    if x.dim() != 3 or x.shape[2] != e:
        raise ValueError(f"flash attention: {name} must be [B,S,{e}], got "
                         f"{tuple(x.shape)}")
    item = x.element_size()
    if (x.stride(2) != 1 or x.stride(0) != x.shape[1] * x.stride(1)
            or (x.stride(1) * item) % 16 or x.data_ptr() % 16):
        raise ValueError(
            f"flash attention: {name} must have contiguous, 16-byte aligned "
            f"rows of one stride, got strides {x.stride()}")


def _check_kernel_args(q, k, v, heads):
    """-> (B, Sq, Sk, D, KVH) of q [B,Sq,H*D] and k, v [B,Sk,KVH*D]."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernels take CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32/bfloat16, "
                        f"got {q.dtype}")
    b, sq, e = q.shape
    if heads < 1 or e % heads or (e // heads) not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head dims "
                         f"{HEAD_DIMS}, got E={e} over {heads} heads")
    d = e // heads
    _check_heads(e, heads, k.shape[-1])
    _check_operand("q", q, q.dtype, q.device, e)
    for name, x in (("k", k), ("v", v)):
        _check_operand(name, x, q.dtype, q.device, k.shape[-1])
    if k.shape != v.shape or k.shape[0] != b or k.stride() != v.stride():
        raise ValueError("flash attention: k and v must share shape and "
                         "strides")
    return b, sq, k.shape[1], d, k.shape[-1] // d


def flash_fwd_cuda(q, k, v, heads, causal):
    """Launch the forward kernel. q [B,Sq,H*D], k, v [B,Sk,KVH*D] (KVH
    dividing H) on a card: views with contiguous 16-byte aligned rows,
    e.g. column slices of a packed [B,S,3E]; D in HEAD_DIMS. Returns new
    (out [B,Sq,H*D], lse fp32 [B,H,Sq])."""
    b, sq, sk, d, kvh = _check_kernel_args(q, k, v, heads)
    out = torch.empty(b, sq, heads * d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, heads, sq, dtype=torch.float32, device=q.device)
    FLASH_FWD_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1),
        k.stride(1), out.data_ptr(), lse.data_ptr(), b, sq, sk, heads, kvh,
        d, int(bool(causal)), DTYPE_CODES[q.dtype])
    return out, lse


def flash_bwd_cuda(q, k, v, out, lse, dout, heads, causal, dq, dk, dv):
    """Launch the backward kernels: writes dq [B,Sq,H*D] and dk, dv
    [B,Sk,KVH*D] (views with contiguous 16-byte aligned rows, dk and dv
    sharing strides, e.g. column slices of a packed [B,S,3E] gradient).
    q, k, v as :func:`flash_fwd_cuda`; out, dout [B,Sq,H*D] contiguous;
    lse fp32 [B,H,Sq] from the forward. Its only scratch is delta, fp32
    [B,H,Sq]."""
    b, sq, sk, d, kvh = _check_kernel_args(q, k, v, heads)
    e = heads * d
    for name, x in (("out", out), ("dout", dout)):
        if (x.shape != (b, sq, e) or x.dtype != q.dtype
                or x.device != q.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"flash attention: {name} must be a "
                             f"contiguous, 16-byte aligned [{b},{sq},{e}] "
                             f"{q.dtype} tensor")
    if (lse.shape != (b, heads, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash attention: lse must be fp32 [B,H,Sq]")
    _check_operand("dq", dq, q.dtype, q.device, e)
    for name, x in (("dk", dk), ("dv", dv)):
        _check_operand(name, x, q.dtype, q.device, kvh * d)
    if dk.stride() != dv.stride():
        raise ValueError("flash attention: dk and dv must share strides")
    if dq.shape[:2] != (b, sq) or dk.shape[:2] != (b, sk) \
            or dv.shape[:2] != (b, sk):
        raise ValueError("flash attention: gradient shapes do not match")
    delta = torch.empty(b, heads, sq, dtype=torch.float32, device=q.device)
    FLASH_BWD_KERNEL.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1),
        k.stride(1), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dq.stride(1), dk.stride(1), b, sq, sk, heads, kvh, d,
        int(bool(causal)), DTYPE_CODES[q.dtype])


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------

def _nl_forward(q, k, v, heads, causal):
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, heads, causal)
    if q.device.type == "cpu":
        return _nl_forward_ref(q, k, v, heads, causal)
    raise ValueError(f"flash attention: unsupported device {q.device}")


def _nl_backward(q, k, v, out, lse, dout, heads, causal, dq, dk, dv):
    """Fill dq, dk, dv (views, see :func:`flash_bwd_cuda`)."""
    if q.device.type == "cuda":
        flash_bwd_cuda(q, k, v, out, lse, dout, heads, causal, dq, dk, dv)
        return
    for dst, src in zip((dq, dk, dv), _nl_backward_ref(
            q, k, v, out, lse, dout, heads, causal)):
        dst.copy_(src)


def _gqa_broadcastable(h: int, kvh: int) -> bool:
    """Grouped-query shapes whose kv heads the kernels share in place."""
    return kvh > 0 and h % kvh == 0


def _gqa_route(h: int, kvh: int, d: int) -> str:
    """Shape-only route of [B,S,H,D] attention over KVH kv heads, the one
    authority of flash_attention_fused and sdpa's eligibility check (the
    JAX package's ``_gqa_route``, here deciding MHA too): "native" (the
    native-layout kernels, shared kv heads addressed in place) for every
    broadcastable ratio, MQA included, at a head dim in HEAD_DIMS (no TPU
    lane gate carries over); "ramp" (the head-major kernels behind
    FLAGS_flash_native_layout=0); else "reference" (the dense path)."""
    if not _gqa_broadcastable(h, kvh) or d not in HEAD_DIMS:
        return "reference"
    return "native" if get_flag("flash_native_layout") else "ramp"


def _check_heads(e, heads, kv_e=None):
    if heads < 1 or e % heads:
        raise ValueError(f"flash attention: E={e} is not a multiple of "
                         f"{heads} heads")
    d = e // heads
    if kv_e is not None and (kv_e % d or not _gqa_broadcastable(
            heads, kv_e // d)):
        raise ValueError(f"flash attention: a kv width of {kv_e} is not "
                         f"KVH*{d} with KVH dividing {heads} heads")


class _FlashNL(torch.autograd.Function):
    """Native-layout flash attention: qe [B,Sq,H*D], ke, ve [B,Sk,KVH*D]
    in, [B,Sq,H*D] out; the gradients of ke, ve come out at KVH*D."""

    @staticmethod
    def forward(ctx, qe, ke, ve, causal, heads):
        _check_heads(qe.shape[-1], heads, ke.shape[-1])
        out, lse = _nl_forward(qe, ke, ve, heads, causal)
        ctx.save_for_backward(qe, ke, ve, out, lse)
        ctx.causal, ctx.heads = causal, heads
        return out

    @staticmethod
    def backward(ctx, g):
        qe, ke, ve, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty(x.shape, dtype=g.dtype, device=g.device)
                      for x in (qe, ke, ve))
        _nl_backward(qe, ke, ve, out, lse, g.contiguous(), ctx.heads,
                     ctx.causal, dq, dk, dv)
        return dq, dk, dv, None, None


def _packed_views(qkv):
    e = qkv.shape[-1] // 3
    return qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]


class _FlashNLPacked(torch.autograd.Function):
    """Packed self-attention: qkv [B,S,3E] (columns q|k|v) in, [B,S,E]
    out; q, k, v are read in place and d(qkv) is written into one
    [B,S,3E] buffer."""

    @staticmethod
    def forward(ctx, qkv, causal, heads):
        if qkv.shape[-1] % 3:
            raise ValueError(f"flash_attention_packed: last dim "
                             f"{qkv.shape[-1]} is not 3E")
        _check_heads(qkv.shape[-1] // 3, heads)
        out, lse = _nl_forward(*_packed_views(qkv), heads, causal)
        ctx.save_for_backward(qkv, out, lse)
        ctx.causal, ctx.heads = causal, heads
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty(qkv.shape, dtype=g.dtype, device=g.device)
        _nl_backward(*_packed_views(qkv), out, lse, g.contiguous(),
                     ctx.heads, ctx.causal, *_packed_views(dqkv))
        return dqkv, None, None


def _flash_nl(qe, ke, ve, causal, h):
    """[B,Sq,H*D] q against [B,Sk,KVH*D] k, v over h heads -> [B,Sq,H*D]."""
    return _FlashNL.apply(qe, ke, ve, causal, h)


def _flash_nl_packed(qkv, causal, h):
    """[B,S,3E] packed qkv over h heads -> [B,S,E]."""
    return _FlashNLPacked.apply(qkv, causal, h)


def flash_attention_fused(query, key, value, causal=False):
    """[B,Sq,H,D] query against [B,Sk,KVH,D] key, value (KVH dividing H)
    -> [B,Sq,H,D] through the native-layout kernels: a free reshape on
    each side, no transpose and no repeat of key or value. The op sdpa
    routes to, an amp "allow" op as in the JAX package; differentiable
    in all three. The routes ``_gqa_route`` names "ramp" and "reference"
    are not ported and raise."""
    query, key, value = autocast("flash_attention", "allow", query, key,
                                 value)
    b, sq, h, d = query.shape
    sk, kvh = key.shape[1], key.shape[2]
    route = _gqa_route(h, kvh, d)
    if route == "ramp":
        raise NotImplementedError(
            "flash attention: the head-major route "
            "(FLAGS_flash_native_layout=0) is not ported")
    if route == "reference":
        raise NotImplementedError(
            f"flash attention: the dense fallback (head dim {d} outside "
            f"{HEAD_DIMS}, or {kvh} kv heads against {h} heads) is not "
            f"ported")
    out = _flash_nl(query.reshape(b, sq, h * d), key.reshape(b, sk, kvh * d),
                    value.reshape(b, sk, kvh * d), causal, h)
    return out.reshape(b, sq, h, d)


def flash_attention_packed(qkv, num_heads, causal=False):
    """Self-attention over the fused projection's packed [B,S,3E] output
    (columns q|k|v, the reshape([b,s,3,h,d]) order) through the
    native-layout kernels. Parity: the qkv-packed form of the reference's
    flash_attn_qkvpacked. Differentiable in qkv."""
    if not get_flag("flash_native_layout"):
        raise NotImplementedError(
            "flash_attention_packed: the head-major route "
            "(FLAGS_flash_native_layout=0) is not ported")
    (qkv,) = autocast("flash_attention_packed", "allow", qkv)
    return _flash_nl_packed(qkv, causal, num_heads)


__all__ = ["FLASH_BWD_KERNEL", "FLASH_FWD_KERNEL", "HEAD_DIMS",
           "flash_attention_fused", "flash_attention_packed",
           "flash_bwd_cuda", "flash_fwd_cuda", "grouped_pv_out",
           "grouped_qk_logits"]
