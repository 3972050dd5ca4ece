"""Flash attention: the native [B,S,E] layout, the head-major [B*H,S,D]
route, the whole-block fused attention op, and the dense grouped-query
helpers. Counterpart of paddle_tpu/incubate/nn/functional/flash_attention.py.

Native layout (the default): ``flash_attention_packed`` (self-attention
over a fused projection's packed [B,S,3E] output), ``flash_attention_fused``
(the [B,S,H,D] entry sdpa takes) and ``_flash_nl`` / ``_flash_nl_packed``
run through ``torch.autograd.Function``s (the JAX package's custom VJPs).
On a CUDA tensor the forward is K4 and the backward K5, replacing the TPU
kernels ``_fwd_nl_single`` / ``_fwd_nl_stream`` and ``_bwd_nl_fused``;
q, k and v are read in place from the packed array by column offset and
the backward writes d(qkv) straight into one [B,S,3E] buffer. Grouped
query (k, v [B,Sk,KVH*D] with KVH dividing H) is native: q head h reads kv
head h // (H/KVH) in place, and dk, dv come out at the kv width, summed
over the group by one writer; K and V are never repeated on this route.

Head-major (``FLAGS_flash_native_layout=0``, and always inside
``fused_self_attention``, the op behind ``FLAGS_use_fused_attention``):
``_flash_hm`` takes [G,S,D] operands (G = B*H) and saves its residuals in
that layout. Its forward is K6 (replacing ``_fwd_kernel_single`` /
``_fwd_kernel``). Its backward, as the JAX package's
``_flash_backward_pallas`` picks it: while the one-pass backward's
whole-sequence fp32 dq scratch (Sq*D*4 bytes) fits ``_DQ_SCRATCH_BYTES``
(4 MiB: S <= 8192 at D=128), K7 (replacing the one-pass
``_bwd_fused_kernel``); above it the two-kernel K8 (replacing
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``). On flag 0 the [B,S,H,D]
entries transpose to head-major around it, and grouped k, v are repeated
to the q heads first (the JAX package's "ramp"), only on this route. The
native route has no such budget: K5 keeps no whole-sequence scratch, so
it runs at any S.

Which entry runs which kernel (csrc/):

=====  ========================================  ===========================
       bf16 (``wgmma``)                          fp32 (exact fp32 FMAs)
=====  ========================================  ===========================
K4     ``ptt_flash_fwd``, flash_fwd_sm90.cu      ``ptt_flash_fwd_fp32``,
                                                 flash_fwd.cu
K6     ``ptt_flash_fwd_hm``, flash_fwd_sm90.cu   ``ptt_flash_fwd_hm_fp32``,
                                                 flash_fwd.cu
K5     ``ptt_flash_bwd``, flash_bwd_sm90.cu      ``ptt_flash_bwd_fp32``,
       (delta, kv kernel without dq, dq kernel)  flash_bwd.cu
K7     ``ptt_flash_bwd_hm``, flash_bwd_sm90.cu   ``ptt_flash_bwd_hm_fp32``,
       (kv kernel with the ordered dq add)       flash_bwd_hm.cu
K8     ``ptt_flash_bwd_hm_split``,               ``ptt_flash_bwd_hm_split_fp32``,
       flash_bwd_sm90.cu                         flash_bwd.cu
=====  ========================================  ===========================

Each entry has its own ``Kernel`` object and counts (``FLASH_*_KERNEL``,
the fp32 ones ``FLASH_*_FP32_KERNEL``): ``wgmma`` has no fp32 product, so
only fp32 calls (the card-vs-CPU checks) reach the earlier kernels.

On a CPU tensor the same Functions run the kernels' plain versions
(``_nl_forward_ref`` / ``_nl_backward_ref``, ``_hm_forward_ref`` /
``_hm_backward_ref`` / ``_hm_backward_split_ref``). Nothing else: a
tensor on any other device raises, and a failed build or launch raises.
The bf16 kernels' tile orders are mirrored for the CPU tests in
``paddle_tpu_torch/testing/flash_tiled.py`` (schedules: ``fwd_schedule``,
``k5_kv_schedule``, ``hm_bwd_schedule``).

Shapes no kernel takes (a head dim outside 32, 64 and 128, or kv heads
that do not divide the q heads) run the dense fallbacks
``_reference_attention`` ([B,S,H,D]) and ``_attend_hm_reference``
([G,S,D]) in torch math with autograd, as the JAX package leaves them to
XLA: fp32 logits, softmax and P.V, the output in the input dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ....amp.state import autocast
from ....core.flags import get_flag
from ....csrc import DTYPE_CODES, Kernel

# Replaces `_fwd_nl_single` / `_fwd_nl_stream` (paddle_tpu/incubate/nn/
# functional/flash_attention.py:769,805) driven by `_nl_forward` (:944),
# bf16: the warpgroup kernel of csrc/flash_fwd_sm90.cu (a CTA of two
# ping-ponged warpgroups per (q tile of 128, head, batch)). Bound:
# operations, causal 2*B*H*Sq*Sk*D (half of 4*B*H*Sq*Sk*D) over the card's
# bf16 tensor-core rate.
FLASH_FWD_KERNEL = Kernel(
    "flash_fwd_sm90.cu", "ptt_flash_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 8)
# K4's fp32 calls (exact fp32 FMAs in place of `wgmma`, which has no fp32
# product): the earlier kernel of csrc/flash_fwd.cu.
FLASH_FWD_FP32_KERNEL = Kernel(
    "flash_fwd.cu", "ptt_flash_fwd_fp32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 7)
# Replaces `_bwd_nl_fused` (flash_attention.py:873) driven by
# `_nl_backward` (:1021), and the grouped dk/dv fold of `_flash_nl_bwd`
# (:1115), bf16: csrc/flash_bwd_sm90.cu's kv kernel (a CTA per (kv tile of
# 128, kv head, batch) summing dk/dv over the group's q heads) and dq
# kernel at native strides. Bound: operations, five products to the
# forward's two. One launch per call runs the delta, kv and dq kernels
# (each output has one writer: deterministic).
FLASH_BWD_KERNEL = Kernel(
    "flash_bwd_sm90.cu", "ptt_flash_bwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 7
    + [ctypes.c_int64] * 2 + [ctypes.c_int] * 8)
# K5's fp32 calls: the earlier delta, dk/dv and dq kernels of
# csrc/flash_bwd.cu.
FLASH_BWD_FP32_KERNEL = Kernel(
    "flash_bwd.cu", "ptt_flash_bwd_fp32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 7
    + [ctypes.c_int64] * 2 + [ctypes.c_int] * 7)
# Replaces `_fwd_kernel_single` / `_fwd_kernel` (flash_attention.py:135,
# 167) driven by `_flash_forward_pallas` (:297), bf16: K4's kernel at
# head-major strides, its own entry point and counters. Bound: as K4.
FLASH_FWD_HM_KERNEL = Kernel(
    "flash_fwd_sm90.cu", "ptt_flash_fwd_hm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6)
# K6's fp32 calls: csrc/flash_fwd.cu at head-major strides.
FLASH_FWD_HM_FP32_KERNEL = Kernel(
    "flash_fwd.cu", "ptt_flash_fwd_hm_fp32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 5)
# Replaces `_bwd_fused_kernel` (flash_attention.py:441) driven by
# `_flash_backward_fused` (:531), bf16: the warpgroup kernel of
# csrc/flash_bwd_sm90.cu. Bound: operations, as K5. One launch per call
# runs the delta kernel and the one-pass kernel (one CTA per (kv tile of
# 128, head); dq summed over kv tiles in ascending order through a
# whole-sequence fp32 scratch and a counter per (head, q tile):
# deterministic).
FLASH_BWD_HM_KERNEL = Kernel(
    "flash_bwd_sm90.cu", "ptt_flash_bwd_hm",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 5)
# K7's fp32 calls (exact fp32 FMAs in place of `wgmma`, which has no fp32
# product): csrc/flash_bwd_hm.cu, one CTA per head.
FLASH_BWD_HM_FP32_KERNEL = Kernel(
    "flash_bwd_hm.cu", "ptt_flash_bwd_hm_fp32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 5)
# Replaces `_bwd_dq_kernel` / `_bwd_dkv_kernel` (flash_attention.py:349,
# 393) driven by `_flash_backward_pallas` (:567), bf16: csrc/
# flash_bwd_sm90.cu's kv kernel without dq, then its dq kernel. Bound:
# operations, five products, as K5/K7. One launch per call runs the delta
# and the two kernels (each output has one writer: deterministic).
FLASH_BWD_HM_SPLIT_KERNEL = Kernel(
    "flash_bwd_sm90.cu", "ptt_flash_bwd_hm_split",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 5)
# K8's fp32 calls: K5's kernels at head-major strides (csrc/flash_bwd.cu).
FLASH_BWD_HM_SPLIT_FP32_KERNEL = Kernel(
    "flash_bwd.cu", "ptt_flash_bwd_hm_split_fp32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 5)
HEAD_DIMS = (32, 64, 128)
# Budget of the one-pass head-major backward's whole-sequence fp32 dq
# scratch, as the JAX package's (:506): above it the head-major backward
# is the two-kernel K8.
_DQ_SCRATCH_BYTES = 4 << 20
# Tiles of the bf16 head-major backward (csrc/flash_bwd_sm90.cu): q tiles
# of 64 rows, kv tiles of 128.
HM_BWD_TILE_Q, HM_BWD_TILE_KV = 64, 128
# Tiles of the bf16 forward (csrc/flash_fwd_sm90.cu `FwdTile`): q tiles of
# 128 rows (64 a warpgroup); kv tiles of 128 keys at D=128, 64 at D <= 64.
FWD_TILE_Q = 128


def fwd_tile_kv(d):
    """Keys per kv tile of the bf16 forward at head dim ``d``."""
    return 128 if d > 64 else 64
# Tiles of bf16 K5 (csrc/flash_bwd_sm90.cu at native strides): the kv
# kernel's kv tiles of 128 keys and streamed q tiles of 64 rows, the dq
# kernel's q tiles of 128 rows.
K5_TILE_Q, K5_TILE_KV, K5_TILE_DQ = 64, 128, 128


def _live_kv_tiles(sq, sk, causal, tq, tk):
    """(first, last) live kv tile (of tk keys) per q tile of tq rows, None
    where the tile's rows see no key. Causal alignment is bottom-right (q
    row r sees keys k <= r + Sk - Sq); key 0 is visible to every row that
    sees any key, so ``first`` is 0. Mirrored by ``Schedule::kv_last`` in
    csrc/flash_bwd_sm90.cuh."""
    nkv = -(-sk // tk)
    tiles = []
    for i in range(-(-sq // tq)):
        if not causal:
            tiles.append((0, nkv - 1))
            continue
        top = min(i * tq + tq, sq) - 1 + sk - sq
        tiles.append(None if top < 0 else (0, min(nkv - 1, top // tk)))
    return tiles


def hm_bwd_schedule(sq, sk, causal):
    """The live kv tiles of each q tile of the bf16 one-pass backward K7,
    as (first, last) per q tile of HM_BWD_TILE_Q rows over kv tiles of
    HM_BWD_TILE_KV (:func:`_live_kv_tiles`): a q tile's dq partials are
    summed over kv tiles 0..last in that order, the CTA of kv tile j
    adding once its (head, q tile) counter reads j. A kv tile's first
    live q tile (``Schedule::q_first``) is the first q tile whose
    ``last`` reaches it."""
    return _live_kv_tiles(sq, sk, causal, HM_BWD_TILE_Q, HM_BWD_TILE_KV)


def fwd_schedule(sq, sk, causal, d):
    """The live kv tiles of each q tile of the bf16 forward (K4 / K6) at
    head dim ``d``: a CTA of FWD_TILE_Q rows walks kv tiles of
    ``fwd_tile_kv(d)`` keys from 0 to ``last`` in order (both warpgroups
    alike), None: no tile."""
    return _live_kv_tiles(sq, sk, causal, FWD_TILE_Q, fwd_tile_kv(d))


def k5_kv_schedule(sq, sk, causal):
    """The q tiles (of K5_TILE_Q rows) that bf16 K5's kv kernel walks for
    each kv tile of K5_TILE_KV keys, in its order: the last first, down
    to the kv tile's first live q tile (``Schedule::q_first``: the first q
    tile with a row that sees one of its keys). The same list serves each
    q head of a kv head's group, heads in ascending order."""
    tq, tk = K5_TILE_Q, K5_TILE_KV
    nq = -(-sq // tq)
    out = []
    for j in range(-(-sk // tk)):
        first = j * tk - (sk - sq)
        lo = first // tq if causal and first > 0 else 0
        out.append(list(range(nq - 1, lo - 1, -1)))
    return out


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


def _forward_math(q, k, v, heads, causal):
    """The forward kernels' arithmetic: q [B,Sq,H*D], k, v [B,Sk,KVH*D]
    -> (out [B,Sq,H*D] in q's dtype, lse fp32 [B,H,Sq]). fp32 logits and
    softmax statistics, p cast to the input dtype before the P.V product,
    out = acc / max(l, 1e-30), lse = m_safe + log(max(l, 1e-30))."""
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


def _backward_math(q, k, v, out, lse, dout, heads, causal):
    """The backward kernels' arithmetic -> (dq [B,Sq,H*D], dk, dv
    [B,Sk,KVH*D]) in dout's dtype: p = exp(logits - lse), dv = p^T dO,
    dp = dO v^T, ds = p (dp - delta) cast to the input dtype,
    dk = ds^T q * scale, dq = ds k * scale, every product accumulated in
    fp32; a kv head's dk and dv sum over its q heads."""
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


def _nl_forward_ref(q, k, v, heads, causal):
    """Plain K4: :func:`_forward_math` on the native layout."""
    FLASH_FWD_KERNEL.plain_calls += 1
    return _forward_math(q, k, v, heads, causal)


def _nl_backward_ref(q, k, v, out, lse, dout, heads, causal):
    """Plain K5: :func:`_backward_math` on the native layout."""
    FLASH_BWD_KERNEL.plain_calls += 1
    return _backward_math(q, k, v, out, lse, dout, heads, causal)


def _hm_forward_ref(qh, kh, vh, causal):
    """Plain K6: qh [G,Sq,D], kh, vh [G,Sk,D] -> (out [G,Sq,D], lse fp32
    [G,Sq]); one head per group, the arithmetic of :func:`_forward_math`."""
    FLASH_FWD_HM_KERNEL.plain_calls += 1
    out, lse = _forward_math(qh, kh, vh, 1, causal)
    return out, lse.reshape(qh.shape[0], qh.shape[1])


def _hm_backward_math(qh, kh, vh, out, lse, doh, causal):
    """-> (dq [G,Sq,D], dk, dv [G,Sk,D]) in doh's dtype: the arithmetic
    of :func:`_backward_math`, one head per group."""
    return _backward_math(qh, kh, vh, out, lse.reshape(lse.shape[0], 1, -1),
                          doh, 1, causal)


def _hm_backward_ref(qh, kh, vh, out, lse, doh, causal):
    """Plain K7 (:func:`_hm_backward_math`)."""
    FLASH_BWD_HM_KERNEL.plain_calls += 1
    return _hm_backward_math(qh, kh, vh, out, lse, doh, causal)


def _hm_backward_split_ref(qh, kh, vh, out, lse, doh, causal):
    """Plain K8 (:func:`_hm_backward_math`: the two kernels compute the
    one-pass backward's function)."""
    FLASH_BWD_HM_SPLIT_KERNEL.plain_calls += 1
    return _hm_backward_math(qh, kh, vh, out, lse, doh, causal)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _row_stride(x):
    """The distance between consecutive rows of a [B,S,e] view as the
    kernels step through them (row b*S + s at (b*S + s) times it):
    stride(1), or, at S = 1, where stride(1) says nothing (a decode
    step's column slice of a packed [B,1,3E] projection), stride(0)."""
    return x.stride(0) if x.shape[1] == 1 else x.stride(1)


def _check_operand(name, x, dtype, device, e):
    """x: a [B,S,e] view whose rows are 16-byte aligned, one row stride
    apart, and whose last dim is contiguous (a column slice of a packed
    array qualifies)."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"flash attention: {name} must be {dtype} on "
                         f"{device}, got {x.dtype} on {x.device}")
    if x.dim() != 3 or x.shape[2] != e:
        raise ValueError(f"flash attention: {name} must be [B,S,{e}], got "
                         f"{tuple(x.shape)}")
    item, rs = x.element_size(), _row_stride(x)
    if (x.stride(2) != 1
            or (x.shape[0] > 1 and x.stride(0) != x.shape[1] * rs)
            or (rs * item) % 16 or x.data_ptr() % 16):
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
    if (k.shape != v.shape or k.shape[0] != b
            or _row_stride(k) != _row_stride(v)):
        raise ValueError("flash attention: k and v must share shape and "
                         "row stride")
    return b, sq, k.shape[1], d, k.shape[-1] // d


def _bf16_or_fp32(dtype, bf16_kernel, fp32_kernel):
    """The entry point of a call: the warpgroup kernel in bf16, the
    earlier exact-FMA kernel in fp32 (``wgmma`` has no fp32 product), and
    the trailing dtype code the bf16 entry takes (the fp32 one takes
    none)."""
    if dtype == torch.bfloat16:
        return bf16_kernel, (DTYPE_CODES[dtype],)
    return fp32_kernel, ()


def flash_fwd_cuda(q, k, v, heads, causal):
    """Launch the forward kernel (K4; bf16 on ``wgmma``, csrc/
    flash_fwd_sm90.cu, fp32 csrc/flash_fwd.cu). q [B,Sq,H*D], k, v
    [B,Sk,KVH*D] (KVH dividing H) on a card: views with contiguous 16-byte
    aligned rows, e.g. column slices of a packed [B,S,3E]; D in
    HEAD_DIMS. Returns new (out [B,Sq,H*D], lse fp32 [B,H,Sq])."""
    b, sq, sk, d, kvh = _check_kernel_args(q, k, v, heads)
    out = torch.empty(b, sq, heads * d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, heads, sq, dtype=torch.float32, device=q.device)
    kernel, code = _bf16_or_fp32(q.dtype, FLASH_FWD_KERNEL,
                                 FLASH_FWD_FP32_KERNEL)
    kernel.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _row_stride(q),
        _row_stride(k), out.data_ptr(), lse.data_ptr(), b, sq, sk, heads, kvh,
        d, int(bool(causal)), *code)
    return out, lse


def flash_bwd_cuda(q, k, v, out, lse, dout, heads, causal, dq, dk, dv):
    """Launch the backward kernels (K5; bf16 the delta, kv and dq
    kernels of csrc/flash_bwd_sm90.cu, fp32 those of csrc/flash_bwd.cu):
    writes dq [B,Sq,H*D] and dk, dv
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
    if _row_stride(dk) != _row_stride(dv):
        raise ValueError("flash attention: dk and dv must share a row "
                         "stride")
    if dq.shape[:2] != (b, sq) or dk.shape[:2] != (b, sk) \
            or dv.shape[:2] != (b, sk):
        raise ValueError("flash attention: gradient shapes do not match")
    delta = torch.empty(b, heads, sq, dtype=torch.float32, device=q.device)
    kernel, code = _bf16_or_fp32(q.dtype, FLASH_BWD_KERNEL,
                                 FLASH_BWD_FP32_KERNEL)
    kernel.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), _row_stride(q),
        _row_stride(k), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _row_stride(dq), _row_stride(dk), b, sq, sk, heads, kvh, d,
        int(bool(causal)), *code)


def _check_hm_args(qh, kh, vh):
    """-> (G, Sq, Sk, D) of qh [G,Sq,D] and kh, vh [G,Sk,D] on a card.
    Any group and row strides are taken, as long as the last dim is
    contiguous and rows are 16-byte aligned: with B=1 the fused op's
    head-major q, k, v are views of its projection (group stride D, row
    stride 3E), which the kernels read in place."""
    if qh.device.type != "cuda":
        raise ValueError(f"flash attention kernels take CUDA tensors, got "
                         f"{qh.device}")
    if qh.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32/bfloat16, "
                        f"got {qh.dtype}")
    if qh.dim() != 3 or qh.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head-major flash attention kernels take [G,S,D] "
                         f"with D in {HEAD_DIMS}, got {tuple(qh.shape)}")
    g, d = qh.shape[0], qh.shape[2]
    for name, x in (("q", qh), ("k", kh), ("v", vh)):
        item = x.element_size()
        if x.device != qh.device or x.dtype != qh.dtype:
            raise ValueError(f"flash attention: {name} must be {qh.dtype} "
                             f"on {qh.device}, got {x.dtype} on {x.device}")
        if x.dim() != 3 or x.shape[0] != g or x.shape[2] != d:
            raise ValueError(f"flash attention: {name} must be [{g},S,{d}], "
                             f"got {tuple(x.shape)}")
        if (x.stride(2) != 1 or (x.stride(1) * item) % 16
                or (x.stride(0) * item) % 16 or x.data_ptr() % 16):
            raise ValueError(f"flash attention: {name} must have contiguous, "
                             f"16-byte aligned rows, got strides {x.stride()}")
    if kh.shape != vh.shape or kh.stride() != vh.stride():
        raise ValueError("flash attention: k and v must share shape and "
                         "strides")
    return g, qh.shape[1], kh.shape[1], d


def flash_fwd_hm_cuda(qh, kh, vh, causal):
    """Launch K6 (bf16 csrc/flash_fwd_sm90.cu, fp32 csrc/flash_fwd.cu).
    qh [G,Sq,D], kh, vh [G,Sk,D] (G = B*H, one head each) on
    a card, with contiguous 16-byte aligned rows at any group and row
    strides; D in HEAD_DIMS. Returns new (out [G,Sq,D], lse fp32
    [G,Sq])."""
    g, sq, sk, d = _check_hm_args(qh, kh, vh)
    out = torch.empty(g, sq, d, dtype=qh.dtype, device=qh.device)
    lse = torch.empty(g, sq, dtype=torch.float32, device=qh.device)
    kernel, code = _bf16_or_fp32(qh.dtype, FLASH_FWD_HM_KERNEL,
                                 FLASH_FWD_HM_FP32_KERNEL)
    kernel.launch(
        qh.device, qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), qh.stride(0),
        qh.stride(1), kh.stride(0), kh.stride(1), out.data_ptr(),
        lse.data_ptr(), g, sq, sk, d, int(bool(causal)), *code)
    return out, lse


def _check_hm_bwd_args(qh, kh, vh, out, lse, doh):
    """The head-major backward's operands (:func:`_check_hm_args`, out
    and doh [G,Sq,D] contiguous, lse fp32 [G,Sq]) -> (G, Sq, Sk, D) and
    new (delta fp32 [G,Sq], dq [G,Sq,D], dk, dv [G,Sk,D])."""
    g, sq, sk, d = _check_hm_args(qh, kh, vh)
    for name, x in (("out", out), ("dout", doh)):
        if (x.shape != (g, sq, d) or x.dtype != qh.dtype
                or x.device != qh.device or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"flash attention: {name} must be a "
                             f"contiguous, 16-byte aligned [{g},{sq},{d}] "
                             f"{qh.dtype} tensor")
    if (lse.shape != (g, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash attention: lse must be fp32 [G,Sq]")
    delta = torch.empty(g, sq, dtype=torch.float32, device=qh.device)
    dq = torch.empty(g, sq, d, dtype=qh.dtype, device=qh.device)
    dk, dv = (torch.empty(g, sk, d, dtype=qh.dtype, device=qh.device)
              for _ in range(2))
    return (g, sq, sk, d), (delta, dq, dk, dv)


def flash_bwd_hm_cuda(qh, kh, vh, out, lse, doh, causal):
    """Launch K7. qh, kh, vh as :func:`flash_fwd_hm_cuda`; out, doh
    [G,Sq,D] contiguous; lse fp32 [G,Sq] from the forward. Returns new
    (dq [G,Sq,D], dk, dv [G,Sk,D]). Its scratch: delta fp32 [G,Sq], the
    whole-sequence dq accumulator fp32 [G,Sq,D] and, in bf16, an int32
    counter per (head, q tile of :func:`hm_bwd_schedule`), zeroed."""
    (g, sq, sk, d), (delta, dq, dk, dv) = _check_hm_bwd_args(
        qh, kh, vh, out, lse, doh)
    dq_acc = torch.empty(g, sq, d, dtype=torch.float32, device=qh.device)
    head = (qh.device, qh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
            qh.stride(0), qh.stride(1), kh.stride(0), kh.stride(1),
            out.data_ptr(), doh.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr())
    tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), g, sq, sk, d,
            int(bool(causal)))
    if qh.dtype == torch.bfloat16:
        tiles = len(hm_bwd_schedule(sq, sk, causal))
        counters = torch.zeros(g, tiles, dtype=torch.int32, device=qh.device)
        FLASH_BWD_HM_KERNEL.launch(*head, counters.data_ptr(), *tail)
    else:
        FLASH_BWD_HM_FP32_KERNEL.launch(*head, *tail)
    return dq, dk, dv


def flash_bwd_hm_split_cuda(qh, kh, vh, out, lse, doh, causal):
    """Launch K8, arguments and results as :func:`flash_bwd_hm_cuda`.
    Its only scratch is delta fp32 [G,Sq]."""
    (g, sq, sk, d), (delta, dq, dk, dv) = _check_hm_bwd_args(
        qh, kh, vh, out, lse, doh)
    kernel = (FLASH_BWD_HM_SPLIT_KERNEL if qh.dtype == torch.bfloat16
              else FLASH_BWD_HM_SPLIT_FP32_KERNEL)
    kernel.launch(
        qh.device, qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), qh.stride(0),
        qh.stride(1), kh.stride(0), kh.stride(1), out.data_ptr(),
        doh.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), g, sq, sk, d, int(bool(causal)))
    return dq, dk, dv


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


def _flash_forward_hm(qh, kh, vh, causal):
    """K6 on a card, its plain version on the CPU: (out [G,Sq,D], lse
    [G,Sq])."""
    if qh.device.type == "cuda":
        return flash_fwd_hm_cuda(qh, kh, vh, causal)
    if qh.device.type == "cpu":
        return _hm_forward_ref(qh, kh, vh, causal)
    raise ValueError(f"flash attention: unsupported device {qh.device}")


def _flash_backward_hm(qh, kh, vh, out, lse, doh, causal):
    """The head-major backward, as the JAX package's
    ``_flash_backward_pallas`` picks it: the one-pass K7 while its
    whole-sequence fp32 dq scratch (Sq*D*4 bytes) fits
    ``_DQ_SCRATCH_BYTES``, the two-kernel K8 above it; on a card the
    kernel, on the CPU its plain version. -> (dq, dk, dv) head-major."""
    split = qh.shape[1] * qh.shape[2] * 4 > _DQ_SCRATCH_BYTES
    if qh.device.type == "cuda":
        kernel = flash_bwd_hm_split_cuda if split else flash_bwd_hm_cuda
        return kernel(qh, kh, vh, out, lse, doh, causal)
    if qh.device.type == "cpu":
        plain = _hm_backward_split_ref if split else _hm_backward_ref
        return plain(qh, kh, vh, out, lse, doh, causal)
    raise ValueError(f"flash attention: unsupported device {qh.device}")


class _FlashHM(torch.autograd.Function):
    """Head-major flash attention: qh [G,Sq,D], kh, vh [G,Sk,D] in,
    [G,Sq,D] out; the residuals are saved head-major (the JAX package's
    ``_flash_hm_fwd`` / ``_flash_hm_bwd``)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, causal):
        out, lse = _flash_forward_hm(qh, kh, vh, causal)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward_hm(qh, kh, vh, out, lse,
                                        g.contiguous(), ctx.causal)
        return dq, dk, dv, None


def _flash_hm(qh, kh, vh, causal):
    """[G,Sq,D] q against [G,Sk,D] k, v (one head per group) -> [G,Sq,D]."""
    return _FlashHM.apply(qh, kh, vh, causal)


def _bhsd(x):
    """[B,S,H,D] -> head-major [B*H,S,D]: a transposing copy, or at B=1 a
    view at group stride D (the kernels take either)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _hm_ok(q, k) -> bool:
    """Shapes the head-major kernels take ([B,S,H,D] q and k; the JAX
    package's ``_pallas_ok``, shape only): as many kv heads as q heads
    and a head dim in HEAD_DIMS (no TPU tiling gate carries over)."""
    return (q.dim() == 4 and k.dim() == 4 and k.shape[2] == q.shape[2]
            and q.shape[3] in HEAD_DIMS and q.shape[1] >= 1
            and k.shape[1] >= 1)


def _gqa_broadcastable(h: int, kvh: int) -> bool:
    """Grouped-query shapes whose kv heads the kernels share in place."""
    return kvh > 0 and h % kvh == 0


def _gqa_route(h: int, kvh: int, d: int) -> str:
    """Shape-only route of [B,S,H,D] attention over KVH kv heads, the one
    authority of flash_attention_fused and sdpa's eligibility check (the
    JAX package's ``_gqa_route``, here deciding MHA too): "native" (the
    native-layout kernels, shared kv heads addressed in place) for every
    broadcastable ratio, MQA included, at a head dim in HEAD_DIMS (no TPU
    lane gate carries over) while FLAGS_flash_native_layout is on; on
    flag 0 "ramp" (k and v repeated to the q heads where KVH < H, then the
    head-major kernels, as the JAX package reaches them through
    ``_pallas_ok``); else "reference" (the dense path)."""
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


def _reference_attention(q, k, v, causal):
    """Dense [B,Sq,H,D] q against [B,Sk,KVH,D] k, v (grouped against the
    shared kv heads, none repeated) -> [B,Sq,H,D] in q's dtype: fp32
    logits with the bottom-right causal mask, fp32 softmax and P.V (the
    JAX package's ``_reference_attention``)."""
    qh, kh, vh = (x.transpose(1, 2).float() for x in (q, k, v))
    probs = torch.softmax(_masked_logits(qh, kh, causal), dim=-1)
    return grouped_pv_out(probs, vh).transpose(1, 2).to(q.dtype)


def _attend_hm_reference(qh, kh, vh, causal):
    """Dense head-major [G,Sq,D] attention (the JAX package's
    ``_attend_hm_reference``): :func:`_reference_attention` with one head
    per group."""
    out = _reference_attention(qh.unsqueeze(2), kh.unsqueeze(2),
                               vh.unsqueeze(2), causal)
    return out.squeeze(2)


def _flash_attention(q, k, v, causal):
    """[B,Sq,H,D] q against [B,Sk,KVH,D] k, v -> [B,Sq,H,D]: the route
    ``_gqa_route`` names. "native": the native-layout Function through a
    free reshape on each side. "ramp": k, v repeated to the H q heads
    where KVH < H (the JAX package's ``jnp.repeat``), then the head-major
    Function between transposes. "reference": the dense
    :func:`_reference_attention`."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    route = _gqa_route(h, kvh, d)
    if route == "native":
        out = _flash_nl(q.reshape(b, sq, h * d), k.reshape(b, sk, kvh * d),
                        v.reshape(b, sk, kvh * d), causal, h)
        return out.reshape(b, sq, h, d)
    if route == "ramp":
        if kvh != h:
            k = k.repeat_interleave(h // kvh, dim=2)
            v = v.repeat_interleave(h // kvh, dim=2)
        if _hm_ok(q, k):
            out = _flash_hm(_bhsd(q), _bhsd(k), _bhsd(v), causal)
            return out.reshape(b, h, sq, d).transpose(1, 2)
    return _reference_attention(q, k, v, causal)


def flash_attention_fused(query, key, value, causal=False):
    """[B,Sq,H,D] query against [B,Sk,KVH,D] key, value (KVH dividing H)
    -> [B,Sq,H,D]: the native-layout kernels (no transpose and no repeat
    of key or value) or, on FLAGS_flash_native_layout=0, the head-major
    ones (see :func:`_flash_attention`). The op sdpa routes to, an amp
    "allow" op as in the JAX package; differentiable in all three."""
    query, key, value = autocast("flash_attention", "allow", query, key,
                                 value)
    return _flash_attention(query, key, value, causal)


def flash_attention_packed(qkv, num_heads, causal=False):
    """Self-attention over the fused projection's packed [B,S,3E] output
    (columns q|k|v, the reshape([b,s,3,h,d]) order): the native-layout
    kernels read it in place; on FLAGS_flash_native_layout=0 it is
    unpacked into the [B,S,H,D] dispatch (the JAX package's
    ``_flash_packed_impl``), as it is at a head dim no kernel takes.
    Parity: the qkv-packed form of the reference's flash_attn_qkvpacked.
    Differentiable in qkv."""
    (qkv,) = autocast("flash_attention_packed", "allow", qkv)
    if qkv.shape[-1] % 3:
        raise ValueError(f"flash_attention_packed: last dim "
                         f"{qkv.shape[-1]} is not 3E")
    b, s, e3 = qkv.shape
    e = e3 // 3
    _check_heads(e, num_heads)
    d = e // num_heads
    if _gqa_route(num_heads, num_heads, d) == "native":
        return _flash_nl_packed(qkv, causal, num_heads)
    q4 = qkv.reshape(b, s, 3, num_heads, d)
    return _flash_attention(q4[:, :, 0], q4[:, :, 1], q4[:, :, 2],
                            causal).reshape(b, s, e)


# ---------------------------------------------------------------------------
# fused projections + attention (whole-block op)
# ---------------------------------------------------------------------------

def _fused_mha_impl(x, wqkv, bqkv, wo, bo, num_heads=1, causal=False):
    """The whole attention block over the head-major layout: the qkv
    projection contracts x [B,S,E] with the [E,3E] weight viewed
    [E,3,H,D] straight into [3,B,H,S,D], the head-major Function runs
    K6 and K7 or K8 on [B*H,S,D] (at B=1 on views of the projection, read
    in place), and the output projection contracts [B,H,S,D]
    with the [E,E] weight viewed [H,D,E]. The matmuls are torch's, as
    they lie outside the Pallas kernel in the JAX package. Biases may be
    None. At a head dim outside HEAD_DIMS the attention is the dense
    :func:`_attend_hm_reference`."""
    b, s, e = x.shape
    h = num_heads
    _check_heads(e, h)
    d = e // h
    qkv = torch.einsum("bse,ethd->tbhsd", x, wqkv.reshape(e, 3, h, d))
    if bqkv is not None:
        qkv = qkv + bqkv.reshape(3, 1, h, 1, d)
    qh, kh, vh = (qkv[i].reshape(b * h, s, d) for i in range(3))
    attend = _flash_hm if d in HEAD_DIMS else _attend_hm_reference
    out = attend(qh, kh, vh, causal)
    y = torch.einsum("bhsd,hde->bse", out.reshape(b, h, s, d),
                     wo.reshape(h, d, e))
    return y if bo is None else y + bo


def fused_self_attention(x, qkv_weight, qkv_bias, out_weight, out_bias,
                         num_heads, causal=False):
    """Self-attention block (qkv proj -> flash attention -> out proj) as
    one op, an amp "allow" op as in the JAX package. qkv_weight is
    [E, 3E] (column order q|k|v), out_weight [E, E]; biases may be None.
    Differentiable in x, the weights and the biases."""
    x, qkv_weight, qkv_bias, out_weight, out_bias = autocast(
        "fused_self_attention", "allow", x, qkv_weight, qkv_bias,
        out_weight, out_bias)
    return _fused_mha_impl(x, qkv_weight, qkv_bias, out_weight, out_bias,
                           num_heads, causal)


__all__ = ["FLASH_BWD_FP32_KERNEL", "FLASH_BWD_HM_FP32_KERNEL",
           "FLASH_BWD_HM_KERNEL", "FLASH_BWD_HM_SPLIT_FP32_KERNEL",
           "FLASH_BWD_HM_SPLIT_KERNEL", "FLASH_BWD_KERNEL",
           "FLASH_FWD_FP32_KERNEL", "FLASH_FWD_HM_FP32_KERNEL",
           "FLASH_FWD_HM_KERNEL", "FLASH_FWD_KERNEL",
           "HEAD_DIMS", "flash_attention_fused", "flash_attention_packed",
           "flash_bwd_cuda", "flash_bwd_hm_cuda", "flash_bwd_hm_split_cuda",
           "flash_fwd_cuda", "flash_fwd_hm_cuda", "fused_self_attention",
           "fwd_schedule", "fwd_tile_kv", "grouped_pv_out",
           "grouped_qk_logits",
           "hm_bwd_schedule", "k5_kv_schedule"]
