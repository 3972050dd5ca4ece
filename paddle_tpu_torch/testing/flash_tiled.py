"""The bf16 attention kernels' orders of work, mirrored in plain PyTorch
for the CPU tests: a tiled forward as ``csrc/flash_fwd_sm90.cu`` walks it
(K4 / K6) and a tiled native-layout backward as ``csrc/flash_bwd_sm90.cu``'s
kv and dq kernels walk it for K5. They run at any dtype on the CPU and
repeat the kernels' arithmetic (fp32 products and sums, p and ds rounded
to the input dtype before their products, the softmax in the exp2 domain
with the scale folded into one multiply-add) tile by tile, in the
kernels' order. They are not the port's plain versions (``_nl_forward_ref``
/ ``_nl_backward_ref`` in flash_attention.py are); the tests hold them
against those and against the JAX package, so that a change of tile, of
schedule or of summation order in the kernels has a CPU counterpart to
hold too."""
from __future__ import annotations

import math

import torch

from ..incubate.nn.functional import flash_attention as fa

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _split_heads(x, heads):
    """[B,S,H*D] -> fp32 [B,H,S,D]."""
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads).transpose(1, 2).float()


def _mask(rows, cols, sq, sk, causal):
    """[len(rows), len(cols)] bool: the key is visible to the q row
    (inside Sk, and at or below the bottom-right diagonal)."""
    keep = cols[None, :] < sk
    if causal:
        keep = keep & (cols[None, :] <= rows[:, None] + (sk - sq))
    return keep


def forward_tiled(q, k, v, heads, causal):
    """K4's kernel order on the native layout: q [B,Sq,H*D], k, v
    [B,Sk,KVH*D] -> (out [B,Sq,H*D] in q's dtype, lse fp32 [B,H,Sq]).
    Per q tile of ``FWD_TILE_Q`` rows, kv tiles of ``fwd_tile_kv(D)`` keys
    from 0 to the tile's last live one (``fwd_schedule``): s = q k^T in
    fp32; masked entries -inf (only on tiles that cross the diagonal or
    the end); m = max(m, rowmax(s) * scale log2(e)); p = exp2(s * scale
    log2(e) - m) (m taken as 0 while it is -inf); l = alpha l + rowsum(p)
    with alpha = exp2(m_old - m); O = alpha (O + P_prev V_prev), P the
    previous tile's p rounded to the input dtype, as the kernel issues P V
    one tile late; at the end O += P V; out = O / max(l, 1e-30), lse =
    m_safe ln 2 + log(max(l, 1e-30))."""
    b, sq, e = q.shape
    sk = k.shape[1]
    kvh = fa._kv_heads(q, k, heads)
    d = e // heads
    rep = heads // kvh
    dt = q.dtype
    c = (1.0 / math.sqrt(d)) * LOG2E
    qh = _split_heads(q, heads)
    kh = _split_heads(k, kvh).repeat_interleave(rep, dim=1)
    vh = _split_heads(v, kvh).repeat_interleave(rep, dim=1)
    tq, tk = fa.FWD_TILE_Q, fa.fwd_tile_kv(d)
    out = torch.zeros(b, heads, sq, d)
    lse = torch.zeros(b, heads, sq)
    for i, live in enumerate(fa.fwd_schedule(sq, sk, causal, d)):
        rows = torch.arange(i * tq, min(sq, i * tq + tq))
        n = len(rows)
        o = torch.zeros(b, heads, n, d)
        m = torch.full((b, heads, n), -math.inf)
        l = torch.zeros(b, heads, n)
        p_prev = v_prev = None
        for j in range(0 if live is None else live[1] + 1):
            cols = torch.arange(j * tk, j * tk + tk)
            kj = kh[:, :, j * tk:j * tk + tk]
            s = qh[:, :, rows] @ kj.transpose(-1, -2)
            if s.shape[-1] < tk:         # the ragged end: zero rows of K
                s = torch.cat([s, s.new_zeros(*s.shape[:-1],
                                              tk - s.shape[-1])], -1)
            if j * tk + tk > sk or (causal and j * tk + tk - 1
                                    > i * tq + sk - sq):
                keep = _mask(rows, cols, sq, sk, causal)
                s = s.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * c)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(s * c - m_use[..., None])
            l = alpha * l + p.sum(-1)
            m = m_new
            if p_prev is not None:
                o = o + p_prev @ v_prev
            o = o * alpha[..., None]
            vj = vh[:, :, j * tk:j * tk + tk]
            p_prev = p[..., :vj.shape[2]].to(dt).float()
            v_prev = vj
        if p_prev is not None:
            o = o + p_prev @ v_prev
        lsafe = l.clamp_min(1e-30)
        out[:, :, rows] = o / lsafe[..., None]
        m_safe = torch.where(m == -math.inf, 0.0, m)
        lse[:, :, rows] = m_safe * LN2 + torch.log(lsafe)
    out = out.to(dt).transpose(1, 2).reshape(b, sq, e)
    return out, lse


def forward_tiled_hm(qh, kh, vh, causal):
    """K6: :func:`forward_tiled` on head-major [G,Sq,D] q, [G,Sk,D] k, v
    (one head a group) -> (out [G,Sq,D], lse fp32 [G,Sq])."""
    out, lse = forward_tiled(qh, kh, vh, 1, causal)
    return out, lse.reshape(qh.shape[0], qh.shape[1])


def backward_tiled(q, k, v, out, lse, dout, heads, causal):
    """K5's kernel order on the native layout -> (dq [B,Sq,H*D], dk, dv
    [B,Sk,KVH*D]) in dout's dtype. delta = rowsum(dO O) in fp32. The kv
    kernel: per kv tile of ``K5_TILE_KV`` keys and kv head, the group's q
    heads in ascending order, each over its live q tiles of ``K5_TILE_Q``
    rows from the last down to the tile's first (``k5_kv_schedule``):
    p^T = exp2(k q^T scale log2(e) - lse log2(e)) (masked 0), dp^T = v
    dO^T, ds^T = p^T (dp^T - delta), dv += (p^T in dtype) dO, dk += (ds^T
    in dtype) q, all in fp32, dk scaled at the end: dk and dv sum over the
    whole group once, in that order. The dq kernel: per q tile of
    ``K5_TILE_DQ`` rows and q head, kv tiles of ``K5_TILE_KV`` from 0 to
    the last live one, each as two halves of 64 keys: dq += (ds in dtype)
    k, scaled at the end."""
    b, sq, e = q.shape
    sk = k.shape[1]
    kvh = fa._kv_heads(q, k, heads)
    d = e // heads
    rep = heads // kvh
    dt = dout.dtype
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    qh, doh = _split_heads(q, heads), _split_heads(dout, heads)
    kh, vh = _split_heads(k, kvh), _split_heads(v, kvh)
    lse2 = lse.float() * LOG2E                           # [B,H,Sq]
    delta = fa._delta(out, dout, heads)                  # [B,H,Sq]
    tq, tk, tdq = fa.K5_TILE_Q, fa.K5_TILE_KV, fa.K5_TILE_DQ

    dk = torch.zeros(b, kvh, sk, d)
    dv = torch.zeros(b, kvh, sk, d)
    for j, q_tiles in enumerate(fa.k5_kv_schedule(sq, sk, causal)):
        cols = torch.arange(j * tk, min(sk, j * tk + tk))
        kj, vj = kh[:, :, cols], vh[:, :, cols]
        acc_k = torch.zeros(b, kvh, len(cols), d)
        acc_v = torch.zeros(b, kvh, len(cols), d)
        for r in range(rep):
            hq = torch.arange(kvh) * rep + r             # one q head a group
            for i in q_tiles:
                rows = torch.arange(i * tq, min(sq, i * tq + tq))
                qi, doi = qh[:, hq][:, :, rows], doh[:, hq][:, :, rows]
                keep = _mask(rows, cols, sq, sk, causal).T   # [keys, rows]
                st = kj @ qi.transpose(-1, -2)
                pt = torch.exp2(st * c - lse2[:, hq][:, :, None, rows])
                pt = torch.where(keep, pt, 0.0)
                dpt = vj @ doi.transpose(-1, -2)
                dst = pt * (dpt - delta[:, hq][:, :, None, rows])
                acc_v = acc_v + pt.to(dt).float() @ doi
                acc_k = acc_k + dst.to(dt).float() @ qi
        dk[:, :, cols] = acc_k * scale
        dv[:, :, cols] = acc_v

    dq = torch.zeros(b, heads, sq, d)
    kq, vq = (x.repeat_interleave(rep, dim=1) for x in (kh, vh))
    for i, live in enumerate(fa._live_kv_tiles(sq, sk, causal, tdq, tk)):
        rows = torch.arange(i * tdq, min(sq, i * tdq + tdq))
        acc = torch.zeros(b, heads, len(rows), d)
        for j in range(0 if live is None else live[1] + 1):
            for half in range(2):
                k0 = j * tk + 64 * half
                if k0 >= sk:
                    continue
                cols = torch.arange(k0, min(sk, k0 + 64))
                keep = _mask(rows, cols, sq, sk, causal)
                s = qh[:, :, rows] @ kq[:, :, cols].transpose(-1, -2)
                p = torch.where(keep, torch.exp2(
                    s * c - lse2[:, :, rows, None]), 0.0)
                dp = doh[:, :, rows] @ vq[:, :, cols].transpose(-1, -2)
                ds = p * (dp - delta[:, :, rows, None])
                acc = acc + ds.to(dt).float() @ kq[:, :, cols]
        dq[:, :, rows] = acc * scale

    def back(x, s_):
        return x.to(dt).transpose(1, 2).reshape(b, s_, -1)
    return back(dq, sq), back(dk, sk), back(dv, sk)


__all__ = ["backward_tiled", "forward_tiled", "forward_tiled_hm"]
