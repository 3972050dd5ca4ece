"""Grouped-query attention helpers. Counterpart of the dense helpers in
paddle_tpu/incubate/nn/functional/flash_attention.py (the flash kernels
come with the training slice)."""
from __future__ import annotations

import torch


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


__all__ = ["grouped_pv_out", "grouped_qk_logits"]
