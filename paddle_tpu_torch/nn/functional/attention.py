"""scaled_dot_product_attention. Counterpart of
paddle_tpu/nn/functional/attention.py, cut to the training slice.

Layout follows Paddle: [batch, seq, num_heads, head_dim]; key and value
may hold fewer heads than query (grouped query, KVH dividing H). A
mask-free call at the default scale on a shape the kernels take goes to
``flash_attention_fused`` (the hand-written flash kernels on a card);
anything else runs the dense ``_sdpa`` in plain torch, as the JAX
package computes it in jnp outside any kernel. Training-mode dropout
takes the dense route (the kernels have no dropout), its mask drawn from
``core.generator.rng_tracker``.
"""
from __future__ import annotations

import math

import torch

from ...amp.state import autocast
from ...incubate.nn.functional import flash_attention as fa
from .common import keep_mask


def _sdpa(query, key, value, attn_mask=None, is_causal=False, scale=None,
          dropout_p=0.0):
    """Dense attention: fp32 logits of q grouped against the shared kv
    heads (no repeat of k or v), the bottom-right causal mask, a boolean
    (keep) or additive mask, softmax in fp32, probabilities in the input
    dtype before the P.V product, where a ``dropout_p`` > 0 drops each
    with that probability and scales the rest by 1/(1 - dropout_p). An
    amp "allow" op."""
    query, key, value = autocast("scaled_dot_product_attention", "allow",
                                 query, key, value)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = fa.grouped_qk_logits(q, k).float() * s
    if is_causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(qlen, klen, dtype=torch.bool,
                          device=logits.device).tril(klen - qlen)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p:
        keep = keep_mask(probs.shape, 1.0 - dropout_p, probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return fa.grouped_pv_out(probs, v).transpose(1, 2)


def _flash_eligible(query, key) -> bool:
    """Shapes the flash kernels take: ``fa._gqa_route``'s decision, shape
    only, for grouped and equal head counts alike ("native", or "ramp" on
    FLAGS_flash_native_layout=0)."""
    if query.dim() != 4 or key.dim() != 4:
        return False
    return fa._gqa_route(query.shape[2], key.shape[2],
                         query.shape[3]) != "reference"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    """paddle.nn.functional.scaled_dot_product_attention over [B,S,H,D]
    query and [B,S,KVH,D] key, value; causal masking is aligned
    bottom-right. Mask-free, dropout-free calls at the default scale on
    the kernels' shapes run the flash kernels, the rest the dense
    ``_sdpa``."""
    drop = dropout_p if training else 0.0
    default_scale = scale is None or (
        scale == 1.0 / math.sqrt(query.shape[-1]))
    if (attn_mask is None and default_scale and not drop
            and _flash_eligible(query, key)):
        return fa.flash_attention_fused(query, key, value, causal=is_causal)
    return _sdpa(query, key, value, attn_mask, is_causal=is_causal,
                 scale=scale, dropout_p=drop)


__all__ = ["scaled_dot_product_attention"]
