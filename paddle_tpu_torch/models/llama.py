"""Llama-family decoder: RMSNorm pre-norms, rotary embeddings,
grouped-query attention, SwiGLU MLP. Counterpart of
paddle_tpu/models/llama.py: the no-cache training forward, the dense
(k, v) tuple cache of the default generate(), and the paged-cache
serving path.

Every norm runs the RMSNorm kernel through fused_rms_norm. Training and
dense-cache attention go through scaled_dot_product_attention to the
flash kernels, which address the shared kv heads in place; a dense
decode step is one query row against the whole cache, causal aligned
bottom-right. Parameter names and layouts
are the JAX package's, so its state_dict loads name for name
(bridge.load_jax_state), and each parameter carries that name as
``.param_name`` (the key of its optimizer state). ``recompute=True`` recomputes
each layer in the backward while training (distributed.fleet.recompute).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.generator import new_generator
from ..core.place import resolve_device
from ..distributed.fleet import recompute
from ..incubate.nn.functional.fused_ops import (
    fused_rms_norm, fused_rotary_position_embedding, swiglu)
from ..incubate.nn.functional.paged_kv import (
    PagedCache, block_grouped_query_attention,
    block_grouped_query_attention_quant)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Embedding, Linear
from ..nn.layer.common import name_parameters, new_parameter


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None   # < num_heads = GQA; None = MHA
    intermediate_size: int = 0           # 0 -> LLaMA's 2/3 * 4h, 128-rounded
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    recompute: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        return ((int(8 * self.hidden_size / 3) + 127) // 128) * 128


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                       num_heads=4, max_seq_len=128, **kw)


def llama2_7b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, intermediate_size=11008,
                       max_seq_len=4096, **kw)


def _positions(pos_offset, s: int, device):
    """[B, S] (per-sequence [B] offset) or [1, S] (scalar offset)
    positions of this call's tokens."""
    ar = torch.arange(s, dtype=torch.int64, device=device)
    if isinstance(pos_offset, torch.Tensor) and pos_offset.dim() >= 1:
        return pos_offset.to(torch.int64)[:, None] + ar[None, :]
    return (ar + pos_offset)[None, :]


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.weight = new_parameter([hidden], I.Constant(1.0), device, dtype,
                                    generator)
        self._eps = eps

    def forward(self, x):
        return fused_rms_norm(x, self.weight, epsilon=self._eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        h, kv = cfg.num_heads, cfg.kv_heads
        if h % kv:
            raise ValueError(f"num_heads {h} not a multiple of kv_heads {kv}")
        if cfg.hidden_size % h:
            raise ValueError(f"hidden_size {cfg.hidden_size} not divisible "
                             f"by num_heads {h}")
        self.num_heads = h
        self.kv_heads = kv
        self.head_dim = cfg.hidden_size // h
        e, ekv = cfg.hidden_size, kv * self.head_dim
        self.q_proj = Linear(e, e, bias_attr=False, **factory)
        self.k_proj = Linear(e, ekv, bias_attr=False, **factory)
        self.v_proj = Linear(e, ekv, bias_attr=False, **factory)
        self.o_proj = Linear(e, e, bias_attr=False, **factory)
        self._theta = cfg.rope_theta

    def forward(self, x, cache=None, pos_offset=0):
        """No cache (training): rope at positions 0..S-1, causal attention
        over the shared kv heads; returns out. Dense ``(k, v)`` cache
        (``(None, None)`` before the prompt): rope at the cached length,
        this call's k/v appended to the cache's, causal attention aligned
        bottom-right; returns (out, the grown (k, v)). Paged serving: each
        sequence's tokens are rotated at its own cached position
        (``pos_offset`` is a per-sequence [B] vector in decode); returns
        (out, the cache advanced by this call)."""
        b, s, e = x.shape
        d = self.head_dim
        q = self.q_proj(x).reshape(b, s, self.num_heads, d)
        k = self.k_proj(x).reshape(b, s, self.kv_heads, d)
        v = self.v_proj(x).reshape(b, s, self.kv_heads, d)
        # v is not rotated in llama
        if not isinstance(cache, PagedCache):
            past_k, past_v = (None, None) if cache is None else cache
            off = 0 if past_k is None else past_k.shape[1]
            q, k = fused_rotary_position_embedding(q, k, theta=self._theta,
                                                   pos_offset=off)
            if past_k is not None:
                k = torch.cat([past_k, k], dim=1)
                v = torch.cat([past_v, v], dim=1)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            out = self.o_proj(out.reshape(b, s, e))
            return out if cache is None else (out, (k, v))
        q, k = fused_rotary_position_embedding(
            q, k, theta=self._theta,
            position_ids=_positions(pos_offset, s, x.device))
        slt = (cache.new_lens if cache.new_lens is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        if cache.key_scale is not None:
            # int8 pool: payloads and per-token scales thread through
            # together (quantize on write, dequantize on read)
            out, kc, ks, vc, vs = block_grouped_query_attention_quant(
                q, k, v, cache.key_cache, cache.key_scale,
                cache.value_cache, cache.value_scale, cache.seq_lens, slt,
                block_tables=cache.block_tables)
            new_cache = PagedCache(kc, vc, cache.block_tables,
                                   cache.seq_lens + slt, key_scale=ks,
                                   value_scale=vs)
        else:
            out, kc, vc = block_grouped_query_attention(
                q, k, v, cache.key_cache, cache.value_cache,
                cache.seq_lens, slt, block_tables=cache.block_tables)
            new_cache = PagedCache(kc, vc, cache.block_tables,
                                   cache.seq_lens + slt)
        return self.o_proj(out.reshape(b, s, e)), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.gate_proj = Linear(h, f, bias_attr=False, **factory)
        self.up_proj = Linear(h, f, bias_attr=False, **factory)
        self.down_proj = Linear(f, h, bias_attr=False, **factory)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps,
                                            **factory)
        self.self_attn = LlamaAttention(cfg, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_eps, **factory)
        self.mlp = LlamaMLP(cfg, **factory)
        self._recompute = cfg.recompute

    def _inner(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, cache=None, pos_offset=0):
        if cache is not None:
            a, new_cache = self.self_attn(self.input_layernorm(x),
                                          cache=cache, pos_offset=pos_offset)
            x = x + a
            return x + self.mlp(self.post_attention_layernorm(x)), new_cache
        if self._recompute and self.training:
            return recompute(self._inner, x)
        return self._inner(x)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, **factory) for _ in range(cfg.num_layers)])
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_eps, **factory)
        _llama_init(self, cfg, factory.get("generator"))

    def forward(self, input_ids, caches=None, pos_offset=0):
        """No caches (training): returns the final-norm hidden [B, S, E].
        Per-layer dense (k, v) or paged caches (generation, serving):
        returns (hidden, the per-layer caches advanced by this call)."""
        x = self.embed_tokens(input_ids)
        if caches is None:
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)
        new_caches = []
        for layer, c in zip(self.layers, caches):
            x, nc = layer(x, cache=c, pos_offset=pos_offset)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    """Llama with an untied lm_head. ``device`` defaults to the card (and
    raises without one); ``generator`` (default: seed 0 on ``device``)
    draws the initial weights."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = new_generator(0, device)
        factory = dict(device=device, dtype=dtype, generator=generator)
        self.llama = LlamaModel(cfg, **factory)
        self.cfg = cfg
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              bias_attr=False, **factory)
        # the untied head follows the body's N(0, 0.02) scheme
        I.Normal(mean=0.0, std=0.02)(self.lm_head.weight, generator)
        name_parameters(self)

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V] of the untied lm_head; with ``labels`` [B, S],
        (logits, mean cross-entropy loss)."""
        logits = self.lm_head(self.llama(input_ids))
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        return logits, loss

    def generate(self, input_ids, max_new_tokens: int = 20,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id=None,
                 use_paged_kv: bool = False, kv_block_size: int = 64,
                 aot: bool = True, seed: int = 0, speculative=None):
        """Greedy (or sampled) decoding. By default an eager loop over a
        dense per-layer (k, v) cache: one prefill, then one-token steps
        (rope at the cached position). ``use_paged_kv`` runs the same
        loop over the block-table pool, and with ``aot`` (the default)
        the paged GenerationSession instead (inference.serving
        aot_generate). Greedy tokens are the same on all three paths;
        ``seed`` seeds the sampling draws of each. ``speculative``
        needs the paged session."""
        from ..inference.serving import aot_generate, eager_generate

        if use_paged_kv and aot:
            return aot_generate(
                self, input_ids, max_new_tokens, kv_block_size=kv_block_size,
                do_sample=do_sample, temperature=temperature, top_k=top_k,
                top_p=top_p, eos_token_id=eos_token_id, seed=seed,
                speculative=speculative)
        if speculative is not None:
            raise ValueError(
                "speculative decoding runs on the AOT serving path: "
                "pass use_paged_kv=True (with aot=True)")
        return eager_generate(
            self, input_ids, max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, use_paged_kv=use_paged_kv,
            kv_block_size=kv_block_size, seed=seed)


def _llama_init(model: nn.Module, cfg: LlamaConfig, generator):
    """N(0, 0.02) weights with residual-scaled output projections."""
    normal = I.Normal(mean=0.0, std=0.02)
    resid = I.Normal(mean=0.0, std=0.02 / math.sqrt(2 * cfg.num_layers))
    for name, p in model.named_parameters():
        if p.dim() < 2:
            continue
        if name.endswith(("o_proj.weight", "down_proj.weight")):
            resid(p, generator)
        else:
            normal(p, generator)


__all__ = ["LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel", "LlamaRMSNorm",
           "llama2_7b", "llama_tiny"]
