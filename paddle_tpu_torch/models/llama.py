"""Llama-family decoder for paged-KV serving: RMSNorm pre-norms, rotary
embeddings, grouped-query attention, SwiGLU MLP. Counterpart of
paddle_tpu/models/llama.py, cut to the paged-cache serving path.

Every norm runs the RMSNorm kernel through fused_rms_norm. Parameter
names and layouts are the JAX package's, so its state_dict loads name
for name (bridge.load_jax_state).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.generator import seed as _seed
from ..core.place import resolve_device
from ..incubate.nn.functional.fused_ops import (
    fused_rms_norm, fused_rotary_position_embedding, swiglu)
from ..incubate.nn.functional.paged_kv import (
    PagedCache, block_grouped_query_attention)
from ..nn import initializer as I
from ..nn.layer import Embedding, Linear
from ..nn.layer.common import new_parameter


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

    def forward(self, x, cache: PagedCache, pos_offset=0):
        """Paged serving: each sequence's tokens are rotated at its own
        cached position (``pos_offset`` is a per-sequence [B] vector in
        decode). Returns (out, the cache advanced by this call)."""
        if not isinstance(cache, PagedCache):
            raise NotImplementedError(
                "LlamaAttention: only the paged-cache serving path is ported")
        b, s, e = x.shape
        d = self.head_dim
        q = self.q_proj(x).reshape(b, s, self.num_heads, d)
        k = self.k_proj(x).reshape(b, s, self.kv_heads, d)
        v = self.v_proj(x).reshape(b, s, self.kv_heads, d)
        # v is not rotated in llama
        q, k = fused_rotary_position_embedding(
            q, k, theta=self._theta,
            position_ids=_positions(pos_offset, s, x.device))
        slt = (cache.new_lens if cache.new_lens is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        out, kc, vc = block_grouped_query_attention(
            q, k, v, cache.key_cache, cache.value_cache, cache.seq_lens, slt,
            block_tables=cache.block_tables)
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

    def forward(self, x, cache, pos_offset=0):
        a, new_cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                      pos_offset=pos_offset)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


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
        """Paged-cache forward: returns (final-norm hidden [B, S, E], the
        per-layer caches advanced by this call)."""
        if caches is None:
            raise NotImplementedError(
                "LlamaModel: the no-cache (training) forward is not ported")
        x = self.embed_tokens(input_ids)
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
            generator = _seed(0, device)
        factory = dict(device=device, dtype=dtype, generator=generator)
        self.llama = LlamaModel(cfg, **factory)
        self.cfg = cfg
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              bias_attr=False, **factory)
        # the untied head follows the body's N(0, 0.02) scheme
        I.Normal(mean=0.0, std=0.02)(self.lm_head.weight, generator)

    def forward(self, input_ids, labels=None):
        raise NotImplementedError(
            "LlamaForCausalLM.forward (training / no-cache) is not ported; "
            "serve with generate(use_paged_kv=True)")

    def generate(self, input_ids, max_new_tokens: int = 20,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id=None,
                 use_paged_kv: bool = False, kv_block_size: int = 64,
                 aot: bool = True, seed: int = 0, speculative=None):
        """Greedy (or sampled) decoding through the paged-KV
        GenerationSession. Only ``use_paged_kv=True`` is ported."""
        from ..inference.serving import aot_generate

        if not use_paged_kv or not aot:
            raise NotImplementedError(
                "only generate(use_paged_kv=True, aot=True) is ported")
        return aot_generate(
            self, input_ids, max_new_tokens, kv_block_size=kv_block_size,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token_id=eos_token_id, seed=seed,
            speculative=speculative)


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
