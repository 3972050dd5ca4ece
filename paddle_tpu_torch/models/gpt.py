"""GPT-style decoder LM for paged-KV serving. Counterpart of
paddle_tpu/models/gpt.py, cut to the non-tensor-parallel paged-cache
serving path.

Every LayerNorm runs the LayerNorm kernel through nn.functional
layer_norm. Parameter names and layouts are the JAX package's (the
packed qkv weight is [E, 3E]), so its state_dict loads name for name
(bridge.load_jax_state).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.generator import seed as _seed
from ..core.place import resolve_device
from ..incubate.nn.functional.paged_kv import (PagedCache,
                                               block_multihead_attention)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from .llama import _positions


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0  # 0 -> 4*hidden
    dropout: float = 0.0
    # model-parallel variants of the JAX package: not ported (raise)
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    segment_parallel: bool = False

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


def gpt3_1p3b(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_seq_len=2048, **kw)


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, max_seq_len=128, **kw)


def _gpt_init(model: nn.Module, cfg: GPTConfig, generator):
    """GPT-2-style init: N(0, 0.02) for weight matrices (scaled residual
    projections), zeros for biases, norms left at their defaults."""
    normal = I.Normal(mean=0.0, std=0.02)
    resid = I.Normal(mean=0.0, std=0.02 / math.sqrt(2 * cfg.num_layers))
    zero = I.Constant(0.0)
    for name, p in model.named_parameters():
        if name.endswith(".bias") or ".ln" in name or "norm" in name.lower():
            continue
        if "proj" in name or "fc2" in name:
            resid(p, generator)
        elif p.dim() >= 2 or "wte" in name or "wpe" in name:
            normal(p, generator)
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            zero(p)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **factory)
        self.proj = Linear(cfg.hidden_size, cfg.hidden_size, **factory)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache: PagedCache):
        """Paged serving: the packed [B, S, 3E] projection reshaped to
        [B, S, 3, H, D]. Returns (out, the cache advanced by this call)."""
        if not isinstance(cache, PagedCache):
            raise NotImplementedError(
                "GPTAttention: only the paged-cache serving path is ported")
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        slt = (cache.new_lens if cache.new_lens is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        out, _, kc, vc = block_multihead_attention(
            qkv, cache.key_cache, cache.value_cache, None, cache.seq_lens,
            slt, block_tables=cache.block_tables)
        new_cache = PagedCache(kc, vc, cache.block_tables,
                               cache.seq_lens + slt)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.dropout(self.proj(out)), new_cache


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_size, **factory)
        self.fc2 = Linear(cfg.ffn_size, cfg.hidden_size, **factory)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x))))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, **factory)
        self.attn = GPTAttention(cfg, **factory)
        self.ln2 = LayerNorm(cfg.hidden_size, **factory)
        self.mlp = GPTMLP(cfg, **factory)

    def forward(self, x, cache):
        a, new_cache = self.attn(self.ln1(x), cache=cache)
        x = x + a
        return x + self.mlp(self.ln2(x)), new_cache


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, **factory):
        super().__init__()
        for flag in ("tensor_parallel", "sequence_parallel",
                     "segment_parallel"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"GPTConfig.{flag} is not ported")
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size, **factory)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **factory)
                                     for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, **factory)
        _gpt_init(self, cfg, factory.get("generator"))

    def forward(self, input_ids, caches=None, pos_offset=0):
        """Paged-cache forward; ``pos_offset`` is a scalar or a
        per-sequence [B] vector. Returns (final-norm hidden [B, S, E], the
        per-layer caches advanced by this call)."""
        if caches is None:
            raise NotImplementedError(
                "GPTModel: the no-cache (training) forward is not ported")
        s = input_ids.shape[1]
        pos = _positions(pos_offset, s, input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, nc = blk(x, cache=cache)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    """GPT with the unembedding tied to wte. ``device`` defaults to the
    card (and raises without one); ``generator`` (default: seed 0 on
    ``device``) draws the initial weights."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = _seed(0, device)
        self.gpt = GPTModel(cfg, device=device, dtype=dtype,
                            generator=generator)
        self.cfg = cfg

    def forward(self, input_ids, labels=None):
        raise NotImplementedError(
            "GPTForCausalLM.forward (training / no-cache) is not ported; "
            "serve with generate(use_paged_kv=True)")

    def generate(self, input_ids, max_new_tokens: int = 20,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id=None,
                 use_cache: bool = True, use_paged_kv: bool = False,
                 kv_block_size: int = 64, aot: bool = True, seed: int = 0,
                 speculative=None):
        """Greedy (or sampled) decoding through the paged-KV
        GenerationSession. Only ``use_paged_kv=True`` is ported."""
        from ..inference.serving import aot_generate

        if not (use_paged_kv and aot and use_cache):
            raise NotImplementedError(
                "only generate(use_paged_kv=True, aot=True) is ported")
        return aot_generate(
            self, input_ids, max_new_tokens, kv_block_size=kv_block_size,
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token_id=eos_token_id, seed=seed,
            speculative=speculative)


__all__ = ["GPTAttention", "GPTBlock", "GPTConfig", "GPTForCausalLM",
           "GPTMLP", "GPTModel", "gpt3_1p3b", "gpt_tiny"]
