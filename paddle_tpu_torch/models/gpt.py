"""GPT-style decoder LM: training, generation and paged-KV serving.
Counterpart of paddle_tpu/models/gpt.py, cut to the non-tensor-parallel
paths: the no-cache forward (training; ``GPTForCausalLM.forward(ids,
labels)``), the dense (k, v) tuple cache of the default generate(), and
the paged-cache serving path.

Every LayerNorm runs the LayerNorm kernels (forward and backward) through
nn.functional layer_norm; training attention runs the flash kernels over
the packed [B, S, 3E] projection (flash_attention_packed: native layout,
or head-major on FLAGS_flash_native_layout=0), or, with
FLAGS_use_fused_attention, the whole block as one op
(fused_self_attention: einsum projections around the head-major
kernels). Parameter names and layouts are the JAX package's (the packed
qkv weight is [E, 3E]), so its state_dict loads name for name
(bridge.load_jax_state), and each parameter carries that name as
``.param_name`` (the key of its optimizer state). ``recompute=True`` recomputes
each block in the backward while training (distributed.fleet.recompute).
The dense-cache path splits the packed projection into q, k, v views and
takes scaled_dot_product_attention to the native-layout flash kernel (a
decode step is one query row against the whole cache). Not ported
(raise): the model-parallel variants.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.flags import get_flag
from ..core.generator import new_generator
from ..core.place import resolve_device
from ..distributed.fleet import recompute
from ..incubate.nn.functional.flash_attention import (flash_attention_packed,
                                                      fused_self_attention)
from ..incubate.nn.functional.paged_kv import (
    PagedCache, block_multihead_attention, block_multihead_attention_quant)
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from ..nn.layer.common import name_parameters
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
    recompute: bool = False   # recompute each block in the backward
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

    def forward(self, x, cache=None):
        """No cache (training): the packed [B, S, 3E] projection feeds the
        flash kernels as is, or with FLAGS_use_fused_attention the whole
        block runs as one fused op; returns out. Dense ``(k, v)`` cache
        (``(None, None)`` before the prompt): the projection's q, k, v
        views, this call's k/v appended to the cache's, causal attention
        aligned bottom-right; returns (out, the grown (k, v)). Paged
        serving: the projection reshaped to [B, S, 3, H, D]; returns (out,
        the cache advanced by this call)."""
        if cache is None:
            if get_flag("use_fused_attention"):
                out = fused_self_attention(
                    x, self.qkv.weight, self.qkv.bias, self.proj.weight,
                    self.proj.bias, self.num_heads, causal=True)
                return self.dropout(out)
            out = flash_attention_packed(self.qkv(x), self.num_heads,
                                         causal=True)
            return self.dropout(self.proj(out))
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        if not isinstance(cache, PagedCache):
            q, k, v = (qkv[:, :, i] for i in range(3))
            past_k, past_v = cache
            if past_k is not None:
                k = torch.cat([past_k, k], dim=1)
                v = torch.cat([past_v, v], dim=1)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            out = out.reshape(b, s, self.num_heads * self.head_dim)
            return self.dropout(self.proj(out)), (k, v)
        slt = (cache.new_lens if cache.new_lens is not None
               else torch.full((b,), s, dtype=torch.int32, device=x.device))
        if cache.key_scale is not None:
            # int8 pool: payloads and per-token scales thread through
            # together (quantize on write, dequantize on read)
            out, kc, ks, vc, vs = block_multihead_attention_quant(
                qkv, cache.key_cache, cache.key_scale, cache.value_cache,
                cache.value_scale, cache.seq_lens, slt,
                block_tables=cache.block_tables)
            new_cache = PagedCache(kc, vc, cache.block_tables,
                                   cache.seq_lens + slt, key_scale=ks,
                                   value_scale=vs)
        else:
            out, _, kc, vc = block_multihead_attention(
                qkv, cache.key_cache, cache.value_cache, None,
                cache.seq_lens, slt, block_tables=cache.block_tables)
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
        self._recompute = cfg.recompute

    def _inner(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def forward(self, x, cache=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache)
            x = x + a
            return x + self.mlp(self.ln2(x)), new_cache
        if self._recompute and self.training:
            return recompute(self._inner, x)
        return self._inner(x)


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
        """No caches (training): returns the final-norm hidden [B, S, E].
        Per-layer dense (k, v) or paged caches (generation, serving;
        ``pos_offset`` the cached length, a scalar or a per-sequence [B]
        vector): returns (hidden, the per-layer caches advanced by this
        call)."""
        pos = _positions(0 if caches is None else pos_offset,
                         input_ids.shape[1], input_ids.device)
        if caches is not None:
            # the pad columns of a right-padded serving buffer (a slot
            # riding an admit with one token, a dead row) may sit past
            # the table; JAX's take fills them with NaN, a gather on a
            # card would fault. Only pad rows can get here: submit()
            # bounds every real token below max_seq_len
            pos = torch.clamp(pos, max=self.cfg.max_seq_len - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        if caches is None:
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)
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
            generator = new_generator(0, device)
        self.gpt = GPTModel(cfg, device=device, dtype=dtype,
                            generator=generator)
        self.cfg = cfg
        name_parameters(self)

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V] of the tied unembedding (hidden @ wte^T); with
        ``labels`` [B, S], (logits, mean cross-entropy loss)."""
        hidden = self.gpt(input_ids)
        logits = F.matmul(hidden, self.gpt.wte.weight, transpose_y=True)
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
        return logits, loss

    def generate(self, input_ids, max_new_tokens: int = 20,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token_id=None,
                 use_cache: bool = True, use_paged_kv: bool = False,
                 kv_block_size: int = 64, aot: bool = True, seed: int = 0,
                 speculative=None):
        """Greedy (or sampled) decoding. By default an eager loop over a
        dense per-layer (k, v) cache: one prefill over the prompt, then
        one-token steps attending over the cached prefix.
        ``use_cache=False`` runs the full no-cache forward over the
        growing sequence at every step; ``use_paged_kv`` runs the loop
        over the block-table pool, and with ``aot`` (the default) the
        paged GenerationSession instead (inference.serving
        aot_generate). Greedy tokens are the same on every path; ``seed``
        seeds the sampling draws of each (the JAX package's eager loop
        draws from its global generator). ``speculative`` needs the paged
        session."""
        from ..inference.serving import aot_generate, eager_generate

        if use_paged_kv and aot and use_cache:
            return aot_generate(
                self, input_ids, max_new_tokens, kv_block_size=kv_block_size,
                do_sample=do_sample, temperature=temperature, top_k=top_k,
                top_p=top_p, eos_token_id=eos_token_id, seed=seed,
                speculative=speculative)
        if speculative is not None:
            raise ValueError(
                "speculative decoding runs on the AOT serving path: "
                "pass use_paged_kv=True, aot=True (and use_cache=True)")
        return eager_generate(
            self, input_ids, max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, use_cache=use_cache,
            use_paged_kv=use_paged_kv, kv_block_size=kv_block_size,
            seed=seed)


__all__ = ["GPTAttention", "GPTBlock", "GPTConfig", "GPTForCausalLM",
           "GPTMLP", "GPTModel", "gpt3_1p3b", "gpt_tiny"]
