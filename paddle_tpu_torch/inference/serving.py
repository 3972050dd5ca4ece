"""Paged-KV serving for causal LMs: one prefill, then a greedy (or
sampled) decode over the block-table KV pool. Counterpart of the
GenerationSession path of paddle_tpu/inference/serving.py.

Where the JAX package compiles a prefill executable and ONE scanned
decode executable, the port runs the same model code eagerly: the decode
``lax.scan`` is a Python loop, and the pools the JAX package donates
into its decode executable are updated in place. Token selection stays
on the card, so the loop never waits for the host until the tokens are
returned.

Speculative decoding, LoRA, quantized weights and quantized pools are
not ported: asking for them raises NotImplementedError.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core.flags import env_int
from ..incubate.nn.functional.paged_kv import PagedCache, alloc_block_tables

__all__ = ["GenerationSession", "ModelAdapter", "aot_generate",
           "get_model_adapter", "make_run_model", "mask_logits",
           "sample_logits"]


def _reject_unported(speculative=None, lora=None, quantize_weights=None,
                     kv_dtype=None):
    """Raise NotImplementedError for a serving feature the port lacks.
    ``False``/"none" for the quantization knobs mean off, as in the JAX
    package."""
    asked = [name for name, v in (("speculative", speculative),
                                  ("lora", lora)) if v is not None]
    asked += [name for name, v in (("quantize_weights", quantize_weights),
                                   ("kv_dtype", kv_dtype))
              if v not in (None, False, "", "none")]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)} serving is not ported to paddle_tpu_torch")


class ModelAdapter:
    """Uniform serving view of a causal LM: a paged-cache backbone, an
    unembedding, and the cache geometry. The session is written against
    this interface only: it does not know whether logits are weight-tied
    (GPT) or a separate lm_head (Llama), nor how many kv heads the pools
    carry (GQA pools hold only the shared heads)."""

    __slots__ = ("backbone", "logits", "num_layers", "kv_heads",
                 "head_dim", "max_seq_len", "dtype", "device")

    def __init__(self, backbone, logits, num_layers, kv_heads, head_dim,
                 max_seq_len, dtype, device):
        self.backbone = backbone      # (ids, caches=, pos_offset=) -> (h, caches)
        self.logits = logits          # (hidden [B, E]) -> [B, V]
        self.num_layers = num_layers
        self.kv_heads = kv_heads      # heads in the PAGED POOL (GQA: shared)
        self.head_dim = head_dim
        self.max_seq_len = max_seq_len
        self.dtype = dtype            # pool dtype
        self.device = device          # where the pools and tokens live


def get_model_adapter(model) -> ModelAdapter:
    """Adapter for the known model families."""
    cfg = model.cfg
    if hasattr(model, "gpt"):        # GPTForCausalLM: tied unembedding
        w = model.gpt.wte.weight
        return ModelAdapter(
            backbone=model.gpt,
            logits=lambda h: torch.matmul(h, model.gpt.wte.weight.t()),
            num_layers=cfg.num_layers, kv_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            max_seq_len=cfg.max_seq_len, dtype=w.dtype, device=w.device)
    if hasattr(model, "llama"):      # LlamaForCausalLM: untied lm_head
        w = model.llama.embed_tokens.weight
        return ModelAdapter(
            backbone=model.llama, logits=model.lm_head,
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            max_seq_len=cfg.max_seq_len, dtype=w.dtype, device=w.device)
    raise TypeError(
        f"no serving adapter for {type(model).__name__}: expose .gpt or "
        f".llama")


def make_run_model(model, adapter):
    """The forward shared by prefill and decode: one pass of the real
    model over the paged pools (updated in place), in eval mode, under
    inference_mode. Returns (last-position logits fp32 [B, V], kcs, vcs,
    seq_lens'). ``new_lens``: per-sequence valid token counts (ragged
    prompts; masks reads and the seq_lens advance, never the writes);
    ``last_idx``: per-sequence index of the position whose logits to
    return (None = the final position)."""

    def run_model(tok_ids, kcs, vcs, bt, seq_lens, pos, new_lens=None,
                  last_idx=None):
        was_training = model.training
        if was_training:
            model.eval()
        try:
            with torch.inference_mode():
                caches = [PagedCache(kc, vc, bt, seq_lens, new_lens)
                          for kc, vc in zip(kcs, vcs)]
                hidden, ncaches = adapter.backbone(tok_ids, caches=caches,
                                                   pos_offset=pos)
                if last_idx is None:
                    h_last = hidden[:, -1]
                else:
                    idx = last_idx.to(torch.int64)[:, None, None].expand(
                        -1, 1, hidden.shape[-1])
                    h_last = torch.gather(hidden, 1, idx)[:, 0]
                lv = adapter.logits(h_last).float()
        finally:
            if was_training:
                model.train()
        return (lv, tuple(c.key_cache for c in ncaches),
                tuple(c.value_cache for c in ncaches), ncaches[0].seq_lens)

    return run_model


def mask_logits(lv, temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0):
    """Temperature, then top-k and top-p masking (to -inf) of fp32 logits
    [B, V]: the rules the JAX package's sample_logits applies before its
    categorical draw."""
    lv = lv / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(lv, top_k, dim=-1).values[:, -1:]
        lv = lv.masked_fill(lv < kth, float("-inf"))
    if top_p < 1.0:
        sorted_lv = torch.sort(lv, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lv, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # clamped as JAX clamps a gather index: all of cum < top_p can
        # only happen by rounding, and then nothing is cut
        cutoff_idx = torch.clamp((cum < top_p).sum(dim=-1, keepdim=True),
                                 max=lv.shape[-1] - 1)
        cutoff = torch.gather(sorted_lv, -1, cutoff_idx)
        lv = lv.masked_fill(lv < cutoff, float("-inf"))
    return lv


def sample_logits(lv, generator, do_sample: bool, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Next-token selection from fp32 logits [B, V]: argmax, or a
    categorical draw (Gumbel-max with ``generator``) from the masked
    logits. A draw matches the JAX package's in distribution, not bit for
    bit; one seed gives one stream within the port."""
    if not do_sample:
        return torch.argmax(lv, dim=-1)
    lv = mask_logits(lv, temperature, top_k, top_p)
    u = torch.rand(lv.shape, generator=generator, device=lv.device,
                   dtype=torch.float32)
    return torch.argmax(lv - torch.log(-torch.log(u)), dim=-1)


class GenerationSession:
    """Prefill + decode for one causal-LM model and one (batch,
    prompt_len, n_new) shape class, reused across requests.

    The model is seen through its ModelAdapter: GPT's tied-wte logits,
    Llama's untied lm_head and GQA pools. The tokens and pools live on the
    model's device.
    """

    def __init__(self, model, batch: int, prompt_len: int,
                 max_new_tokens: int, kv_block_size: int = 64,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 ragged_prompts: bool = False,
                 prefix_sharing: bool = True,
                 speculative=None, lora=None,
                 quantize_weights=None, kv_dtype=None):
        _reject_unported(speculative, lora, quantize_weights, kv_dtype)
        adapter = get_model_adapter(model)
        if prompt_len + max_new_tokens > adapter.max_seq_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = "
                f"{prompt_len + max_new_tokens} exceeds max_seq_len "
                f"{adapter.max_seq_len}")
        self.model = model
        self.batch = batch
        self.prompt_len = prompt_len
        self.n_new = max_new_tokens
        self.eos_token_id = eos_token_id
        self._sampling = (bool(do_sample), float(temperature), int(top_k),
                          float(top_p))
        # batch-repeated prompt: prefill ONCE at batch 1 and share the
        # prefix blocks across every row's table
        self.prefix_sharing = bool(prefix_sharing)
        # ragged mode: prompts right-padded to prompt_len, per-sequence
        # real lengths masked through the paged attention
        self.ragged = ragged_prompts
        self._device = adapter.device
        bt, nblocks = alloc_block_tables(batch, adapter.max_seq_len,
                                         kv_block_size, device=self._device)
        self._bt_dev = bt
        self._bt_host = bt.cpu().numpy()
        self._cache_shape = (nblocks, adapter.kv_heads, kv_block_size,
                             adapter.head_dim)
        self._cache_dtype = adapter.dtype
        self._kv_block_size = kv_block_size
        self._n_layers = adapter.num_layers
        self._run_model = make_run_model(model, adapter)
        self._shared_plan = None      # lazy: repeated-prompt path

    def _fresh_pools(self):
        """Zeroed K and V pools, one per layer, for one request."""
        def side():
            return tuple(torch.zeros(self._cache_shape,
                                     dtype=self._cache_dtype,
                                     device=self._device)
                         for _ in range(self._n_layers))
        return side(), side()

    def _select(self, lv, generator, done):
        """Token selection on the card; rows that emitted eos keep
        emitting it."""
        nxt = sample_logits(lv, generator, *self._sampling).to(torch.int32)
        if self.eos_token_id is not None:
            nxt = torch.where(done, self.eos_token_id, nxt)
            done = done | (nxt == self.eos_token_id)
        return nxt, done

    def _prefill(self, ids, lens, generator):
        kcs, vcs = self._fresh_pools()
        seq_lens = torch.zeros((self.batch,), dtype=torch.int32,
                               device=self._device)
        lv, kcs, vcs, seq_lens = self._run_model(
            ids, kcs, vcs, self._bt_dev, seq_lens, 0,
            new_lens=lens if self.ragged else None,
            last_idx=lens - 1 if self.ragged else None)
        done = torch.zeros((self.batch,), dtype=torch.bool,
                           device=self._device)
        tok, done = self._select(lv, generator, done)
        return tok, kcs, vcs, seq_lens, done, self._bt_dev

    def _shared_prefill_plan(self):
        """(aliased table, CoW source block, CoW destination blocks) of the
        batch-repeated-prompt path, built once: every row's table points
        at row 0's full prefix blocks, and the partially filled tail block
        (if any) is copied to each row's own block so decode appends never
        touch the shared blocks. The JAX package aims out-of-pool
        destinations at the sentinel ``nb`` and drops them in the scatter;
        here they are dropped on the host, before any index reaches the
        card."""
        if self._shared_plan is None:
            bs = self._kv_block_size
            nb = self._cache_shape[0]
            k0 = self.prompt_len // bs
            bt_np = self._bt_host.copy()
            bt_np[1:, :k0] = bt_np[0:1, :k0]
            cow_dst = np.full((self.batch,), nb, np.int64)
            cow_src = nb
            if self.prompt_len % bs:
                cow_src = int(bt_np[0, k0])
                cow_dst[1:] = bt_np[1:, k0]
            cow_dst = cow_dst[cow_dst < nb]
            self._shared_plan = (
                torch.as_tensor(bt_np, device=self._device),
                min(cow_src, nb - 1),
                torch.as_tensor(cow_dst, device=self._device))
        return self._shared_plan

    def _prefill_shared(self, ids, generator):
        """Batch-1 prefill over row 0's blocks; the last-position logits
        are broadcast to every row for (independent) selection."""
        bt_dev, cow_src, cow_dst = self._shared_prefill_plan()
        kcs, vcs = self._fresh_pools()
        lv, kcs, vcs, _ = self._run_model(
            ids[:1], kcs, vcs, bt_dev[:1],
            torch.zeros((1,), dtype=torch.int32, device=self._device), 0)
        if cow_dst.numel():
            with torch.inference_mode():
                for c in kcs + vcs:
                    c[cow_dst] = c[cow_src].clone()      # in place
        lvb = lv.expand(self.batch, -1)
        done = torch.zeros((self.batch,), dtype=torch.bool,
                           device=self._device)
        tok, done = self._select(lvb, generator, done)
        seq_lens = torch.full((self.batch,), self.prompt_len,
                              dtype=torch.int32, device=self._device)
        return tok, kcs, vcs, seq_lens, done, bt_dev

    def generate(self, input_ids, seed: int = 0, prompt_lens=None,
                 adapters=None):
        """Run one request. Fixed mode: prompt [B, prompt_len] ->
        [B, prompt_len + n_new] token ids. Ragged mode (built with
        ragged_prompts=True): prompts right-padded to prompt_len with the
        real lengths in ``prompt_lens``; returns just the generated tokens
        [B, n_new]. Tokens come back on the session's device in the
        caller's id dtype. ``seed`` seeds the draw of a sampled session."""
        if adapters is not None:
            raise ValueError(
                "this session was built without lora=; adapters is only "
                "meaningful for LoRA sessions")
        ids_in = torch.as_tensor(input_ids)
        out_dtype = ids_in.dtype
        ids_host = ids_in.cpu().numpy()
        if ids_host.shape != (self.batch, self.prompt_len):
            raise ValueError(
                f"this session serves shape ({self.batch}, "
                f"{self.prompt_len}); got {ids_host.shape}")
        ids = ids_in.to(device=self._device, dtype=torch.int64)
        if self.ragged:
            if prompt_lens is None:
                raise ValueError("ragged session needs prompt_lens")
            lens_np = np.asarray(torch.as_tensor(prompt_lens).cpu())
            if lens_np.shape != (self.batch,) or (lens_np < 1).any() \
                    or (lens_np > self.prompt_len).any():
                raise ValueError(
                    f"prompt_lens must be [{self.batch}] values in "
                    f"[1, {self.prompt_len}]; got {lens_np}")
            lens = torch.as_tensor(lens_np, dtype=torch.int32,
                                   device=self._device)
        else:
            if prompt_lens is not None:
                raise ValueError(
                    "this session was built without ragged_prompts=True; "
                    "prompt_lens is only meaningful for ragged sessions")
            lens = None
        generator = torch.Generator(device=self._device)
        generator.manual_seed(int(seed))
        shared = (self.prefix_sharing and self.batch > 1 and not self.ragged
                  and bool((ids_host == ids_host[0:1]).all()))
        if shared:
            tok, kcs, vcs, seq_lens, done, bt = self._prefill_shared(
                ids, generator)
        else:
            tok, kcs, vcs, seq_lens, done, bt = self._prefill(
                ids, lens, generator)
        toks = [tok]
        for _ in range(self.n_new - 1):
            # the incoming token sits at each sequence's cached length
            lv, kcs, vcs, seq_lens = self._run_model(
                tok[:, None], kcs, vcs, bt, seq_lens, seq_lens)
            tok, done = self._select(lv, generator, done)
            toks.append(tok)
        gen = torch.stack(toks, dim=1).to(out_dtype)
        if self.ragged:
            return gen
        return torch.cat([ids.to(out_dtype), gen], dim=1)


def aot_generate(model, input_ids, max_new_tokens: int,
                 kv_block_size: int = 64, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id=None, seed: int = 0,
                 speculative=None, lora=None, adapters=None,
                 quantize_weights=None, kv_dtype=None):
    """Serve one generate() call through a per-model cache of
    GenerationSessions keyed by (shape, sampling) class. Output after
    every row has emitted eos is trimmed, as the JAX package's eager loop
    stops there. The cache keeps PADDLE_SERVING_SESSION_CACHE sessions
    per model (default 8), dropping the least recently served."""
    _reject_unported(speculative, lora, quantize_weights, kv_dtype)
    if adapters is not None:
        raise NotImplementedError("LoRA serving is not ported")
    adapter = get_model_adapter(model)
    b, prompt_len = input_ids.shape
    n_new = min(max_new_tokens, adapter.max_seq_len - prompt_len)
    if n_new <= 0:
        return input_ids
    key = (b, prompt_len, n_new, kv_block_size, do_sample, temperature,
           top_k, top_p, eos_token_id)
    cache = getattr(model, "_serving_sessions", None)
    if cache is None:
        cache = model._serving_sessions = collections.OrderedDict()
    sess = cache.get(key)
    if sess is None:
        sess = cache[key] = GenerationSession(
            model, batch=b, prompt_len=prompt_len, max_new_tokens=n_new,
            kv_block_size=kv_block_size, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id)
        cap = max(1, env_int("PADDLE_SERVING_SESSION_CACHE", 8))
        while len(cache) > cap:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    out = sess.generate(input_ids, seed=seed)
    if eos_token_id is not None:
        toks = out[:, prompt_len:].cpu().numpy()
        col_done = ((toks == eos_token_id).cumsum(axis=1) > 0).all(axis=0)
        if col_done.any():
            return out[:, :prompt_len + int(np.argmax(col_done)) + 1]
    return out
