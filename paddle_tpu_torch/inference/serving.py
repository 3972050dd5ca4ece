"""Paged-KV serving for causal LMs. Counterpart of
paddle_tpu/inference/serving.py: the GenerationSession path (one
prefill, then a greedy or sampled decode of one fixed batch) and the
continuous-batching core (ContinuousBatchingSession: a slot grid fed by
the scheduler, over a prefix-caching block pool).

Where the JAX package compiles a prefill executable and one scanned
decode executable, GenerationSession runs the same model code eagerly:
the decode ``lax.scan`` is a Python loop, and the pools the JAX package
donates into its decode executable are updated in place. Token selection
stays on the card, so the loop never waits for the host until the tokens
are returned. ``eager_generate`` is the models' default generate() loop
(a dense or paged cache, or none), as the JAX package runs it eagerly.

ContinuousBatchingSession keeps the reference's programs: the mixed
admit (prefill chunks beside one-token riders) at each token-buffer
width of its power-of-two ladder, and the pure-decode chunk (``chunk``
steps for every slot with token selection on the card). On a card each
is ONE CUDA graph, all in one shared memory pool: the chunk and the
admit at width max_prompt_len captured with the session (the JAX
package's pinned executables), each other admit width at its first use,
over static
buffers that the host refills with ``copy_`` before each replay (the
tokens, the new-token counts and prefix-hit boundaries, the live mask,
the block table and the cached lengths); copy-on-write block copies,
whose number varies, run eagerly before an admit's replay. The pools are
written in place and the host reads one token buffer back per dispatch.
The graphs read the weights by address: a weight replaced since the
capture is seen before the next replay, which re-captures. On the CPU
the same functions run eagerly. A capture that fails raises; nothing
falls back to eager admits or decode on a card.

The scheduler's overload paths are the reference's: chunked prefill
(``prefill_chunk``), request priorities and deadlines, preemption
(automatic under slot or block pressure, or forced by ``preempt()``)
with a re-prefill of the committed history through the prefix cache,
and a pool sized by bytes (``kv_pool_bytes``).

Speculative decoding (``speculative=``, inference/speculative/) runs in
both sessions and in ``aot_generate``: a proposer drafts up to k tokens a
row, and one verify program of the window's width scores them all. With
it on, ContinuousBatchingSession captures no decode chunk: each decode
step is one verify window whose graph also folds the acceptance and
rolls the lengths back on the card (device accept; host accept with
PADDLE_SPEC_DEVICE_ACCEPT=0); GenerationSession replaces its decode loop
with the host loop of propose, verify (its programs graphs too, over
pools it keeps), accept and rollback.

ContinuousBatchingSession runs the reference's default engine, the
overlapped one (``overlap=None``: on unless PADDLE_ENGINE_OVERLAP=0): a
pure-decode chunk or a verify window is left in flight when ``step()``
returns, and the next step harvests it, validates the plan it staged
against the predicted post-dispatch state, replays the next program from
that plan and only then does the harvested step's bookkeeping, so the
host's collect loops, metric commits and the next stage run while the
card computes (speculative windows stage with an n-gram proposer,
PADDLE_SPEC_STAGE_AHEAD). A mispredict drops the plan and replans; the
dispatches, and so the streams, are the sequential engine's.
``logprobs=True`` runs the sequential engine over raw-logits admits
(one CUDA graph a width): the device sampler's selection runs eagerly
after each replay from the session's generator, and each token's log
probability comes from the fp32 logits read back (``Request.token_logprobs``).

Quantized serving (``quantize_weights="int8"`` or ``"int4"``,
``kv_dtype="int8"``, or the PADDLE_SERVING_QUANT_WEIGHTS /
PADDLE_SERVING_QUANT_KV defaults) runs in all three entry points, with
speculation, logprobs and either engine. The selected backbone weights
(every Linear but the embeddings and the unembedding) are kept as int8
or packed int4 payloads with f32 scales in static buffers; inside each
program, every quantized Linear dequantizes its own weight just before
its product (``_WeightQuantState.applied``), so no graph holds the whole
dequantized image, and a weight that changed is re-quantized into the
same buffers at the next admission. An int8 pool side is a (payload,
per-token scale) pair everywhere a plain pool is a tensor: the graphs'
static pools, copy-on-write block copies, preemption and the prefix
cache. The model keeps its own parameters, whose addresses and versions
the weight checks read as before. With both knobs off the pools stay
plain tensors.

Not ported (NotImplementedError, ROADMAP queue A item 6): LoRA and the
hierarchical KV tier (with speculation or without).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import os
import time
import weakref
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..analysis.sanitizers import race_exempt, race_handoff, race_track
from ..core.flags import env_int, env_on
from ..incubate.nn.functional.paged_kv import (PagedCache,
                                               alloc_block_tables,
                                               init_block_cache,
                                               init_block_cache_quant)
from ..nn import Linear
from ..nn import functional as F
from ..quantization import dequantize_weight, quantize_weight_tree
from .scheduler import AdmissionRejected, InvalidRequest  # noqa: F401
from .speculative.verify import pow2_width
# (re-exported: submit() raises them; the Scheduler itself lives in
# scheduler.py and is reached via session.scheduler)

__all__ = ["AdmissionRejected", "ContinuousBatchingSession",
           "GenerationSession", "InvalidRequest", "ModelAdapter",
           "Request", "aot_generate", "eager_generate",
           "get_model_adapter",
           "make_run_model", "mask_logits", "sample_logits"]

UNPORTED = "is not ported to paddle_tpu_torch (ROADMAP queue A item 6)"


def _reject_unported(speculative=None, lora=None, kv_tier=None):
    """Raise NotImplementedError naming every serving feature asked for
    that the port lacks (with speculation on, "with speculative" names
    the combination). ``False``/"none" for ``kv_tier`` mean off, as in
    the JAX package."""
    asked = ["lora"] if lora is not None else []
    if kv_tier not in (None, False, "", "none"):
        asked.append("kv_tier")
    if asked:
        spec = " with speculative" if speculative is not None else ""
        raise NotImplementedError(f"{', '.join(asked)}{spec} {UNPORTED}")


# weight-only quantization leaves the embeddings and the unembedding in
# the model dtype: the logits head is the accuracy-critical product
_QUANT_EXCLUDE = ("wte", "wpe", "embed_tokens", "lm_head")
_QUANT_GROUP = 64          # int4 group size, shared by quantize + dequant


def _quant_weight_select(name, w):
    """Backbone matmul weights only (rank 2, not embedding/unembedding).
    Biases and norms are rank 1 and stay in the model dtype."""
    return w.ndim == 2 and not any(t in name for t in _QUANT_EXCLUDE)


def _resolve_quant_knobs(quantize_weights, kv_dtype):
    """Session quantization knobs with env defaults: ``None`` defers to
    PADDLE_SERVING_QUANT_WEIGHTS ("int8"/"int4") and
    PADDLE_SERVING_QUANT_KV ("int8"/"1"/"true"/"on"); ``False`` (or
    "none", "") forces a feature OFF whatever the environment says."""
    if quantize_weights is None:
        v = os.environ.get("PADDLE_SERVING_QUANT_WEIGHTS",
                           "").strip().lower()
        quantize_weights = v if v in ("int8", "int4") else None
    elif quantize_weights in (False, "", "none"):
        quantize_weights = None
    elif quantize_weights not in ("int8", "int4"):
        raise ValueError(
            f"quantize_weights must be None/'int8'/'int4'; got "
            f"{quantize_weights!r}")
    if kv_dtype is None:
        v = os.environ.get("PADDLE_SERVING_QUANT_KV", "").strip().lower()
        kv_dtype = "int8" if v in ("1", "int8", "true", "on") else None
    elif kv_dtype in (False, "", "none"):
        kv_dtype = None
    elif kv_dtype != "int8":
        raise ValueError(
            f"kv_dtype must be None or 'int8'; got {kv_dtype!r}")
    return quantize_weights, kv_dtype


class _WeightQuantState:
    """A session's weight-only quantization: the int8 (or packed int4)
    payload and f32 scales of every selected weight, on the model's
    device, in buffers that keep their addresses for the session's life
    (the graphs read them). Every selected weight is a ``Linear.weight``;
    the model keeps its own parameters.

    ``applied()`` is the context a forward of the session runs in: each
    quantized Linear's forward dequantizes its own weight
    (``dequantize_weight``, the reference's function) just before its
    product and drops it after, so one layer's temporary is live at a
    time. ``refresh()`` re-quantizes each weight whose address or
    ``_version`` moved INTO the same buffers (``copy_``)."""

    def __init__(self, model, mode: str):
        self.mode = mode                       # "int8" | "int4"
        self.bits = 8 if mode == "int8" else 4
        params = model.state_dict(keep_vars=True)
        mods = dict(model.named_modules())
        self._owners = {}
        for n in sorted(params):
            if not _quant_weight_select(n, params[n]):
                continue
            owner = mods.get(n.rpartition(".")[0])
            if not (n.endswith(".weight") and isinstance(owner, Linear)):
                raise TypeError(f"quantized weight {n} is not the weight "
                                f"of a Linear")
            self._owners[n] = owner
        qtree, scales = quantize_weight_tree(
            {n: m.weight for n, m in self._owners.items()}, bits=self.bits,
            group_size=_QUANT_GROUP, predicate=lambda n, w: True)
        self.qvals = {n: (qtree[n], scales[n]) for n in self._owners}
        # what dequantize_weight needs (int4 packing hides the row count)
        self.meta = {n: (int(m.weight.shape[0]), m.weight.dtype)
                     for n, m in self._owners.items()}
        self._stamps = {n: self._stamp(n) for n in self._owners}

    def _stamp(self, name):
        w = self._owners[name].weight
        return w.data_ptr(), w._version

    def refresh(self) -> bool:
        """Re-quantize every weight replaced or written since it was last
        quantized, into its payload and scale buffers; True if any was."""
        stale = [n for n in self._owners if self._stamp(n) != self._stamps[n]]
        if not stale:
            return False
        qtree, scales = quantize_weight_tree(
            {n: self._owners[n].weight for n in stale}, bits=self.bits,
            group_size=_QUANT_GROUP, predicate=lambda n, w: True)
        with torch.no_grad():
            for n in stale:
                self.qvals[n][0].copy_(qtree[n])
                self.qvals[n][1].copy_(scales[n])
                self._stamps[n] = self._stamp(n)
        return True

    def _forward(self, name, linear, x):
        q, scale = self.qvals[name]
        rows, dtype = self.meta[name]
        w = dequantize_weight(q, scale, dtype, rows=rows,
                              group_size=_QUANT_GROUP)
        return F.linear(x, w, linear.bias)

    @contextlib.contextmanager
    def applied(self):
        """Each quantized Linear computes from its payload while inside
        (an instance ``forward`` shadows the class's for the call)."""
        for n, m in self._owners.items():
            m.__dict__["forward"] = partial(self._forward, n, m)
        try:
            yield
        finally:
            for m in self._owners.values():
                m.__dict__.pop("forward", None)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for pair in self.qvals.values() for t in pair)


def _kv_zero_pool(cache_shape, dtype, n_layers, kv_quant, device):
    """One side's fresh pool, a tensor per layer, or with ``kv_quant`` an
    (int8 payload, f32 per-token scale) pair per layer."""
    if kv_quant:
        return tuple(init_block_cache_quant(*cache_shape, device=device)
                     for _ in range(n_layers))
    return tuple(torch.zeros(cache_shape, dtype=dtype, device=device)
                 for _ in range(n_layers))


def _pool_tensors(*sides):
    """Every tensor of the pool sides ``sides`` (tuples of per-layer
    tensors or (payload, scale) pairs). Each leads with the block dim, so
    a block copy or a zeroing applies to all of them alike."""
    return [t for side in sides for e in side
            for t in (e if isinstance(e, tuple) else (e,))]


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


def make_run_model(model, adapter, weights=None, kv_quant: bool = False):
    """The forward shared by prefill, decode and verify: one pass of the
    real model over the paged pools (updated in place), in eval mode,
    under inference_mode. Returns (last-position logits fp32 [B, V], kcs,
    vcs, seq_lens'). ``new_lens``: per-sequence valid token counts
    (ragged prompts; masks reads and the seq_lens advance, never the
    writes); ``last_idx``: per-sequence index of the position whose
    logits to return (None = the final position); ``all_logits=True``
    returns fp32 logits [B, S, V] at EVERY position of the token buffer
    instead, one unembedding over [B·S, E] (the speculative verifier
    scores a whole draft window in one dispatch).

    ``weights`` (a _WeightQuantState): the forward runs in its
    ``applied()`` context, each quantized Linear dequantizing its payload
    just before its product. ``kv_quant=True``: every kcs / vcs entry is
    an (int8 payload, f32 scale) pair, threaded through the models'
    int8 paged-attention branch and returned as pairs."""
    quant = contextlib.nullcontext if weights is None else weights.applied

    def run_model(tok_ids, kcs, vcs, bt, seq_lens, pos, new_lens=None,
                  last_idx=None, all_logits=False):
        was_training = model.training
        if was_training:
            model.eval()
        try:
            with torch.inference_mode(), quant():
                if kv_quant:
                    caches = [PagedCache(kc, vc, bt, seq_lens, new_lens,
                                         key_scale=ks, value_scale=vs)
                              for (kc, ks), (vc, vs) in zip(kcs, vcs)]
                else:
                    caches = [PagedCache(kc, vc, bt, seq_lens, new_lens)
                              for kc, vc in zip(kcs, vcs)]
                hidden, ncaches = adapter.backbone(tok_ids, caches=caches,
                                                   pos_offset=pos)
                if all_logits:
                    b, s = hidden.shape[:2]
                    lv = adapter.logits(hidden.reshape(b * s, -1)).float()
                    lv = lv.reshape(b, s, -1)
                else:
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
        if kv_quant:
            return (lv, tuple((c.key_cache, c.key_scale) for c in ncaches),
                    tuple((c.value_cache, c.value_scale) for c in ncaches),
                    ncaches[0].seq_lens)
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

    ``speculative`` (a SpeculativeConfig or its kwargs): the decode loop
    becomes the JAX package's host loop (``_spec_decode``): propose,
    verify every row's window in one program of the window's width
    (host accept: the argmax chain, or the logits of a sampled session),
    accept with ``greedy_accept`` / ``rejection_accept`` (a numpy rng
    seeded with the request's seed), roll the lengths back. The verify
    programs read pools, a table and lengths that the session keeps (the
    pools zeroed for each request), so on a card each width is one CUDA
    graph, captured at its first use.

    ``quantize_weights`` ("int8"/"int4") and ``kv_dtype`` ("int8"), with
    the environment's defaults (``_resolve_quant_knobs``): the backbone's
    Linears compute from quantized payloads, re-quantized at each
    ``generate`` when a weight changed, and the pools are (payload,
    scale) pairs (module docstring).
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
        from .speculative import resolve_speculative

        _reject_unported(speculative, lora)
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
        quantize_weights, kv_dtype = _resolve_quant_knobs(quantize_weights,
                                                          kv_dtype)
        self._quant_weights = quantize_weights
        self._kv_dtype = kv_dtype
        self._kv_quant = kv_dtype == "int8"
        self._wq = (None if quantize_weights is None
                    else _WeightQuantState(model, quantize_weights))
        self._run_model = make_run_model(model, adapter, weights=self._wq,
                                         kv_quant=self._kv_quant)
        self._shared_plan = None      # lazy: repeated-prompt path
        self._spec = resolve_speculative(speculative)
        self._proposer = self._verify_ladder = None
        if self._spec is not None:
            self._build_spec(model, adapter)

    def _build_spec(self, model, adapter):
        """The proposer, the pools, table and lengths the verify programs
        read (static: a graph reads them by address), and the ladder."""
        from .speculative import VerifyLadder, build_proposer

        dev, b = self._device, self.batch
        self._proposer = build_proposer(
            self._spec, rows=b, kv_block_size=self._kv_block_size,
            capacity=adapter.max_seq_len)
        self._spec_pools = self._zero_pools()
        self._spec_bt = self._bt_dev.clone()
        self._spec_seq = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._weight_dicts = [(m._parameters, m._buffers)
                              for m in model.modules()]
        self._spec_weights = weight_addresses(self._weight_dicts)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        do_sample, temperature, top_k, top_p = self._sampling
        self._verify_ladder = VerifyLadder(
            self._run_model, rows=b, cap=self._spec.num_draft_tokens + 1,
            device=dev,
            pools=lambda: (*self._spec_pools, self._spec_bt,
                           self._spec_seq),
            build=self._build_verify, greedy=not do_sample,
            sampling={"do_sample": do_sample, "temperature": temperature,
                      "top_k": top_k, "top_p": top_p},
            vocab=model.cfg.vocab_size)

    def _build_verify(self, body, w):
        return _GraphProgram(body, self._device, self._spec_null_inputs,
                             self._spec_weights, pool=self._graph_pool,
                             what=f"the verify program of width {w}")

    def _spec_null_inputs(self):
        """Context: every row dead and every table row the sentinel, so a
        verify capture's warm-up and recording write no pool byte; the
        table is put back on exit."""
        @contextlib.contextmanager
        def ctx():
            bt = self._spec_bt.clone()
            self._verify_ladder.new_lens.zero_()
            self._spec_bt.fill_(self._cache_shape[0])
            try:
                yield
            finally:
                self._spec_bt.copy_(bt)
        return ctx()

    def _zero_pools(self):
        def side():
            return _kv_zero_pool(self._cache_shape, self._cache_dtype,
                                 self._n_layers, self._kv_quant,
                                 self._device)
        return side(), side()

    def _fresh_pools(self):
        """Zeroed K and V pools, one per layer, for one request: new ones,
        or with speculation the session's own, zeroed in place."""
        if self._spec is None:
            return self._zero_pools()
        with torch.inference_mode():
            for c in _pool_tensors(*self._spec_pools):
                c.zero_()
        return self._spec_pools

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
                # payloads and scales alike: a copied block keeps its
                # per-token scales
                for c in _pool_tensors(kcs, vcs):
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
        if self._wq is not None:
            self._wq.refresh()      # a changed weight, re-quantized
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
        if self._spec is not None:
            lens_np = (lens.cpu().numpy() if self.ragged else
                       np.full((self.batch,), self.prompt_len, np.int64))
            gen, n_prop, n_acc = self._spec_decode(ids_host, lens_np, tok,
                                                   bt, seq_lens, done, seed)
            if _obs_enabled():
                sm = _serving_metrics()
                sm["spec_proposed"].inc(n_prop)
                sm["spec_accepted"].inc(n_acc)
                if n_prop:
                    sm["spec_rate"].set(n_acc / n_prop)
            gen = torch.from_numpy(gen).to(device=self._device,
                                           dtype=out_dtype)
        else:
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

    def _spec_decode(self, prompts, lens, tok0, bt, seq_lens, done0, seed):
        """Host-driven speculative decode (the JAX package's
        ``_spec_decode``): propose a per-row draft window, verify every
        window in ONE program of the ladder's width, accept or reject on
        the host, roll each row's cached length back to its accepted
        boundary, repeat until every row holds n_new tokens. Greedy rows
        emit the target's argmax chain; sampled rows draw from the exact
        target distribution by rejection sampling with a numpy rng
        seeded with ``seed``. Rows that emit eos freeze (new_lens 0) and
        pad with eos, as the decode loop's done rows do. Returns (gen
        [B, n_new] int32 numpy, proposed draft tokens, accepted draft
        tokens)."""
        from .speculative import greedy_accept, rejection_accept

        B, k = self.batch, self._spec.num_draft_tokens
        eos = self.eos_token_id
        do_sample, temperature, top_k, top_p = self._sampling
        ladder = self._verify_ladder
        weights = weight_addresses(self._weight_dicts)
        if weights != self._spec_weights:    # the graphs read weights
            self._spec_weights = weights     # by address: re-capture
            ladder.clear()
        rng = np.random.default_rng(seed)
        emitted = [[int(t)] for t in _harvest_sync(tok0)]
        done = _harvest_sync(done0)
        seq = _harvest_sync(seq_lens).astype(np.int32)
        with torch.inference_mode():
            self._spec_bt.copy_(bt)
        self._proposer.on_admit(
            [(r, prompts[r, :lens[r]]) for r in range(B)])
        n_prop = n_acc_total = 0
        while True:
            active = [r for r in range(B)
                      if not done[r] and len(emitted[r]) < self.n_new]
            if not active:
                break
            contexts, caps = [], {}
            for r in active:
                hist = np.concatenate(
                    [prompts[r, :lens[r]].astype(np.int64),
                     np.asarray(emitted[r], np.int64)])
                contexts.append((r, hist))
                caps[r] = max(0, min(k, self.n_new - len(emitted[r]) - 1))
            proposals = self._proposer.propose(contexts, caps)
            need = 1 + max(len(proposals.get(r, ())) for r in active)
            prog, w = ladder.get(need)
            toks = np.zeros((B, w), np.int32)
            new_lens = np.zeros((B,), np.int32)
            for r in active:
                d = np.asarray(proposals[r])[:min(caps[r], w - 1)]
                proposals[r] = d
                toks[r, 0] = emitted[r][-1]
                toks[r, 1:1 + len(d)] = d
                new_lens[r] = 1 + len(d)
            ladder.load(toks, new_lens)
            with torch.inference_mode():
                self._spec_seq.copy_(torch.from_numpy(seq))
            prog()
            lv = _harvest_sync(ladder.out[w])    # accept/reject on host
            for r in active:
                m = int(new_lens[r])
                if do_sample:
                    out, n_acc = rejection_accept(
                        lv[r, :m], proposals[r], rng, temperature, top_k,
                        top_p)
                else:
                    out, n_acc = greedy_accept(lv[r, :m], proposals[r])
                n_prop += len(proposals[r])
                for j, t in enumerate(out):
                    emitted[r].append(int(t))
                    if j < n_acc:  # accepted drafts that truly entered
                        n_acc_total += 1   # the stream (eos may cut
                        # the window short)
                    if eos is not None and int(t) == eos:
                        done[r] = True
                        break
                seq[r] += n_acc + 1
                self._proposer.rollback(r, int(seq[r]))
        fill = eos if eos is not None else 0
        gen = np.full((B, self.n_new), fill, np.int32)
        for r in range(B):
            row = emitted[r][:self.n_new]
            gen[r, :len(row)] = row
        return gen, n_prop, n_acc_total


def aot_generate(model, input_ids, max_new_tokens: int,
                 kv_block_size: int = 64, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id=None, seed: int = 0,
                 speculative=None, lora=None, adapters=None,
                 quantize_weights=None, kv_dtype=None):
    """Serve one generate() call through a per-model cache of
    GenerationSessions keyed by (shape, sampling, speculation,
    quantization) class.
    Output after every row has emitted eos is trimmed, as the JAX
    package's eager loop stops there. The cache keeps
    PADDLE_SERVING_SESSION_CACHE sessions per model (default 8), dropping
    the least recently served."""
    from .speculative import resolve_speculative

    _reject_unported(speculative, lora)
    if adapters is not None:
        raise NotImplementedError("LoRA serving is not ported")
    adapter = get_model_adapter(model)
    b, prompt_len = input_ids.shape
    n_new = min(max_new_tokens, adapter.max_seq_len - prompt_len)
    if n_new <= 0:
        return input_ids
    # the speculative config is part of the session identity: a spec
    # session holds proposer state and decodes by verify windows, so it
    # never serves a plain caller of the same shape class, nor the reverse
    spec = resolve_speculative(speculative)
    # quantization is part of the session identity the same way: its
    # pools and payloads are the session's own
    quantize_weights, kv_dtype = _resolve_quant_knobs(quantize_weights,
                                                      kv_dtype)
    key = (b, prompt_len, n_new, kv_block_size, do_sample, temperature,
           top_k, top_p, eos_token_id,
           None if spec is None else spec.cache_key(), quantize_weights,
           kv_dtype)
    cache = getattr(model, "_serving_sessions", None)
    if cache is None:
        cache = model._serving_sessions = collections.OrderedDict()
    sess = cache.get(key)
    if sess is None:
        sess = cache[key] = GenerationSession(
            model, batch=b, prompt_len=prompt_len, max_new_tokens=n_new,
            kv_block_size=kv_block_size, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, speculative=spec,
            quantize_weights=quantize_weights, kv_dtype=kv_dtype)
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


def eager_generate(model, input_ids, max_new_tokens: int,
                   do_sample: bool = False, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 1.0, eos_token_id=None,
                   use_cache: bool = True, use_paged_kv: bool = False,
                   kv_block_size: int = 64, seed: int = 0):
    """The models' eager generate loop (the JAX package's
    ``LlamaForCausalLM.generate`` / ``GPTForCausalLM.generate`` off the
    AOT path): ``n_new = min(max_new_tokens, max_seq_len - S)`` steps,
    each one forward of the backbone and a token selection on the
    model's device. The cache is a dense per-layer (k, v) that grows by
    concatenation (the default), the block-table pool
    (``use_paged_kv``; each sequence rotated at its own cached length),
    or none (``use_cache=False``: the no-cache forward over the whole
    sequence so far, every step). Rows that emitted ``eos_token_id`` keep
    emitting it, and the loop stops once every row has. Sampled draws
    come from a generator seeded with ``seed`` on the model's device.
    Returns prompt + generated tokens [B, S + n] on the model's device in
    the caller's id dtype (the prompt alone when n_new <= 0)."""
    adapter = get_model_adapter(model)
    dev = adapter.device
    ids_in = torch.as_tensor(input_ids)
    out_dtype = ids_in.dtype
    ids = ids_in.to(device=dev, dtype=torch.int64)
    b, prompt_len = ids.shape
    n_new = min(max_new_tokens, adapter.max_seq_len - prompt_len)
    if n_new <= 0:
        return ids.to(out_dtype)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))
    sampling = (bool(do_sample), float(temperature), int(top_k),
                float(top_p))
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            caches = None
            if use_cache and use_paged_kv:
                bt, nblocks = alloc_block_tables(
                    b, adapter.max_seq_len, kv_block_size, device=dev)
                caches = [PagedCache(*init_block_cache(
                    nblocks, adapter.kv_heads, kv_block_size,
                    adapter.head_dim, adapter.dtype, device=dev), bt,
                    torch.zeros((b,), dtype=torch.int32, device=dev))
                    for _ in range(adapter.num_layers)]
            elif use_cache:
                caches = [(None, None)] * adapter.num_layers
            toks, cur, cached = [ids], ids, 0
            done = torch.zeros((b,), dtype=torch.bool, device=dev)
            for _ in range(n_new):
                if caches is None:
                    hidden = adapter.backbone(torch.cat(toks, dim=1))
                else:
                    # the paged pool's seq_lens is each row's cached
                    # length; a dense cache's is the same for every row
                    pos = (caches[0].seq_lens if use_paged_kv else cached)
                    hidden, caches = adapter.backbone(cur, caches=caches,
                                                      pos_offset=pos)
                    cached += cur.shape[1]
                lv = adapter.logits(hidden[:, -1]).float()
                nxt = sample_logits(lv, generator, *sampling)
                if eos_token_id is not None:
                    nxt = torch.where(done, eos_token_id, nxt)
                    done = done | (nxt == eos_token_id)
                cur = nxt[:, None].to(torch.int64)
                toks.append(cur)
                if eos_token_id is not None and bool(done.all()):
                    break
            return torch.cat(toks, dim=1).to(out_dtype)
    finally:
        if was_training:
            model.train()


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

_SM = None   # serving metric handles, created once on first use


def _serving_metrics():
    """Registry handles for the serving tier (latency histograms and
    occupancy gauges, the names and help strings of the JAX package's).
    Instrumentation is host-side only: it never reads device values, so
    token outputs are byte-identical with the flag off or on."""
    global _SM
    from ..observability import get_registry
    from ..observability.slo import SLO_LATENCY_BUCKETS

    reg = get_registry()
    # rebuild after a registry reset/swap (tests): the cached handles
    # must be the ones the live registry renders
    if _SM is None or reg.get("serving_ttft_seconds") is not _SM["ttft"]:
        _SM = {
            "admit_steps": reg.counter(
                "serving_admit_steps_total",
                "mixed prefill+decode admit executions"),
            "chunk_steps": reg.counter(
                "serving_chunk_steps_total",
                "pure-decode chunk executions"),
            "tokens": reg.counter(
                "serving_tokens_total", "output tokens emitted"),
            "requests_submitted": reg.counter(
                "serving_requests_submitted_total",
                "requests entering the queue"),
            "requests_completed": reg.counter(
                "serving_requests_completed_total",
                "requests finished (eos or max_new_tokens)"),
            "live_slots": reg.gauge(
                "serving_live_slots", "slots holding an active request"),
            "queue_depth": reg.gauge(
                "serving_queue_depth", "requests waiting for a slot"),
            "kv_blocks_used": reg.gauge(
                "serving_kv_blocks_used",
                "paged-KV pool blocks held by live sequences"),
            "kv_occupancy": reg.gauge(
                "serving_kv_pool_occupancy",
                "fraction of the paged-KV pool in use (0..1)"),
            "prefix_hits": reg.counter(
                "serving_prefix_cache_hits_total",
                "admissions that reused >= 1 cached prefix block"),
            "prefix_misses": reg.counter(
                "serving_prefix_cache_misses_total",
                "admissions that ran a full prefill"),
            "prefix_evictions": reg.counter(
                "serving_prefix_cache_evictions_total",
                "cached free blocks evicted to supply allocations"),
            "prefix_cow": reg.counter(
                "serving_prefix_cache_cow_total",
                "copy-on-write block copies (full-prompt hits)"),
            "prefix_hit_tokens": reg.counter(
                "serving_prefix_hit_tokens_total",
                "prompt tokens whose prefill was skipped via the "
                "prefix cache"),
            "prefill_tokens": reg.counter(
                "serving_prefill_tokens_total",
                "prompt tokens actually fed to the admit executable "
                "(the admit-FLOP proxy)"),
            "prefix_cache_blocks": reg.gauge(
                "paged_kv_prefix_cache_blocks",
                "free blocks whose prefix hashes are retained "
                "(matchable cache-on-free inventory)"),
            "kv_blocks_state": reg.gauge(
                "paged_kv_blocks",
                "paged-KV pool block breakdown; a shared block counts "
                "once, in exactly one state"),
            # the speculative ones and the generate timing are declared
            # for the families' sake (the reference's set); nothing in
            # the port feeds them until speculative decoding and a timed
            # generate are ported
            "spec_proposed": reg.counter(
                "serving_spec_proposed_tokens_total",
                "draft tokens submitted to speculative verification"),
            "spec_accepted": reg.counter(
                "serving_spec_accepted_tokens_total",
                "draft tokens accepted by the verifier"),
            "spec_rate": reg.gauge(
                "serving_spec_acceptance_rate",
                "running accepted/proposed draft-token ratio (0..1)"),
            "spec_draft_lat": reg.histogram(
                "serving_spec_draft_seconds",
                "per-step draft proposal wall seconds (host n-gram "
                "lookup or draft-model decode)"),
            "spec_verify_lat": reg.histogram(
                "serving_spec_verify_seconds",
                "per-step verify dispatch + host accept wall seconds"),
            "preempted": reg.counter(
                "serving_preemptions_total",
                "running requests evicted back to the waiting queue "
                "(blocks freed; regenerated via prefix cache + "
                "re-prefill)"),
            "expired": reg.counter(
                "serving_deadline_expired_total",
                "requests terminated by their deadline_s budget"),
            "cancelled": reg.counter(
                "serving_cancelled_total",
                "requests terminated by session.cancel()"),
            "rejected": reg.counter(
                "serving_rejected_total",
                "submissions refused by the bounded waiting queue "
                "(max_waiting)"),
            "preempt_lat": reg.histogram(
                "serving_preempt_seconds",
                "host wall seconds to evict one slot (release blocks "
                "+ neutralize its table row + requeue)"),
            # SLO-aligned boundaries: windowed compliance counts
            # (obs <= threshold) are exact only when the policy
            # thresholds sit on bucket bounds (observability.slo)
            "queue_wait": reg.histogram(
                "serving_queue_wait_seconds",
                "submit -> slot admission wait",
                buckets=SLO_LATENCY_BUCKETS),
            "ttft": reg.histogram(
                "serving_ttft_seconds",
                "submit -> first output token (time to first token)",
                buckets=SLO_LATENCY_BUCKETS),
            "tpot": reg.histogram(
                "serving_tpot_seconds",
                "per-output-token latency after the first token",
                buckets=SLO_LATENCY_BUCKETS),
            "request_latency": reg.histogram(
                "serving_request_seconds",
                "submit -> request completion"),
            "generate": reg.histogram(
                "serving_generate_seconds",
                "AOT GenerationSession.generate wall seconds (host "
                "dispatch; device completion overlaps)"),
        }
    return _SM


def _obs_enabled() -> bool:
    from ..observability import enabled

    return enabled()


def _tracer():
    from ..observability.tracing import get_tracer

    return get_tracer()


def _slo():
    from ..observability.slo import get_slo_monitor

    return get_slo_monitor()


def _harvest_sync(value) -> np.ndarray:
    """THE device->host read of the serving loop: every dispatch's
    tokens come back through here, and the engine waits for the card
    here and nowhere else. Returns a host copy (the device buffer is
    reused by the next dispatch)."""
    return value.cpu().numpy().copy()


def weight_addresses(weight_dicts):
    """(address, shape, strides, dtype) of every tensor in ``weight_dicts``
    [(module._parameters, module._buffers)], read from the modules' own
    dicts, so a replaced Parameter shows as well as a replaced ``.data``:
    what a captured graph reads by address. A third of a millisecond for
    300 tensors."""
    return [(t.data_ptr(), t.shape, t.stride(), t.dtype)
            for params, bufs in weight_dicts
            for t in itertools.chain(params.values(), bufs.values())
            if t is not None]


def _token_logprobs(lv, toks) -> np.ndarray:
    """log p of ``toks`` [...] under the fp32 logits ``lv`` [..., V] on
    the host: the raw log-softmax at the chosen token, max-shifted in
    fp32 as the JAX package's ``_host_select`` computes it (no
    temperature, no top-k/p)."""
    m = lv.max(axis=-1)
    logz = m + np.log(np.exp(lv - m[..., None]).sum(axis=-1))
    return (np.take_along_axis(lv, np.asarray(toks, np.int64)[..., None],
                               -1)[..., 0] - logz)


@race_track
class _OverlapState:
    """Double-buffer state of the overlapped engine: the inflight
    (dispatched, not yet harvested) decode chunk or verify window, the
    staged next-step plan, and the step / overlapped / mispredict
    counters the flight recorder and the step profiler read.
    Engine-thread single-writer (declared at the module's end)."""

    def __init__(self):
        self.inflight = None    # {"kind", ...}: the dispatch's record
        self.staged = None      # {"kind", "slot_version", ...}
        self.steps = 0          # productive step() calls
        self.overlapped = 0     # steps dispatched straight from a staged plan
        self.mispredicts = 0    # staged plans invalidated before dispatch


class _GraphProgram:
    """One of a session's serving programs (the decode chunk, or the
    admit at one token-buffer width): ``body()`` runs it over the
    session's static buffers. On a card it is captured once into a CUDA
    graph (``graph``), in the session's shared graph memory pool, and
    every call replays it; on the CPU every call runs ``body()``.
    ``weights`` is the record of weight addresses it was built against
    (the graph reads every weight by address). The graph keeps its nodes
    for ``debug_dump``: they are each replay's launches. ``capture_s``:
    the host seconds the capture took (warm-up, recording, instantiation)."""

    def __init__(self, body, device, null_inputs, weights, generator=None,
                 pool=None, what="the chunk program"):
        self.body = body
        self.weights = weights
        self.graph = None
        self.device_bytes = 0
        self.capture_s = 0.0
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        # capture over null inputs (every row dead, every table row
        # the sentinel): the warm-up and the capture write nothing the
        # session keeps, whatever state it is in. The garbage collector
        # stays off meanwhile. That is a guess, not a known fix: a
        # sampled capture once failed on the card with
        # cudaErrorStreamCaptureInvalidated, for a cause not found
        # (ROADMAP queue C item 11). No collection runs before it: a
        # full one would sit on the path of each admit width's first use
        before = torch.cuda.memory_allocated(device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        if generator is not None:
            graph.register_generator_state(generator)
        failed = []

        def recorded():
            try:
                body()
            except Exception as e:      # torch reports only the capture's
                failed.append(e)        # end; keep the cause
                raise

        gc_on = gc.isenabled()
        gc.disable()
        try:
            with null_inputs():
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    body()                  # the warm-up
                    # captured on the same stream, without the
                    # synchronize and the empty_cache of torch.cuda.graph:
                    # an admit width is captured mid-serving, where a
                    # freed cache would send the next allocations back to
                    # cudaMalloc
                    graph.capture_begin(*(() if pool is None else (pool,)))
                    try:
                        recorded()
                    finally:
                        graph.capture_end()
                torch.cuda.current_stream(device).wait_stream(side)
        except Exception as e:
            if failed and failed[0] is not e:
                raise RuntimeError(
                    f"capturing {what} failed: {failed[0]!r}"
                ) from failed[0]
            raise
        finally:
            if gc_on:
                gc.enable()
        graph.instantiate()             # else the first replay would
        torch.cuda.synchronize(device)
        self.graph = graph
        self.device_bytes = torch.cuda.memory_allocated(device) - before
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        if self.graph is None:
            self.body()
        else:
            self.graph.replay()


class Request:
    """One generation request in the continuous-batching queue (the JAX
    package's Request, same slots and status walk).

    submit_t/admit_t/first_tok_t/finish_t are monotonic timestamps
    (submit_t is always set at submit; the others may stay None with
    FLAGS_observability=0): queue wait, TTFT and total latency derive
    from them. ``trace`` is the request's span tree (None when tracing is
    off or the sampler skipped it): queue_wait -> admit -> decode.

    ``seed`` folds into the session's sampling generator at the
    request's first admission (a no-op for greedy sessions). The draws
    are the port's own: a seed gives one stream within the port, not
    the JAX package's. ``block_hashes`` carries the prompt's chained
    full-block prefix hashes (truncated hex), stamped at admission.

    ``priority`` (higher admits first; strictly lower-priority running
    requests may be preempted for it) and ``deadline_s`` (seconds from
    submit; past it the request terminates with status "expired",
    checked at step boundaries) are the scheduler's knobs. ``status``
    walks waiting -> running -> (preempted -> waiting ...) -> one of
    done/cancelled/expired; "rejected" is terminal at submit."""

    __slots__ = ("req_id", "prompt", "max_new_tokens", "tokens",
                 "submit_t", "admit_t", "first_tok_t", "finish_t",
                 "queued_t", "prefix_hit_tokens", "spec_accepted_tokens",
                 "trace", "trace_ctx", "priority", "deadline_s", "status",
                 "submit_seq", "preemptions", "seed", "block_hashes",
                 "token_logprobs", "adapter")

    def __init__(self, req_id, prompt, max_new_tokens: int,
                 priority: int = 0, deadline_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 adapter: Optional[str] = None):
        self.req_id = req_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.seed = None if seed is None else int(seed)
        self.adapter = None if adapter is None else str(adapter)
        self.block_hashes = []
        self.tokens = []
        self.submit_t = None
        self.admit_t = None
        self.first_tok_t = None
        self.finish_t = None
        self.queued_t = None    # last time the request (re)entered the
        # waiting queue: the base of the current queue_wait span
        self.trace = None
        self.trace_ctx = None   # remote traceparent (W3C wire form)
        self.status = "new"
        self.submit_seq = -1
        self.preemptions = 0
        # prompt tokens whose prefill was skipped (cached-prefix reuse)
        self.prefix_hit_tokens = 0
        self.spec_accepted_tokens = 0
        self.token_logprobs = []


class _Slot:
    __slots__ = ("req", "last_tok", "block_ids", "pending", "first_chunk",
                 "hit", "cow", "hashes", "draft_prompt", "admit_seq",
                 "seq_len")

    def __init__(self):
        self.req = None
        self.last_tok = 0
        self.block_ids = []     # pool block ids this slot holds (table
        # order: shared prefix blocks first, then private blocks)
        self._clear_prefill()
        self.admit_seq = -1
        self.seq_len = 0        # host mirror of the device seq_lens row
        # (flight-recorder snapshots must never sync device state)

    def _clear_prefill(self):
        self.pending = None     # remaining prefill tokens (np array)
        # while mid-prefill; None once the slot is decode-ready
        self.first_chunk = False
        self.hit = 0            # prefix-cache hit boundary (tokens)
        self.cow = None         # (src, dst) block copy for the first chunk
        self.hashes = []        # prompt full-block hashes, registered
        # with the pool only once the LAST chunk has written them
        self.draft_prompt = None


@race_track
class ContinuousBatchingSession:
    """Mixed prefill+decode serving over persistent slots (the JAX
    package's ContinuousBatchingSession).

    Finished sequences' slots accept new prompts while the others keep
    decoding, over a static slot grid and two programs:

    - ``admit``: an [S, C] token buffer with per-slot new-token counts (a
      freshly admitted slot feeds its right-padded prompt with its cache
      length reset to its prefix-hit boundary; a decoding slot feeds its
      last token; an idle slot feeds count 0) -> one next token per live
      slot. C is the narrowest power of two over the longest chunk of
      uncached prompt (at most ``prefill_chunk``), or max_prompt_len with
      the prefix cache and chunked prefill both off. One CUDA graph per
      width on a card (module docstring).
    - ``decode_chunk``: ``chunk`` pure-decode steps for every slot, token
      selection on the card, one host read of the [chunk, S] tokens per
      chunk. One CUDA graph on a card.

    With ``speculative`` (a SpeculativeConfig or its kwargs) no decode
    chunk is built: a step with no prefill work is one speculative window
    for every live slot (``_spec_step``): the proposer drafts up to k
    tokens a slot, and one verify program of the window's width (one
    CUDA graph a width on a card, captured at its first use) scores
    them, folds the acceptance (greedy matching or exact rejection
    sampling, uniforms from the session's own Philox generator seeded
    with the config's seed) and rolls the lengths back on the card; two
    int32 vectors are read back. PADDLE_SPEC_DEVICE_ACCEPT=0 accepts on
    the host instead (the same decisions).

    ``overlap`` (None: on unless PADDLE_ENGINE_OVERLAP=0) picks the
    overlapped engine (``step``); ``logprobs=True`` forces the
    sequential one, runs raw-logits admits (the decode chunk is not
    built: each decode step is ``chunk`` width-1 admits) and host accept
    under speculation, and records each emitted token's log probability
    in ``Request.token_logprobs``.

    ``quantize_weights`` ("int8"/"int4") and ``kv_dtype`` ("int8"), with
    the environment's defaults: the graphs' Linears compute from
    quantized payloads, re-quantized into the same buffers at the
    admission that sees a weight change; the pools are (payload, scale)
    pairs, and ``kv_pool_bytes`` sizes them by the int8 block's bytes
    (module docstring).

    The KV pools are written in place; the host keeps the request queue
    (the Scheduler), the slot table, the block table mirror and the
    prefix-caching block pool (PrefixBlockPool). The session lives on the
    model's device.
    """

    def __init__(self, model, slots: int, max_prompt_len: int,
                 kv_block_size: int = 64, chunk: int = 8,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 prefix_cache: bool = True, min_match_blocks: int = 1,
                 cache_on_free: bool = True,
                 num_blocks: Optional[int] = None,
                 speculative=None, prefill_chunk: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 preemption: bool = True,
                 overlap: Optional[bool] = None,
                 logprobs: bool = False, lora=None,
                 quantize_weights=None, kv_dtype=None,
                 kv_pool_bytes: Optional[int] = None,
                 kv_tier=None):
        from ..incubate.nn.functional.paged_kv import (PrefixBlockPool,
                                                       kv_block_bytes)
        from ..observability.stepprof import StepProfiler
        from .scheduler import Scheduler
        from .speculative import resolve_speculative

        _reject_unported(speculative, lora, kv_tier)
        adapter = get_model_adapter(model)
        self.model = model
        self.slots = slots
        self.max_prompt_len = max_prompt_len
        self.chunk = int(chunk)
        self.eos_token_id = eos_token_id
        self._do_sample = bool(do_sample)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        # logprobs=True: the raw fp32 logits of every admit cross to the
        # host for log p, so the [S] token read becomes an [S, V] one and
        # the overlapped engine is off
        self._logprobs = bool(logprobs)
        if overlap is None:
            overlap = env_on("PADDLE_ENGINE_OVERLAP", True)
        self._overlap = bool(overlap) and not self._logprobs
        if max_prompt_len > adapter.max_seq_len:
            raise ValueError("max_prompt_len exceeds the model's "
                             f"max_seq_len {adapter.max_seq_len}")
        heads, hdim = adapter.kv_heads, adapter.head_dim
        n_layers = adapter.num_layers
        # dynamic allocation: per-slot tables stay static [S, MB] shapes
        # but their entries are pool block ids assigned at admission;
        # prefix hits point several slots at the same physical blocks.
        # Default sizing: every slot can hold a full max_seq_len
        # sequence; an explicit smaller num_blocks, or a byte budget
        # (kv_pool_bytes, else PADDLE_SERVING_QUANT_KV_POOL_BYTES; the
        # JAX package's equal-byte-budget geometry), turns on allocation
        # pressure, LRU eviction and preemption. num_blocks wins over a
        # budget, which counts blocks of the pool's own geometry: an int8
        # block costs about half a bf16 one, so the same budget holds
        # about twice the blocks (the scheduler and the gauges count
        # those)
        mbs = -(-adapter.max_seq_len // kv_block_size)
        quantize_weights, kv_dtype = _resolve_quant_knobs(quantize_weights,
                                                          kv_dtype)
        self._quant_weights = quantize_weights
        self._kv_dtype = kv_dtype
        self._kv_quant = kv_dtype == "int8"
        block_bytes = kv_block_bytes(n_layers, heads, kv_block_size, hdim,
                                     dtype=adapter.dtype, kv_dtype=kv_dtype)
        if kv_pool_bytes is None:
            env_pb = os.environ.get("PADDLE_SERVING_QUANT_KV_POOL_BYTES",
                                    "").strip()
            kv_pool_bytes = int(env_pb) if env_pb else None
        if num_blocks is not None:
            nblocks = int(num_blocks)
        elif kv_pool_bytes is not None:
            nblocks = max(1, int(kv_pool_bytes) // block_bytes)
        else:
            nblocks = slots * mbs
        self._kv_pool_bytes = nblocks * block_bytes
        self._blocks_per_slot = mbs
        self._cache_shape = (nblocks, heads, kv_block_size, hdim)
        self._cache_dtype = adapter.dtype
        self.max_cached = adapter.max_seq_len
        self._device = dev = adapter.device
        self._wq = (None if quantize_weights is None
                    else _WeightQuantState(model, quantize_weights))
        self._run_model = make_run_model(model, adapter, weights=self._wq,
                                         kv_quant=self._kv_quant)
        self._kv_block_size = kv_block_size
        self._num_blocks = nblocks

        # device-resident state. Every tensor the decode graph reads or
        # writes keeps its address for the session's life: admissions
        # and frees refill these buffers with copy_, never rebind them
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._kcs = _kv_zero_pool(self._cache_shape, adapter.dtype, n_layers,
                                  self._kv_quant, dev)
        self._vcs = _kv_zero_pool(self._cache_shape, adapter.dtype, n_layers,
                                  self._kv_quant, dev)
        self._seq_lens = zeros(slots)
        self._tok_dev = zeros(slots)        # last token per slot
        self._live_dev = zeros(slots, dtype=torch.bool)
        self._toks_dev = zeros(self.chunk, slots)    # the chunk's output
        # logprobs=True: the raw admit's last-position logits
        self._raw_lv = (zeros(slots, model.cfg.vocab_size,
                              dtype=torch.float32)
                        if self._logprobs else None)
        self._live_up = None    # the live mask last uploaded to _live_dev
        # host mirror of the tables; entries past a slot's owned blocks
        # hold the out-of-pool sentinel so padded prefill writes DROP
        # instead of landing in another slot's blocks
        self._bt = np.full((slots, mbs), nblocks, np.int32)
        self._bt_dev = torch.from_numpy(self._bt.copy()).to(dev)
        self._bt_dirty = False
        # sampling: one generator for the session (the JAX package's
        # session key), seeded 0; Request.seed folds into it
        self._gen = torch.Generator(device=dev)
        self._gen_seed = 0
        self._gen.manual_seed(self._gen_seed)
        self._slots = [_Slot() for _ in range(slots)]
        # requests finished since the last run(); bounded so a server
        # driving step() directly cannot leak host memory
        self._completed = []
        self._completed_cap = 65536
        # bumped whenever a slot binds or frees: a plan staged against
        # predicted state is stale the moment it moved
        self._slot_version = 0
        self._ov = _OverlapState()
        self.replica_name = os.environ.get("PADDLE_REPLICA_NAME") or None
        self.serving_role = None
        # host-side block registry: ref counts, chained prefix hashes,
        # LRU cache-on-free: the automatic prefix cache
        self._pool = PrefixBlockPool(
            nblocks, kv_block_size, prefix_cache=prefix_cache,
            min_match_blocks=min_match_blocks,
            cache_on_free=cache_on_free)
        # cached KV is a function of the weights: admissions compare
        # this fingerprint and flush the prefix cache when any weight
        # was replaced or written in place
        self._param_fingerprint = self._weights_fingerprint()
        # plain host counters back the stats view unconditionally (the
        # registry mirrors them only when FLAGS_observability is on)
        self._admit_steps = 0
        self._chunk_steps = 0
        self._tokens_out = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_hit_tokens = 0
        self._prefill_tokens = 0
        self._sched = Scheduler(self, prefill_chunk=prefill_chunk,
                                max_waiting=max_waiting,
                                preemption=preemption)
        self._spec = resolve_speculative(speculative)
        self._spec_steps = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._proposer = self._verify_ladder = None
        if self._spec is not None:
            self._build_spec(adapter, model.cfg.vocab_size)
        # the programs: the decode chunk and the admit at width
        # max_prompt_len, captured here on a card (the JAX package's
        # pinned executables), and the admit at each other width of the
        # ladder, captured at the width's first use. Their graphs share
        # one memory pool (no two replays overlap); each admit width
        # reads its own static token buffer [S, w] and the shared lens
        # buffer [3, S]
        self._weight_dicts = [(m._parameters, m._buffers)
                              for m in model.modules()]
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        self._admit_toks = {}
        self._admit_lens = zeros(3, slots)
        self._admit_progs = {}
        self._captures = 0
        self._chunk_prog = None
        self._build_chunk_program()
        self._admit_program(self.max_prompt_len)
        self._stepprof = StepProfiler(replica=self.replica_name)
        self._register_overlap_provider()
        self._register_memz_provider()

    @property
    def _queue(self):
        """The scheduler's waiting list."""
        return self._sched.waiting

    @property
    def scheduler(self):
        return self._sched

    def _build_spec(self, adapter, vocab):
        """The proposer, the window uniforms' generator and the verify
        ladder (its programs captured at each width's first use).
        PADDLE_SPEC_TENANT_STATS=1 gives the n-gram proposer a tenant
        corpus (PADDLE_SPEC_TENANT_CAP_TOKENS tokens; every request of
        the port is the base-model tenant)."""
        from .speculative import VerifyLadder, build_proposer

        spec, dev = self._spec, self._device
        self._proposer = build_proposer(
            spec, rows=self.slots, kv_block_size=self._kv_block_size,
            capacity=adapter.max_seq_len,
            tenant_stats=env_on("PADDLE_SPEC_TENANT_STATS", False),
            tenant_cap_tokens=env_int("PADDLE_SPEC_TENANT_CAP_TOKENS",
                                      8192))
        # the windows' uniforms: one [S, k+1] draw a verify dispatch,
        # greedy too, from a generator of their own (the JAX session
        # splits its spec key once a dispatch)
        self._spec_gen = torch.Generator(device=dev)
        self._spec_gen.manual_seed(int(spec.seed))
        # logprobs reads every window position's logits back, so it
        # accepts on the host
        self._spec_accept = ("host" if self._logprobs or not env_on(
            "PADDLE_SPEC_DEVICE_ACCEPT", True) else "device")
        # the overlapped engine stages window N+1 from the predicted
        # post-window history while the card verifies window N: device
        # accept only, and only for proposers whose drafts are a pure
        # function of the history (``stage_ahead``)
        self._spec_stage = (
            self._overlap and self._spec_accept == "device"
            and getattr(self._proposer, "stage_ahead", False)
            and env_on("PADDLE_SPEC_STAGE_AHEAD", True))
        self._spec_by_adapter = {}
        self._verify_ladder = VerifyLadder(
            self._run_model, rows=self.slots,
            cap=spec.num_draft_tokens + 1, device=dev,
            pools=lambda: (self._kcs, self._vcs, self._bt_dev,
                           self._seq_lens),
            build=lambda body, w: self._build_program(body, "verify",
                                                      width=w),
            greedy=not self._do_sample and not self._logprobs,
            accept=self._spec_accept,
            sampling={"do_sample": self._do_sample,
                      "temperature": self._temperature,
                      "top_k": self._top_k, "top_p": self._top_p},
            generator=self._spec_gen, last_tok=self._tok_dev, vocab=vocab)

    # -- programs ----------------------------------------------------------
    def _weight_addresses(self):
        """The model's weight addresses (``weight_addresses``): what the
        session's graphs read."""
        return weight_addresses(self._weight_dicts)

    def _build_program(self, body, kind, **span):
        """A graph program of this session over ``body`` (captured on a
        card, eager on the CPU). A card capture is a ``compile.<kind>``
        trace span, and the JAX package's ProgramCache gauges count the
        captured programs."""
        if self._ov.inflight is not None:
            raise RuntimeError(
                f"capturing a {kind} program while a replay is in flight")
        t0 = time.monotonic()
        what = f"the {kind} program" + "".join(
            f" of {k} {v}" for k, v in span.items())
        gen = (self._spec_gen if kind == "verify"
               else self._gen if self._do_sample and not self._logprobs
               else None)
        prog = _GraphProgram(body, self._device, self._null_inputs,
                             self._weight_addresses(), gen,
                             self._graph_pool, what)
        if prog.graph is not None:
            self._captures += 1
            _tracer().record_span(f"compile.{kind}", t0, **span)
        return prog

    def _record_program_gauges(self):
        if not _obs_enabled():
            return
        from ..observability import get_registry

        reg = get_registry()
        progs = self._programs().values()
        reg.gauge("engine_program_cache_programs",
                  "compiled serving executables resident in the "
                  "unified ProgramCache").set(
                      sum(p.graph is not None for p in progs))
        reg.gauge("engine_program_cache_compiles",
                  "lifetime ProgramCache compiles (pinned + lazy)"
                  ).set(self._captures)
        reg.gauge("engine_program_cache_evictions",
                  "ProgramCache LRU evictions").set(0)

    def _programs(self):
        """{name: program} of every program the session holds: the
        decode chunk, the admit widths, the verify widths."""
        progs = {} if self._chunk_prog is None else {
            "chunk": self._chunk_prog}
        progs.update((f"admit {w}", p) for w, p in self._admit_progs.items())
        if self._verify_ladder is not None:
            progs.update((f"verify {w}", p)
                         for w, p in self._verify_ladder.programs.items())
        return progs

    def _build_chunk_program(self):
        """(Re)build the decode chunk (none with speculation: decode is
        one verify window a step; none with logprobs: decode is width-1
        raw admits); the admit and verify programs, captured against the
        same weights, go with it and are captured again at their next
        use (max_prompt_len's too). Never with a replay in flight."""
        if self._ov.inflight is not None:
            raise RuntimeError("re-capturing the programs while a replay "
                               "is in flight")
        self._chunk_prog = None         # retired graphs go first
        self._admit_progs.clear()
        if self._verify_ladder is not None:
            self._verify_ladder.clear()
        self._prog_weights = self._weight_addresses()
        if self._spec is None and not self._logprobs:
            self._chunk_prog = self._build_program(self._chunk_body,
                                                   "chunk")
        self._record_program_gauges()

    def _check_weights(self):
        """Before any replay: a weight replaced since the programs were
        captured (``param.data = ...``, ``load_state_dict(assign=True)``)
        re-captures them first, so a replay never reads a freed one."""
        if self._weight_addresses() != self._prog_weights:
            self._build_chunk_program()

    def _admit_program(self, w):
        """The admit program of token-buffer width ``w`` (the JAX
        package's per-width admit executable), built at its first use."""
        prog = self._admit_progs.get(w)
        if prog is None:
            if w not in self._admit_toks:
                self._admit_toks[w] = torch.zeros(
                    (self.slots, w), dtype=torch.int32, device=self._device)
            prog = self._build_program(partial(self._admit_body, w),
                                       "admit", width=w)
            self._admit_progs[w] = prog
            self._record_program_gauges()
        return prog

    def _select(self, lv, live):
        """Token selection on the card; dead rows emit eos (when set)."""
        nxt = sample_logits(lv, self._gen, self._do_sample,
                            self._temperature, self._top_k,
                            self._top_p).to(torch.int32)
        if self.eos_token_id is not None:
            nxt = torch.where(live, nxt, self.eos_token_id)
        return nxt

    def _admit_body(self, w):
        """One mixed admit over the static buffers: the [S, w] token
        buffer of width ``w`` and the lens buffer [3, S] (new-token
        counts, reset flags, prefix-hit boundaries); writes the pools in
        place, the cached lengths and the selected tokens [S] (the next
        chunk's starting tokens: mid-prefill and dead rows carry junk
        there), or with logprobs the raw fp32 logits [S, V] and no
        selection. No host read anywhere (capturable)."""
        with torch.inference_mode():
            lens = self._admit_lens
            new_lens, reset, hit_lens = lens[0], lens[1] > 0, lens[2]
            # freshly admitted slots restart their cache at the prefix
            # hit boundary (0 on a miss); frozen slots (new_lens == 0)
            # write nothing the session keeps and stay put
            seq_lens = torch.where(reset, hit_lens, self._seq_lens)
            lv, _, _, seq_lens = self._run_model(
                self._admit_toks[w], self._kcs, self._vcs, self._bt_dev,
                seq_lens, seq_lens, new_lens,
                torch.clamp(new_lens - 1, min=0))
            self._seq_lens.copy_(seq_lens)
            if self._logprobs:
                self._raw_lv.copy_(lv)
            else:
                self._tok_dev.copy_(self._select(lv, new_lens > 0))

    def _admit_prepare(self, toks, lens, cow):
        """Everything of one mixed admit dispatch but the program: the
        weight check, the width's program (captured at its first use),
        the copy-on-write block copies (``cow`` [(src, dst)], eager:
        their number varies; a slot whose whole prompt was cached gets a
        private copy of the final shared block before its 1-token
        re-prefill writes into it), and the static buffers refilled from
        ``toks`` [S, w] and ``lens`` [3, S] (int32). Returns the program
        to run."""
        self._check_weights()
        w = toks.shape[1]
        prog = self._admit_program(w)
        with torch.inference_mode():
            for src, dst in cow:
                # payloads and scales alike
                for c in _pool_tensors(self._kcs, self._vcs):
                    c[dst].copy_(c[src])
            self._admit_toks[w].copy_(torch.from_numpy(toks))
            self._admit_lens.copy_(torch.from_numpy(lens))
        return prog

    def _admit(self, toks, lens, cow):
        """One mixed admit dispatch (:meth:`_admit_prepare`, then the
        width's program). Returns the selected tokens [S] on the
        device."""
        self._admit_prepare(toks, lens, cow)()
        if self._logprobs:
            return self._raw_select()
        return self._tok_dev

    def _raw_select(self):
        """logprobs=True: the token selection of the last raw admit, run
        eagerly on the card over its logits with the device sampler's
        ops (``_select``: live rows are those the admit fed), drawing
        from the session's generator one [S, V] draw a token, in the
        order and shape of the admit and chunk graphs' draws, so
        pinned-seed streams equal the device sampler's at any
        ``chunk``. Returns the tokens [S] on the device."""
        with torch.inference_mode():
            return self._select(self._raw_lv, self._admit_lens[0] > 0)

    def _chunk_body(self):
        """``chunk`` decode steps over the static buffers: reads the last
        tokens, the live mask, the table and the cached lengths; writes
        the pools in place, the [chunk, S] tokens, the last tokens and
        the advanced lengths. No host read anywhere (capturable)."""
        with torch.inference_mode():
            tok, live = self._tok_dev, self._live_dev
            new_lens = live.to(torch.int32)
            first = torch.zeros_like(tok)
            seq_lens = self._seq_lens
            for t in range(self.chunk):
                lv, _, _, seq_lens = self._run_model(
                    tok[:, None], self._kcs, self._vcs, self._bt_dev,
                    seq_lens, seq_lens, new_lens, first)
                tok = self._select(lv, live)
                self._toks_dev[t].copy_(tok)
            self._seq_lens.copy_(seq_lens)
            self._tok_dev.copy_(tok)

    def _null_inputs(self):
        """Context: every row dead (no new tokens, no reset) and every
        table row the sentinel, so a chunk or an admit run inside writes
        no pool byte and advances no length (a capture's warm-up and the
        capture itself); the last tokens, the table and the sampling
        generator are put back on exit (the live mask and the lens are
        refilled before every dispatch)."""
        gens = [self._gen] + ([self._spec_gen] if self._spec is not None
                              else [])

        @contextlib.contextmanager
        def ctx():
            tok = self._tok_dev.clone()
            gen_states = [g.get_state() for g in gens]
            self._live_dev.fill_(False)
            self._live_up = None
            self._admit_lens.zero_()
            if self._verify_ladder is not None:
                self._verify_ladder.new_lens.zero_()
            self._bt_dev.fill_(self._num_blocks)
            try:
                yield
            finally:
                self._tok_dev.copy_(tok)
                for g, st in zip(gens, gen_states):
                    g.set_state(st)
                self._bt_dev.copy_(torch.from_numpy(self._bt))
        return ctx()

    # -- telemetry providers -----------------------------------------------
    def _register_overlap_provider(self):
        """The overlapped engine's state for flight-recorder dumps
        (weakref'd): whether a step was dispatched from a staged plan,
        what is in flight, and what the engine believed the next step
        looked like."""
        from ..observability.flight_recorder import register_state_provider

        ref = weakref.ref(self)

        def _provide():
            sess = ref()
            if sess is None:
                return None
            ov = sess._ov
            st, inf = ov.staged, ov.inflight
            return {"overlap": bool(sess._overlap),
                    "inflight_kind": None if inf is None else inf["kind"],
                    "staged_plan": None if st is None else {
                        "kind": st["kind"],
                        "live_slots": list(st.get("live",
                                                  st.get("rows", ()))),
                        "slot_version": int(st["slot_version"])},
                    "slot_version": int(sess._slot_version),
                    "steps_total": int(ov.steps),
                    "steps_overlapped": int(ov.overlapped),
                    "mispredicts": int(ov.mispredicts)}

        register_state_provider(f"engine_staged_plan_{id(self):x}",
                                _provide)

    def _weights_bytes(self) -> tuple:
        """(total_bytes, detail) of the weights the session serves from:
        the model's tensors for unquantized names, payloads plus scales
        for the names the weight quantization owns."""
        owned = {} if self._wq is None else self._wq.qvals
        raw = sum(t.numel() * t.element_size()
                  for n, t in self.model.state_dict().items()
                  if n not in owned)
        quant = 0 if self._wq is None else self._wq.nbytes()
        return raw + quant, {"raw_bytes": raw, "quant_bytes": quant,
                             "quant_mode": None if self._wq is None
                             else self._wq.mode}

    def _register_memz_provider(self):
        """This session's device memory for the HBM ledger (weakref'd):
        weights, the paged-KV pool and the captured graphs."""
        from ..observability.memz import register_memz_provider

        ref = weakref.ref(self)

        def _provide():
            sess = ref()
            if sess is None:
                return None
            weights, wdetail = sess._weights_bytes()
            admits = sess._admit_progs
            verify = ({} if sess._verify_ladder is None
                      else sess._verify_ladder.programs)
            comps = {"weights": weights,
                     "kv_pool": int(sess._kv_pool_bytes),
                     "executables": sum(p.device_bytes for p in
                                        sess._programs().values())}
            detail = {"weights": wdetail,
                      "kv_pool": {"num_blocks": int(sess._num_blocks),
                                  "kv_pool_bytes": int(sess._kv_pool_bytes),
                                  "kv_dtype": sess._kv_dtype
                                  or str(sess._cache_dtype)
                                  .replace("torch.", "")},
                      "executables": {"decode_chunk_graph":
                                      sess._chunk_prog is not None
                                      and sess._chunk_prog.graph
                                      is not None,
                                      "admit_graph_widths": sorted(
                                          w for w, p in admits.items()
                                          if p.graph is not None),
                                      "verify_graph_widths": sorted(
                                          w for w, p in verify.items()
                                          if p.graph is not None)},
                      "replica": sess.replica_name,
                      "role": sess.serving_role}
            return {"components": comps, "detail": detail}

        register_memz_provider(f"serving_session_{id(self):x}", _provide)

    @property
    def stats(self):
        """Step/token/prefix-cache counters, with the JAX package's keys
        (the features the port lacks count 0)."""
        return {"admit_steps": self._admit_steps,
                "chunk_steps": self._chunk_steps,
                "tokens_out": self._tokens_out,
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "prefill_tokens": self._prefill_tokens,
                "prefix_evictions": self._pool.evictions,
                "prefix_cow": self._pool.cow_copies,
                "spec_steps": self._spec_steps,
                "spec_proposed_tokens": self._spec_proposed,
                "spec_accepted_tokens": self._spec_accepted, "kv_spills": 0,
                "kv_restores": 0, "kv_fetches": 0, "kv_fetch_hits": 0,
                "kv_spill_us": 0.0, "kv_restore_us": 0.0,
                "preemptions": self._sched.preemptions,
                "expirations": self._sched.expirations,
                "cancellations": self._sched.cancellations,
                "rejections": self._sched.rejections}

    @stats.setter
    def stats(self, d):
        """Resettable for benchmarking loops; registry counters are
        monotonic and are not rewound."""
        self._admit_steps = int(d.get("admit_steps", 0))
        self._chunk_steps = int(d.get("chunk_steps", 0))
        self._tokens_out = int(d.get("tokens_out", 0))
        self._prefix_hits = int(d.get("prefix_hits", 0))
        self._prefix_misses = int(d.get("prefix_misses", 0))
        self._prefix_hit_tokens = int(d.get("prefix_hit_tokens", 0))
        self._prefill_tokens = int(d.get("prefill_tokens", 0))
        self._pool.evictions = int(d.get("prefix_evictions", 0))
        self._pool.cow_copies = int(d.get("prefix_cow", 0))
        self._spec_steps = int(d.get("spec_steps", 0))
        self._spec_proposed = int(d.get("spec_proposed_tokens", 0))
        self._spec_accepted = int(d.get("spec_accepted_tokens", 0))
        self._sched.preemptions = int(d.get("preemptions", 0))
        self._sched.expirations = int(d.get("expirations", 0))
        self._sched.cancellations = int(d.get("cancellations", 0))
        self._sched.rejections = int(d.get("rejections", 0))

    def flush_prefix_cache(self):
        """Drop every cached prefix hash (live requests keep serving).
        Called automatically when a weight update is detected; public
        for servers that change weights in ways the fingerprint cannot
        see (writes through ``.data``)."""
        self._pool.flush_cache()

    # -- telemetry ---------------------------------------------------------
    def _record_state_metrics(self, sm):
        """Occupancy + liveness gauges after a step, from the block
        registry's breakdown: a block shared by several slots counts
        once."""
        live = [s.req is not None for s in self._slots]
        occ = self._pool.occupancy()
        sm["kv_blocks_used"].set(occ["referenced"])
        sm["kv_occupancy"].set(occ["referenced"]
                               / max(1, self._num_blocks))
        sm["prefix_cache_blocks"].set(occ["cached"])
        for state in ("referenced", "cached", "free"):
            sm["kv_blocks_state"].set(occ[state], state=state)
        sm["live_slots"].set(sum(live))
        sm["queue_depth"].set(len(self._queue))
        mon = _slo()
        mon.observe("queue_depth", float(len(self._queue)))
        # burn-rate evaluation rides the step loop, rate-limited to
        # ~1 Hz inside the monitor
        mon.maybe_evaluate()

    # -- host-side queue/slot management ----------------------------------
    def submit(self, req: Request):
        """Validate + enqueue through the scheduler. Raises a typed
        ``InvalidRequest`` (a ValueError) for requests that can never
        be served, and ``AdmissionRejected`` when the bounded waiting
        queue (max_waiting) is full."""
        self._sched.submit(req)

    def cancel(self, req_id) -> bool:
        """Cancel a waiting or running request: its blocks free at the
        next step boundary (immediately when no step is in flight) and
        it terminates with status "cancelled". Returns False for
        unknown/already-terminal ids."""
        return self._sched.cancel(req_id)

    def preempt(self, req_id=None):
        """Forcibly evict a running request (by id, or the scheduler's
        default victim) back to the waiting queue: its blocks return to
        the pool and it later re-admits through the prefix cache and a
        re-prefill of its committed history, byte-identical for greedy
        streams. Returns the preempted req_id or None. Chaos/testing
        API; must be called between steps. The overlapped engine's
        deferred chunk or window is committed first (the victim keeps
        the tokens it earned) and its staged plan dropped."""
        self._drain_inflight()
        return self._sched.force_preempt(req_id)

    def _preempt_slot(self, i):
        """Evict slot `i`'s request back to the waiting queue: its blocks
        return to the pool (registered prompt hashes retained by
        cache-on-free, so regeneration hits the prefix cache), the
        request keeps its emitted tokens and re-admits later through an
        ordinary (typically chunked) re-prefill of its full committed
        history."""
        t0 = time.monotonic()
        req = self._slots[i].req
        self._free_slot(i)
        self._sched.requeue(req, t0)
        if _obs_enabled():
            sm = _serving_metrics()
            sm["preempted"].inc()
            sm["preempt_lat"].observe(time.monotonic() - t0)
            sm["queue_depth"].set(len(self._sched.waiting))
            if req.trace is not None:
                req.trace.add_span("preempted", t0, t0,
                                   n_tokens=len(req.tokens))
            _tracer().record_span("scheduler.preempt", t0,
                                  req_id=str(req.req_id),
                                  n_tokens=len(req.tokens))
            from ..observability import get_event_log

            get_event_log().emit(
                "serving.request_preempted", req_id=str(req.req_id),
                n_tokens=len(req.tokens), priority=req.priority,
                preemptions=req.preemptions)

    def _collect(self, i, slot, tok, obs=False):
        """Record one emitted token; evict slot `i` on completion."""
        req = slot.req
        if req is None:
            return
        req.tokens.append(int(tok))
        slot.last_tok = int(tok)
        if req.first_tok_t is None:
            req.first_tok_t = time.monotonic()
            if obs and req.submit_t is not None:
                ttft_s = req.first_tok_t - req.submit_t
                _serving_metrics()["ttft"].observe(ttft_s)
                _slo().observe("ttft", ttft_s)
        hit_eos = (self.eos_token_id is not None
                   and int(tok) == self.eos_token_id)
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            req.status = "done"
            req.finish_t = time.monotonic()
            store = getattr(self._proposer, "store", None)
            if store is not None:
                # the committed stream feeds its tenant's draft corpus
                store.observe(self._spec_tenant_seed(req), np.concatenate(
                    [np.asarray(req.prompt, np.int64),
                     np.asarray(req.tokens, np.int64)]))
            # slot freed (cache junk is reset on admit); blocks return
            # to the pool with their prompt-prefix hashes retained
            # (cache-on-free): the next identical prefix revives them
            self._free_slot(i)
            self._completed.append(req)
            if obs:
                self._finish_request(req, hit_eos)
            self._trim_completed()
        self._tokens_out += 1

    def _trim_completed(self):
        if len(self._completed) > self._completed_cap:
            import warnings

            warnings.warn(
                "ContinuousBatchingSession: completed-request buffer "
                "exceeded its cap (run() never called?); dropping "
                "oldest results", stacklevel=2)
            del self._completed[:len(self._completed) // 2]

    def _free_slot(self, i):
        """Release slot `i` back to the pool and neutralize its table
        row. Every dispatch writes ALL rows (new_lens masks reads, not
        writes), and the released blocks may be recycled to another
        slot: the out-of-pool sentinel makes the dead row's phantom
        writes drop instead of corrupting the new owner's KV."""
        slot = self._slots[i]
        slot.req = None
        self._slot_version += 1
        self._pool.release(slot.block_ids)
        slot.block_ids = []
        slot._clear_prefill()
        slot.seq_len = 0
        self._bt[i, :] = self._num_blocks
        self._bt_dirty = True
        if self._proposer is not None:
            # roll the draft row back to empty: a freed or preempted
            # request leaves no draft state behind
            self._proposer.rollback(i, 0)

    def _terminate(self, req, status, slot=None):
        """Terminal path for cancellation/rejection: free any held slot
        immediately, stamp the typed status, emit the typed event, and
        surface the request (with the tokens it already produced)
        through run()."""
        if slot is not None:
            self._free_slot(slot)
        req.status = status
        req.finish_t = time.monotonic()
        self._completed.append(req)
        self._trim_completed()
        self._sched._emit_terminal_event(req, status)
        if _obs_enabled():
            if req.trace is not None:
                _tracer().finish_trace(req.trace, t1=req.finish_t,
                                       n_tokens=len(req.tokens),
                                       status=status,
                                       role=self.serving_role)
                req.trace = None
            sm = _serving_metrics()
            sm["queue_depth"].set(len(self._sched.waiting))
            # cancellation is a client choice, not an SLO violation
            _slo().observe_request(ok=(status == "cancelled"))

    def _finish_request(self, req, hit_eos):
        """Completion metrics + the structured per-request event (with
        trace_id + per-phase durations when the request was traced)."""
        from ..observability import get_event_log

        now = time.monotonic()
        sm = _serving_metrics()
        sm["requests_completed"].inc(
            **({"replica": self.replica_name} if self.replica_name
               else {}))
        _slo().observe_request(ok=True)
        total_s = (now - req.submit_t) if req.submit_t is not None else None
        if total_s is not None:
            sm["request_latency"].observe(total_s)
        trace, phases = req.trace, None
        if trace is not None:
            from ..observability.tracing import phase_breakdown

            _tracer().finish_trace(
                trace, t1=now, n_tokens=len(req.tokens),
                eos=bool(hit_eos), role=self.serving_role)
            phases = phase_breakdown(trace)
        rnd = lambda v: None if v is None else round(v, 6)  # noqa: E731
        get_event_log().emit(
            "serving.request_done", req_id=str(req.req_id),
            replica=self.replica_name,
            adapter=req.adapter,
            block_hashes=req.block_hashes or None,
            prompt_len=len(req.prompt), n_tokens=len(req.tokens),
            prefix_hit_tokens=int(req.prefix_hit_tokens),
            spec_accepted_tokens=int(req.spec_accepted_tokens),
            preemptions=int(req.preemptions),
            eos=bool(hit_eos), total_s=rnd(total_s),
            queue_wait_s=rnd((req.admit_t - req.submit_t)
                             if req.admit_t is not None
                             and req.submit_t is not None else None),
            ttft_s=rnd((req.first_tok_t - req.submit_t)
                       if req.first_tok_t is not None
                       and req.submit_t is not None else None),
            trace_id=None if trace is None else trace.trace_id,
            fleet_trace_id=None if trace is None
            else trace.attrs.get("fleet_trace_id"),
            role=self.serving_role,
            phases=phases)

    def _weights_fingerprint(self):
        """(name, address, version) of every weight: a replaced tensor
        changes the address, an in-place write (an optimizer step, a
        ``no_grad`` assignment) the version."""
        return [(n, t.data_ptr(), t._version)
                for n, t in self.model.state_dict(keep_vars=True).items()]

    def _check_weight_swap(self):
        """Cached KV belongs to the weights that computed it: if any
        weight was replaced or written since the last admission, flush
        every cached hash (live blocks keep serving: their requests
        started under the old weights and already hold the matching
        KV). A replaced weight's new address reaches the decode graph
        in ``_dispatch_decode``, at every chunk, queue or no queue; a
        quantized weight is re-quantized here, into the payload buffers
        the graphs read (ordered after any replay in flight on the
        stream)."""
        cur = self._weights_fingerprint()
        if cur == self._param_fingerprint:
            return
        self.flush_prefix_cache()
        self._param_fingerprint = cur
        if self._wq is not None:
            self._wq.refresh()

    def _effective_prompt(self, req):
        """The token history an admission must prefill: the prompt for a
        fresh request; prompt + already-emitted tokens for a preempted
        one."""
        if not req.tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])

    def _plan_admission(self, req):
        """Block plan for admitting `req`: (table, hit_tokens, cow,
        hashes) or None when the pool cannot supply the blocks even
        after LRU-evicting unreferenced cached blocks (the request stays
        queued; allocation is all-or-nothing so waiting can never
        deadlock).

        table      full list of pool block ids (prompt + decode room)
        hit_tokens prefill starts here (0 = full prefill)
        cow        (src, dst) device block copy to run before admit, or
                   None: the full-prompt-hit case, where every prompt
                   block is cached but the last token must still run to
                   produce logits, so the final shared block is first
                   copied to a private one and exactly one token is
                   re-prefilled into the copy
        hashes     chained hashes of the prompt's full blocks, for
                   registration once the admit has written them"""
        pool, bs = self._pool, self._kv_block_size
        ep = self._effective_prompt(req)
        plen = len(ep)
        total = -(-(plen + req.max_new_tokens - len(req.tokens)) // bs)
        matched, hashes = pool.match(ep)
        hit = len(matched) * bs
        cow = None
        extra = 1 if (matched and hit >= plen) else 0
        fresh = pool.allocate(total - len(matched) + extra)
        if fresh is None and extra:
            # the CoW copy is the one block that didn't fit: recompute
            # the final matched block instead of copying it
            pool.release(matched[-1:])
            matched = matched[:-1]
            if len(matched) < pool.min_match_blocks:
                pool.release(matched)
                matched = []
            hit = len(matched) * bs
            extra = 0
            fresh = pool.allocate(total - len(matched))
        if fresh is None:
            # full pool: release the match and retry later
            pool.release(matched)
            return None, 0, None, hashes
        if extra:
            src = matched[-1]
            cow = (src, fresh[0])
            matched = matched[:-1] + [fresh[0]]
            fresh = fresh[1:]
            pool.release([src])      # the private copy replaces the ref
            hit = plen - 1
            pool.cow_copies += 1
        return matched + fresh, hit, cow, hashes

    def _bind_slot(self, i, req, plan, now, admit_seq):
        """Bind an admitted request to slot `i` per the block plan:
        table row, pending prefill tail, bookkeeping + admission
        telemetry. The prefill runs on the next dispatch."""
        table, hit, cow, hashes = plan
        nb = self._num_blocks
        slot = self._slots[i]
        ep = self._effective_prompt(req)
        if req.seed is not None and req.admit_t is None:
            # first admission only: fold the seed into the generator
            self._gen_seed = hash((self._gen_seed,
                                   req.seed & 0x7FFFFFFF)) & 0x7FFFFFFF
            self._gen.manual_seed(self._gen_seed)
        req.block_hashes = [h.hex()[:16] for h in hashes]
        slot.req = req
        self._slot_version += 1
        slot.block_ids = table
        self._bt[i, :len(table)] = table
        self._bt[i, len(table):] = nb        # sentinel
        self._bt_dirty = True
        if getattr(self._proposer, "store", None) is not None:
            # adapter-aware drafting: bind the row to its tenant corpus
            self._proposer.set_tenant(i, self._spec_tenant_seed(req))
        slot.pending = np.asarray(ep[hit:], np.int32)
        slot.first_chunk = True
        slot.hit = hit
        slot.cow = cow
        slot.hashes = hashes
        slot.draft_prompt = ep
        slot.admit_seq = admit_seq
        slot.seq_len = hit
        req.status = "running"
        req.admit_t = now
        req.prefix_hit_tokens = hit
        if hit:
            self._prefix_hits += 1
            self._prefix_hit_tokens += hit
        else:
            self._prefix_misses += 1
        self._prefill_tokens += len(ep) - hit
        if _obs_enabled():
            if req.trace is not None:
                req.trace.add_span(
                    "queue_wait",
                    req.queued_t if req.queued_t is not None else now,
                    now, requeued=bool(req.preemptions))
            sm = _serving_metrics()
            if req.queued_t is not None:
                sm["queue_wait"].observe(now - req.queued_t)
                _slo().observe("queue_wait", now - req.queued_t)
            sm["prefix_hits" if hit else "prefix_misses"].inc()
            if hit:
                sm["prefix_hit_tokens"].inc(hit)
            sm["prefill_tokens"].inc(len(ep) - hit)
            if cow is not None:
                sm["prefix_cow"].inc()
            sm["queue_depth"].set(len(self._sched.waiting))

    def step(self):
        """One scheduling step. The scheduler first applies pending
        cancellations and deadline expirations, then plans this step's
        prefill work: continuation chunks of mid-prefill slots and new
        admissions. Any prefill work runs as ONE mixed admit dispatch
        with every decode-ready slot riding along for one token; with no
        prefill work, the live slots run a pure-decode chunk (or one
        speculative window). Returns False when no work remains.

        Overlapped engine (``overlap``, the default): a pure-decode
        chunk or a verify window is left in flight (its harvest and
        bookkeeping deferred to the next call), and the next step's plan
        is staged against the predicted post-dispatch state. The next
        call harvests it (the loop's one wait), and when the staged plan
        survives validation (no submission, cancellation, eos, deadline
        or slot change touched it; a window also landed exactly on its
        prediction) it replays the next program straight from that plan,
        BEFORE the harvested step's bookkeeping, so the host's collect
        loops, metric commits and the next stage run while the card
        computes. A mispredict drops the plan, commits the harvested step
        and replans: the dispatches, and so the streams, are the
        sequential engine's; the overlapped engine spends one more
        ``step()`` a decode run (the last harvest)."""
        sched = self._sched
        ov = self._ov
        if self._overlap:
            inflight = ov.inflight
            staged, ov.staged = ov.staged, None
        else:
            inflight = staged = None
        if inflight is None and staged is None:
            # sequential entry (the whole story with overlap off)
            sched.begin_step(time.monotonic())
            if not sched.waiting \
                    and not any(s.req is not None for s in self._slots):
                return False
            obs = _obs_enabled()
            t0 = time.monotonic() if obs else 0.0
            # step attribution span (None when the step_profile flag is
            # off): plan runs until mark_dispatch, the harvest sync sits
            # between mark_harvest/mark_harvested, end() attributes the
            # rest to the host bubble (overlapped: to plan-ahead)
            sp = self._stepprof.begin()
            sched._in_step = True
            try:
                if self._overlap:
                    ov.steps += 1
                return self._plan_and_dispatch(obs, t0, sp)
            finally:
                sched._in_step = False
        obs = _obs_enabled()
        t0 = time.monotonic() if obs else 0.0
        sp = self._stepprof.begin()
        sched._in_step = True
        try:
            ov.steps += 1
            harvested = (None, None, None)      # (toks, acc, bound)
            spec_if = inflight is not None and inflight["kind"] == "spec"
            if inflight is not None:
                if sp:
                    sp.mark_harvest()
                harvested = self._harvest_inflight(inflight)
                if sp:
                    sp.mark_harvested()
            toks_np, acc_np, bound_np = harvested
            if staged is not None:
                if staged["kind"] == "spec":
                    held = spec_if and self._staged_spec_valid(
                        staged, acc_np, bound_np)
                else:
                    held = self._staged_valid(staged) and (
                        toks_np is None
                        or not self._eos_hit(toks_np, inflight["live"]))
                if held:
                    # the plan held: dispatch step N+1 before step N's
                    # bookkeeping. begin_step is skipped soundly: the
                    # validation proved it a no-op (nothing waiting, no
                    # cancellation pending, no deadline among the live)
                    if staged["kind"] == "spec":
                        nf = self._dispatch_spec_staged(staged, obs, t0,
                                                        sp)
                    else:
                        nf = self._dispatch_decode(obs, t0, sp)
                    if sp:
                        sp.mark_plan_ahead()
                        sp.overlapped = True
                    ov.overlapped += 1
                    self._commit_and_stage(inflight, harvested, nf,
                                           staged["kind"], obs, sp)
                    return True
                # mispredict: reality diverged from the staged plan
                # (submit, cancel, eos, deadline, preemption, or a
                # window's boundary short of the prediction): drop it
                # and replan from the reconciled state
                ov.mispredicts += 1
                if sp:
                    sp.mispredict = True
            n = 0
            if inflight is not None:
                n = self._bookkeeping(inflight, harvested, obs)
            sched.begin_step(time.monotonic())
            if not sched.waiting \
                    and not any(s.req is not None for s in self._slots):
                # the deferred harvest WAS this call's work; the next
                # call sees the drained state and returns False
                if sp:
                    self._stepprof.end(sp, tokens=n, live=0)
                return True
            return self._plan_and_dispatch(obs, t0, sp)
        finally:
            sched._in_step = False

    def _plan_and_dispatch(self, obs, t0, sp):
        """The sequential (non-staged) step body: the full scheduler
        plan, then one admit, spec or decode dispatch (and, overlapped,
        the next step's stage)."""
        sched = self._sched
        work = sched.plan_step(time.monotonic())
        if work:
            self._run_prefill(work, obs, t0, sp)
            self._stage_next()
            return True
        if not any(s.req is not None for s in self._slots):
            # queue non-empty but nothing admitted and no live work:
            # impossible by construction (zero live slots frees every
            # block, and submit() bounds each request to the pool).
            # Guard instead of spinning.
            raise RuntimeError("no admissible request and no live slot")
        if self._spec is not None:
            return self._spec_step(obs, t0, sp)
        r = self._decode_step(obs, t0, sp)
        self._stage_next()
        return r

    # -- the overlapped engine ---------------------------------------------
    def _harvest_inflight(self, inflight):
        """Read a deferred dispatch's outputs back (the loop's one wait):
        (tokens [chunk, S], None, None) of a decode chunk, or (None,
        accepted counts [S], boundary tokens [S]) of a verify window.
        The static buffers they come from are reused by the next
        replay, which is why the harvest precedes every dispatch; from
        here on nothing is in flight until that dispatch."""
        if inflight["kind"] == "spec":
            acc_np, bound_np = _harvest_sync(self._verify_ladder.result)
            out = (None, acc_np, bound_np)
        else:
            out = (_harvest_sync(inflight["toks"]), None, None)
        self._ov.inflight = None
        return out

    def _bookkeeping(self, inflight, harvested, obs) -> int:
        """Commit one harvested decode chunk or verify window."""
        toks_np, acc_np, bound_np = harvested
        if inflight["kind"] == "spec":
            return self._spec_bookkeeping(inflight, acc_np, bound_np, obs)
        return self._decode_bookkeeping(inflight, toks_np, obs)

    def _commit_and_stage(self, inflight, harvested, nf, kind, obs, sp):
        """What a staged step does once its replay is enqueued, while the
        card computes it: the harvested step's bookkeeping, then the
        stage of the step after. Host work only: nothing here reads the
        card or waits for it."""
        self._ov.inflight = nf
        n = 0
        if inflight is not None:
            n = self._bookkeeping(inflight, harvested, obs)
        if kind == "spec":
            self._stage_next_spec(nf)
        else:
            self._stage_next()
        if sp:
            self._stepprof.end(
                sp, tokens=n,
                live=sum(s.req is not None for s in self._slots))

    def _stage_next(self):
        """Stage the next step's plan against the PREDICTED post-chunk
        state. Only the steady pure-decode state stages: any prefill
        work, speculation, waiting or cancel traffic, a deadline-bearing
        request, or a request that completes inside the inflight chunk
        sends the next step through the full scheduler plan instead."""
        ov = self._ov
        ov.staged = None
        if not self._overlap or self._spec is not None:
            return
        if not self._sched.plan_ahead_safe():
            return
        ahead = self.chunk if ov.inflight is not None else 0
        live = []
        for i, s in enumerate(self._slots):
            r = s.req
            if r is None:
                continue
            if s.pending is not None:
                return          # mid-prefill: the next step must admit
            if r.deadline_s is not None:
                return          # expiry is checked every step
            if len(r.tokens) + ahead >= r.max_new_tokens:
                return          # completes inside the inflight chunk
            live.append(i)
        if not live:
            return
        ov.staged = {"kind": "decode", "slot_version": self._slot_version,
                     "live": tuple(live)}

    def _staged_valid(self, staged) -> bool:
        """Is a staged decode plan still exactly right? Nothing submitted
        (waiting empty), no cancellation pending, no slot bound or freed
        since staging. Deadlines need no check: staging refused
        deadline-bearing requests, and new ones arrive by submit."""
        return (staged["slot_version"] == self._slot_version
                and self._sched.plan_ahead_safe())

    def _eos_hit(self, toks_np, live) -> bool:
        """Did a live row emit eos inside the harvested chunk? Its slot
        frees during the bookkeeping, so the staged plan is dropped (the
        chunk itself was safe: an overshooting row writes only its own
        private tail blocks or sentinel rows)."""
        eos = self.eos_token_id
        if eos is None:
            return False
        rows = [i for i, l in enumerate(live) if l]
        return bool((toks_np[:, rows] == eos).any())

    def _drain_inflight(self):
        """Commit any deferred dispatch and drop the staged plan, so
        state surgery from outside step() (preemption) sees reconciled
        slots. A no-op with the overlapped engine off or idle."""
        if not self._overlap:
            return
        ov = self._ov
        ov.staged = None
        inflight = ov.inflight
        if inflight is not None:
            self._bookkeeping(inflight, self._harvest_inflight(inflight),
                              _obs_enabled())

    def _dispatch_decode(self, obs, t0, sp=None):
        """Launch one pure-decode chunk from device-resident state and
        return the inflight record (results not yet harvested). Dead
        rows start from junk tokens, which is safe: rows are
        independent, sentinel tables drop their writes, and select()
        masks their outputs to eos. The graph reads every weight by
        address: a weight replaced since it was captured
        (``param.data = ...``, ``load_state_dict(assign=True)``)
        re-captures it first, so a replay never reads a freed one. The
        live mask and the table are uploaded only when they changed (a
        staged plan changed neither)."""
        self._check_weights()
        live = [s.req is not None for s in self._slots]
        if live != self._live_up:
            self._live_dev.copy_(torch.tensor(live))
            self._live_up = live
        if self._bt_dirty:      # freed-slot rows were neutralized
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        if sp:
            sp.kind = "decode"
            sp.mark_dispatch()
        self._chunk_prog()
        self._chunk_steps += 1
        return {"kind": "decode", "toks": self._toks_dev, "live": live,
                "t0": t0 if obs else 0.0}

    def _decode_bookkeeping(self, inflight, toks_np, obs, lps=None) -> int:
        """Commit one harvested decode chunk: trace spans, seq_len
        advances, per-token collection (eos/max_new may free slots),
        and metrics. ``lps`` [chunk, S]: each token's log p (logprobs)."""
        live = inflight["live"]
        t0 = inflight["t0"]
        if obs:
            t1 = time.monotonic()
            for i, s in enumerate(self._slots):
                if (s.req is not None and live[i]
                        and s.req.trace is not None):
                    s.req.trace.add_span("decode", t0, t1,
                                         tokens=self.chunk, via="chunk")
        for i, l in enumerate(live):
            if l:
                self._slots[i].seq_len += self.chunk
        n_emitted = 0
        for t in range(self.chunk):
            for i, s in enumerate(self._slots):
                if s.req is not None and live[i]:
                    if lps is not None:
                        s.req.token_logprobs.append(float(lps[t, i]))
                    self._collect(i, s, toks_np[t, i], obs)
                    n_emitted += 1
        if obs:
            sm = _serving_metrics()
            sm["chunk_steps"].inc()
            sm["tokens"].inc(n_emitted)
            dt = time.monotonic() - t0
            # every live sequence advanced `chunk` tokens in dt
            if n_emitted:
                sm["tpot"].observe_many(dt / max(1, self.chunk),
                                        n_emitted)
                _slo().observe("tpot", dt / max(1, self.chunk),
                               count=n_emitted)
            self._record_state_metrics(sm)
        return n_emitted

    def _run_prefill(self, work, obs, t0, sp=None):
        """One mixed admit dispatch: every slot in `work` feeds its
        prefill (bounded by the scheduler's chunk budget); every other
        live, decode-ready slot rides along with its last token. Hash
        registration happens once a slot's last chunk has written its
        blocks."""
        S = self.slots
        nb = self._num_blocks
        cap = self._sched.chunk_cap()
        lens = np.zeros((3, S), np.int32)    # new_lens, reset, hit_lens
        new_lens, reset, hit_lens = lens
        cow = []
        chunks = {}
        for i in work:
            s = self._slots[i]
            n = min(len(s.pending), cap)
            chunks[i] = n
            new_lens[i] = n
            if s.first_chunk:
                reset[i] = 1
                hit_lens[i] = s.hit
                if s.cow is not None:
                    cow.append(s.cow)
        riders = [i for i, s in enumerate(self._slots)
                  if s.req is not None and i not in chunks]
        for i in riders:
            new_lens[i] = 1
        # the token buffer's width (the JAX package's admit ladder): the
        # narrowest power of two over the longest chunk while the prefix
        # cache or chunked prefill is on, else max_prompt_len
        ladder = (self._pool.prefix_cache
                  or self._sched.prefill_chunk is not None)
        w = pow2_width(int(new_lens.max()) if ladder
                       else self.max_prompt_len, self.max_prompt_len)
        toks = np.zeros((S, w), np.int32)
        for i, n in chunks.items():
            toks[i, :n] = self._slots[i].pending[:n]
        for i in riders:
            toks[i, 0] = self._slots[i].last_tok
        if self._bt_dirty:
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        if sp:
            sp.kind = "admit"
            sp.mark_dispatch()
        nxt_dev = self._admit(toks, lens, cow)
        if sp:
            sp.mark_harvest()
        nxt = _harvest_sync(nxt_dev)
        # logprobs: the raw logits the tokens were selected from
        lps = (_token_logprobs(_harvest_sync(self._raw_lv), nxt)
               if self._logprobs else None)
        if sp:
            sp.mark_harvested()
        # span the dispatch BEFORE _collect: a request can complete on
        # its very first token, and its trace closes inside _collect
        t1 = time.monotonic() if obs else 0.0
        n_stream = 0
        on_admit = []
        for i, n in chunks.items():
            s = self._slots[i]
            s.pending = s.pending[n:]
            s.seq_len += n
            final = len(s.pending) == 0
            s.first_chunk = False
            cowed = s.cow is not None
            s.cow = None
            if obs and s.req.trace is not None:
                s.req.trace.add_span(
                    "admit", t0, t1, width=w,
                    prefill_tokens=int(n),
                    prefix_hit_tokens=int(hit_lens[i]),
                    cow=cowed, final=final)
            if final:
                # the last chunk has WRITTEN every prompt block:
                # register the chained hashes so the next identical
                # prefix shares them (first writer wins)
                for k, h in enumerate(s.hashes):
                    self._pool.register(s.block_ids[k], h)
                if s.draft_prompt is not None:
                    on_admit.append((i, s.draft_prompt))
                s._clear_prefill()
                if lps is not None:
                    s.req.token_logprobs.append(float(lps[i]))
                self._collect(i, s, nxt[i], obs)
                n_stream += 1
            # else: mid-prompt logits, the selected token is discarded
        for i in riders:
            s = self._slots[i]
            s.seq_len += 1
            if obs and s.req is not None and s.req.trace is not None:
                s.req.trace.add_span("decode", t0, t1, tokens=1,
                                     via="admit")
            if lps is not None and s.req is not None:
                s.req.token_logprobs.append(float(lps[i]))
            self._collect(i, s, nxt[i], obs)
            n_stream += 1
        if self._proposer is not None and on_admit:
            # a draft model prefills its own pools with the full committed
            # history (no prefix cache of its own); a request that
            # completed on its first token is skipped
            self._proposer.on_admit([(i, dp) for i, dp in on_admit
                                     if self._slots[i].req is not None])
        self._admit_steps += 1
        if obs:
            sm = _serving_metrics()
            sm["admit_steps"].inc()
            sm["tokens"].inc(n_stream)
            dt = time.monotonic() - t0
            for _ in riders:
                sm["tpot"].observe(dt)
            if riders:
                _slo().observe("tpot", dt, count=len(riders))
            self._record_state_metrics(sm)
        if sp:
            self._stepprof.end(
                sp, tokens=n_stream,
                live=sum(s.req is not None for s in self._slots))

    def _decode_step(self, obs, t0, sp=None):
        """One pure-decode chunk for the live slots. Overlapped engine:
        dispatch only (the harvest and the bookkeeping are deferred to
        the next step() call); sequential: dispatch, the one harvest read
        of its [chunk, S] tokens, bookkeeping."""
        if self._logprobs:
            return self._decode_step_hostsample(obs, t0, sp)
        inflight = self._dispatch_decode(obs, t0, sp)
        if self._overlap:
            self._ov.inflight = inflight
            if sp:
                self._stepprof.end(
                    sp, tokens=0,
                    live=sum(s.req is not None for s in self._slots))
            return True
        if sp:
            sp.mark_harvest()
        toks_np, _, _ = self._harvest_inflight(inflight)    # [chunk, S]
        if sp:
            sp.mark_harvested()
        n_emitted = self._decode_bookkeeping(inflight, toks_np, obs)
        if sp:
            self._stepprof.end(
                sp, tokens=n_emitted,
                live=sum(s.req is not None for s in self._slots))
        return True

    def _decode_step_hostsample(self, obs, t0, sp=None):
        """Decode with logprobs: every live slot advances ``chunk``
        tokens a step through ``chunk`` replays of the width-1 raw admit,
        each followed by the device sampler's selection over its logits
        (``_raw_select``; the next replay reads the selected tokens on
        the card), then one read of the tokens and the [chunk, S, V]
        logits, whose log-softmax at each emitted token is its log p.
        Rows that emit eos mid-chunk go on to the chunk's end, as in the
        decode chunk; their tail tokens are never emitted."""
        S = self.slots
        live = np.array([s.req is not None for s in self._slots])
        toks = np.zeros((S, 1), np.int32)
        for i, s in enumerate(self._slots):
            if s.req is not None:
                toks[i, 0] = s.last_tok
        lens = np.zeros((3, S), np.int32)
        lens[0] = live
        if self._bt_dirty:      # freed-slot rows were neutralized
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        prog = self._admit_prepare(toks, lens, [])
        if sp:
            sp.mark_dispatch()
        feed = self._admit_toks[1]
        out_toks, out_lv = [], []
        with torch.inference_mode():
            for _ in range(self.chunk):
                prog()
                nxt = self._raw_select()
                feed[:, 0].copy_(nxt)
                out_toks.append(nxt)
                out_lv.append(self._raw_lv.clone())
            out_toks, out_lv = torch.stack(out_toks), torch.stack(out_lv)
        if sp:
            sp.mark_harvest()
        nxt = _harvest_sync(out_toks)                       # [chunk, S]
        lps = _token_logprobs(_harvest_sync(out_lv), nxt)
        if sp:
            sp.mark_harvested()
        self._chunk_steps += 1
        n_emitted = self._decode_bookkeeping(
            {"live": list(live), "t0": t0 if obs else 0.0}, nxt, obs, lps)
        if sp:
            self._stepprof.end(
                sp, tokens=n_emitted,
                live=sum(s.req is not None for s in self._slots))
        return True

    # -- speculative decoding ----------------------------------------------
    def _spec_tenant_seed(self, req) -> bytes:
        """The draft-corpus key of a request: the shared base-model corpus
        (an adapter's own corpus comes with LoRA serving, not ported)."""
        return b"__base__"

    def _spec_contexts(self):
        """(contexts, caps) for this step's spec windows: every live
        slot's full token history, with drafting capped so the window
        never emits past the request's remaining budget (the commit
        boundary stays within the blocks sized at submit())."""
        k = self._spec.num_draft_tokens
        contexts, caps = [], {}
        for i, s in enumerate(self._slots):
            if s.req is None:
                continue
            req = s.req
            hist = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int64)])
            contexts.append((i, hist))
            caps[i] = max(0, min(k, req.max_new_tokens
                                 - len(req.tokens) - 1))
        return contexts, caps

    def _build_spec_window(self, contexts, caps, proposals):
        """The dispatch-ready window from one round of proposals:
        (program, width, toks, new_lens, old_lens, rows). Committed
        lengths come from the host mirror (s.seq_len), never from the
        device. Free rows' values are irrelevant: their sentinel tables
        audit to the empty span, their new_lens stays 0, and an admit
        resets the row."""
        S = self.slots
        need = 1 + max((len(proposals.get(i, ())) for i, _ in contexts),
                       default=0)
        prog, w = self._verify_ladder.get(need)
        toks = np.zeros((S, w), np.int32)
        new_lens = np.zeros((S,), np.int32)
        old_lens = np.array([s.seq_len for s in self._slots], np.int32)
        rows = []
        for i, _ in contexts:
            d = np.asarray(proposals.get(i, np.zeros((0,), np.int64)))
            d = d[:min(caps[i], w - 1)]
            proposals[i] = d
            toks[i, 0] = self._slots[i].last_tok
            toks[i, 1:1 + len(d)] = d
            new_lens[i] = 1 + len(d)
            rows.append(i)
        return prog, w, toks, new_lens, old_lens, rows

    def _dispatch_spec_window(self, prog, w, toks, new_lens, old_lens,
                              proposals, rows, obs, t0, t_verify0, sp):
        """Audit and dispatch one window; returns the inflight record
        (acceptance not yet read back). A device-accept program folds
        the acceptance, rolls the lengths back and refreshes the
        last-token vector on the card; a host-accept one leaves the
        chain or the logits (and the window's uniforms) in the ladder's
        buffers."""
        from ..incubate.nn.functional.paged_kv import write_span_blocks

        # the window writes the FULL width w for EVERY row (new_lens
        # masks reads, never writes), so the audited span is w from each
        # row's committed length, padding included: every touched block
        # must be private to its slot, never a shared or canonical
        # cached prefix block (freed rows hold sentinel entries and
        # audit to the empty span)
        for i in range(self.slots):
            self._pool.assert_private(write_span_blocks(
                self._bt[i], int(old_lens[i]), w, self._kv_block_size,
                self._num_blocks))
        if self._bt_dirty:
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        self._verify_ladder.load(toks, new_lens)
        if sp:
            sp.kind = "spec"
            sp.mark_dispatch()
        prog()
        self._spec_steps += 1
        return {"kind": "spec", "rows": tuple(rows), "proposals": proposals,
                "new_lens": new_lens, "old_lens": old_lens, "width": w,
                "t0": t0, "t_verify0": t_verify0}

    def _spec_bookkeeping(self, inflight, acc_np, bound_np, obs,
                          lv=None) -> int:
        """Commit one window from its two int32 vectors: each row's
        emitted tokens are drafts[:n_accepted] + [boundary]. ``lv`` (the
        logprobs path's host accept) is the window's [S, w, V] logits:
        each emitted token's log p comes from its own window position
        (a draft's from its accept position, the boundary's from its
        resample or bonus position)."""
        t0 = inflight["t0"]
        t_verify0 = inflight["t_verify0"]
        w = inflight["width"]
        old_lens = inflight["old_lens"]
        proposals = inflight["proposals"]
        t_acc0 = time.monotonic() if obs else 0.0
        n_emitted = realized_acc = proposed = 0
        for i in inflight["rows"]:
            s = self._slots[i]
            drafts = proposals[i]
            n_acc = min(int(acc_np[i]), len(drafts))
            emitted = [int(t) for t in drafts[:n_acc]]
            emitted.append(int(bound_np[i]))
            self._spec_proposed += len(drafts)
            proposed += len(drafts)
            req = s.req
            row_acc = 0
            if obs and req is not None and req.trace is not None:
                # the window's span BEFORE _collect (which may finish the
                # request and close its trace); propose, verify and
                # accept are its children, so the per-phase breakdown
                # (top level only) never counts them twice
                t1 = time.monotonic()
                d = req.trace.add_span(
                    "decode", t0, t1, via="spec",
                    proposed=len(drafts), accepted=int(n_acc))
                req.trace.add_span("spec.propose", t0, t_verify0,
                                   parent=d)
                req.trace.add_span("spec.verify", t_verify0, t_acc0,
                                   parent=d, width=int(w))
                req.trace.add_span("spec.accept", t_acc0, t1, parent=d)
            for j, t in enumerate(emitted):
                if s.req is None:      # eos / max_new freed the slot;
                    break              # tokens past it are discarded
                if j < n_acc:          # count only accepted drafts that
                    self._spec_accepted += 1      # enter the stream
                    req.spec_accepted_tokens += 1
                    row_acc += 1
                if lv is not None:
                    req.token_logprobs.append(float(
                        _token_logprobs(lv[i, j], t)))
                self._collect(i, s, int(t), obs)
                n_emitted += 1
            realized_acc += row_acc
            if s.req is not None:
                s.seq_len = int(old_lens[i]) + n_acc + 1
            self._proposer.rollback(i, int(old_lens[i]) + n_acc + 1)
            if obs and req is not None and req.adapter is not None:
                pa = self._spec_by_adapter.setdefault(req.adapter, [0, 0])
                pa[0] += len(drafts)
                pa[1] += row_acc
        if obs:
            now = time.monotonic()
            sm = _serving_metrics()
            sm["tokens"].inc(n_emitted)
            sm["spec_proposed"].inc(proposed)
            sm["spec_accepted"].inc(realized_acc)
            sm["spec_rate"].set(self._spec_accepted
                                / max(1, self._spec_proposed))
            for name, (p, a) in self._spec_by_adapter.items():
                sm["spec_rate"].set(a / max(1, p), adapter=name)
            sm["spec_draft_lat"].observe(t_verify0 - t0)
            sm["spec_verify_lat"].observe(now - t_verify0)
            if n_emitted:
                sm["tpot"].observe_many((now - t0) / n_emitted, n_emitted)
                _slo().observe("tpot", (now - t0) / n_emitted,
                               count=n_emitted)
            self._record_state_metrics(sm)
        return n_emitted

    def _spec_window(self, obs, t0, sp):
        """Propose, build and dispatch this step's window. Returns the
        inflight record."""
        self._check_weights()         # before the width's program is got
        contexts, caps = self._spec_contexts()
        proposals = self._proposer.propose(contexts, caps)
        t_verify0 = time.monotonic() if obs else 0.0
        prog, w, toks, new_lens, old_lens, rows = \
            self._build_spec_window(contexts, caps, proposals)
        return self._dispatch_spec_window(prog, w, toks, new_lens,
                                          old_lens, proposals, rows, obs,
                                          t0, t_verify0, sp)

    def _stage_next_spec(self, inflight):
        """Stage window N+1 while window N verifies on the card, assuming
        FULL acceptance of N and a predicted boundary token (the
        proposer's own one-token guess). The staged window is the one
        the sequential path would build if the prediction lands: the
        guess extends the history the next propose() would see, the caps
        use the post-window token counts, the committed lengths advance
        by the whole window; drafting of a ``stage_ahead`` proposer is a
        pure function of the history, so a validated staged dispatch is
        the sequential replan's (the same drafts, width and draw).
        Validation demands acc == m-1 and bound == the guess per row;
        anything short of that is a mispredict.

        Refusals mirror decode staging (scheduler traffic, mid-prefill,
        deadline-bearing requests, a request that would complete inside
        window N) plus an eos among N's drafts or the guess, or no
        guess."""
        ov = self._ov
        ov.staged = None
        if not self._spec_stage:
            return
        if not self._sched.plan_ahead_safe("spec"):
            return
        k = self._spec.num_draft_tokens
        eos = self.eos_token_id
        new_lens = inflight["new_lens"]
        old_lens = np.asarray(inflight["old_lens"]).copy()
        proposals, last, rows, expect = {}, {}, [], []
        for i, s in enumerate(self._slots):
            r = s.req
            if r is None:
                continue
            if s.pending is not None or r.deadline_s is not None:
                return
            if i not in inflight["proposals"]:
                return
            m = int(new_lens[i])
            drafts = np.asarray(inflight["proposals"][i], np.int64)
            if len(r.tokens) + m >= r.max_new_tokens:
                return          # completes inside window N
            if eos is not None and (drafts == eos).any():
                return          # would free during N's bookkeeping
            ph = np.concatenate(
                [r.prompt, np.asarray(r.tokens, np.int64), drafts])
            b = self._proposer.predict(i, ph, 1)
            if not len(b):
                return          # no boundary guess, nothing to stage
            bhat = int(b[0])
            if eos is not None and bhat == eos:
                return
            cap_i = max(0, min(k, r.max_new_tokens
                               - (len(r.tokens) + m) - 1))
            nd = self._proposer.predict(
                i, np.append(ph, np.int64(bhat)), cap_i)
            proposals[i] = np.asarray(nd, np.int64)
            last[i] = bhat
            old_lens[i] = int(inflight["old_lens"][i]) + m
            rows.append(i)
            expect.append((i, m, bhat))
        if not rows:
            return
        ov.staged = {"kind": "spec", "slot_version": self._slot_version,
                     "rows": tuple(rows), "proposals": proposals,
                     "last": last, "old_lens": old_lens,
                     "expect": tuple(expect)}

    def _staged_spec_valid(self, staged, acc_np, bound_np) -> bool:
        """Did window N land EXACTLY on the staged prediction? Version
        fencing and scheduler quiescence as for decode, plus full
        acceptance and the predicted boundary token on every row."""
        if staged["slot_version"] != self._slot_version \
                or not self._sched.plan_ahead_safe("spec"):
            return False
        return all(int(acc_np[i]) == m - 1 and int(bound_np[i]) == bhat
                   for i, m, bhat in staged["expect"])

    def _dispatch_spec_staged(self, staged, obs, t0, sp=None):
        """Build the validated staged window and dispatch it before the
        harvested window's bookkeeping: each row's first token is the
        validated boundary, the committed lengths the fully accepted ones
        the card already holds, the drafts those proposed at staging
        time (the proposal ran behind the previous window)."""
        self._check_weights()         # before the width's program is got
        S = self.slots
        proposals = staged["proposals"]
        need = 1 + max((len(proposals[i]) for i in staged["rows"]),
                       default=0)
        prog, w = self._verify_ladder.get(need)
        toks = np.zeros((S, w), np.int32)
        new_lens = np.zeros((S,), np.int32)
        props = {}
        for i in staged["rows"]:
            d = np.asarray(proposals[i], np.int64)[:w - 1]
            props[i] = d
            toks[i, 0] = staged["last"][i]
            toks[i, 1:1 + len(d)] = d
            new_lens[i] = 1 + len(d)
        return self._dispatch_spec_window(
            prog, w, toks, new_lens, staged["old_lens"], props,
            staged["rows"], obs, t0, time.monotonic() if obs else 0.0, sp)

    def _spec_step(self, obs, t0, sp=None):
        """One speculative decode step for every live slot: propose up to
        k draft tokens a slot (the host n-gram lookup or the draft
        model's own paged decode), then verify AND accept every window
        in ONE replay of the window width's program: greedy matching or
        exact rejection sampling runs on the card (``acceptance_fold``)
        and only the accepted counts and boundary tokens are read back.
        Rejected drafts roll the slot's cached length back to its
        accepted boundary on the card: their KV stays in the slot's
        private tail blocks (audited before the dispatch), invisible to
        reads and overwritten from the boundary up by the next window.
        Overlapped engine: the window is left in flight and the next
        window staged from the predicted post-window history."""
        if self._spec_accept != "device":
            return self._spec_step_host(obs, t0, sp)
        inflight = self._spec_window(obs, t0, sp)
        if self._overlap:
            self._ov.inflight = inflight
            self._stage_next_spec(inflight)
            if sp:
                self._stepprof.end(
                    sp, tokens=0,
                    live=sum(s.req is not None for s in self._slots))
            return True
        if sp:
            sp.mark_harvest()
        _, acc_np, bound_np = self._harvest_inflight(inflight)
        if sp:
            sp.mark_harvested()
        n = self._spec_bookkeeping(inflight, acc_np, bound_np, obs)
        if sp:
            self._stepprof.end(
                sp, tokens=n,
                live=sum(s.req is not None for s in self._slots))
        return True

    def _spec_step_host(self, obs, t0, sp=None):
        """Host-accept spec step (the logprobs path, and
        PADDLE_SPEC_DEVICE_ACCEPT=0): greedy reads the argmax chain back
        and accepts with the numpy ``greedy_accept``; sampled, or with
        logprobs, runs ``fold_host``, the device program's fold, over
        the window's logits and uniforms, so the decisions and boundary
        draws are the device path's; logprobs also reads the [S, w, V]
        logits back for each emitted token's log p. The lengths are
        rolled back from the host."""
        from ..incubate.nn.functional.paged_kv import rollback_seq_lens
        from .speculative import greedy_accept

        ladder = self._verify_ladder
        inflight = self._spec_window(obs, t0, sp)
        w, rows = inflight["width"], inflight["rows"]
        new_lens, old_lens = inflight["new_lens"], inflight["old_lens"]
        if sp:
            sp.mark_harvest()
        lv_np = None
        if ladder.greedy:
            chain = _harvest_sync(ladder.out[w])      # [S, w] int32
            acc_np = np.zeros((self.slots,), np.int32)
            bound_np = np.zeros((self.slots,), np.int32)
            for i in rows:
                emitted, n_acc = greedy_accept(
                    chain[i, :int(new_lens[i])], inflight["proposals"][i])
                acc_np[i] = n_acc
                bound_np[i] = emitted[-1]
        else:
            with torch.inference_mode():
                folded = torch.stack(ladder.fold_host(
                    ladder.out[w], ladder.toks[w], ladder.new_lens,
                    ladder.u))
            acc_np, bound_np = _harvest_sync(folded)
            if self._logprobs:
                lv_np = _harvest_sync(ladder.out[w])  # [S, w, V] fp32
        if sp:
            sp.mark_harvested()
        n = self._spec_bookkeeping(inflight, acc_np, bound_np, obs,
                                   lv=lv_np)
        # the host program advanced no length: the accepted boundary per
        # row, the committed length elsewhere
        accepted = old_lens + new_lens
        for i in rows:
            accepted[i] = old_lens[i] + min(
                int(acc_np[i]), int(new_lens[i]) - 1) + 1
        with torch.inference_mode():
            self._seq_lens.copy_(torch.from_numpy(rollback_seq_lens(
                old_lens + new_lens, accepted)))
        if sp:
            self._stepprof.end(
                sp, tokens=n,
                live=sum(s.req is not None for s in self._slots))
        return True

    def run(self):
        """Drain the queue; returns {req_id: generated token array} for
        every request completed since the previous run(), including
        those that finished during manual step() calls."""
        while self.step():
            pass
        done = {r.req_id: np.asarray(r.tokens, np.int64)
                for r in self._completed}
        self._completed = []
        return done


race_handoff("ContinuousBatchingSession.*",
             "session-init on the caller thread, then engine-thread "
             "single-writer (one thread drives step()/run())")
# the staged plan and the deferred harvest never leave step() and
# _drain_inflight(), both on the thread that owns the session; the
# flight recorder's dump thread only reads the counters, which a health
# handler may also read lock-free: a torn read costs one stale sample,
# never a token
race_handoff("_OverlapState.*",
             "engine-thread single-writer: staged plans and deferred "
             "harvests never escape step()/_drain_inflight(); the "
             "flight-recorder dump thread only reads counters")
for _ctr in ("steps", "overlapped", "mispredicts"):
    race_exempt(f"_OverlapState.{_ctr}",
                "GIL-atomic int read by monitoring (flight recorder, "
                "health); the engine thread is the only writer")
del _ctr
