"""Draft-token proposers for speculative decoding. Counterpart of
paddle_tpu/inference/speculative/proposers.py: the n-gram proposer and
the tenant corpora are its numpy, copied; the draft model runs on the
port's paged pools.

Two families, one protocol (the serving sessions only see the
protocol):

- ``NgramProposer`` — prompt-lookup self-drafting (the vLLM/SGLang
  "[ngram]" method): match the sequence's last n-gram against its OWN
  earlier token history and propose the continuation that followed the
  previous occurrence. Zero extra weights, pure host work; acceptance
  is high exactly when the continuation is repetitive (code, quoting,
  structured output) and gracefully zero when it is not.
- ``DraftModelProposer`` — a smaller causal LM proposes greedily
  through its own kv-heads-sized paged-KV allocation (its OWN pools and
  block tables, sized by ITS ModelAdapter geometry), kept position-
  synchronized with the target by the same rollback the target applies.
  Its one-token decode step is one CUDA graph on a card; its prefill
  runs eagerly.

Both proposers are deterministic (greedy drafts), i.e. the proposal
distribution q is one-hot — ``rejection.rejection_accept`` handles that
case exactly (accept with p(d), residual = p with d zeroed), so sampled
serving preserves the target distribution with either proposer.

Protocol (per serving session; slot/row indices are the session's):
    on_admit(pairs)        pairs = [(i, prompt_tokens)] admitted NOW
    propose(contexts, caps) contexts = [(i, history)], caps = {i: max
                           drafts}; -> {i: np draft tokens (<= cap)}
    rollback(i, new_len)   the target committed new_len cached tokens
                           for slot i; discard any draft state past it

Adapter-aware drafting: ``AdapterDraftStore`` keeps bounded per-tenant
n-gram corpora keyed by a hash identity (``adapter_hash_seed``; every
request of the port shares the base-model corpus until LoRA serving is
ported, ROADMAP queue A item 6), learned from committed streams — a
sequence whose OWN history misses falls back to matching its tenant
corpus, and never another tenant's. The n-gram proposer keeps
``stage_ahead``/``predict``, the hooks of the JAX package's overlapped
engine (not ported: the port runs the sequential engine).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

import torch

from ...analysis.sanitizers import race_handoff, race_track

__all__ = ["AdapterDraftStore", "NgramProposer", "DraftModelProposer",
           "build_proposer"]


def _trace_t0() -> float:
    """Span start when tracing is live, else 0.0 — so the flag-off
    path in propose() stays one bool test."""
    from ...observability.tracing import get_tracer

    return time.monotonic() if get_tracer().active() else 0.0


def _record_propose_span(t0: float, proposer: str, rows: int):
    """Process-level propose span (the serving loop separately charges
    each traced request its per-window spec.propose child)."""
    from ...observability.tracing import get_tracer

    get_tracer().record_span("spec.propose", t0, proposer=proposer,
                             rows=rows)


def _ngram_lookup(hist, needle_src, k: int, ngram_max: int,
                  ngram_min: int):
    """Continuation tokens from `hist` matching the final n-gram of
    `needle_src` (n-gram tried ngram_max down to ngram_min). hist and
    needle_src are the SAME array for self-lookup; they differ on the
    tenant-corpus fallback (the needle is the live sequence, the hay a
    finished stream of the same tenant). Returns up to k tokens."""
    from numpy.lib.stride_tricks import sliding_window_view

    own = hist is needle_src
    # self-lookup: candidate windows must END before the end, so the
    # suffix's own (trivial) occurrence never matches and every match
    # has at least one continuation token. Corpus lookup has no such
    # trivial match — the whole stream is hay.
    hay = hist[:-1] if own else hist
    for n in range(min(ngram_max, len(hay)), ngram_min - 1, -1):
        if len(hay) < n or len(needle_src) < n:
            continue
        wins = sliding_window_view(hay, n)
        hits = np.nonzero((wins == needle_src[-n:]).all(axis=1))[0]
        if len(hits):
            # prefer the most RECENT occurrence that still has a
            # full k-token continuation; a short-period stream
            # would otherwise always pick the match butting against
            # the end of history and propose a 1-token stub
            full = hits[hits + n + k <= len(hist)]
            s = int(full[-1]) if len(full) else int(hits[0])
            cont = hist[s + n:s + n + k]
            if len(cont):
                return cont.copy()
    return np.zeros((0,), np.int64)


@race_track
class AdapterDraftStore:
    """Bounded per-tenant n-gram corpora for adapter-aware drafting.

    Keys are adapter-seeded hash identities (bytes, as
    paged_kv.adapter_hash_seed gives them), so
    tenant A's committed streams can never feed tenant B's drafts —
    the same byte-level isolation rule the prefix cache enforces.
    ``observe`` learns a finished/committed stream (oldest streams
    dropped past the per-tenant token budget); ``lookup`` is the
    fallback the n-gram proposer consults when a sequence's OWN
    history has no match; ``evict`` drops a tenant's corpus alongside
    its adapter (a LoRA manager's eviction listener, once LoRA serving
    is ported)."""

    def __init__(self, cap_tokens: int = 8192):
        self.cap_tokens = int(cap_tokens)
        self._corpora = {}       # seed bytes -> list of np streams
        self._tokens = {}        # seed bytes -> resident token count

    def observe(self, seed: bytes, tokens):
        t = np.asarray(tokens, np.int64).reshape(-1)
        if not len(t) or self.cap_tokens <= 0:
            return
        streams = self._corpora.setdefault(seed, [])
        streams.append(t[-self.cap_tokens:])
        self._tokens[seed] = self._tokens.get(seed, 0) + len(streams[-1])
        while self._tokens[seed] > self.cap_tokens and len(streams) > 1:
            self._tokens[seed] -= len(streams.pop(0))

    def lookup(self, seed: bytes, needle, k: int, ngram_max: int,
               ngram_min: int):
        for stream in reversed(self._corpora.get(seed, ())):
            cont = _ngram_lookup(stream, needle, k, ngram_max,
                                 ngram_min)
            if len(cont):
                return cont
        return np.zeros((0,), np.int64)

    def evict(self, seed: bytes):
        self._corpora.pop(seed, None)
        self._tokens.pop(seed, None)

    def stats(self) -> dict:
        return {"tenants": len(self._corpora),
                "tokens": int(sum(self._tokens.values()))}


# engine-thread single-writer: observe/lookup/evict all run between
# steps on the thread that owns the serving session (observe from
# _collect's completion path, lookup from propose, evict from the LoRA
# manager's eviction listener — itself invoked on the engine thread's
# admission path); cross-thread readers (flight-recorder stats) only
# see GIL-atomic dict sizes
race_handoff("AdapterDraftStore.*",
             "engine-thread single-writer: learn/lookup/evict run "
             "between steps on the session's thread; stats() reads "
             "GIL-atomic sizes only")


class NgramProposer:
    """Prompt-lookup self-drafting: propose the continuation of the
    most recent earlier occurrence of the sequence's final n-gram,
    trying n = ngram_max down to ngram_min. With a per-tenant
    ``AdapterDraftStore`` attached, a sequence whose own history
    misses falls back to its TENANT corpus (never another tenant's).

    ``stage_ahead`` marks this proposer safe for the overlapped
    engine's spec staging: proposals are a pure function of the passed
    context (no device state, no ordering hazard), so window N+1 can
    be proposed from the PREDICTED post-window history while window N
    verifies on device."""

    stage_ahead = True

    def __init__(self, num_draft_tokens: int = 4, ngram_max: int = 3,
                 ngram_min: int = 1, store: AdapterDraftStore = None):
        self.num_draft_tokens = int(num_draft_tokens)
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        self.store = store
        self._tenants = {}       # row -> adapter hash seed (bytes)

    def set_tenant(self, i, seed):
        """Bind row i to a tenant identity (None unbinds) — the
        session calls this at slot bind/free so corpus fallback and
        eviction stay adapter-scoped."""
        if seed is None:
            self._tenants.pop(i, None)
        else:
            self._tenants[i] = seed

    def propose_one(self, history, k: int, tenant=None):
        """Draft tokens (possibly empty) for one sequence from its own
        token history (prompt + everything emitted so far), falling
        back to the tenant corpus when the own-history lookup misses."""
        hist = np.asarray(history, np.int64).reshape(-1)
        k = min(int(k), self.num_draft_tokens)
        if k <= 0 or len(hist) < self.ngram_min + 1:
            return np.zeros((0,), np.int64)
        cont = _ngram_lookup(hist, hist, k, self.ngram_max,
                             self.ngram_min)
        if not len(cont) and self.store is not None and tenant is not None:
            cont = self.store.lookup(tenant, hist, k, self.ngram_max,
                                     self.ngram_min)
        return cont

    def predict(self, i, history, k: int):
        """Stage-ahead lookup for row i over a PREDICTED history — the
        overlapped engine proposes the next window (bonus guess first,
        drafts after) while the device verifies the current one. k may
        exceed num_draft_tokens by one: the extra leading token is the
        BONUS guess, not a draft."""
        hist = np.asarray(history, np.int64).reshape(-1)
        k = int(k)
        if k <= 0 or len(hist) < self.ngram_min + 1:
            return np.zeros((0,), np.int64)
        cont = _ngram_lookup(hist, hist, k, self.ngram_max,
                             self.ngram_min)
        tenant = self._tenants.get(i)
        if not len(cont) and self.store is not None and tenant is not None:
            cont = self.store.lookup(tenant, hist, k, self.ngram_max,
                                     self.ngram_min)
        return cont

    # -- protocol ----------------------------------------------------------
    def on_admit(self, pairs):
        pass

    def propose(self, contexts, caps):
        t0 = _trace_t0()
        out = {i: self.propose_one(h, caps.get(i, 0),
                                   tenant=self._tenants.get(i))
               for i, h in contexts}
        if t0:
            _record_propose_span(t0, "ngram", len(out))
        return out

    def rollback(self, i, new_len):
        if new_len == 0:
            # slot freed: drop the tenant binding with it (the next
            # bind re-establishes it; a stale binding would let a
            # recycled slot draft from the previous tenant's corpus)
            self._tenants.pop(i, None)


class _DraftEngine:
    """Device-side state for a draft model serving one session's rows:
    its own paged-KV pools (kv-heads-sized via the draft's ModelAdapter),
    a trivial per-row block table, an eager prefill at power-of-two
    widths, and the one-token decode step as one program (a CUDA graph
    on a card, built at its first use; eager on the CPU), which also
    runs every one-token write (most catch-up ingests). The engine
    mirrors the target's committed lengths: rollback() is the ONE
    authority on each row's cached length (``seq``), so rejected draft
    positions are exactly as stale (masked on read, overwritten before
    the boundary ever advances past them) as the target's.

    ``written`` counts the leading positions of each row whose KV the
    draft computed from the row's own history. A window leaves committed
    positions past it: the last draft of a fully accepted window (k
    decode steps write the committed token and the first k-1 drafts),
    and the first position of a row that drafted nothing while others
    did (its write ran under a masked read). The next proposal drops the
    row's length to ``written`` and ingests those tokens again, so the
    draft conditions on the exact history: the JAX package keeps the
    committed length there and drafts from the stale positions (ROADMAP
    queue C item 16)."""

    def __init__(self, model, rows: int, kv_block_size: int,
                 capacity: int):
        from ...incubate.nn.functional.paged_kv import (alloc_block_tables,
                                                        init_block_cache)
        from ..serving import get_model_adapter, make_run_model

        adapter = get_model_adapter(model)
        if adapter.max_seq_len < capacity:
            raise ValueError(
                f"draft model max_seq_len {adapter.max_seq_len} < the "
                f"serving capacity {capacity}; speculation would rotate "
                f"positions the draft cannot represent")
        self.model = model
        self.rows = rows
        self.device = dev = adapter.device
        self._run_model = make_run_model(model, adapter)
        self._bt, self._nblocks = alloc_block_tables(rows, capacity,
                                                     kv_block_size,
                                                     device=dev)
        pools = [init_block_cache(self._nblocks, adapter.kv_heads,
                                  kv_block_size, adapter.head_dim,
                                  adapter.dtype, device=dev)
                 for _ in range(adapter.num_layers)]
        self._kcs = tuple(k for k, _ in pools)
        self._vcs = tuple(v for _, v in pools)
        self.seq = np.zeros((rows,), np.int32)      # committed lengths
        self.written = np.zeros((rows,), np.int32)  # lengths it computed
        # the decode step's static buffers: the fed tokens (then the
        # drafted ones), the live mask as counts, the cached lengths
        self._tok = torch.zeros((rows,), dtype=torch.int32, device=dev)
        self._new_lens = torch.zeros_like(self._tok)
        self._seq_dev = torch.zeros_like(self._tok)
        self._weight_dicts = [(m._parameters, m._buffers)
                              for m in model.modules()]
        self._decode_prog = None
        self.decode_steps = 0        # decode-program replays that draft
        self.ingest_steps = 0        # ... that write one committed token
        self.prefill_widths = []     # eager prefill widths, in order

    def _decode_body(self):
        """One greedy draft step for every row over the static buffers:
        writes the fed tokens' KV, advances the lengths by the live
        counts, and leaves the argmax tokens as the next step's input.
        No host read anywhere (capturable)."""
        with torch.inference_mode():
            lv, _, _, seq = self._run_model(
                self._tok[:, None], self._kcs, self._vcs, self._bt,
                self._seq_dev, self._seq_dev, self._new_lens)
            self._seq_dev.copy_(seq)
            self._tok.copy_(lv.argmax(-1))

    def _null_inputs(self):
        """Context: every row dead and every table row the sentinel, so
        a capture's warm-up and recording write no pool byte."""
        @contextlib.contextmanager
        def ctx():
            bt = self._bt.clone()
            self._new_lens.zero_()
            self._bt.fill_(self._nblocks)
            try:
                yield
            finally:
                self._bt.copy_(bt)
        return ctx()

    def _decode_program(self):
        """The decode step's program, (re)built when a draft weight moved
        since its capture (the graph reads every weight by address)."""
        from ..serving import _GraphProgram, weight_addresses

        weights = weight_addresses(self._weight_dicts)
        if self._decode_prog is None or self._decode_prog.weights != weights:
            self._decode_prog = None
            self._decode_prog = _GraphProgram(
                self._decode_body, self.device, self._null_inputs, weights,
                what="the draft decode step")
        return self._decode_prog

    def admit(self, pairs):
        """Prefill the draft cache for freshly admitted rows (the draft
        sees the FULL prompt — it has no prefix cache of its own)."""
        self._write(pairs, reset=True)

    def ingest(self, pairs):
        """Append committed tokens' KV at the rows' CURRENT positions —
        catch-up for tokens the target committed outside a verify
        window (the continuous session's admit emits one token for
        every decode-continuing slot; the draft cache must ingest it or
        every later position is shifted by one)."""
        self._write(pairs, reset=False)

    def _write(self, pairs, reset: bool):
        """One forward over every row at the narrowest power-of-two width
        of the longest of ``pairs`` [(row, tokens)]; the other rows feed
        nothing visible (their padded writes land at or past their
        cached length, as in the JAX package). Width 1 replays the decode
        program (the same function at one token), wider ones run
        eagerly."""
        from .verify import pow2_width

        if not pairs:
            return
        need = max(len(p) for _, p in pairs)
        w = pow2_width(need)         # uncapped: prompts set the rung
        toks = np.zeros((self.rows, w), np.int32)
        new_lens = np.zeros((self.rows,), np.int32)
        seq = self.seq.copy()
        for i, tokens in pairs:
            p = np.asarray(tokens).reshape(-1)
            toks[i, :len(p)] = p
            new_lens[i] = len(p)
            if reset:
                seq[i] = 0
        if w == 1:
            prog = self._decode_program()
            with torch.inference_mode():
                self._tok.copy_(torch.from_numpy(toks[:, 0].copy()))
                self._new_lens.copy_(torch.from_numpy(new_lens))
                self._seq_dev.copy_(torch.from_numpy(seq))
                prog()
            self.ingest_steps += 1
        else:
            self.prefill_widths.append(w)
            dev = self.device
            nl = torch.from_numpy(new_lens).to(dev)
            seq_t = torch.from_numpy(seq).to(dev)
            self._run_model(torch.from_numpy(toks).to(dev), self._kcs,
                            self._vcs, self._bt, seq_t, seq_t, nl,
                            torch.clamp(nl - 1, min=0))
        for i, tokens in pairs:
            n = len(np.asarray(tokens).reshape(-1))
            self.seq[i] = n if reset else self.seq[i] + n
            self.written[i] = self.seq[i]

    def decode_drafts(self, firsts, active, k: int):
        """k greedy draft tokens per row, each step one replay of the
        decode program over the draft's paged pools, with one host read
        at the end. firsts[i] = the last committed target token (fed at
        the row's current position); rows not ``active`` feed nothing
        visible and keep their lengths."""
        prog = self._decode_program()
        new_lens = np.asarray(active, bool).astype(np.int32)
        with torch.inference_mode():
            self._tok.copy_(torch.from_numpy(
                np.asarray(firsts).astype(np.int32)))
            self._new_lens.copy_(torch.from_numpy(new_lens))
            self._seq_dev.copy_(torch.from_numpy(self.seq))
            cols = []
            for _ in range(k):
                prog()
                cols.append(self._tok.clone())
            drafts = torch.stack(cols, dim=1).cpu().numpy()
        self.decode_steps += k
        # an active row's k steps wrote its committed token and k-1 drafts
        self.written = np.where(new_lens > 0, self.seq + k, self.written)
        self.seq = self.seq + k * new_lens
        return drafts.astype(np.int64)


class DraftModelProposer:
    """A smaller ModelAdapter-wrapped model proposes greedy drafts from
    its own paged-KV pools, rolled back in lockstep with the target.

    ``stage_ahead`` is False: drafting mutates the engine's device
    pools and committed-length mirror, so proposing from a PREDICTED
    history would corrupt the draft cache on a mispredict."""

    stage_ahead = False

    def __init__(self, draft_model, rows: int, kv_block_size: int,
                 capacity: int, num_draft_tokens: int = 4):
        self.num_draft_tokens = int(num_draft_tokens)
        self._engine = _DraftEngine(draft_model, rows, kv_block_size,
                                    capacity)

    # -- protocol ----------------------------------------------------------
    def on_admit(self, pairs):
        self._engine.admit(pairs)

    def propose(self, contexts, caps):
        if not contexts:
            return {}
        t0 = _trace_t0()
        out = self._propose(contexts, caps)
        if t0:
            _record_propose_span(t0, "draft", len(contexts))
        return out

    def _propose(self, contexts, caps):
        # self-heal rows whose draft cache lags the committed history:
        # the history is authoritative (hist[:-1] is committed KV,
        # hist[-1] is the pending token the verify window re-feeds), so
        # any tokens the target committed WITHOUT a verify dispatch —
        # the continuous session's admit emits one per decode-continuing
        # slot — are ingested here before drafting, and so are committed
        # positions the draft never computed from the row's history
        # (_DraftEngine: ``written``)
        e = self._engine
        e.seq = np.minimum(e.seq, e.written)
        lag = []
        for i, hist in contexts:
            h = np.asarray(hist, np.int64).reshape(-1)
            gap = len(h) - 1 - int(self._engine.seq[i])
            if gap > 0:
                lag.append((i, h[len(h) - 1 - gap:len(h) - 1]))
        self._engine.ingest(lag)
        k = max((min(caps.get(i, 0), self.num_draft_tokens)
                 for i, _ in contexts), default=0)
        if k <= 0:
            return {i: np.zeros((0,), np.int64) for i, _ in contexts}
        firsts = np.zeros((self._engine.rows,), np.int64)
        active = np.zeros((self._engine.rows,), bool)
        for i, hist in contexts:
            firsts[i] = int(np.asarray(hist).reshape(-1)[-1])
            active[i] = caps.get(i, 0) > 0
        drafts = self._engine.decode_drafts(firsts, active, k)
        return {i: drafts[i, :min(caps.get(i, 0),
                                  self.num_draft_tokens)].copy()
                for i, _ in contexts}

    def rollback(self, i, new_len):
        self._engine.seq[i] = int(new_len)


def build_proposer(cfg, rows: int, kv_block_size: int, capacity: int,
                   tenant_stats: bool = False,
                   tenant_cap_tokens: int = 8192):
    """Per-session proposer instance from a declarative
    SpeculativeConfig (draft engines hold device state and are never
    shared across sessions). ``tenant_stats`` attaches a per-tenant
    AdapterDraftStore to the n-gram proposer."""
    if cfg.proposer == "ngram":
        store = (AdapterDraftStore(tenant_cap_tokens)
                 if tenant_stats else None)
        return NgramProposer(cfg.num_draft_tokens, cfg.ngram_max,
                             cfg.ngram_min, store=store)
    return DraftModelProposer(cfg.draft_model, rows=rows,
                              kv_block_size=kv_block_size,
                              capacity=capacity,
                              num_draft_tokens=cfg.num_draft_tokens)
