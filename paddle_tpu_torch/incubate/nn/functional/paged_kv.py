"""Paged (block-table) KV-cache attention for serving, and the host-side
prefix-caching block pool. Counterpart of
paddle_tpu/incubate/nn/functional/paged_kv.py (without the int8 pools and
the KV block export/import of the disaggregated fleet).

The pool is one [num_blocks, KVH, block_size, D] tensor per K and V; a
block table [B, max_blocks_per_seq] of block ids maps each sequence's
logical positions onto the pool. Writes scatter into the pool IN PLACE
(where the JAX package returns a new pool and donates the old one), and
reads gather each sequence's blocks.

Two JAX indexing rules are made explicit here, because an out-of-range
index on a card is a device-side assert that kills the process:
writes whose block id is not in the pool are dropped (JAX's
``mode="drop"``), and gather indices are clamped into the pool (JAX's
default clamp; masked reads make the clamped values irrelevant).
"""
from __future__ import annotations

import collections
import math

import torch

from ....analysis.sanitizers import race_handoff, race_track
from ....core.place import resolve_device
from .flash_attention import grouped_pv_out, grouped_qk_logits

# new_lens (optional): per-sequence count of VALID new tokens this call
# (ragged right-padded prefill writes the padded length into the pool but
# only new_lens positions become visible). None means every position of
# the call is valid.
PagedCache = collections.namedtuple(
    "PagedCache",
    ["key_cache", "value_cache", "block_tables", "seq_lens", "new_lens"],
    defaults=[None])


def init_block_cache(num_blocks: int, num_heads: int, block_size: int,
                     head_dim: int, dtype=torch.float32, device=None):
    """An empty KV pool: [num_blocks, KVH, block_size, D] zeros for K and
    for V. num_heads is the number of KV heads (a GQA pool holds only the
    shared heads)."""
    shape = (num_blocks, num_heads, block_size, head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def alloc_block_tables(batch: int, max_seq_len: int, block_size: int,
                       device=None):
    """Trivial allocator: sequence b owns blocks [b*mbs, (b+1)*mbs).
    Returns (table [batch, mbs] int32, num_blocks)."""
    mbs = -(-max_seq_len // block_size)
    bt = torch.arange(batch * mbs, dtype=torch.int32,
                      device=resolve_device(device)).reshape(batch, mbs)
    return bt, batch * mbs


def kv_block_bytes(num_layers: int, num_heads: int, block_size: int,
                   head_dim: int, dtype=torch.float32, kv_dtype=None):
    """Bytes ONE pool block costs across all layers, K and V sides,
    payload + scales — the equal-byte-budget geometry primitive
    (num_blocks = kv_pool_bytes // kv_block_bytes). ``kv_dtype="int8"``
    (payload byte per element + one f32 scale per token) is the JAX
    package's quantized pool geometry, kept so the two packages size
    pools alike; the port's pools themselves are not quantized (ROADMAP
    queue A item 6)."""
    slab = int(num_heads) * int(block_size) * int(head_dim)
    if kv_dtype is None:
        per_side = slab * torch.empty((), dtype=dtype).element_size()
    elif str(kv_dtype) == "int8":
        per_side = slab + int(block_size) * 4    # + f32 per-token scale
    else:
        raise ValueError(f"unsupported kv_dtype: {kv_dtype!r}")
    return 2 * int(num_layers) * per_side


def pool_occupancy(seq_lens, block_size: int, num_blocks: int, live=None,
                   block_tables=None):
    """(blocks_used, fraction) of a paged pool from per-sequence cached
    lengths — the scheduler-tuning occupancy signal (vLLM's
    gpu_cache_usage analogue). `live` masks slots whose cached junk no
    longer belongs to a request (a freed continuous-batching slot keeps
    its seq_len until re-admission resets it). With `block_tables` a
    block referenced by several sequences (prefix caching) is counted
    ONCE: the count is over unique in-pool block ids in the sequences'
    used table prefixes, not per-sequence ceilings. Host-side only:
    forces seq_lens to numpy."""
    import numpy as np

    def host(a):
        return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    lens = host(seq_lens)
    if live is not None:
        lens = np.where(np.asarray(live, bool), lens, 0)
    if block_tables is not None:
        bt = host(block_tables)
        ids = set()
        for b in range(len(lens)):
            nb = -(-int(lens[b]) // int(block_size))
            for x in bt[b, :nb]:
                if 0 <= int(x) < int(num_blocks):
                    ids.add(int(x))
        used = len(ids)
    else:
        used = int(np.sum(-(-lens // int(block_size))))
    return used, used / max(1, int(num_blocks))


def adapter_hash_seed(adapter=None) -> bytes:
    """Hash-chain seed scoping the prefix cache by adapter identity
    (r20 multi-tenant LoRA): the base model keeps the historic
    ``b"prefix-root"`` seed — every pre-LoRA digest is unchanged —
    while requests served through adapter ``name`` chain from a
    name-derived seed, so tenant A's cached blocks are unreachable from
    tenant B's (or the base model's) requests. Name-based (not
    weight-based) so the router derives the identical chain from a
    request's ``model=`` field; weight changes under the same name are
    handled by the manager's epoch -> prefix-flush path instead."""
    import hashlib

    if not adapter:
        return b"prefix-root"
    return b"lora:" + hashlib.sha256(str(adapter).encode()).digest()


def chain_block_hashes(tokens, block_size: int, seed: bytes = b"prefix-root"):
    """Chained sha256 digest per FULL block of ``tokens`` — the pool's
    prefix-cache identity (see PrefixBlockPool.chain_hashes). Module
    level so consumers with no pool of their own (the multi-replica
    router's affinity map) compute the identical chain a replica
    registers. ``seed`` roots the chain (adapter-scoped caching seeds
    it per tenant via :func:`adapter_hash_seed`)."""
    import hashlib

    import numpy as np

    bs = int(block_size)
    toks = np.asarray(tokens).reshape(-1).astype(np.int64)
    out, parent = [], bytes(seed)
    for k in range(len(toks) // bs):
        h = hashlib.sha256(
            parent + toks[k * bs:(k + 1) * bs].tobytes()).digest()
        out.append(h)
        parent = h
    return out


@race_track
class PrefixBlockPool:
    """Host-side ref-counted block allocator with automatic prefix
    caching (vLLM's block-hash prefix caching / SGLang's RadixAttention
    capability, expressed over hash chains instead of a radix tree).

    Every FULL block of a sequence's prompt gets a content hash chained
    on its predecessor (``hash(parent_hash, block_tokens)``), so a hash
    identifies the block's tokens AND everything before them. Blocks are
    ref-counted: a cached block matched by a new sequence is shared by
    pointing the new block table at it (ref += 1) — sharing is a pointer
    operation, never a copy. Freed blocks enter the free pool with their
    hashes RETAINED (cache-on-free): a later admission whose prompt
    chain reaches that hash revives the block from the free pool.
    Reusing a free block for new content evicts its hash; plain (never
    hashed / retention-disabled) free blocks are handed out first and
    cached free blocks are evicted in LRU order, so allocation pressure
    consumes cache value last, oldest first. A referenced (live) block
    is never in a free queue and therefore can never be evicted.

    The pool manages IDS only — the device arrays are owned by the
    serving session, which must uphold the invariant that shared blocks
    are never written: prefill starts at the hit boundary, and a block a
    sequence would append into is first copied to a private block
    (copy-on-write; the pool only does the bookkeeping via allocate +
    release of the shared source).
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True, min_match_blocks: int = 1,
                 cache_on_free: bool = True):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self.min_match_blocks = max(1, int(min_match_blocks))
        self.cache_on_free = bool(cache_on_free)
        self.ref = [0] * self.num_blocks
        self.block_hash = [None] * self.num_blocks
        self.cached = {}                 # hash -> canonical block id
        self._free_plain = collections.deque(range(self.num_blocks))
        self._free_cached = collections.OrderedDict()   # LRU: old first
        self.evictions = 0
        self.cow_copies = 0
        # optional callable(digest, bid) invoked just BEFORE an LRU
        # eviction forgets a cached hash — the hierarchical KV tier's
        # spill hook (r24). Runs on the allocating thread (the engine
        # thread, per the handoff contract below); a raising listener
        # never blocks the allocation. flush_cache() does NOT fire it:
        # flushed blocks are stale under new weights, spilling them
        # would resurrect wrong bytes as cache hits.
        self.evict_listener = None

    @property
    def num_free(self) -> int:
        return len(self._free_plain) + len(self._free_cached)

    def chain_hashes(self, tokens, seed: bytes = b"prefix-root"):
        """Chained content hash per FULL block of `tokens` (the partial
        tail block never hashes — it is never shared). sha256 so a
        collision serving another request's KV is out of the picture.
        ``seed`` scopes the chain (per-adapter isolation)."""
        return chain_block_hashes(tokens, self.block_size, seed=seed)

    def match(self, tokens, seed: bytes = b"prefix-root"):
        """(shared_block_ids, full_block_hashes) for the longest cached
        block-aligned prefix of `tokens`. Matched blocks are ref'd
        (revived out of the free pool if cache-on-free held them); a
        match shorter than min_match_blocks returns no blocks."""
        if not self.prefix_cache:
            return [], []
        hashes = self.chain_hashes(tokens, seed=seed)
        blocks = []
        for h in hashes:
            bid = self.cached.get(h)
            if bid is None:
                break
            blocks.append(bid)
        if len(blocks) < self.min_match_blocks:
            return [], hashes
        for bid in blocks:
            if self.ref[bid] == 0:
                self._free_cached.pop(bid, None)     # revive
            self.ref[bid] += 1
        return blocks, hashes

    def allocate(self, n: int):
        """n private blocks (ref 1, no hash), or None if the pool cannot
        supply them even after evicting every unreferenced cached block
        — allocation is all-or-nothing so a half-admitted request can
        never deadlock the pool. Plain free blocks go first; cached free
        blocks are evicted LRU (least-recently-freed first)."""
        if n > self.num_free:
            return None
        out = []
        for _ in range(n):
            if self._free_plain:
                bid = self._free_plain.popleft()
            else:
                bid, _ = self._free_cached.popitem(last=False)
                h = self.block_hash[bid]
                if h is not None and self.cached.get(h) == bid:
                    if self.evict_listener is not None:
                        try:
                            self.evict_listener(h, bid)
                        except Exception:
                            pass    # spill is best-effort, alloc isn't
                    del self.cached[h]
                    self.evictions += 1
            self.block_hash[bid] = None
            self.ref[bid] = 1
            out.append(bid)
        return out

    def register(self, bid: int, h) -> None:
        """Record that block `bid` holds the full-block content hashed
        `h`. First writer wins: a concurrent private duplicate stays
        unregistered so the canonical block keeps the shares."""
        if not self.prefix_cache or h in self.cached:
            return
        self.cached[h] = bid
        self.block_hash[bid] = h

    def release(self, blocks) -> None:
        """Drop one reference per id; a block reaching ref 0 enters the
        free pool — hash retained (cache-on-free) so the bytes stay
        matchable until the block is reused for other content."""
        for bid in blocks:
            self.ref[bid] -= 1
            if self.ref[bid] < 0:
                raise RuntimeError(f"block {bid} over-released")
            if self.ref[bid] == 0:
                h = self.block_hash[bid]
                if (self.cache_on_free and h is not None
                        and self.cached.get(h) == bid):
                    self._free_cached[bid] = None    # tail = most recent
                else:
                    if h is not None and self.cached.get(h) == bid:
                        del self.cached[h]
                    self.block_hash[bid] = None
                    self._free_plain.append(bid)

    def flush_cache(self) -> None:
        """Forget every cached hash (weight updates invalidate cached
        KV). Live blocks keep serving their requests; cached free
        blocks demote to plain free blocks."""
        self.cached.clear()
        self.block_hash = [None] * self.num_blocks
        while self._free_cached:
            bid, _ = self._free_cached.popitem(last=False)
            self._free_plain.append(bid)

    def assert_private(self, blocks) -> None:
        """Audit for multi-position (speculative/draft) cache writes:
        every block a write span touches must be PRIVATE to its slot —
        ref count exactly 1 and not the canonical holder of a cached
        hash. A shared prefix block (ref > 1, or the registered
        canonical copy another admission could match) must never take a
        draft write: rejected-draft bytes there would be replayed into
        OTHER requests' attention. Raises RuntimeError on violation —
        this is the write-unmasking invariant made executable (writes
        are never masked by new_lens; only table sentinels and private
        ownership keep them safe)."""
        for bid in blocks:
            h = self.block_hash[bid]
            if self.ref[bid] != 1 or (h is not None
                                      and self.cached.get(h) == bid):
                raise RuntimeError(
                    f"speculative write span touches shared block {bid} "
                    f"(ref={self.ref[bid]}, "
                    f"canonical={h is not None and self.cached.get(h) == bid})")

    def assert_quiescent(self) -> None:
        """Audit for a drained pool: ZERO referenced blocks. Cached free
        blocks (cache-on-free) are fine — they hold no live reference.
        The serving chaos storm calls this after every request reaches a
        terminal state; a surviving reference is a leak that would
        eventually starve admission."""
        held = [bid for bid, r in enumerate(self.ref) if r > 0]
        if held:
            raise RuntimeError(
                f"pool not quiescent: blocks {held} still referenced "
                f"(refs {[self.ref[b] for b in held]})")

    def occupancy(self) -> dict:
        """referenced / cached / free block breakdown — each block falls
        in exactly ONE bucket, so a block shared by many sequences
        counts once (the pool_occupancy double-count fix for sharing)."""
        referenced = sum(1 for r in self.ref if r > 0)
        cached_free = len(self._free_cached)
        return {"num_blocks": self.num_blocks,
                "referenced": referenced,
                "cached": cached_free,
                "free": self.num_blocks - referenced - cached_free}


# built with the session on the caller thread; under ApiServer every
# later touch happens on the engine thread (sessions are single-
# threaded by contract — disagg ingest/export included, since the
# DisaggEndpoint only runs them inside the engine tick).  A second
# mutator thread after that handoff still races.
race_handoff("PrefixBlockPool.*",
             "session-init on the caller thread, then engine-thread "
             "single-writer (the r14/r17 'engine thread is the only "
             "session toucher' invariant)")


def write_span_blocks(table_row, start: int, count: int,
                      block_size: int, num_blocks: int):
    """Pool block ids a multi-position cache write at logical positions
    [start, start + count) lands in, given one sequence's block table
    row (host numpy). Entries holding the out-of-pool sentinel
    (>= num_blocks) are left out: the write drops there, as it does past
    the table's capacity. The speculative verify path audits this span
    with PrefixBlockPool.assert_private before every window."""
    import numpy as np

    if count <= 0:
        return []
    row = np.asarray(table_row).reshape(-1)
    first = int(start) // int(block_size)
    last = (int(start) + int(count) - 1) // int(block_size)
    return [int(row[k]) for k in range(first, min(last + 1, len(row)))
            if 0 <= int(row[k]) < int(num_blocks)]


def rollback_seq_lens(seq_lens, accepted_lens):
    """Cached lengths after speculative verification (host numpy): the
    accepted boundary replaces the optimistic post-write length.
    Positions in (accepted, written] hold rejected draft KV; every read
    masks them (attention stops at seq_lens) and the next window writes
    from the accepted boundary up, so a stale position is overwritten
    before the boundary can pass it."""
    import numpy as np

    lens = np.asarray(seq_lens)
    return np.minimum(lens, np.asarray(accepted_lens)).astype(lens.dtype)


def _write_tokens(cache, vals, block_tables, start_pos):
    """Scatter vals [B, S, H, D] into the pool, in place, at logical
    positions start_pos[b] + [0, S). Returns the pool.

    Positions past the sequence's table capacity, and table entries
    outside the pool, are DROPPED, never clipped. The drop needs no host
    sync: a dropped row is re-aimed at the slot of the first kept row and
    carries that row's value, so the scatter writes the same bytes to
    that slot twice and nothing else (when no row is kept, every row
    rewrites slot (0, 0) with its current content)."""
    b, s, h, d = vals.shape
    nb, bs = cache.shape[0], cache.shape[2]
    capacity = block_tables.shape[1] * bs
    pos = start_pos.to(torch.int64)[:, None] + torch.arange(
        s, device=vals.device)[None, :]                           # [B, S]
    blk = torch.gather(block_tables.to(torch.int64), 1,
                       torch.clamp(pos, max=capacity - 1) // bs)
    blk = torch.where(pos < capacity, blk, nb).reshape(-1)
    slot = (pos % bs).reshape(-1)
    flat = vals.reshape(b * s, h, d).to(cache.dtype)
    keep = (blk >= 0) & (blk < nb)
    # [1]-shaped (not 0-d) index: a 0-d tensor index may be read on the
    # host, which would stall on the card
    first = torch.argmax(keep.to(torch.int32), dim=0, keepdim=True)
    any_kept = keep.any()
    fb = torch.where(any_kept, blk[first], 0)
    fs = torch.where(any_kept, slot[first], 0)
    fv = torch.where(any_kept, flat[first], cache[0:1, :, 0, :])
    blk = torch.where(keep, blk, fb)
    slot = torch.where(keep, slot, fs)
    flat = torch.where(keep[:, None, None], flat, fv)
    cache[blk, :, slot, :] = flat
    return cache


def _gather_kv(cache, block_tables):
    """[num_blocks, H, bs, D] + [B, MB] -> [B, H, MB*bs, D]."""
    idx = torch.clamp(block_tables.to(torch.int64), 0, cache.shape[0] - 1)
    g = cache[idx]                                   # [B, MB, H, bs, D]
    b, mb, h, bs, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d)


def _attend(q, k, v, q_pos, kv_len):
    """q [B, Sq, H, D] against gathered k/v [B, KVH, L, D]; position i of
    q sits at absolute q_pos[b] + i and sees keys < min(that+1, kv_len).
    KVH < H (grouped query) contracts q grouped against the shared kv
    heads. Math in fp32, output in q's dtype."""
    bsz, sq, h, d = q.shape
    qh = q.transpose(1, 2).float()                               # [B,H,Sq,D]
    logits = grouped_qk_logits(qh, k.float())
    logits = logits / math.sqrt(d)
    kpos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    abs_q = (q_pos.to(torch.int64)[:, None]
             + torch.arange(sq, device=q.device)[None, :])[:, None, :, None]
    visible = (kpos <= abs_q) & (kpos < kv_len.to(torch.int64)[:, None, None,
                                                               None])
    logits = logits.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = grouped_pv_out(probs, v.float())
    return out.transpose(1, 2).to(q.dtype)


def block_attention_gqa_impl(q, k, v, key_cache, value_cache, block_tables,
                             seq_lens_decoder, seq_lens_this_time):
    """q [B, S, H, D], k/v [B, S, KVH, D] write into a KVH-headed pool
    (in place). seq_lens_decoder[b] = tokens already cached;
    seq_lens_this_time[b] = valid new tokens. Returns
    (out [B, S, H, D], key_cache, value_cache)."""
    start = seq_lens_decoder.to(torch.int32)
    key_cache = _write_tokens(key_cache, k, block_tables, start)
    value_cache = _write_tokens(value_cache, v, block_tables, start)
    kv_len = start + seq_lens_this_time.to(torch.int32)
    kg = _gather_kv(key_cache, block_tables)
    vg = _gather_kv(value_cache, block_tables)
    out = _attend(q, kg, vg, start, kv_len)
    return out, key_cache, value_cache


def block_attention_impl(qkv, key_cache, value_cache, block_tables,
                         seq_lens_decoder, seq_lens_this_time):
    """Packed form: qkv [B, S, 3, H, D]."""
    return block_attention_gqa_impl(
        qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], key_cache, value_cache,
        block_tables, seq_lens_decoder, seq_lens_this_time)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              block_tables=None):
    """Reference-signature entry. Returns (out, qkv, key_cache,
    value_cache); the pools are updated in place and returned.

    The JAX package checks eagerly that the lengths fit the table
    capacity, a check its traced serving path skips. The port skips it
    too: reading the lengths would stall the card at every layer, and
    writes past the capacity are dropped, never clipped."""
    if block_tables is None:
        raise ValueError("block_multihead_attention requires block_tables")
    out, kc, vc = block_attention_impl(qkv, key_cache, value_cache,
                                       block_tables, seq_lens_decoder,
                                       seq_lens_this_time)
    return out, qkv, kc, vc


def block_grouped_query_attention(q, k, v, key_cache, value_cache,
                                  seq_lens_decoder, seq_lens_this_time,
                                  block_tables=None):
    """Grouped-query entry (the Llama serving shape). Returns
    (out, key_cache, value_cache), pools updated in place."""
    if block_tables is None:
        raise ValueError("block_grouped_query_attention requires "
                         "block_tables")
    return block_attention_gqa_impl(q, k, v, key_cache, value_cache,
                                    block_tables, seq_lens_decoder,
                                    seq_lens_this_time)


__all__ = ["PagedCache", "PrefixBlockPool", "adapter_hash_seed",
           "alloc_block_tables", "block_attention_gqa_impl",
           "block_attention_impl", "block_grouped_query_attention",
           "block_multihead_attention", "chain_block_hashes",
           "init_block_cache", "kv_block_bytes", "pool_occupancy",
           "rollback_seq_lens", "write_span_blocks"]
