"""Paged (block-table) KV-cache attention for serving. Counterpart of
paddle_tpu/incubate/nn/functional/paged_kv.py (without the int8 pools
and the prefix-caching block pool).

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


__all__ = ["PagedCache", "alloc_block_tables", "block_attention_gqa_impl",
           "block_attention_impl", "block_grouped_query_attention",
           "block_multihead_attention", "init_block_cache"]
