"""The port's paged KV cache against the JAX package's.

Shadows tests/test_paged_kv.py: the same pools, tables and q/k/v (made
with numpy) go through ``_write_tokens`` / ``_gather_kv`` / ``_attend``
and the ``block_attention_*_impl`` cores of both packages. Pools must
agree exactly (a write is a copy); attention outputs at fp32 tolerance
(1e-5: the two frameworks sum the softmax and the products in different
orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import paged_kv as jkv
from paddle_tpu_torch.incubate.nn.functional import paged_kv as tkv


def _t(a):
    return torch.tensor(np.asarray(a))      # a copy: writes stay in torch


def _pool(nb, h, bs, d, seed):
    return np.random.RandomState(seed).randn(nb, h, bs, d).astype(np.float32)


@pytest.mark.parametrize("start,s", [([0, 3], 5), ([7, 15], 1),
                                     ([14, 2], 4), ([16, 20], 2)])
def test_write_tokens_matches_jax_including_drops(start, s):
    """Positions past the table capacity (16 here) are dropped in both,
    never clipped into the last block."""
    b, h, bs, d = 2, 2, 4, 3
    bt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    cache = _pool(8, h, bs, d, seed=1)
    vals = np.random.RandomState(2).randn(b, s, h, d).astype(np.float32)
    start = np.array(start, np.int32)
    want = jkv._write_tokens(jnp.asarray(cache), jnp.asarray(vals),
                             jnp.asarray(bt), jnp.asarray(start))
    got = tkv._write_tokens(_t(cache), _t(vals), _t(bt), _t(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_tokens_drops_out_of_pool_table_entries():
    """A table entry at or past num_blocks (the serving sentinel) drops
    the write, in both packages; so does an all-dropped call."""
    h, bs, d = 2, 4, 3
    bt = np.array([[0, 8], [9, 3]], np.int32)
    cache = _pool(8, h, bs, d, seed=3)
    for start, s in (([2, 1], 4), ([4, 0], 3)):
        vals = np.random.RandomState(s).randn(2, s, h, d).astype(np.float32)
        st = np.array(start, np.int32)
        want = jkv._write_tokens(jnp.asarray(cache), jnp.asarray(vals),
                                 jnp.asarray(bt), jnp.asarray(st))
        got = tkv._write_tokens(_t(cache), _t(vals), _t(bt), _t(st))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    all_out = np.array([[8, 9], [10, 8]], np.int32)
    vals = np.ones((2, 3, h, d), np.float32)
    got = tkv._write_tokens(_t(cache), _t(vals), _t(all_out),
                            _t(np.array([0, 1], np.int32)))
    np.testing.assert_array_equal(got.numpy(), cache)


def test_gather_kv_matches_jax():
    cache = _pool(6, 2, 4, 3, seed=4)
    bt = np.array([[5, 0, 2], [1, 4, 3]], np.int32)
    want = jkv._gather_kv(jnp.asarray(cache), jnp.asarray(bt))
    got = tkv._gather_kv(_t(cache), _t(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kvh", [4, 2])
def test_attend_matches_jax(kvh):
    rng = np.random.RandomState(kvh)
    q = rng.randn(2, 3, 4, 8).astype(np.float32)
    k = rng.randn(2, kvh, 12, 8).astype(np.float32)
    v = rng.randn(2, kvh, 12, 8).astype(np.float32)
    q_pos = np.array([0, 5], np.int32)
    kv_len = np.array([3, 7], np.int32)
    want = jkv._attend(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_len)))
    got = tkv._attend(*(_t(a) for a in (q, k, v, q_pos, kv_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _impl_case(kvh, prefill):
    """Ragged lengths: row 1 has fewer valid tokens than row 0."""
    b, h, d, bs = 2, 4, 8, 4
    bt, nb = jkv.alloc_block_tables(b, 16, bs)
    rng = np.random.RandomState(10 * kvh + prefill)
    if prefill:
        s, dec, this = 7, np.array([0, 0]), np.array([7, 4])
    else:
        s, dec, this = 1, np.array([7, 4]), np.array([1, 1])
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, kvh, d).astype(np.float32)
    v = rng.randn(b, s, kvh, d).astype(np.float32)
    kc = _pool(nb, kvh, bs, d, seed=5)
    vc = _pool(nb, kvh, bs, d, seed=6)
    return (q, k, v, kc, vc, np.asarray(bt), dec.astype(np.int32),
            this.astype(np.int32))


@pytest.mark.parametrize("prefill", [True, False])
@pytest.mark.parametrize("kvh", [4, 2])
def test_block_attention_gqa_impl_matches_jax(kvh, prefill):
    q, k, v, kc, vc, bt, dec, this = _impl_case(kvh, prefill)
    jout, jkc, jvc = jkv.block_attention_gqa_impl(
        *(jnp.asarray(a) for a in (q, k, v, kc, vc, bt, dec, this)))
    tout, tkc, tvc = tkv.block_attention_gqa_impl(
        *(_t(a) for a in (q, k, v, kc, vc, bt, dec, this)))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("prefill", [True, False])
def test_block_attention_impl_packed_qkv_matches_jax(prefill):
    q, k, v, kc, vc, bt, dec, this = _impl_case(4, prefill)
    qkv = np.stack([q, k, v], axis=2)            # [B, S, 3, H, D]
    jout, jkc, jvc = jkv.block_attention_impl(
        *(jnp.asarray(a) for a in (qkv, kc, vc, bt, dec, this)))
    tout, _, tkc, tvc = tkv.block_multihead_attention(
        _t(qkv), _t(kc), _t(vc), None, _t(dec), _t(this),
        block_tables=_t(bt))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jvc))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_pool_and_table_helpers_match_jax():
    jbt, jnb = jkv.alloc_block_tables(3, 10, 4)
    tbt, tnb = tkv.alloc_block_tables(3, 10, 4, device="cpu")
    assert tnb == jnb and tbt.dtype == torch.int32
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    kc, vc = tkv.init_block_cache(tnb, 2, 4, 8, device="cpu")
    assert kc.shape == vc.shape == tuple(jkv.init_block_cache(
        jnb, 2, 4, 8)[0].shape)
    assert not kc.any() and not vc.any()
