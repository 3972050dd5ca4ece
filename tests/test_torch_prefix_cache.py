"""The port's prefix-block pool and prefix-cached serving against the JAX
package's.

Shadows tests/test_prefix_cache.py :35, :65, :95 (the host-side block
registry: the same operations on both packages' PrefixBlockPool give the
same decisions, digests, reference counts and occupancy) and :115, :161,
:189, :216, :262, :290, :316, :371 (ContinuousBatchingSession with the
prefix cache: greedy streams byte-identical to the JAX session's and to
the JAX package's paged generate, stats equal key for key, the pool
quiescent at the end). Sampled streams are held within the port, cache
on against cache off: the port's draws (Philox) are not the JAX
package's (threefry). The speculative, AOT-cache and LoRA tests of that
file are outside the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import paged_kv as jpk
from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.incubate.nn.functional import paged_kv as tpk
from paddle_tpu_torch.inference import serving as tserving

from test_torch_continuous_batching import (FAMILIES, assert_streams,
                                            jax_paged_generate,
                                            make_cb_pair, port_solo, serve,
                                            session)


def _pool_state(pool):
    return (list(pool.ref), list(pool.block_hash), dict(pool.cached),
            list(pool._free_plain), list(pool._free_cached),
            pool.evictions, pool.cow_copies, pool.occupancy())


def _both(fn):
    """Run fn(package) on the JAX package's paged_kv and the port's;
    their results and final pool states must be equal."""
    (jr, jpool), (tr, tpool) = fn(jpk), fn(tpk)
    assert tr == jr
    assert _pool_state(tpool) == _pool_state(jpool)
    return tr


def test_pool_match_share_release_and_cache_on_free():
    """Shadows test_prefix_cache.py:35."""
    def run(pk):
        log = []
        pool = pk.PrefixBlockPool(8, 4)
        toks = np.arange(100, 112)                       # 3 full blocks
        m, hashes = pool.match(toks)
        log.append((m, hashes))
        assert m == [] and len(hashes) == 3              # cold cache
        blocks = pool.allocate(3)
        for bid, h in zip(blocks, hashes):
            pool.register(bid, h)
        m2, h2 = pool.match(np.concatenate([toks, [7, 8]]))
        assert m2 == blocks and h2[:3] == hashes
        log.append((m2, h2, list(pool.ref)))
        pool.release(m2)
        pool.release(blocks)                             # -> free + cached
        log.append(pool.occupancy())
        assert pool.occupancy() == {"num_blocks": 8, "referenced": 0,
                                    "cached": 3, "free": 5}
        m3, _ = pool.match(toks)                         # revived
        assert m3 == blocks and pool.occupancy()["cached"] == 0
        pool.release(m3)
        bad = toks.copy()
        bad[5] += 1
        m4, h4 = pool.match(bad)
        assert m4 == blocks[:1] and h4[1] != hashes[1]
        log.append((m3, m4, h4))
        pool.release(m4)
        return log, pool
    _both(run)
    # the chained digests are the reference's, byte for byte, under the
    # base seed and a tenant seed
    toks = np.random.RandomState(0).randint(0, 50000, 70)
    for seed in (b"prefix-root", jpk.adapter_hash_seed("tenant")):
        assert (tpk.chain_block_hashes(toks, 16, seed=seed)
                == jpk.chain_block_hashes(toks, 16, seed=seed))
    assert tpk.adapter_hash_seed("tenant") == jpk.adapter_hash_seed("tenant")
    assert tpk.adapter_hash_seed(None) == b"prefix-root"


def test_pool_lru_eviction_prefers_plain_and_never_touches_live():
    """Shadows test_prefix_cache.py:65: the same LRU victim, the same
    refusal of a half grant, min_match_blocks and flush."""
    def run(pk):
        pool = pk.PrefixBlockPool(6, 4)
        a = pool.allocate(2)
        ha = pool.chain_hashes(np.arange(8))
        for bid, h in zip(a, ha):
            pool.register(bid, h)
        b = pool.allocate(2)                 # live, unhashed
        pool.release(a)                      # a -> cached free (LRU)
        c = pool.allocate(3)                 # 2 plain, then the LRU one
        assert c is not None and not set(c) & set(b)
        assert pool.evictions == 1
        assert pool.cached.get(ha[0]) is None
        assert pool.cached.get(ha[1]) == a[1]
        refused = pool.allocate(2)
        assert refused is None and pool.ref[b[0]] == 1
        pool.assert_private(c)
        with pytest.raises(RuntimeError, match="shared block"):
            pool.register(c[0], b"x" * 32)   # canonical holder now
            pool.assert_private(c[:1])
        strict = pk.PrefixBlockPool(4, 4, min_match_blocks=2)
        blk = strict.allocate(1)
        strict.register(blk[0], strict.chain_hashes(np.arange(4))[0])
        m, _ = strict.match(np.arange(4))
        assert m == []                       # 1 block < min 2
        pool.flush_cache()
        assert pool.cached == {} and pool.occupancy()["cached"] == 0
        with pytest.raises(RuntimeError, match="not quiescent"):
            pool.assert_quiescent()
        return (a, b, c, refused, m, _pool_state(strict)), pool
    _both(run)


def test_pool_occupancy_counts_shared_blocks_once():
    """Shadows test_prefix_cache.py:95 (pool_occupancy, host side), on
    torch tensors for the port."""
    lens = np.array([8, 8])
    bt = np.array([[0, 1, 99, 99], [0, 1, 99, 99]])  # 99 = sentinel
    for kw in (dict(block_tables=bt), {},
               dict(live=[True, False], block_tables=bt)):
        want = jpk.pool_occupancy(lens, 4, 16, **kw)
        tkw = {k: (torch.as_tensor(v) if k == "block_tables" else v)
               for k, v in kw.items()}
        assert tpk.pool_occupancy(torch.as_tensor(lens), 4, 16,
                                  **tkw) == want
    assert tpk.pool_occupancy(lens, 4, 16, block_tables=bt)[0] == 2
    assert tpk.pool_occupancy(lens, 4, 16)[0] == 4
    for dt, jdt in ((torch.float32, np.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert (tpk.kv_block_bytes(24, 16, 64, 128, dtype=dt)
                == jpk.kv_block_bytes(24, 16, 64, 128, dtype=jdt))


def _shared_corpus(seed, tails):
    rs = np.random.RandomState(seed)
    shared = rs.randint(1, 500, (8,)).astype("int64")   # 2 blocks @ 4
    tl = [rs.randint(1, 500, (n,)).astype("int64") for n in tails]
    return shared, tl


def _serve_widths(tm, requests, sess_kw, with_session=False):
    """serve() on the port, recording the token-buffer width of every
    admit. Returns (out, widths[, session])."""
    sess = session(tm, **sess_kw)
    widths, admit = [], sess._admit

    def spy(toks, lens, cow):
        widths.append(toks.shape[1])
        return admit(toks, lens, cow)
    sess._admit = spy
    for rid, p, n in requests:
        sess.submit(tserving.Request(rid, p, n))
    out = sess.run()
    return (out, widths, sess) if with_session else (out, widths)


@pytest.mark.parametrize("family", FAMILIES)
def test_prefix_hit_skips_prefill_and_streams_byte_identical(family):
    """Shadows test_prefix_cache.py:115: cache on equals cache off, the
    JAX session and the paged generate; hits really skip prefill (the
    full-hit admissions feed 1 token); the admits run at the JAX
    session's token-buffer widths, with the cache off all at
    max_prompt_len."""
    jm, tm = make_cb_pair(family)
    shared, tails = _shared_corpus(3, (4, 3))
    prompts = [shared.copy(), np.concatenate([shared, tails[0]]),
               shared.copy(), np.concatenate([shared, tails[1]])]
    reqs = [(i, p, 5) for i, p in enumerate(prompts)]
    kw = dict(slots=2, max_prompt_len=12, kv_block_size=4, chunk=4)
    out_off, widths_off = _serve_widths(tm, reqs, dict(kw,
                                                       prefix_cache=False))
    out_on, widths, sess = _serve_widths(tm, reqs, kw, with_session=True)
    want, jsess = serve(jm, reqs, kw)
    assert set(widths_off) == {12}
    # the JAX session compiles max_prompt_len up front and each width
    # it admits at on first use
    assert sorted(set(widths) | {12}) == sorted(jsess._admit_compiled)
    assert_streams(out_on, out_off, range(4), "cache off")
    assert_streams(out_on, want, range(4), "the JAX session")
    paged = jax_paged_generate(jm, prompts, 5, kv_block_size=4)
    for i in range(4):
        np.testing.assert_array_equal(out_on[i], paged[i],
                                      err_msg=f"request {i} vs generate")
    st = sess.stats
    assert st == jsess.stats
    assert st["prefix_hits"] >= 2 and st["prefix_hit_tokens"] >= 8
    assert st["prefill_tokens"] == (sum(len(p) for p in prompts)
                                    - st["prefix_hit_tokens"])
    assert st["prefix_cow"] >= 1
    sess._pool.assert_quiescent()


def test_sampled_streams_byte_identical_cache_on_off():
    """Shadows test_prefix_cache.py:161 within the port: pinned-seed
    sampled serving emits the same streams with the cache on and off
    (same dispatches, same draws); the admission decisions (stats) are
    the JAX session's."""
    jm, tm = make_cb_pair("gpt", seed=5)
    shared, tails = _shared_corpus(11, (2, 4, 2))
    prompts = [np.concatenate([shared, t]) for t in tails] + [shared.copy()]
    reqs = [(i, p, 6) for i, p in enumerate(prompts)]
    kw = dict(slots=2, max_prompt_len=12, kv_block_size=4, chunk=3,
              do_sample=True, temperature=0.9, top_k=30)
    out_off, _ = serve(tm, reqs, dict(kw, prefix_cache=False))
    out_on, sess = serve(tm, reqs, kw)
    assert sess.stats["prefix_hits"] >= 2, sess.stats
    assert_streams(out_on, out_off, range(4), "cache off")
    again, _ = serve(tm, reqs, kw)
    assert_streams(again, out_on, range(4), "the same seed again")
    _, jsess = serve(jm, reqs, kw)
    for k in ("admit_steps", "chunk_steps", "prefix_hits",
              "prefix_hit_tokens", "prefill_tokens", "prefix_cow"):
        assert sess.stats[k] == jsess.stats[k], k


@pytest.mark.parametrize("family", FAMILIES)
def test_cow_isolation_divergent_requests_never_corrupt(family):
    """Shadows test_prefix_cache.py:189: two concurrent requests share a
    cached prefix and diverge, one through the copy-on-write block; the
    canonical shared blocks keep their bytes."""
    jm, tm = make_cb_pair(family, seed=6)
    shared, (tail,) = _shared_corpus(8, (4,))
    pa, pb = shared.copy(), np.concatenate([shared, tail])
    kw = dict(slots=2, max_prompt_len=12, kv_block_size=4, chunk=4)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, **kw)
        sess.submit(pkg.Request("prime", pb, 3))
        sess.run()
        if pkg is tserving:
            canon = [sess._pool.cached[h]
                     for h in sess._pool.chain_hashes(shared)]
            snap = [(k[canon].clone(), v[canon].clone())
                    for k, v in zip(sess._kcs, sess._vcs)]
        sess.submit(pkg.Request("a", pa, 8))
        sess.submit(pkg.Request("b", pb, 8))
        res[pkg] = (sess.run(), sess)
    out, sess = res[tserving]
    want, jsess = res[jserving]
    assert sess.stats["prefix_cow"] >= 1
    assert sess.stats == jsess.stats
    assert_streams(out, want, ("a", "b"), "the JAX session")
    for rid, p in (("a", pa), ("b", pb)):
        np.testing.assert_array_equal(out[rid], port_solo(tm, p, 8, 4),
                                      err_msg=f"request {rid} vs solo")
    for (k, v), (ks, vs) in zip(zip(sess._kcs, sess._vcs), snap):
        assert torch.equal(k[canon], ks) and torch.equal(v[canon], vs)
    sess._pool.assert_quiescent()


def test_freed_slot_phantom_writes_never_corrupt_recycled_blocks():
    """Shadows test_prefix_cache.py:216: a freed slot's table row is the
    sentinel, so its phantom writes never land in blocks recycled to a
    later request. The new request's gathered KV is byte-identical to a
    fresh session's, and equals the JAX session's to fp32 rounding."""
    jm, tm = make_cb_pair("gpt", seed=9)
    rs = np.random.RandomState(11)
    n_new = 6
    pa, pb, pc = (rs.randint(1, 500, (24,)).astype("int64")
                  for _ in range(3))
    kw = dict(slots=2, max_prompt_len=32, kv_block_size=8, chunk=2,
              num_blocks=8)

    def kv_and_tokens_of_c(model, pkg, contaminate):
        sess = session(model, **kw)
        if contaminate:
            sess.submit(pkg.Request("a", pa, n_new))
            sess.submit(pkg.Request("b", pb, n_new))
            sess.run()
            for i, sl in enumerate(sess._slots):
                assert sl.req is None and (sess._bt[i] == 8).all()
        sess.submit(pkg.Request("c", pc, n_new))
        sess.step()                       # admit + first decode writes
        slot = [s for s in sess._slots if s.req is not None][0]
        k = np.asarray(sess._kcs[0])
        gathered = np.concatenate([k[b].transpose(1, 0, 2)
                                   for b in slot.block_ids])
        return gathered[:len(pc)], sess.run()["c"]

    truth_kv, truth_toks = kv_and_tokens_of_c(tm, tserving, False)
    got_kv, got_toks = kv_and_tokens_of_c(tm, tserving, True)
    np.testing.assert_array_equal(truth_kv, got_kv)
    np.testing.assert_array_equal(truth_toks, got_toks)
    jkv, jtoks = kv_and_tokens_of_c(jm, jserving, True)
    np.testing.assert_allclose(got_kv, jkv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_toks, jtoks)


def test_eviction_under_pressure_falls_back_to_full_prefill():
    """Shadows test_prefix_cache.py:262: a pool one request wide evicts
    the earlier request's cached blocks (LRU) and serves a repeat as a
    miss; nothing deadlocks."""
    jm, tm = make_cb_pair("gpt", seed=7, max_seq_len=16)
    rs = np.random.RandomState(9)
    pa, pb = (rs.randint(1, 500, (8,)).astype("int64") for _ in range(2))
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=4, chunk=4,
              num_blocks=4)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, **kw)
        outs = {}
        for rid, p in (("a", pa), ("b", pb), ("a2", pa)):
            sess.submit(pkg.Request(rid, p, 6))
            outs.update(sess.run())          # returns => no deadlock
        res[pkg] = (outs, sess.stats)
    outs, st = res[tserving]
    assert st["prefix_evictions"] >= 2
    assert st["prefix_hits"] == 0 and st["prefix_misses"] == 3
    assert st == res[jserving][1]
    assert_streams(outs, res[jserving][0], ("a", "b", "a2"),
                   "the JAX session")
    paged = jax_paged_generate(jm, [pa, pb], 6, kv_block_size=4)
    for rid, want in (("a", paged[0]), ("b", paged[1]), ("a2", paged[0])):
        np.testing.assert_array_equal(outs[rid], want, err_msg=rid)


def test_cow_degrade_honors_min_match_blocks():
    """Shadows test_prefix_cache.py:290: with no room for the CoW block
    the plan drops the final matched block, and below min_match_blocks
    it full-prefills."""
    jm, tm = make_cb_pair("gpt", seed=12, max_seq_len=16)
    p = np.random.RandomState(13).randint(1, 500, (8,)).astype("int64")
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=4, chunk=4,
              num_blocks=4, min_match_blocks=2)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, **kw)
        outs = {}
        for rid in ("a", "b"):                           # b full-hits a
            sess.submit(pkg.Request(rid, p, 8))
            outs.update(sess.run())
        res[pkg] = (outs, sess.stats)
    outs, st = res[tserving]
    assert st["prefix_hits"] == 0 and st["prefix_cow"] == 0, st
    assert st == res[jserving][1]
    solo = port_solo(tm, p, 8, 4)
    for rid in ("a", "b"):
        np.testing.assert_array_equal(outs[rid], res[jserving][0][rid])
        np.testing.assert_array_equal(outs[rid], solo, err_msg=rid)


def test_full_pool_queues_request_and_never_evicts_live_blocks():
    """Shadows test_prefix_cache.py:316: a request waits while every
    block is live (decode keeps going), then admits; a full hit against
    a pool one request wide degrades the hit instead of copying; a
    request larger than the pool is refused at submit."""
    jm, tm = make_cb_pair("gpt", seed=8, max_seq_len=16)
    rs = np.random.RandomState(10)
    pa, pb = (rs.randint(1, 500, (8,)).astype("int64") for _ in range(2))
    kw = dict(slots=2, max_prompt_len=8, kv_block_size=4, chunk=2,
              num_blocks=4)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, **kw)
        sess.submit(pkg.Request("a", pa, 6))     # holds all 4 blocks
        sess.submit(pkg.Request("b", pb, 6))     # waits for a's release
        assert sess.step()                       # admits a only
        assert sess._slots[0].req is not None and sess._slots[1].req is None
        assert sess._pool.num_free == 0
        waited = 0
        while sess._slots[1].req is None and sess._queue:
            assert sess.step()                   # decode-only progress
            waited += 1
            assert waited < 50
        out = sess.run()
        sess2 = session(m, **dict(kw, slots=1))
        sess2.submit(pkg.Request("a", pa, 8))    # 4 blocks = whole pool
        first = sess2.run()["a"]
        sess2.submit(pkg.Request("a2", pa, 8))   # full hit, no CoW room
        again = sess2.run()["a2"]
        res[pkg] = (out, waited, first, again, sess.stats, sess2.stats)
    out, waited, first, again, st, st2 = res[tserving]
    jout, jwaited, jfirst, jagain, jst, jst2 = res[jserving]
    assert_streams(out, jout, ("a", "b"), "the JAX session")
    assert waited == jwaited and st == jst and st2 == jst2
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(again, jagain)
    assert st2["prefix_cow"] == 0 and st2["prefix_hits"] == 1
    assert st2["prefix_hit_tokens"] == 4
    tiny = session(tm, **dict(kw, slots=1, num_blocks=3))
    with pytest.raises(ValueError, match="KV blocks"):
        tiny.submit(tserving.Request("x", pa, 6))


def test_weight_update_flushes_prefix_cache():
    """Shadows test_prefix_cache.py:371: a weight written between
    requests flushes the prefix cache, and the repeated prompt is served
    from the new weights, as in the JAX session."""
    jm, tm = make_cb_pair("gpt", seed=4)
    p = np.random.RandomState(6).randint(1, 500, (8,)).astype("int64")
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=4, chunk=4)
    jsess, tsess = session(jm, **kw), session(tm, **kw)
    outs = {}
    for name, sess, pkg in (("jax", jsess, jserving),
                            ("port", tsess, tserving)):
        sess.submit(pkg.Request(0, p, 4))
        outs[name] = [sess.run()[0]]
        assert sess._pool.occupancy()["cached"] > 0      # primed
    wpe = jm.gpt.wpe.weight
    wpe._value = wpe._value.at[7].set(100.0 * jm.gpt.wte.weight._value[7])
    with torch.no_grad():
        tm.gpt.wpe.weight[7] = 100.0 * tm.gpt.wte.weight[7]
    for name, sess, pkg in (("jax", jsess, jserving),
                            ("port", tsess, tserving)):
        sess.submit(pkg.Request(1, p, 4))
        outs[name].append(sess.run()[1])
    st = tsess.stats
    assert st["prefix_hits"] == 0 and st["prefix_misses"] == 2
    assert st == jsess.stats
    out1, out2 = outs["port"]
    assert int(out2[0]) == 7 and list(out1) != list(out2)
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out2, port_solo(tm, p, 4, 4))
