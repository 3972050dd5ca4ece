"""The port's speculative-decoding host units and acceptance fold against
the JAX package's.

Shadows tests/test_speculative.py :40 (n-gram lookup), :66 (config),
:79 (greedy accept), :91 (rejection sampling), :119 (filtered probs) and
tests/test_spec_overlap_v2.py :262 (the fold against the host oracle):
the same inputs, made from a seed with numpy, go through the JAX
function and the port's. The numpy modules (config, rejection, the
n-gram proposer, the span helpers) must agree exactly. The fold, fed the
JAX fold's own uniforms, must give the same accepted count and boundary
token for every row; its probabilities are fp32 on both sides and agree
within 1e-6 (the sum and cumsum orders differ), which no decision in
these inputs comes near.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import paged_kv as jpkv
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.inference.speculative import verify as jverify
from paddle_tpu_torch.incubate.nn.functional import paged_kv as tpkv
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.inference.speculative.rejection import UniformStream


def _histories(seed, n=40):
    """Seeded token histories: periodic, random and short."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        period = rs.randint(1, 6)
        motif = rs.randint(1, 9, (period,))
        h = np.tile(motif, rs.randint(1, 6))[:rs.randint(1, 20)]
        if rs.rand() < 0.4:
            h = rs.randint(1, 9, (rs.randint(1, 16),))
        out.append(h.astype(np.int64))
    return out


@pytest.mark.parametrize("kw", [dict(num_draft_tokens=4, ngram_max=3,
                                     ngram_min=1),
                                dict(num_draft_tokens=3, ngram_max=3,
                                     ngram_min=2),
                                dict(num_draft_tokens=2, ngram_max=1,
                                     ngram_min=1)])
def test_ngram_lookup_equals_jax(kw):
    """Shadows test_speculative.py:40: the reference's cases, then
    seeded histories at every cap, with a tenant corpus fallback."""
    t, j = tspec.NgramProposer(**kw), jspec.NgramProposer(**kw)
    hist = np.array([5, 6, 7, 8, 9, 5, 6, 7])
    if kw["ngram_min"] == 1 and kw["ngram_max"] == 3:
        np.testing.assert_array_equal(t.propose_one(hist, 4), [8, 9, 5, 6])
    for h in _histories(0):
        for k in range(0, kw["num_draft_tokens"] + 2):
            np.testing.assert_array_equal(t.propose_one(h, k),
                                          j.propose_one(h, k))
    ts, js = tspec.AdapterDraftStore(64), jspec.AdapterDraftStore(64)
    for s in (ts, js):
        for h in _histories(1, 8):
            s.observe(b"t", h)
    assert ts.stats() == js.stats()
    t.store, j.store = ts, js
    for h in _histories(2):
        np.testing.assert_array_equal(
            t.propose_one(h, 3, tenant=b"t"),
            j.propose_one(h, 3, tenant=b"t"))
    tp = t.propose([(0, h) for h in _histories(3, 1)], {0: 3})
    jp = j.propose([(0, h) for h in _histories(3, 1)], {0: 3})
    np.testing.assert_array_equal(tp[0], jp[0])


def test_speculative_config_validation_and_cache_key_equal_jax():
    """Shadows test_speculative.py:66: the same refusals and keys."""
    for bad in (dict(proposer="oracle"), dict(num_draft_tokens=0),
                dict(proposer="draft"), dict(ngram_min=3, ngram_max=2)):
        with pytest.raises(ValueError) as te:
            tspec.SpeculativeConfig(**bad)
        with pytest.raises(ValueError) as je:
            jspec.SpeculativeConfig(**bad)
        assert str(te.value) == str(je.value)
    for kw in ({}, dict(num_draft_tokens=3), dict(ngram_max=5, seed=4)):
        assert (tspec.SpeculativeConfig(**kw).cache_key()
                == jspec.SpeculativeConfig(**kw).cache_key())
    assert (tspec.SpeculativeConfig(num_draft_tokens=3).cache_key()
            != tspec.SpeculativeConfig(num_draft_tokens=4).cache_key())
    draft = object()
    a = tspec.SpeculativeConfig(proposer="draft", draft_model=draft)
    assert a.cache_key()[4] == id(draft)
    assert tspec.resolve_speculative({"num_draft_tokens": 2}) == \
        tspec.SpeculativeConfig(num_draft_tokens=2)
    assert tspec.resolve_speculative(None) is None
    with pytest.raises(TypeError):
        tspec.resolve_speculative(3)


def test_greedy_accept_equals_jax():
    """Shadows test_speculative.py:79: logits and argmax chains."""
    rs = np.random.RandomState(4)
    lv = np.full((3, 8), -1.0)
    lv[0, 2] = lv[1, 5] = lv[2, 1] = 1.0
    assert tspec.greedy_accept(lv, [2, 5]) == ([2, 5, 1], 2)
    assert tspec.greedy_accept(lv, [2, 4]) == ([2, 5], 1)
    for _ in range(50):
        m = rs.randint(1, 6)
        lv = rs.randn(m, 8)
        chain = lv.argmax(-1)
        drafts = np.where(rs.rand(m - 1) < 0.6, chain[:-1],
                          rs.randint(0, 8, (m - 1,)))
        want = jspec.greedy_accept(lv, drafts)
        assert tspec.greedy_accept(lv, drafts) == want
        assert tspec.greedy_accept(chain, drafts) == want


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=8),
                                dict(temperature=1.2, top_p=0.7),
                                dict()])
def test_rejection_accept_equals_jax(kw):
    """Shadows test_speculative.py:91: the same draws from the same rng
    state give the same emitted tokens and counts; and the first token's
    distribution is the target's (chi-square at the reference's bar)."""
    rs = np.random.RandomState(0)
    V = 16
    for _ in range(30):
        m = rs.randint(1, 5)
        lv = rs.randn(m, V) * 2.0
        drafts = rs.randint(0, V, (m - 1,))
        seed = rs.randint(1 << 30)
        got = tspec.rejection_accept(lv, drafts,
                                     np.random.default_rng(seed), **kw)
        want = jspec.rejection_accept(lv, drafts,
                                      np.random.default_rng(seed), **kw)
        assert got == want
    logits = rs.normal(size=(1, V)) * 2.0
    p = tspec.filtered_probs(logits[0], **kw)
    lv2 = np.concatenate([logits, logits])
    rng, counts, N = np.random.default_rng(7), np.zeros(V), 4000
    for _ in range(N):
        out, _ = tspec.rejection_accept(lv2, [int(p.argmin())], rng, **kw)
        counts[out[0]] += 1
    exp = p * N
    mask = exp > 5
    chi2 = ((counts[mask] - exp[mask]) ** 2 / exp[mask]).sum()
    assert chi2 < 45.0, (chi2, counts, exp)


@pytest.mark.parametrize("kw", [{"top_k": 5}, {"top_p": 0.7},
                                {"top_k": 4, "top_p": 0.9},
                                {"temperature": 0.5, "top_k": 3}, {}])
def test_filtered_probs_equal_jax(kw):
    """Shadows test_speculative.py:119: the numpy filter equals the JAX
    package's; the torch mirror equals ``filtered_probs_jax`` within
    1e-6 with the same support, and keeps the tokens ``mask_logits``
    keeps."""
    import jax.numpy as jnp

    from paddle_tpu_torch.inference.serving import mask_logits

    rs = np.random.RandomState(0)
    lv = (rs.randn(4, 3, 32) * 3).astype(np.float32)
    np.testing.assert_array_equal(tspec.filtered_probs(lv, **kw),
                                  jspec.filtered_probs(lv, **kw))
    got = tspec.filtered_probs_torch(torch.from_numpy(lv), **kw).numpy()
    want = np.asarray(jverify.filtered_probs_jax(jnp.asarray(lv), **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got > 0, want > 0)
    masked = mask_logits(torch.from_numpy(lv[:, 0]), **kw)
    np.testing.assert_array_equal(got[:, 0] > 0,
                                  torch.isfinite(masked).numpy())


def _fold_inputs(seed, S=4, w=4, V=64):
    """Window logits, drafts biased toward the argmax (some rows accept,
    some reject) and widths [w, w, 2, 1] (with a dead row at seed 2)."""
    rs = np.random.RandomState(seed)
    lv = rs.randn(S, w, V).astype(np.float32) * 2.0
    toks = np.zeros((S, w), np.int32)
    toks[:, 0] = rs.randint(1, V, (S,))
    for i in range(S):
        for j in range(1, w):
            toks[i, j] = (int(lv[i, j - 1].argmax()) if rs.rand() < 0.6
                          else int(rs.randint(1, V)))
    new_lens = np.array([w, w, 2, 0 if seed == 2 else 1], np.int32)
    return lv, toks, new_lens


FOLD_CASES = [dict(greedy=True), dict(greedy=False, temperature=1.2),
              dict(greedy=False, temperature=0.7, top_k=5),
              dict(greedy=False, temperature=1.0, top_p=0.8)]


@functools.lru_cache(maxsize=None)
def _jax_fold(cap, **kw):
    """The JAX fold, jitted once per case (its seeds share the
    compiled program)."""
    import jax

    return jax.jit(functools.partial(jverify.acceptance_fold, cap=cap,
                                     **kw))


@pytest.mark.parametrize("kw", FOLD_CASES,
                         ids=["greedy", "sampled", "top_k", "top_p"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_acceptance_fold_equals_jax_on_its_uniforms(kw, seed):
    """Shadows test_spec_overlap_v2.py:262: the port's fold, fed the JAX
    fold's own uniforms (``uniform(key, (S, cap))``), gives the JAX
    fold's accepted count and boundary for every row; so does the fold
    at a narrower width than cap (the uniforms' shape does not follow
    the width)."""
    import jax
    import jax.numpy as jnp

    cap = 5
    for w in (4, 1):
        lv, toks, new_lens = _fold_inputs(seed, w=w)
        new_lens = np.minimum(new_lens, w)
        key = jax.random.PRNGKey(seed)
        jn, jb = _jax_fold(cap, **kw)(jnp.asarray(lv), jnp.asarray(toks),
                       jnp.asarray(new_lens), key)
        u = np.array(jax.random.uniform(key, (len(lv), cap)))
        tn, tb = tspec.acceptance_fold(
            torch.from_numpy(lv), torch.from_numpy(toks),
            torch.from_numpy(new_lens), torch.from_numpy(u), **kw)
        assert tn.dtype == tb.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("kw", FOLD_CASES[1:],
                         ids=["sampled", "top_k", "top_p"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_acceptance_fold_matches_host_oracle(kw, seed):
    """Shadows test_spec_overlap_v2.py:262: the fold and
    ``rejection_accept`` fed the same uniforms through UniformStream
    agree on every accept decision and the boundary token; greedy
    matches ``greedy_accept``."""
    lv, toks, new_lens = _fold_inputs(seed)
    u = np.random.RandomState(seed + 100).rand(len(lv), 5).astype(
        np.float32)
    samp = {k: v for k, v in kw.items() if k != "greedy"}
    tn, tb = tspec.acceptance_fold(
        torch.from_numpy(lv), torch.from_numpy(toks),
        torch.from_numpy(new_lens), torch.from_numpy(u), **kw)
    gn, gb = tspec.acceptance_fold(
        torch.from_numpy(lv), torch.from_numpy(toks),
        torch.from_numpy(new_lens), None, greedy=True)
    for i in range(len(lv)):
        m = int(new_lens[i])
        if m <= 0:
            continue
        emitted, j_acc = tspec.rejection_accept(
            lv[i, :m], toks[i, 1:m], UniformStream(u[i]), **samp)
        assert (j_acc, emitted[-1]) == (int(tn[i]), int(tb[i])), (seed, i)
        emitted, j_acc = tspec.greedy_accept(lv[i, :m], toks[i, 1:m])
        assert (j_acc, emitted[-1]) == (int(gn[i]), int(gb[i])), (seed, i)


def test_span_helpers_equal_jax():
    """The write-span audit and the host rollback of the verify path
    (paged_kv.py:434, :458 of the JAX package)."""
    rs = np.random.RandomState(5)
    nb, bs = 12, 4
    for _ in range(60):
        row = rs.randint(0, nb + 1, (6,)).astype(np.int32)
        start, count = rs.randint(0, 26), rs.randint(0, 6)
        assert (tpkv.write_span_blocks(row, start, count, bs, nb)
                == jpkv.write_span_blocks(row, start, count, bs, nb))
    lens = rs.randint(0, 30, (5,)).astype(np.int32)
    acc = rs.randint(0, 30, (5,))
    got = tpkv.rollback_seq_lens(lens, acc)
    np.testing.assert_array_equal(got, np.asarray(
        jpkv.rollback_seq_lens(lens, acc)))
    assert got.dtype == np.int32


def test_pow2_width_and_ladder_widths():
    """The ladder's widths: the narrowest power of two over the window,
    capped at k+1 (k = 4: 1, 2, 4, 5), as the JAX package's; each width
    built once, at its first use."""
    for need in range(1, 12):
        for cap in (0, 3, 5, 8):
            assert (tspec.pow2_width(need, cap)
                    == jspec.pow2_width(need, cap))
    built = []
    ladder = tspec.VerifyLadder(
        None, rows=2, cap=5, device=torch.device("cpu"),
        pools=lambda: None, build=lambda body, w: built.append(w) or body,
        greedy=True)
    assert [ladder.get(n)[1] for n in range(1, 6)] == [1, 2, 4, 4, 5]
    assert built == [1, 2, 4, 5]
    assert sorted(ladder.toks) == [1, 2, 4, 5]
    assert ladder.out[4].shape == (2, 4) and ladder.out[4].dtype == \
        torch.int32
    with pytest.raises(ValueError, match="generator"):
        tspec.VerifyLadder(None, 2, 5, torch.device("cpu"), None, None,
                           accept="device")
