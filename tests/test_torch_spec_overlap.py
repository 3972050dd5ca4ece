"""Speculative windows on the port's overlapped engine against the JAX
package's, and logprobs=True under speculation.

Shadows tests/test_engine_overlap.py :138 (n-gram staging) and :251
(logprobs with speculation), and tests/test_spec_overlap_v2.py :93
(staging engages), :105 (sampled, pinned seeds), :120 (Llama-GQA), :133
(chunked prefill), :196 (prefix hits), :228 (preemption) and :299
(logprobs pins host accept). Each greedy scenario runs on a JAX session
and a port session, both on their default (overlapped) engine with
device accept and the n-gram proposer staging window N+1 while window N
verifies: byte-identical streams, equal step() counts, staged and
mispredicted steps and stats (spec counts included); the port's
sequential engine streams the same bytes. Sampled streams are held
within the port, overlap on against off (the reference's own test fails
on its tree, ROADMAP queue C). Models: the tiny GPT and Llama-GQA 4:2 of
test_torch_engine_overlap.py.
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu.inference import speculative as jspec
from paddle_tpu_torch.inference import speculative as tspec

from test_torch_engine_overlap import Drive, assert_streams, hold_to_jax
from test_torch_continuous_batching import make_cb_pair

KW = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=4,
          num_blocks=40)


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Free this file's sessions (reference cycles holding memz
    providers) before the next file in the process runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def pairs():
    """{family: (jax model, port model)}, identical fp32 weights."""
    return {fam: make_cb_pair(fam, seed=9) for fam in ("gpt", "llama")}


def hold_spec(pair, scenario, seed=0, **kw):
    """hold_to_jax with speculation: k = 3, the n-gram proposer, device
    accept, windows staged on the overlapped engine."""
    def spec(model):
        pkg = tspec if isinstance(model, torch.nn.Module) else jspec
        return {"speculative": pkg.SpeculativeConfig(num_draft_tokens=3,
                                                     seed=seed)}

    def with_spec(d):
        assert d.sess._spec_accept == "device"
        assert d.sess._spec_stage == d.sess._overlap
        scenario(d)
    return hold_to_jax(pair, with_spec, spec, **dict(KW, **kw))


def rep_prompts(n_list, seed=3, vocab=500):
    """Periodic prompts: the n-gram proposer sees its suffix repeat, so
    windows draft and (greedy) fully accept, the staging regime."""
    rs = np.random.RandomState(seed)
    return [np.tile(rs.randint(1, vocab, (n,)).astype(np.int64), 3)[:16]
            for n in n_list]


def serve_all(prompts, n_new):
    def scenario(d):
        for i, p in enumerate(prompts):
            d.submit(i, p, n_new)
        d.run()
    return scenario


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_spec_overlap_staging_engages_equal_jax(pairs, family):
    """Shadows test_engine_overlap.py:138 and test_spec_overlap_v2.py:93,
    :120: periodic requests over two slots (GPT four, whose streams
    repeat, so drafts are accepted and staged windows launch: the
    boundary guess lands; Llama-GQA two, as the reference, whose random
    streams never repeat a suffix, so nothing drafts and no window
    stages); the counts are the JAX session's either way."""
    n = (5, 7, 4, 6) if family == "gpt" else (6, 8)
    td = hold_spec(pairs[family], serve_all(rep_prompts(n), 12))
    st = td.sess.stats
    assert st["spec_steps"] > 0
    if family == "gpt":
        assert st["spec_accepted_tokens"] > 0 and td.sess._ov.overlapped > 0


def test_spec_overlap_chunked_prefill_equal_jax(pairs):
    """Shadows test_spec_overlap_v2.py:133: a 30-token prompt admitted in
    chunks of 8 while the live streams keep verifying."""
    rs = np.random.RandomState(6)
    long_p = np.tile(rs.randint(1, 500, (8,)).astype(np.int64), 4)[:30]
    prompts = rep_prompts((5, 6), seed=8) + [long_p]
    td = hold_spec(pairs["gpt"], serve_all(prompts, 8), max_prompt_len=32,
                   prefill_chunk=8)
    assert td.sess.stats["spec_steps"] > 0
    assert td.sess._ov.mispredicts > 0


def test_spec_overlap_prefix_hits_equal_jax(pairs):
    """Shadows test_spec_overlap_v2.py:196: a primed shared prefix serves
    a full hit (CoW tail) and a partial hit; draft writes stay out of
    shared blocks on the staged path too."""
    rs = np.random.RandomState(8)
    shared = np.tile(rs.randint(1, 500, (4,)).astype(np.int64), 2)
    pb = np.concatenate([shared, np.tile(shared[:2], 2)]).astype(np.int64)

    def scenario(d):
        d.submit("prime", pb, 4)
        d.run()
        d.submit("a", shared, 8)
        d.submit("b", pb, 8)
        d.run()

    td = hold_spec(pairs["gpt"], scenario, kv_block_size=4)
    st = td.sess.stats
    assert st["prefix_hits"] >= 2 and st["prefix_cow"] >= 1, st
    assert st["spec_steps"] > 0
    td.sess._pool.assert_quiescent()


def test_spec_overlap_preemption_equal_jax(pairs):
    """Shadows test_spec_overlap_v2.py:228: preempt() after three steps
    commits the window in flight, drops the staged one, and the victim
    re-prefills under speculation."""
    prompts = rep_prompts((5, 6, 7), seed=14)

    def scenario(d):
        for i, p in enumerate(prompts):
            d.submit(i, p, 8)
        d.step(3)
        d.sess.preempt()
        assert d.sess._ov.inflight is None and d.sess._ov.staged is None
        d.run()

    td = hold_spec(pairs["gpt"], scenario)
    assert td.sess.stats["preemptions"] == 1
    assert td.sess.stats["spec_steps"] > 0


@pytest.mark.parametrize("temperature", [0.4, 0.1])
def test_spec_overlap_sampled_equal_sequential(pairs, temperature):
    """Shadows test_spec_overlap_v2.py:105 within the port: pinned-seed
    sampled windows (spec seed 7) stream the same bytes with the
    overlapped engine on and off: a staged window launches only after
    validation, so every window's uniform draw is the sequential
    engine's. At temperature 0.4 the tiny model's samples leave the
    period and drafts are rejected (nothing stages); at 0.1 its samples
    follow the period, windows fully accept and the staged path runs,
    its Philox draw taken before the harvested window's bookkeeping,
    with a mispredict as well."""
    prompts = rep_prompts((6, 5, 7), seed=5)
    out, sessions = {}, {}
    for overlap in (False, True):
        d = Drive(pairs["gpt"][1], overlap=overlap, do_sample=True,
                  temperature=temperature,
                  speculative=tspec.SpeculativeConfig(num_draft_tokens=3,
                                                      seed=7), **KW)
        for i, p in enumerate(prompts):
            d.submit(i, p, 10, seed=i)
        out[overlap], sessions[overlap] = d.run(), d.sess
    assert_streams(out[True], out[False], "the sequential engine")
    assert sessions[True].stats == sessions[False].stats
    assert sessions[True].stats["spec_proposed_tokens"] > 0
    if temperature < 0.2:
        ov = sessions[True]._ov
        assert ov.overlapped > 0 and ov.mispredicts > 0, (ov.overlapped,
                                                          ov.mispredicts)


def test_logprobs_with_speculation(pairs, monkeypatch):
    """Shadows test_engine_overlap.py:251 and test_spec_overlap_v2.py:299:
    logprobs=True pins host accept (PADDLE_SPEC_DEVICE_ACCEPT=1 or not)
    and the sequential engine; the streams are the spec-off logprobs
    session's, and each token's log p, taken from its own window
    position, is the spec-off one's within float noise (another program
    width scores the same position)."""
    prompts = rep_prompts((5, 7), seed=26)
    monkeypatch.setenv("PADDLE_SPEC_DEVICE_ACCEPT", "1")
    runs = {}
    for spec in (False, True):
        d = Drive(pairs["gpt"][1], logprobs=True, speculative=(
            tspec.SpeculativeConfig(num_draft_tokens=3) if spec else None),
            **KW)
        for i, p in enumerate(prompts):
            d.submit(f"l{i}", p, 10)
        d.run()
        runs[spec] = d
    on, off = runs[True], runs[False]
    assert on.sess._spec_accept == "host" and not on.sess._overlap
    assert on.sess.stats["spec_accepted_tokens"] > 0
    assert_streams(on.out, off.out, "the spec-off logprobs session")
    for rid, r in on.reqs.items():
        assert len(r.token_logprobs) == len(r.tokens)
        np.testing.assert_allclose(r.token_logprobs,
                                   off.reqs[rid].token_logprobs,
                                   rtol=1e-4, atol=1e-5, err_msg=rid)
