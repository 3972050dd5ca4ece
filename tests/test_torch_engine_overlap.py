"""The port's overlapped engine and its logprobs=True path against the JAX
package's.

Shadows tests/test_engine_overlap.py :61 (prefix hits and chunked
prefill), :92 (Llama-GQA), :112 (forced preemption), :213 (logprobs
against the device sampler at chunk 1 and 4) and :290 (a mid-stream
submit and an eos mispredict). Each scenario runs on a JAX session and a
port session, both on their DEFAULT engine (the overlapped one): the
greedy streams must be byte-identical, and so must the step() counts,
``_ov.overlapped``, ``_ov.mispredicts`` and ``stats``; the port's
sequential engine must stream the same bytes. The models are the
reference tests' tiny GPT (vocab 512, E 64, 2 layers) and a Llama-GQA 4:2
of the same size, fp32, with the JAX models' weights
(bridge.load_jax_state).

Sampled streams are held within the port: overlap on and off byte for
byte (the reference's own sampled identity test fails on its tree,
ROADMAP queue C), and logprobs=True against the device sampler under
pinned seeds. Greedy fp32 log probabilities are held to the JAX
session's within LOGPROB_ATOL.
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.inference import serving as tserving

from test_torch_continuous_batching import make_cb_pair

# |port - JAX| of a greedy token's log p, fp32: both take the same
# max-shifted log-softmax, of fp32 logits that the two packages' forwards
# compute with different summation orders (XLA's and torch's CPU
# matmuls). On this test's data the largest difference is 4.8e-7, one
# fp32 ulp of a log p near -6 (GPT and Llama alike); the bound leaves a
# margin of about 40x for other summation orders
LOGPROB_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Sessions are reference cycles whose memz providers stay registered
    until the collector frees them: free this file's before the next
    file in the process runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def pairs():
    """{family: (jax model, port model)}, identical fp32 weights."""
    return {fam: make_cb_pair(fam, seed=9) for fam in ("gpt", "llama")}


class Drive:
    """One session of either package, driven through a scenario; counts
    the step() calls that did work."""

    def __init__(self, model, **kw):
        port = isinstance(model, torch.nn.Module)
        self.pkg = tserving if port else jserving
        self.sess = self.pkg.ContinuousBatchingSession(model, **kw)
        self.steps, self.out, self.reqs = 0, {}, {}

    def submit(self, rid, prompt, n, **kw):
        r = self.pkg.Request(rid, np.asarray(prompt).copy(), n, **kw)
        self.reqs[rid] = r
        self.sess.submit(r)

    def step(self, n=1):
        for _ in range(n):
            self.steps += bool(self.sess.step())

    def run(self):
        while self.sess.step():
            self.steps += 1
        self.out.update(self.sess.run())
        return self.out

    def counts(self):
        ov = self.sess._ov
        return self.steps, ov.steps, ov.overlapped, ov.mispredicts


def assert_streams(got, want, what):
    assert set(got) == set(want), what
    for rid in want:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]),
                                      err_msg=f"request {rid} vs {what}")


def hold_to_jax(pair, scenario, kw_of=lambda model: {}, **kw):
    """``scenario(drive)`` on a JAX and a port session, both on their
    default engine: equal streams, step counts, overlapped and
    mispredicted steps and stats; the port's sequential engine streams
    the same bytes. ``kw_of(model)``: session kwargs of the model's own
    package. Returns the port's Drive."""
    jd, td = (Drive(m, **kw, **kw_of(m)) for m in pair)
    for d in (jd, td):
        assert d.sess._overlap
        scenario(d)
    assert_streams(td.out, jd.out, "the JAX session")
    assert td.counts() == jd.counts()
    assert td.sess.stats == jd.sess.stats
    seq = Drive(pair[1], overlap=False, **kw, **kw_of(pair[1]))
    scenario(seq)
    assert_streams(seq.out, td.out, "the port's sequential engine")
    assert seq.sess.stats == td.sess.stats and seq.sess._ov.steps == 0
    return td


def _prompts(rs, n, lo=4, hi=13, vocab=500):
    return [rs.randint(1, vocab, (int(rs.randint(lo, hi)),))
            .astype(np.int64) for _ in range(n)]


def test_overlap_prefix_hits_and_chunked_prefill_equal_jax(pairs):
    """Shadows test_engine_overlap.py:61: a primed shared prefix, then a
    full hit and an extended partial hit beside four others, admitted in
    chunks of 4 over two slots."""
    rs = np.random.RandomState(21)
    shared = rs.randint(1, 500, (8,)).astype(np.int64)
    ext = np.concatenate([shared,
                          rs.randint(1, 500, (5,)).astype(np.int64)])
    extras = _prompts(rs, 4)

    def scenario(d):
        d.submit("prime", shared, 4)
        d.run()
        d.submit("hit", shared, 8)
        d.submit("ext", ext, 8)
        for i, p in enumerate(extras):
            d.submit(f"x{i}", p, 6 + i)
        d.run()

    td = hold_to_jax(pairs["gpt"], scenario, slots=2, max_prompt_len=16,
                     kv_block_size=8, chunk=4, prefill_chunk=4,
                     num_blocks=24)
    ov = td.sess._ov
    assert 0 < ov.overlapped < ov.steps      # admits never overlap
    assert td.sess.stats["prefix_hits"] >= 2


def test_overlap_llama_gqa_equal_jax(pairs):
    """Shadows test_engine_overlap.py:92: the staged dispatch is
    model-agnostic (grouped kv heads 4:2)."""
    prompts = _prompts(np.random.RandomState(22), 5)

    def scenario(d):
        for i, p in enumerate(prompts):
            d.submit(f"l{i}", p, 8)
        d.run()

    td = hold_to_jax(pairs["llama"], scenario, slots=2, max_prompt_len=16,
                     kv_block_size=8, chunk=4, num_blocks=24)
    assert td.sess._ov.overlapped > 0


def test_overlap_forced_preemption_equal_jax(pairs):
    """Shadows test_engine_overlap.py:112: preempt() mid-decode commits
    the deferred chunk first (the victim keeps its tokens) and drops the
    staged plan; the requeued request re-prefills through the prefix
    cache."""
    rs = np.random.RandomState(23)
    reqs = [("pa", rs.randint(1, 500, (10,)).astype(np.int64), 10),
            ("pb", rs.randint(1, 500, (7,)).astype(np.int64), 10)]
    in_flight = []

    def scenario(d):
        for rid, p, n in reqs:
            d.submit(rid, p, n)
        d.step(6)                    # both mid-decode
        in_flight.append(d.sess._ov.inflight is not None)
        d.sess.preempt()
        assert d.sess._ov.inflight is None and d.sess._ov.staged is None
        d.run()

    td = hold_to_jax(pairs["gpt"], scenario, slots=2, max_prompt_len=16,
                     kv_block_size=8, chunk=2, prefill_chunk=4,
                     num_blocks=12)
    # a chunk was in flight in both overlapped sessions, none in the
    # sequential one
    assert in_flight == [True, True, False]
    assert td.sess.stats["preemptions"] == 1
    assert td.sess._ov.inflight is None and td.sess._ov.staged is None


def test_overlap_submit_and_eos_mispredicts_equal_jax(pairs):
    """Shadows test_engine_overlap.py:290: a submit between steps makes
    the staged plan stale (a mispredict, never a wrong dispatch), and so
    does an eos inside a harvested chunk (its slot frees)."""
    rs = np.random.RandomState(27)
    p0 = rs.randint(1, 500, (6,)).astype(np.int64)
    p1 = rs.randint(1, 500, (8,)).astype(np.int64)
    late = rs.randint(1, 500, (5,)).astype(np.int64)

    def scenario(d):
        d.submit("a", p0, 12)
        d.submit("b", p1, 12)
        d.step(4)
        d.submit("late", late, 6)    # the staged plan is now stale
        d.run()

    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=2,
              num_blocks=24)
    plain = Drive(pairs["gpt"][1], overlap=False, **kw)
    scenario(plain)
    # an eos that request "a" emits as its third token (the second of its
    # first chunk), and no stream before
    eos = int(plain.out["a"][2])
    assert eos not in plain.out["a"][:2]
    assert all(eos not in plain.out[r] for r in ("b", "late"))
    td = hold_to_jax(pairs["gpt"], scenario, eos_token_id=eos, **kw)
    ov = td.sess._ov
    assert ov.overlapped > 0 and ov.mispredicts >= 2
    assert ov.steps >= ov.overlapped + ov.mispredicts
    assert len(td.out["a"]) == 3 and td.out["a"][-1] == eos


def test_overlap_sampled_streams_equal_sequential(pairs):
    """Pinned-seed sampled streams are byte-equal with the overlapped
    engine on and off (the reference's sampled identity test,
    test_spec_overlap_v2.py:105, fails on its own tree: ROADMAP queue
    C), with staged chunks launched."""
    prompts = _prompts(np.random.RandomState(26), 4)
    out, sessions = {}, {}
    for overlap in (False, True):
        d = Drive(pairs["gpt"][1], overlap=overlap, slots=2,
                  max_prompt_len=16, kv_block_size=8, chunk=4,
                  num_blocks=24, do_sample=True, temperature=0.8,
                  top_k=40)
        for i, (p, sd) in enumerate(zip(prompts, [11, None, 313, None])):
            d.submit(f"d{i}", p, 9, seed=sd)
        out[overlap], sessions[overlap] = d.run(), d.sess
    assert_streams(out[True], out[False], "the sequential engine")
    assert sessions[True]._ov.overlapped > 0


@pytest.mark.parametrize("chunk", [1, 4])
def test_logprobs_sampled_equals_device_sampler(pairs, chunk):
    """Shadows test_engine_overlap.py:213: logprobs=True (raw-logits
    admits, the selection run after each replay from the session's
    generator) streams the device sampler's bytes under pinned session
    and request seeds at chunk 1 and 4 (a decode step is ``chunk``
    width-1 admits, each drawing as the chunk's scan step does), on the
    sequential engine, with a finite log p <= 0 per token."""
    prompts = _prompts(np.random.RandomState(26), 4)
    seeds = [11, None, 313, None]
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=chunk,
              num_blocks=24, do_sample=True, temperature=0.8, top_k=40)
    runs = {}
    for logprobs in (False, True):
        d = Drive(pairs["gpt"][1], logprobs=logprobs, **kw)
        for i, (p, sd) in enumerate(zip(prompts, seeds)):
            d.submit(f"d{i}", p, 6, seed=sd)
        runs[logprobs] = (d.run(), d)
    assert_streams(runs[True][0], runs[False][0], "the device sampler")
    d = runs[True][1]
    assert not d.sess._overlap and d.sess._chunk_prog is None
    assert d.sess.stats == runs[False][1].sess.stats
    for r in d.reqs.values():
        lps = np.asarray(r.token_logprobs, np.float64)
        assert len(lps) == len(r.tokens)
        assert np.all(np.isfinite(lps)) and np.all(lps <= 0.0)


def test_logprobs_greedy_equal_jax(pairs):
    """Greedy fp32 logprobs=True sessions of both packages over
    staggered requests (admits with riders, decode chunks of 3): the
    same tokens, each log p within LOGPROB_ATOL of the JAX session's,
    and the same step counts."""
    prompts = _prompts(np.random.RandomState(31), 3)
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=3,
              num_blocks=24, logprobs=True)
    drives = []
    for model in pairs["llama"]:
        d = Drive(model, **kw)
        d.submit("a", prompts[0], 7)
        d.step(2)
        for i, p in enumerate(prompts[1:]):
            d.submit(f"b{i}", p, 5)
        d.run()
        drives.append(d)
    jd, td = drives
    assert_streams(td.out, jd.out, "the JAX session")
    assert td.steps == jd.steps and td.sess.stats == jd.sess.stats
    for rid, r in td.reqs.items():
        want = np.asarray(jd.reqs[rid].token_logprobs)
        assert len(r.token_logprobs) == len(want) == len(r.tokens)
        np.testing.assert_allclose(r.token_logprobs, want, rtol=0,
                                   atol=LOGPROB_ATOL, err_msg=rid)


def test_engine_knobs_provider_and_inflight_guard(pairs, monkeypatch):
    """overlap=None resolves as in the JAX package (on unless
    PADDLE_ENGINE_OVERLAP=0; logprobs forces the sequential engine); the
    flight-recorder provider reports the real overlap state; nothing
    captures a program while a replay is in flight, and a weight
    replaced mid-decode re-captures only after the harvest (streams
    those of the sequential engine)."""
    from paddle_tpu_torch.observability.flight_recorder import \
        _provider_states

    tm = pairs["gpt"][1]
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=2,
              num_blocks=24)
    assert tserving.ContinuousBatchingSession(tm, **kw)._overlap
    assert not tserving.ContinuousBatchingSession(
        tm, logprobs=True, overlap=True, **kw)._overlap
    monkeypatch.setenv("PADDLE_ENGINE_OVERLAP", "0")
    assert not tserving.ContinuousBatchingSession(tm, **kw)._overlap
    monkeypatch.delenv("PADDLE_ENGINE_OVERLAP")

    prompts = _prompts(np.random.RandomState(5), 2)
    w = tm.gpt.blocks[0].mlp.fc1.weight

    def scenario(d, swap):
        for i, p in enumerate(prompts):
            d.submit(i, p, 10)
        d.step(3)
        if swap:
            assert d.sess._ov.inflight is not None  # a chunk in flight
            with pytest.raises(RuntimeError, match="in flight"):
                d.sess._build_chunk_program()
            state = _provider_states()[f"engine_staged_plan_"
                                       f"{id(d.sess):x}"]
            assert state["overlap"] and state["inflight_kind"] == "decode"
            assert state["staged_plan"]["kind"] == "decode"
            assert state["steps_overlapped"] == d.sess._ov.overlapped > 0
        w.data = w.data.clone()           # a new address, same values
        d.run()

    seq = Drive(tm, overlap=False, **kw)
    scenario(seq, False)
    d = Drive(tm, **kw)
    scenario(d, True)
    assert_streams(d.out, seq.out, "the sequential engine")
    assert d.sess._prog_weights == d.sess._weight_addresses()
