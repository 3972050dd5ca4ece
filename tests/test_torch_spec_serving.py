"""Speculative decoding through the port's serving sessions against the
JAX package's.

Shadows tests/test_speculative.py :149 (continuous batching, spec on and
off), :183 (prefix-cache hits), :215 (draft model and self-draft), :252
(the draft engine's catch-up ingest), :287 (staggered admissions), :328
(Llama-GQA under rejections), :364 (GenerationSession fixed, ragged and
eos) and :400 (sampled distribution), and tests/test_spec_overlap_v2.py
:87, :134, :154, :202, :244 and :296 on their sequential-engine arm
(overlap=False; the overlapped engine is not ported). The models are the
reference tests' tiny GPT (vocab 512, E 64, 2 layers) and a Llama-GQA
4:2 of the same size, and their drafts, in fp32 with the JAX models'
weights (bridge.load_jax_state). Greedy streams and the spec counts
(``spec_steps``, ``spec_proposed_tokens``, ``spec_accepted_tokens``)
must equal the JAX session's byte for byte, and the streams the port's
own spec-off run. Sampled streams are held within the port (ROADMAP
queue C item 17): by distribution against spec off, and byte for byte
between device and host accept and across pinned seeds.

The draft-model cases hold the port against the JAX package's draft
engine with the re-ingest of ROADMAP queue C item 16 patched in for the
test (``exact_jax_drafts``): the reference drafts from KV positions it
never computed, the port (its documented intent) does not;
``test_draft_engine_recomputes_what_the_reference_leaves_stale`` shows
the difference.
"""
import gc
import os

import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as jserving
from paddle_tpu.inference import speculative as jspec
from paddle_tpu.observability import get_registry as jregistry
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.observability import get_registry as tregistry

from test_torch_continuous_batching import make_cb_pair, serve

SESS_KW = dict(slots=2, max_prompt_len=12, kv_block_size=4, chunk=4)
DRAFT_CFG = {"gpt": dict(hidden_size=32, num_layers=1),
             "llama": dict(hidden_size=32, num_layers=1, num_heads=2,
                           num_kv_heads=1, intermediate_size=64)}


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Sessions are reference cycles whose memz providers stay registered
    until the collector frees them: free this file's before the next
    file in the process runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def pairs():
    """{family: (jax model, port model)} and {family + "_draft": ...}:
    the targets (seed 9) and smaller drafts (seed 4) of each family."""
    out = {}
    for fam in ("gpt", "llama"):
        out[fam] = make_cb_pair(fam, seed=9)
        out[fam + "_draft"] = make_cb_pair(fam, seed=4, **DRAFT_CFG[fam])
    return out


@pytest.fixture
def exact_jax_drafts(monkeypatch):
    """The JAX package's draft engine with the port's re-ingest (ROADMAP
    queue C item 16), patched for one test: it tracks the positions it
    computed from each row's history (``written``: the prefills and
    ingests, and an active row's k decode steps), and a proposal first
    drops each row's length to them, so the self-heal ingests the last
    draft of a fully accepted window and the first position of a row
    that drafted nothing. Its drafts are then the port's."""
    from paddle_tpu.inference.speculative import proposers as jprop

    E, P = jprop._DraftEngine, jprop.DraftModelProposer
    write, decode, propose = E._write, E.decode_drafts, P._propose

    def _write(self, pairs, reset):
        write(self, pairs, reset)
        if not hasattr(self, "written"):
            self.written = np.zeros_like(self.seq)
        for i, _ in pairs:
            self.written[i] = self.seq[i]

    def decode_drafts(self, firsts, active, k):
        self.written = np.where(np.asarray(active, bool), self.seq + k,
                                self.written)
        return decode(self, firsts, active, k)

    def _propose(self, contexts, caps):
        e = self._engine
        if hasattr(e, "written"):
            e.seq = np.minimum(e.seq, e.written)
        return propose(self, contexts, caps)

    monkeypatch.setattr(E, "_write", _write)
    monkeypatch.setattr(E, "decode_drafts", decode_drafts)
    monkeypatch.setattr(P, "_propose", _propose)


def spec_cfg(model, draft=None, **kw):
    """A SpeculativeConfig of the package ``model`` belongs to (the
    draft given as that package's model)."""
    pkg = tspec if isinstance(model, torch.nn.Module) else jspec
    if draft is not None:
        kw.update(proposer="draft", draft_model=draft)
    return pkg.SpeculativeConfig(**kw)


def rep_prompts(lens, seed):
    """Periodic prompts (the n-gram proposer sees its suffix repeat) and
    random ones, alternating."""
    rs = np.random.RandomState(seed)
    out = []
    for r, n in enumerate(lens):
        if r % 2:
            out.append(rs.randint(1, 500, (n,)).astype(np.int64))
        else:
            out.append(np.tile(rs.randint(1, 500, (3,)), 6)[:n]
                       .astype(np.int64))
    return out


def assert_streams(got, want, what):
    assert set(got) == set(want), what
    for rid in want:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]),
                                      err_msg=f"request {rid} vs {what}")


@pytest.mark.parametrize("family,proposer", [
    ("gpt", "ngram"), ("llama", "draft")])
def test_cb_spec_greedy_equals_jax_and_spec_off(pairs, exact_jax_drafts,
                                                family, proposer):
    """Shadows test_speculative.py:149, :215, :287, :328 and
    test_spec_overlap_v2.py:87, :111 (GPT's draft proposer against the
    JAX package's is held through GenerationSession below): staggered
    requests of unequal
    lengths over two slots (admissions while the other slot decodes, so
    the draft engine ingests the riders' tokens): the JAX session's
    streams and stats, spec counts included; the port's spec-off
    streams; the ladder's widths within k+1."""
    jm, tm = pairs[family]
    jd, td = pairs[family + "_draft"] if proposer == "draft" else (None,
                                                                   None)
    prompts = rep_prompts((8, 5, 12, 7, 10), seed=3)
    reqs = [(i, p, 6 + 4 * (i % 2)) for i, p in enumerate(prompts)]
    want, js = serve(jm, reqs, dict(SESS_KW, speculative=spec_cfg(
        jm, jd, num_draft_tokens=3)))
    got, ts = serve(tm, reqs, dict(SESS_KW, speculative=spec_cfg(
        tm, td, num_draft_tokens=3)))
    assert_streams(got, want, "the JAX session")
    assert ts.stats == js.stats
    st = ts.stats
    assert st["spec_steps"] > 0 and st["spec_proposed_tokens"] > 0
    assert 0 <= st["spec_accepted_tokens"] <= st["spec_proposed_tokens"]
    assert st["chunk_steps"] == 0 and ts._chunk_prog is None
    assert set(ts._verify_ladder.programs) <= {1, 2, 4}
    off, so = serve(tm, reqs, SESS_KW)
    assert_streams(got, off, "the port's spec-off session")
    assert so._verify_ladder is None and so._chunk_prog is not None
    ts._pool.assert_quiescent()


def test_cb_self_draft_accepts_every_draft_and_stays_synced(pairs):
    """Shadows test_speculative.py:215 (self-draft) and :287: the target
    as its own draft accepts every draft, and over staggered admissions
    the draft engine's cached length equals the slot's committed length
    after every window's bookkeeping (the default, overlapped engine
    commits a window in the step after its dispatch), the streams those
    of spec off."""
    _, tm = pairs["gpt"]
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 500, (n,)).astype(np.int64) for n in (8, 6)]
    cfg = spec_cfg(tm, tm, num_draft_tokens=3)
    reqs = [(i, p, 8) for i, p in enumerate(prompts)]
    got, ts = serve(tm, reqs, dict(SESS_KW, max_prompt_len=8,
                                   speculative=cfg))
    off, _ = serve(tm, reqs, dict(SESS_KW, max_prompt_len=8))
    assert_streams(got, off, "spec off")
    st = ts.stats
    assert st["spec_accepted_tokens"] == st["spec_proposed_tokens"] > 0

    rs = np.random.RandomState(7)
    reqs = [(i, rs.randint(1, 500, (6 + 2 * (i % 2),)).astype(np.int64),
             6 + 10 * (i % 2)) for i in range(4)]
    sess = tserving.ContinuousBatchingSession(tm, speculative=cfg,
                                              **SESS_KW)
    for rid, p, n in reqs:
        sess.submit(tserving.Request(rid, p, n))
    engine, synced, commit = sess._proposer._engine, [], \
        sess._spec_bookkeeping

    def checked(*a, **kw):
        n = commit(*a, **kw)
        for i, s in enumerate(sess._slots):
            if s.req is not None:
                assert int(engine.seq[i]) == s.seq_len, (i, len(synced))
                synced.append(i)
        return n
    sess._spec_bookkeeping = checked
    got = sess.run()
    assert synced and engine.decode_steps > 0
    off, _ = serve(tm, reqs, SESS_KW)
    assert_streams(got, off, "spec off")
    st = sess.stats
    assert st["spec_accepted_tokens"] >= 0.9 * st["spec_proposed_tokens"]


def test_cb_spec_prefix_hits_chunks_preemption_last_block_equal_jax():
    """Shadows test_speculative.py:183 and test_spec_overlap_v2.py:154,
    :202, :244: a primed shared prefix served as a full hit (CoW tail)
    and a partial hit, a prompt admitted in chunks of 8, a forced
    preemption mid-decode, and windows that run past a request's last
    block (the table holds the sentinel there, and at max_seq_len 32 its
    end: the writes drop, never clip): streams, stats and spec counts
    equal the JAX session's, streams equal spec off, and the pool is
    quiescent."""
    jm, tm = make_cb_pair("gpt", seed=23, max_seq_len=32)
    rs = np.random.RandomState(8)
    shared = np.tile(rs.randint(1, 500, (4,)), 2).astype(np.int64)
    pb = np.concatenate([shared, np.tile(shared[:2], 2)]).astype(np.int64)
    long_p = np.tile(rs.randint(1, 500, (5,)), 4)[:16].astype(np.int64)
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=4, chunk=4,
              num_blocks=40, prefill_chunk=8)

    def run(model, spec, spans=None):
        pkg = tserving if isinstance(model, torch.nn.Module) else jserving
        extra = {} if pkg is tserving else {"overlap": False}
        sess = pkg.ContinuousBatchingSession(
            model, speculative=spec, **kw, **extra)
        if spans is not None:
            dispatch = sess._dispatch_spec_window

            def spy(prog, w, toks, new_lens, old_lens, *a):
                # how far each live row's window runs past the positions
                # its table holds (its blocks; sentinels after them)
                held = (sess._bt < sess._num_blocks).sum(1) * 4
                spans.extend(int(old_lens[i]) + w - int(held[i])
                             for i in a[1])
                return dispatch(prog, w, toks, new_lens, old_lens, *a)
            sess._dispatch_spec_window = spy
        sess.submit(pkg.Request("prime", pb.copy(), 4))
        out = sess.run()
        sess.submit(pkg.Request("a", shared.copy(), 10))
        sess.submit(pkg.Request("b", pb.copy(), 12))
        sess.submit(pkg.Request("long", long_p.copy(), 16))
        for _ in range(3):
            sess.step()
        sess.preempt()
        out.update(sess.run())
        sess._pool.assert_quiescent()
        return out, sess.stats

    want, jst = run(jm, spec_cfg(jm, num_draft_tokens=3))
    spans = []
    got, tst = run(tm, spec_cfg(tm, num_draft_tokens=3), spans)
    assert_streams(got, want, "the JAX session")
    assert tst == jst
    assert tst["prefix_hits"] >= 2 and tst["prefix_cow"] >= 1, tst
    assert tst["preemptions"] >= 1 and tst["spec_accepted_tokens"] > 0
    assert max(spans) > 0, "no window ran past a request's last block"
    off, _ = run(tm, None)
    assert_streams(got, off, "spec off")


GS_KW = dict(batch=2, prompt_len=8, max_new_tokens=8, kv_block_size=4)


def _gs_counts(registry):
    return tuple(registry().get(f"serving_spec_{n}_tokens_total").value()
                 for n in ("proposed", "accepted"))


@pytest.mark.parametrize("mode", ["generate-ngram", "ragged-draft",
                                  "eos-ngram"])
def test_generation_session_spec_equals_jax(pairs, exact_jax_drafts,
                                            mode):
    """Shadows test_speculative.py:364: the fixed batch through
    model.generate(use_paged_kv=True, speculative=) (aot_generate), a
    ragged batch with a draft model and an eos that cuts the streams
    short: the JAX package's tokens byte for byte, its spec counts (the
    serving_spec_*_tokens_total counters), and the port's spec-off
    tokens."""
    jm, tm = pairs["gpt"]
    jd, td = pairs["gpt_draft"] if mode == "ragged-draft" else (None, None)
    rs = np.random.RandomState(7)
    ids = rs.randint(1, 500, (2, 8)).astype(np.int64)
    lens = np.array([5, 8])
    eos = None
    if mode == "eos-ngram":
        plain = tserving.GenerationSession(tm, **GS_KW)
        eos = int(plain.generate(ids).numpy()[0, 8 + 2])

    def run(model, draft, spec=True):
        pkg = tserving if isinstance(model, torch.nn.Module) else jserving
        cfg = spec_cfg(model, draft, num_draft_tokens=3) if spec else None
        if mode == "generate-ngram":
            out = model.generate(ids, max_new_tokens=8, use_paged_kv=True,
                                 kv_block_size=4, speculative=cfg)
            return np.asarray(out.numpy())
        sess = pkg.GenerationSession(
            model, speculative=cfg, eos_token_id=eos,
            ragged_prompts=mode == "ragged-draft", **GS_KW)
        kw = {"prompt_lens": lens} if mode == "ragged-draft" else {}
        return np.asarray(sess.generate(ids, **kw).numpy())

    j0, t0 = _gs_counts(jregistry), _gs_counts(tregistry)
    want = run(jm, jd)
    j1 = _gs_counts(jregistry)
    got = run(tm, td)
    t1 = _gs_counts(tregistry)
    np.testing.assert_array_equal(got, want)
    assert [b - a for a, b in zip(t0, t1)] == [b - a for a, b in
                                               zip(j0, j1)]
    assert t1[0] > t0[0]
    np.testing.assert_array_equal(got, run(tm, td, spec=False))


def test_aot_generate_caches_spec_and_plain_sessions_apart(pairs):
    """The speculative config is part of aot_generate's session key: a
    spec session never serves a plain caller of the same shape class."""
    _, tm = pairs["gpt"]
    ids = np.random.RandomState(1).randint(1, 500, (1, 6)).astype(np.int64)
    tm.__dict__.pop("_serving_sessions", None)
    plain = tm.generate(ids, max_new_tokens=5, use_paged_kv=True,
                        kv_block_size=4)
    spec = tm.generate(ids, max_new_tokens=5, use_paged_kv=True,
                       kv_block_size=4, speculative={"num_draft_tokens": 2})
    torch.testing.assert_close(plain, spec, rtol=0, atol=0)
    sessions = list(tm._serving_sessions.values())
    assert len(sessions) == 2
    assert [s._spec is None for s in sessions] == [True, False]


def _sampled_model():
    """The reference's small-vocabulary model of its histogram test."""
    _, tm = make_cb_pair("gpt", seed=21, vocab_size=32, hidden_size=16,
                         num_layers=1, max_seq_len=32)
    return tm


def test_sampled_spec_distribution_matches_spec_off():
    """Shadows test_speculative.py:400: the marginal distribution of the
    first verified token (position 1; position 0 comes from the admit
    identically in both modes) matches the spec-off chunk's, within the
    reference's two-sample chi-square bar. The reference serves its 220
    requests one at a time; here they share 8 slots (each row's token is
    drawn from its own distribution either way)."""
    tm = _sampled_model()
    prompt = np.random.RandomState(5).randint(1, 30, (6,)).astype(np.int64)
    N, V = 220, 32

    def histogram(spec):
        sess = tserving.ContinuousBatchingSession(
            tm, slots=8, max_prompt_len=6, kv_block_size=4, chunk=1,
            do_sample=True, temperature=1.2, speculative=spec)
        for i in range(N):
            sess.submit(tserving.Request(i, prompt, 2))
        counts = np.zeros(V)
        for toks in sess.run().values():
            counts[int(toks[1])] += 1
        return counts

    on = histogram(tspec.SpeculativeConfig(num_draft_tokens=2, seed=3))
    off = histogram(None)
    pool = on + off
    mask = pool > 6
    chi2 = ((on[mask] - off[mask]) ** 2 / pool[mask]).sum()
    assert chi2 < 2.5 * mask.sum(), (chi2, mask.sum(), on, off)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_device_and_host_accept_give_the_same_bytes(pairs, monkeypatch,
                                                    sampled):
    """Shadows test_spec_overlap_v2.py:101 and :296 within the port:
    PADDLE_SPEC_DEVICE_ACCEPT=0 (host accept: the argmax chain and
    greedy_accept, or fold_host over the window's logits and uniforms)
    streams the device fold's bytes; a pinned spec seed replays its
    stream."""
    _, tm = pairs["gpt"]
    prompts = rep_prompts((6, 5, 7), seed=5)
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=4,
              num_blocks=40)
    if sampled:
        kw.update(do_sample=True, temperature=0.4)

    def run(seed=7):
        sess = tserving.ContinuousBatchingSession(
            tm, speculative=tspec.SpeculativeConfig(num_draft_tokens=3,
                                                    seed=seed), **kw)
        for i, p in enumerate(prompts):
            sess.submit(tserving.Request(i, p, 10, seed=i))
        return sess.run(), sess

    dev, sd = run()
    assert sd._spec_accept == "device"
    monkeypatch.setenv("PADDLE_SPEC_DEVICE_ACCEPT", "0")
    host, sh = run()
    assert sh._spec_accept == "host"
    assert_streams(host, dev, "device accept")
    assert sh.stats == sd.stats and sd.stats["spec_proposed_tokens"] > 0
    monkeypatch.delenv("PADDLE_SPEC_DEVICE_ACCEPT")
    again, _ = run()
    assert_streams(again, dev, "the same seed")


def test_draft_engine_recomputes_what_the_reference_leaves_stale(pairs):
    """ROADMAP queue C item 16, on the draft engines themselves (the
    model as its own draft, one row, k = 3). After a fully accepted
    window the committed history holds the third draft, which none of
    the window's three decode steps wrote: the JAX package's engine
    takes the committed length and leaves that position as it was (its
    K there is still the pool's zeros) for the next drafts to attend;
    the port's ingests it first, and drafts what an engine admitted with
    the whole history drafts. The two drafted the same first window."""
    jm, tm = pairs["llama"]
    prompt = np.random.RandomState(2).randint(1, 500, (8,)).astype(np.int64)
    hist = np.concatenate([prompt, [7]])
    runs = {}
    for pkg, model in ((tspec, tm), (jspec, jm)):
        p = pkg.build_proposer(spec_cfg(model, model, num_draft_tokens=3),
                               rows=1, kv_block_size=4, capacity=128)
        p.on_admit([(0, prompt)])
        first = p.propose([(0, hist)], {0: 3})[0]
        # the target accepts all three drafts and emits a bonus token
        hist2 = np.concatenate([hist, first, [11]])
        p.rollback(0, len(hist2) - 1)
        runs[pkg] = (p, first, p.propose([(0, hist2)], {0: 3})[0])
    np.testing.assert_array_equal(runs[tspec][1], runs[jspec][1])
    hist2 = np.concatenate([hist, runs[tspec][1], [11]])
    fresh = tspec.build_proposer(spec_cfg(tm, tm, num_draft_tokens=3),
                                 rows=1, kv_block_size=4, capacity=128)
    fresh.on_admit([(0, hist2[:-1])])
    np.testing.assert_array_equal(runs[tspec][2],
                                  fresh.propose([(0, hist2)], {0: 3})[0])
    engine = runs[jspec][0]._engine
    pos = len(hist) - 1 + 3              # the third draft's position
    block = int(np.asarray(engine._bt_dev)[0, pos // 4])
    assert not np.asarray(engine._kcs[0])[block, :, pos % 4].any()


def test_draft_engine_ingests_externally_committed_tokens(pairs):
    """Shadows test_speculative.py:252: an engine that learns a token
    committed outside a window only through the history it drafts from
    ingests it first (its length counts it) and drafts what an engine
    that saw it at admission drafts."""
    _, tm = pairs["gpt"]
    prompt = np.random.RandomState(1).randint(1, 500, (8,)).astype(np.int64)
    hist = np.concatenate([prompt, [7, 11]])
    drafts = []
    for first in (prompt, np.concatenate([prompt, [7]])):
        p = tspec.build_proposer(spec_cfg(tm, tm, num_draft_tokens=4),
                                 rows=1, kv_block_size=4, capacity=128)
        p.on_admit([(0, first)])
        drafts.append(p.propose([(0, hist)], {0: 4})[0])
        assert int(p._engine.seq[0]) == len(prompt) + 1 + 4
    np.testing.assert_array_equal(drafts[0], drafts[1])


@pytest.mark.parametrize("kwargs,name", [
    ({"overlap": True}, "overlap"), ({"logprobs": True}, "logprobs"),
    ({"kv_tier": True}, "kv_tier"), ({"kv_dtype": "int8"}, "kv_dtype"),
    ({"lora": object()}, "lora")])
def test_spec_with_an_unported_option_raises(pairs, kwargs, name):
    """Speculation beside an option the port lacks raises, naming the
    option and the combination. Beside the options ported since
    (overlap, logprobs, kv_dtype) it serves: the streams of the
    sequential device-accept session (with an int8 pool: of the
    sequential session over the same pool), the overlapped engine
    staging windows, and logprobs accepting on the host with a log p per
    token."""
    _, tm = pairs["gpt"]
    if name in ("overlap", "logprobs", "kv_dtype"):
        prompts = rep_prompts((8, 9, 7, 10), seed=2)
        out, sessions = {}, {}
        seq = dict(kwargs, overlap=False) if name == "kv_dtype" else {
            "overlap": False}
        for opts in (seq, kwargs):
            sess = tserving.ContinuousBatchingSession(
                tm, speculative={"num_draft_tokens": 3},
                **dict(SESS_KW, **opts))
            reqs = [tserving.Request(i, p, 10) for i, p in enumerate(prompts)]
            for r in reqs:
                sess.submit(r)
            out[bool(sessions)] = sess.run()
            sessions[bool(sessions)] = sess
        assert_streams(out[True], out[False], "the sequential session")
        sess = sessions[True]
        if name == "kv_dtype":
            assert sess._kv_quant and sess._kcs[0][0].dtype == torch.int8
            assert sess._spec_accept == "device"
            assert sess.stats["spec_accepted_tokens"] > 0
        elif name == "overlap":
            assert sess._spec_accept == "device" and sess._ov.overlapped > 0
        else:
            assert sess._spec_accept == "host" and not sess._overlap
            for r in reqs:
                lps = np.asarray(r.token_logprobs)
                assert len(lps) == len(r.tokens)
                assert np.isfinite(lps).all() and (lps <= 0).all()
        return
    with pytest.raises(NotImplementedError,
                       match=f"{name}.* with speculative") as e:
        tserving.ContinuousBatchingSession(
            tm, speculative={"num_draft_tokens": 2}, **SESS_KW, **kwargs)
    assert "queue A item 6" in str(e.value)


def test_spec_stats_metrics_and_snapshot(pairs):
    """The spec counters reset through the stats setter; the acceptance
    gauge and the proposer/verify latencies are fed; the scheduler
    snapshot and the memz detail name the speculation and its graphs;
    a tenant corpus learns finished streams with
    PADDLE_SPEC_TENANT_STATS=1."""
    from paddle_tpu_torch.observability.memz import memz_snapshot

    _, tm = pairs["gpt"]
    os.environ["PADDLE_SPEC_TENANT_STATS"] = "1"
    try:
        sess = tserving.ContinuousBatchingSession(
            tm, speculative={"num_draft_tokens": 3}, **SESS_KW)
    finally:
        del os.environ["PADDLE_SPEC_TENANT_STATS"]
    for i, p in enumerate(rep_prompts((8, 9), seed=2)):
        sess.submit(tserving.Request(i, p, 8))
    sess.run()
    st = sess.stats
    assert st["spec_steps"] > 0
    reg = tregistry()
    rate = reg.get("serving_spec_acceptance_rate").value()
    assert rate == pytest.approx(st["spec_accepted_tokens"]
                                 / st["spec_proposed_tokens"])
    assert reg.get("serving_spec_verify_seconds").value()["count"] > 0
    assert sess._proposer.store.stats()["tokens"] > 0
    knobs = sess.scheduler.snapshot()["knobs"]["speculative"]
    assert knobs["proposer"] == "ngram" and knobs["accept"] == "device"
    mine = memz_snapshot()["providers"][f"serving_session_{id(sess):x}"]
    assert mine["detail"]["executables"]["verify_graph_widths"] == []
    sess.stats = {}
    assert sess.stats["spec_steps"] == sess.stats[
        "spec_accepted_tokens"] == 0
