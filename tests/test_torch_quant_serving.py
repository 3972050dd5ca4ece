"""The port's quantized serving against the JAX package's: int8 / int4
weight-only backbones and int8 paged-KV pools through GenerationSession,
aot_generate and ContinuousBatchingSession.

Shadows tests/test_quant_serving.py :190 (greedy identity), :208
(continuous batching), :222 (pool geometry and scheduler knobs), :306
(block bytes across sessions), :326 (prefix hit, copy-on-write and
preemption) and :449 (overlap on and off with a forced preemption),
tests/test_spec_overlap_v2.py::test_quantized_base_overlap_identity and
tests/test_zzdisagg.py::test_memz_int8_quant_accounting. The models are
the reference file's tiny GPT and Llama-GQA (MQA, 2:1), fp32, with the
JAX models' weights (bridge.load_jax_state), and its corpora. Greedy
streams equal the JAX sessions'; the port's quantized session equals the
port's unquantized session serving the dequantized image byte for byte.
Quantized KV blocks are read from the pool through a request's blocks
(the port has no export_kv_blocks, ROADMAP queue A item 8). As in the
reference file, only the Llama-GQA twin of the block-bytes test is slow.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional.paged_kv import \
    kv_block_bytes as jkv_block_bytes
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.incubate.nn.functional.paged_kv import kv_block_bytes
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import GPTForCausalLM as TGPT
from paddle_tpu_torch.models.llama import LlamaConfig as TLlamaConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as TLlama
from paddle_tpu_torch.quantization import dequantize_weight

from test_torch_engine_overlap import Drive, assert_streams, hold_to_jax

Q8 = dict(quantize_weights="int8", kv_dtype="int8")
GPT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
               max_seq_len=64)
LLAMA_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
                 num_kv_heads=1, max_seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Free this file's sessions (reference cycles holding memz
    providers) before the next file in the process runs."""
    yield
    gc.collect()


def make_pair(kind="gpt", seed=9):
    """(jax model, port model): the reference file's _gpt / _llama,
    identical fp32 weights, on the CPU."""
    paddle.seed(seed)
    if kind == "gpt":
        jm, tm = JGPT(JGPTConfig(**GPT_CFG)), TGPT(TGPTConfig(**GPT_CFG),
                                                  device="cpu")
    else:
        jm = JLlama(JLlamaConfig(**LLAMA_CFG))
        tm = TLlama(TLlamaConfig(**LLAMA_CFG), device="cpu")
    jm.eval()
    tm.eval()
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {kind: make_pair(kind) for kind in ("gpt", "llama-gqa")}


def prompts_of(n, seed=7, lo=9, hi=17, vocab=500):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, (int(rs.randint(lo, hi)),))
            .astype(np.int64) for _ in range(n)]


def dequantized_image(model, sess):
    """A copy of ``model`` whose quantized Linear weights are
    dequantize_weight of ``sess``'s own payloads (the reference's
    function), set before any session of it is built."""
    import copy

    img = copy.deepcopy(model)
    wq = sess._wq
    params = dict(img.named_parameters())
    with torch.no_grad():
        for n, (q, s) in wq.qvals.items():
            rows, dtype = wq.meta[n]
            params[n].copy_(dequantize_weight(q, s, dtype, rows=rows,
                                              group_size=64))
    return img


def pool_blocks(sess, req):
    """{layer: (k payload, k scales, v payload, v scales)} of the blocks
    holding ``req``'s full prompt blocks, read from the pool through the
    registry's hashes (the request keeps their truncated hex)."""
    by_hex = {h.hex()[:16]: b for h, b in sess._pool.cached.items()}
    ids = [by_hex[h] for h in req.block_hashes]
    return [tuple(t[ids].clone() for t in (kc[0], kc[1], vc[0], vc[1]))
            for kc, vc in zip(sess._kcs, sess._vcs)]


def assert_blocks_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la[0].dtype == torch.int8 and la[1].dtype == torch.float32
        for ta, tb in zip(la, lb):
            assert torch.equal(ta, tb)


# ---------------------------------------------------------------------------
# greedy identity: GenerationSession, aot_generate, continuous batching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gpt", "llama-gqa"])
def test_generation_greedy_identity_equals_jax(pairs, kind):
    """Shadows test_quant_serving.py:190: on the reference's decisive
    corpus, GenerationSession with int8 and int4 weights over an int8
    pool streams the JAX quantized sessions' bytes, which are the
    unquantized session's; aot_generate serves the same."""
    jm, tm = pairs[kind]
    ids = np.random.RandomState(8).randint(1, 500, (2, 8)).astype(np.int64)
    kw = dict(batch=2, prompt_len=8, max_new_tokens=8, kv_block_size=4)
    ref = tserving.GenerationSession(tm, **kw).generate(ids).numpy()
    np.testing.assert_array_equal(
        ref, np.asarray(jserving.GenerationSession(jm, **kw)
                        .generate(paddle.to_tensor(ids)).numpy()))
    for weights in ("int8", "int4"):
        got = tserving.GenerationSession(
            tm, quantize_weights=weights, kv_dtype="int8",
            **kw).generate(ids).numpy()
        want = np.asarray(jserving.GenerationSession(
            jm, quantize_weights=weights, kv_dtype="int8",
            **kw).generate(paddle.to_tensor(ids)).numpy())
        np.testing.assert_array_equal(got, want, err_msg=weights)
        np.testing.assert_array_equal(got, ref, err_msg=weights)
        out = tserving.aot_generate(tm, ids, 8, kv_block_size=4,
                                    quantize_weights=weights,
                                    kv_dtype="int8").numpy()
        np.testing.assert_array_equal(out, got, err_msg=weights)
    keys = [k for k in tm._serving_sessions if k[-1] == "int8"]
    assert sorted(k[-2] for k in keys) == ["int4", "int8"]


def test_generation_shared_prefix_and_speculation_on_q8(pairs):
    """A batch-repeated prompt (one prefill, copy-on-write of the tail
    block's payload and scales) and speculation over int8 pools stream
    what the plain quantized session streams, row by row."""
    _, tm = pairs["gpt"]
    p = np.random.RandomState(8).randint(1, 500, (10,)).astype(np.int64)
    rep = np.stack([p, p])
    kw = dict(batch=2, prompt_len=10, max_new_tokens=8, kv_block_size=4,
              **Q8)
    shared = tserving.GenerationSession(tm, **kw).generate(rep).numpy()
    alone = tserving.GenerationSession(tm, prefix_sharing=False,
                                       **kw).generate(rep).numpy()
    np.testing.assert_array_equal(shared, alone)
    spec = tserving.GenerationSession(
        tm, speculative={"num_draft_tokens": 3}, **kw).generate(rep)
    np.testing.assert_array_equal(spec.numpy(), alone)


def test_continuous_batching_greedy_identity_equals_jax(pairs):
    """Shadows test_quant_serving.py:208: a Q8 ContinuousBatchingSession
    (both default engines) streams the JAX Q8 session's bytes with equal
    step counts, staged steps and stats; the port's sequential engine
    streams the same, and so does the unquantized session."""
    prompts = prompts_of(5)

    def scenario(d):
        for i, p in enumerate(prompts):
            d.submit(i, p, 6)
        d.run()

    kw = dict(slots=3, max_prompt_len=16, kv_block_size=8, chunk=4,
              num_blocks=48)
    td = hold_to_jax(pairs["gpt"], scenario, **kw, **Q8)
    ref = Drive(pairs["gpt"][1], **kw)
    scenario(ref)
    assert_streams(td.out, ref.out, "the unquantized session")
    assert td.sess._kcs[0][0].dtype == torch.int8
    assert not isinstance(ref.sess._kcs[0], tuple)     # plain tensors


@pytest.mark.parametrize("weights", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["gpt", "llama-gqa"])
def test_quantized_session_equals_the_dequantized_image(pairs, kind,
                                                        weights):
    """The port's quantized session against the port's unquantized
    session over an int8 pool, serving a model whose quantized weights
    were replaced by dequantize_weight of the first session's payloads:
    byte-equal streams (the in-program dequantization is exactly the
    reference's function), and the model's parameters keep their
    addresses and versions."""
    _, tm = pairs[kind]
    before = [(p.data_ptr(), p._version) for p in tm.parameters()]
    prompts = prompts_of(4, seed=3)
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=4,
              num_blocks=32)
    out = {}
    q = tserving.ContinuousBatchingSession(tm, quantize_weights=weights,
                                           kv_dtype="int8", **kw)
    img = dequantized_image(tm, q)
    for name, (model, opts) in {
            "quant": (tm, dict(quantize_weights=weights, kv_dtype="int8")),
            "image": (img, dict(kv_dtype="int8"))}.items():
        sess = q if name == "quant" else \
            tserving.ContinuousBatchingSession(model, **kw, **opts)
        for i, p in enumerate(prompts):
            sess.submit(tserving.Request(i, p, 6))
        out[name] = sess.run()
    assert_streams(out["quant"], out["image"], "the dequantized image")
    assert [(p.data_ptr(), p._version) for p in tm.parameters()] == before
    assert not any("forward" in m.__dict__ for m in tm.modules())


# ---------------------------------------------------------------------------
# pool geometry, scheduler knobs, memz
# ---------------------------------------------------------------------------

def test_kv_pool_bytes_geometry_and_scheduler_knobs_equal_jax(pairs):
    """Shadows test_quant_serving.py:222: int8 block bytes equal the JAX
    package's (at least 1.9 blocks per fp32 block), the same byte budget
    gives the same num_blocks, the scheduler snapshot's knobs carry the
    quantized geometry, and one admit pass references more blocks than
    the whole bf16 pool holds, as in the JAX session."""
    jm, tm = pairs["gpt"]
    bb, bbq = kv_block_bytes(2, 2, 8, 32), kv_block_bytes(
        2, 2, 8, 32, kv_dtype="int8")
    assert (bb, bbq) == (jkv_block_bytes(2, 2, 8, 32),
                         jkv_block_bytes(2, 2, 8, 32, kv_dtype="int8"))
    assert bb / bbq >= 1.9
    kw = dict(slots=8, max_prompt_len=16, kv_block_size=8, chunk=4,
              kv_pool_bytes=10 * bb)
    occ = {}
    for pkg, m in ((jserving, jm), (tserving, tm)):
        bf = pkg.ContinuousBatchingSession(m, **kw)
        qs = pkg.ContinuousBatchingSession(m, **kw, **Q8)
        assert bf._num_blocks == 10
        assert qs._num_blocks == 10 * bb // bbq >= 19
        knobs = {k: qs.scheduler.snapshot()["knobs"][k] for k in (
            "kv_dtype", "quantize_weights", "kv_pool_bytes", "num_blocks")}
        assert knobs == {"kv_dtype": "int8", "quantize_weights": "int8",
                         "kv_pool_bytes": qs._num_blocks * bbq,
                         "num_blocks": qs._num_blocks}
        for i, p in enumerate(prompts_of(6, lo=16, hi=17)):
            qs.submit(pkg.Request(f"g{i}", p, 8))
        qs.step()
        occ[pkg] = qs._pool.occupancy()
        assert occ[pkg]["referenced"] > bf._num_blocks
    assert occ[tserving] == occ[jserving]


def test_memz_int8_quant_accounting_equals_jax(pairs):
    """Shadows test_zzdisagg.py::test_memz_int8_quant_accounting: a Q8
    session reports payload + scale bytes below the unquantized image, a
    smaller pool, kv_dtype int8, totals that reconcile with the session's
    own accounting, and the JAX session's fields, one for one."""
    from paddle_tpu.observability.memz import memz_snapshot as jsnap
    from paddle_tpu_torch.observability import memz_snapshot as tsnap

    kw = dict(slots=4, max_prompt_len=16, kv_block_size=8, chunk=2,
              num_blocks=48)
    got = {}
    for pkg, m, snap in ((jserving, pairs["gpt"][0], jsnap),
                         (tserving, pairs["gpt"][1], tsnap)):
        bf = pkg.ContinuousBatchingSession(m, **kw)
        q8 = pkg.ContinuousBatchingSession(m, **kw, **Q8)
        s = snap()
        b = s["providers"][f"serving_session_{id(bf):x}"]
        q = s["providers"][f"serving_session_{id(q8):x}"]
        assert b["detail"]["weights"]["quant_mode"] is None
        assert q["detail"]["weights"]["quant_mode"] == "int8"
        assert q["detail"]["weights"]["quant_bytes"] > 0
        assert q["components"]["weights"] < b["components"]["weights"]
        assert q["components"]["kv_pool"] < b["components"]["kv_pool"]
        assert q["detail"]["kv_pool"]["kv_dtype"] == "int8"
        for sess, entry in ((bf, b), (q8, q)):
            assert entry["components"]["weights"] == sess._weights_bytes()[0]
            assert entry["components"]["kv_pool"] == int(sess._kv_pool_bytes)
        got[pkg] = [(e["components"]["weights"], e["components"]["kv_pool"],
                     e["detail"]["weights"], e["detail"]["kv_pool"]
                     ["num_blocks"]) for e in (b, q)]
        del bf, q8
        gc.collect()
    assert got[tserving] == got[jserving]


# ---------------------------------------------------------------------------
# quantized-block byte equality: sessions, prefix hits, CoW, preemption
# ---------------------------------------------------------------------------

def _sess(model, **kw):
    base = dict(slots=4, max_prompt_len=16, kv_block_size=8, chunk=2,
                num_blocks=48)
    base.update(kw)
    return tserving.ContinuousBatchingSession(model, **base, **Q8)


def _run_one(sess, rid, prompt, max_new=6):
    req = tserving.Request(rid, np.asarray(prompt, np.int64), max_new)
    sess.submit(req)
    while sess.step():
        pass
    return req


@pytest.mark.parametrize("kind", [
    "gpt", pytest.param("llama-gqa", marks=pytest.mark.slow)])
def test_quant_block_bytes_deterministic_across_sessions(pairs, kind):
    """Shadows test_quant_serving.py:306: identical content gives
    identical (payload, scale) bytes in two sessions, read from each
    pool through the request's blocks."""
    _, tm = pairs[kind]
    prompt = prompts_of(1, seed=11, lo=16, hi=17)[0]
    reqs, blocks = [], []
    for tag in ("a", "b"):
        s = _sess(tm)
        req = _run_one(s, tag, prompt)
        reqs.append(req)
        blocks.append(pool_blocks(s, req))
    assert reqs[0].block_hashes == reqs[1].block_hashes
    assert len(reqs[0].block_hashes) == 2
    assert_blocks_equal(blocks[0], blocks[1])
    assert any(bool(b[1].any()) for b in blocks[0])     # scales written


def test_prefix_hit_cow_preempt_byte_equality(pairs):
    """Shadows test_quant_serving.py:326: a prefix hit on quantized
    blocks, a copy-on-write fork off a shared prefix and a preempt +
    regenerate all stream the cold-run bytes, and the shared head
    blocks' payloads and scales are unchanged by any of it."""
    _, tm = pairs["gpt"]
    rs = np.random.RandomState(17)
    head = rs.randint(1, 500, (16,)).astype(np.int64)   # 2 full blocks
    ext_a = np.concatenate([head, rs.randint(1, 500, (5,)).astype(np.int64)])
    ext_b = np.concatenate([head, rs.randint(1, 500, (4,)).astype(np.int64)])
    cold = _sess(tm, max_prompt_len=24, prefix_cache=False)
    ref = {rid: [int(t) for t in _run_one(cold, rid, p).tokens]
           for rid, p in (("head", head), ("ext-a", ext_a), ("ext-b", ext_b))}
    sess = _sess(tm, max_prompt_len=24)
    warm = _run_one(sess, "head", head)
    assert [int(t) for t in warm.tokens] == ref["head"]
    before = pool_blocks(sess, warm)
    ra = tserving.Request("ext-a", ext_a.copy(), 6)
    rb = tserving.Request("ext-b", ext_b.copy(), 6)
    sess.submit(ra)
    sess.submit(rb)
    for _ in range(3):
        sess.step()
    sess.preempt("ext-a")
    while sess.step():
        pass
    assert ra.prefix_hit_tokens > 0 and rb.prefix_hit_tokens > 0
    assert [int(t) for t in ra.tokens] == ref["ext-a"]
    assert [int(t) for t in rb.tokens] == ref["ext-b"]
    assert sess.stats["preemptions"] == 1
    assert_blocks_equal(before, pool_blocks(sess, warm))
    # a full hit: the final shared block is copied, scales with it
    full = _run_one(sess, "full", head)
    assert full.prefix_hit_tokens == 15 and sess.stats["prefix_cow"] >= 1
    assert [int(t) for t in full.tokens] == ref["head"]


def test_overlap_identity_with_forced_preemption_equals_jax(pairs):
    """Shadows test_quant_serving.py:449: a staggered storm with a
    forced preemption on Q8 sessions: the overlapped and sequential
    engines stream the same bytes, which are the JAX session's, with
    equal steps, staged steps and stats. (12 new tokens a request where
    the reference asks 6: at 6 both packages' requests have finished by
    the preempt() after the third step, and nothing is preempted.)"""
    prompts = prompts_of(5, seed=23)

    def storm(d):
        for i, p in enumerate(prompts):
            d.submit(i, p, 12)
        d.step(3)
        d.sess.preempt()
        d.run()

    td = hold_to_jax(make_pair("gpt", seed=5), storm, slots=2, max_prompt_len=16,
                     kv_block_size=8, chunk=4, num_blocks=32, **Q8)
    assert td.sess._ov.overlapped > 0
    assert td.sess.stats["preemptions"] == 1


# ---------------------------------------------------------------------------
# speculation, logprobs, weight updates
# ---------------------------------------------------------------------------

def _rep_prompts(n_list, seed=9, vocab=500):
    rs = np.random.RandomState(seed)
    return [np.tile(rs.randint(1, vocab, (n,)).astype(np.int64), 3)[:16]
            for n in n_list]


def test_ngram_speculation_on_q8_overlap_identity():
    """Shadows test_spec_overlap_v2.py:147: n-gram windows verified over
    the quantized base with the acceptance folded on the card: the
    overlapped engine (staging windows) streams the sequential
    device-accept session's bytes, and windows ran."""
    _, tm = make_pair("gpt", seed=15)
    prompts = _rep_prompts((5, 7, 6))
    out = {}
    for overlap in (False, True):
        sess = tserving.ContinuousBatchingSession(
            tm, slots=2, max_prompt_len=16, kv_block_size=8, chunk=4,
            num_blocks=40, overlap=overlap,
            speculative=tspec.SpeculativeConfig(num_draft_tokens=3), **Q8)
        assert sess._spec_accept == "device"
        for i, p in enumerate(prompts):
            sess.submit(tserving.Request(i, p.copy(), 10))
        out[overlap] = sess.run()
        assert sess.stats["spec_steps"] > 0
    assert_streams(out[True], out[False], "the sequential session")
    assert sess._ov.overlapped > 0


@pytest.mark.parametrize("spec", [False, True])
def test_logprobs_on_q8(pairs, spec):
    """logprobs=True over a quantized session (with speculation, host
    accept): the device sampler's streams and a finite log p <= 0 for
    every token."""
    _, tm = pairs["gpt"]
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=4,
              num_blocks=40, **Q8)
    if spec:
        kw["speculative"] = {"num_draft_tokens": 3}
    prompts = _rep_prompts((5, 6, 4))
    out, reqs = {}, {}
    for lp in (False, True):
        sess = tserving.ContinuousBatchingSession(tm, logprobs=lp, **kw)
        reqs[lp] = [tserving.Request(i, p, 7) for i, p in enumerate(prompts)]
        for r in reqs[lp]:
            sess.submit(r)
        out[lp] = sess.run()
    assert_streams(out[True], out[False], "the device sampler")
    for r in reqs[True]:
        lps = np.asarray(r.token_logprobs)
        assert len(lps) == len(r.tokens) == 7
        assert np.isfinite(lps).all() and (lps <= 0).all()


def test_weight_update_requantized_at_admission_and_flushes_cache():
    """A weight written in place between requests: the next admission
    flushes the prefix cache and re-quantizes it into the same payload
    buffer, and the stream is a fresh quantized session's over the
    updated model. The JAX session does the same at the same point
    (_admission_seed)."""
    _, tm = make_pair("gpt", seed=4)
    prompt = prompts_of(1, seed=5, lo=16, hi=17)[0]
    sess = _sess(tm)
    first = _run_one(sess, "a", prompt)
    name = "gpt.blocks.0.mlp.fc1.weight"
    payload = sess._wq.qvals[name][0]
    addr, old = payload.data_ptr(), payload.clone()
    with torch.no_grad():
        dict(tm.named_parameters())[name].mul_(-1.5)
    again = _run_one(sess, "b", prompt)
    assert again.prefix_hit_tokens == 0          # flushed: no hit
    assert payload.data_ptr() == addr and not torch.equal(payload, old)
    fresh = _run_one(_sess(tm), "c", prompt)
    assert again.tokens == fresh.tokens
    assert first.prefix_hit_tokens == 0
