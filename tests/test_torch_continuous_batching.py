"""The port's ContinuousBatchingSession against the JAX package's.

Shadows tests/test_continuous_batching.py (:22, :47, :71, :91, :107) for
GPT and, where the test is not GPT-specific, Llama-GQA: the same tiny
fp32 model in both packages (bridge.load_jax_state), the same requests
(numpy, from a seed), the JAX session on the CPU beside the port's on
device="cpu" (the model's device). Greedy streams must be byte-identical
to the JAX session's and to the JAX package's paged generate of each
prompt (one ragged GenerationSession: its rows are independent), and
``stats`` equal key for key. Also here: every serving option outside
the port raises NotImplementedError naming itself (the overload paths
are held in test_torch_overload.py).

The helpers (make_cb_pair, serve, jax_paged_generate) serve
test_torch_prefix_cache.py and test_torch_serving_observability.py too.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from paddle_tpu_torch.models.gpt import GPTForCausalLM as TGPT
from paddle_tpu_torch.models.llama import LlamaConfig as TLlamaConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as TLlama

FAMILIES = ["gpt", "llama"]

# the reference tests' GPT (vocab 512, E 64, 2 layers, 2 heads), and a
# Llama of the same size with grouped query (4 heads over 2 kv heads)
GPT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
               max_seq_len=128)
LLAMA_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=128, max_seq_len=128)


def make_cb_pair(family="gpt", seed=9, **cfg):
    """(jax model, port model) with identical fp32 weights, on the CPU."""
    paddle.seed(seed)
    if family == "gpt":
        c = dict(GPT_CFG, **cfg)
        jm, tm = JGPT(JGPTConfig(**c)), TGPT(TGPTConfig(**c), device="cpu")
    else:
        c = dict(LLAMA_CFG, **cfg)
        jm = JLlama(JLlamaConfig(**c))
        tm = TLlama(TLlamaConfig(**c), device="cpu")
    jm.eval()
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def session(model, **kw):
    """A ContinuousBatchingSession of the package the model belongs to,
    on the sequential engine (overlap=False) in both packages unless the
    caller says otherwise: the step counts these tests compare are the
    sequential engine's (the overlapped engine, both packages' default,
    spends one more step() a decode run; test_torch_engine_overlap.py
    and test_torch_spec_overlap.py hold the default engines)."""
    kw.setdefault("overlap", False)
    if isinstance(model, torch.nn.Module):
        return tserving.ContinuousBatchingSession(model, **kw)
    return jserving.ContinuousBatchingSession(model, **kw)


def serve(model, requests, sess_kw):
    """Submit ``requests`` [(req_id, prompt, n_new)] to a fresh session of
    the package the model belongs to and run it. Returns (out, session)."""
    pkg = tserving if isinstance(model, torch.nn.Module) else jserving
    sess = session(model, **sess_kw)
    for rid, p, n in requests:
        sess.submit(pkg.Request(rid, p, n))
    return sess.run(), sess


def jax_paged_generate(jm, prompts, n_new, kv_block_size=16):
    """The JAX package's paged generate of every prompt: one ragged
    GenerationSession (prompts right-padded to the longest; each row
    attends only its own blocks). Returns [n_new tokens] per prompt."""
    plen = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), plen), np.int64)
    for r, p in enumerate(prompts):
        ids[r, :len(p)] = p
    lens = np.array([len(p) for p in prompts])
    gen = jserving.GenerationSession(
        jm, batch=len(prompts), prompt_len=plen, max_new_tokens=n_new,
        kv_block_size=kv_block_size, ragged_prompts=True)
    out = np.asarray(gen.generate(ids, prompt_lens=lens).numpy())
    return list(out)


def port_solo(tm, p, n_new, kv_block_size=16):
    """The port's own solo paged generate of one prompt (B=1)."""
    out = tm.generate(p[None, :], max_new_tokens=n_new, use_paged_kv=True,
                      kv_block_size=kv_block_size)
    return out.numpy()[0, len(p):]


def assert_streams(got, want, ids, what):
    for rid in ids:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]),
                                      err_msg=f"request {rid} vs {what}")


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 500, (n,)).astype("int64") for n in lens]


@pytest.mark.parametrize("family", FAMILIES)
def test_cb_matches_solo_greedy_and_jax(family):
    """Shadows test_continuous_batching.py:22: staggered arrivals (five
    requests over three slots) emit, per request, the JAX session's
    tokens and each prompt's paged-generate tokens; stats equal."""
    jm, tm = make_cb_pair(family)
    prompts = _prompts(3, (5, 8, 6, 7, 5))
    reqs = [(i, p, 6) for i, p in enumerate(prompts)]
    kw = dict(slots=3, max_prompt_len=8, kv_block_size=16, chunk=4)
    want, jsess = serve(jm, reqs, kw)
    got, tsess = serve(tm, reqs, kw)
    assert tsess.stats["admit_steps"] >= 2, tsess.stats   # staggered waves
    assert tsess.stats == jsess.stats
    assert_streams(got, want, range(5), "the JAX session")
    paged = jax_paged_generate(jm, prompts, 6)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], paged[i],
                                      err_msg=f"request {i} vs JAX generate")
        np.testing.assert_array_equal(got[i], port_solo(tm, p, 6),
                                      err_msg=f"request {i} vs port solo")
    tsess._pool.assert_quiescent()


@pytest.mark.parametrize("family", FAMILIES)
def test_cb_eos_frees_slot_early_equals_jax(family):
    """Shadows test_continuous_batching.py:47: a request stops at its
    first eos (inclusive) and the next request takes the freed slot."""
    jm, tm = make_cb_pair(family, seed=4)
    rs = np.random.RandomState(5)
    p0 = rs.randint(1, 500, (6,)).astype("int64")
    p1 = rs.randint(1, 500, (5,)).astype("int64")
    probe, _ = serve(tm, [("probe", p0, 4)],
                     dict(slots=1, max_prompt_len=8, kv_block_size=16,
                          chunk=2))
    toks = list(probe["probe"])
    eos = int(toks[1])
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2,
              eos_token_id=eos)
    reqs = [("a", p0, 10), ("b", p1, 3)]
    want, jsess = serve(jm, reqs, kw)
    got, tsess = serve(tm, reqs, kw)
    first = toks.index(eos)
    assert list(got["a"]) == toks[:first + 1]
    assert len(got["b"]) == 3
    assert_streams(got, want, ("a", "b"), "the JAX session")
    assert tsess.stats == jsess.stats


def test_cb_weight_updates_visible_equal_jax():
    """Shadows test_continuous_batching.py:71: a weight written between
    runs changes the served tokens (position 5's embedding steered to
    token 7's tied row), in both packages alike."""
    jm, tm = make_cb_pair("gpt", seed=6)
    p = np.random.RandomState(6).randint(1, 500, (6,)).astype("int64")
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2)
    jsess, tsess = session(jm, **kw), session(tm, **kw)
    outs = {}
    for name, sess, pkg in (("jax", jsess, jserving),
                            ("port", tsess, tserving)):
        sess.submit(pkg.Request(0, p, 4))
        outs[name] = [sess.run()[0]]
    wpe = jm.gpt.wpe.weight
    wpe._value = wpe._value.at[5].set(100.0 * jm.gpt.wte.weight._value[7])
    with torch.no_grad():
        tm.gpt.wpe.weight[5] = 100.0 * tm.gpt.wte.weight[7]
    for name, sess, pkg in (("jax", jsess, jserving),
                            ("port", tsess, tserving)):
        sess.submit(pkg.Request(1, p, 4))
        outs[name].append(sess.run()[1])
    out1, out2 = outs["port"]
    assert int(out2[0]) == 7
    assert list(out1) != list(out2)
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    assert tsess.stats == jsess.stats


def test_cb_weight_rebound_mid_decode_equals_jax():
    """Shadows test_continuous_batching.py:71 for a weight replaced (a
    new tensor, ``param.data = ...``) between two decode chunks of a
    running request with nothing queued: the next chunk reads the new
    weight, as the JAX session's next dispatch does. The decode-chunk
    program is rebuilt once for it (on a card: re-captured, since the
    graph reads weights by address) and not for chunks around it."""
    jm, tm = make_cb_pair("gpt", seed=6)
    p = np.random.RandomState(8).randint(1, 500, (6,)).astype("int64")
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2)
    outs, progs = {}, []
    for name, model, pkg in (("jax", jm, jserving), ("port", tm, tserving)):
        sess = session(model, **kw)
        sess.submit(pkg.Request(0, p, 9))
        assert sess.step() and sess.step()   # the admit, one chunk
        assert not sess._queue
        if name == "port":
            progs.append(sess._chunk_prog)
            assert sess.step()               # nothing moved: no rebuild
            progs.append(sess._chunk_prog)
            w = tm.gpt.wpe.weight
            new = w.detach().clone()
            new[8:12] = 100.0 * tm.gpt.wte.weight.detach()[7]
            w.data = new
        else:
            assert sess.step()
            wpe = jm.gpt.wpe.weight
            wpe._value = wpe._value.at[8:12].set(
                100.0 * jm.gpt.wte.weight._value[7])
        outs[name] = sess.run()[0]
        if name == "port":
            progs.append(sess._chunk_prog)
    assert progs[0] is progs[1] and progs[2] is not progs[1]
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    # the first chunk after the swap (fed at positions 10 and 11) reads
    # the steered rows; the tokens before it do not
    assert 7 not in outs["port"][:5] and list(outs["port"][5:]) == [7] * 4


def test_cb_submit_validation_equals_jax():
    """Shadows test_continuous_batching.py:91: the same requests are
    refused with the same typed error and message."""
    jm, tm = make_cb_pair("gpt", seed=7)
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2)
    jsess, tsess = session(jm, **kw), session(tm, **kw)
    cases = [(np.zeros((0,), np.int64), 4, "prompt length"),
             (np.zeros((9,), np.int64), 4, "prompt length"),
             (np.zeros((4,), np.int64), 0, "max_new_tokens"),
             (np.zeros((8,), np.int64), 125, "max_seq_len")]
    for prompt, n, match in cases:
        msgs = []
        for sess, pkg in ((jsess, jserving), (tsess, tserving)):
            with pytest.raises(ValueError, match=match) as e:
                sess.submit(pkg.Request(0, prompt, n))
            assert type(e.value).__name__ == "InvalidRequest"
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # a request whose KV footprint exceeds the whole pool
    small = tserving.ContinuousBatchingSession(tm, num_blocks=1, **kw)
    with pytest.raises(tserving.InvalidRequest, match="KV blocks"):
        small.submit(tserving.Request(0, np.ones((8,), np.int64), 16))


@pytest.mark.parametrize("family", FAMILIES)
def test_cb_manual_steps_then_run_returns_all_completed(family):
    """Shadows test_continuous_batching.py:107: requests completed during
    manual step() calls appear in the next run(), with the JAX session's
    tokens."""
    jm, tm = make_cb_pair(family, seed=8)
    p = np.random.RandomState(8).randint(1, 500, (5,)).astype("int64")
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, **kw)
        sess.submit(pkg.Request("a", p, 3))
        steps = 0
        while any(s.req is not None for s in sess._slots) or sess._queue:
            sess.step()                      # drain manually
            steps += 1
        sess.submit(pkg.Request("b", p, 3))
        res[pkg] = (sess.run(), steps, sess.stats)
    got, steps, stats = res[tserving]
    assert set(got) == {"a", "b"}
    assert len(got["a"]) == 3 and len(got["b"]) == 3
    want, jsteps, jstats = res[jserving]
    assert_streams(got, want, ("a", "b"), "the JAX session")
    assert steps == jsteps and stats == jstats


# the ids are the ones these cases had when the list also held the
# options since ported (prefill_chunk, kv_pool_bytes, preempt,
# priority, deadline_s); logprobs and overlap are ported now and their
# cases serve through the option
PORTED = ("logprobs", "overlap")


@pytest.mark.parametrize("kwargs,name", [
    # speculation itself is ported: beside an unported option it raises,
    # naming the option "with speculative"
    pytest.param({"speculative": {"num_draft_tokens": 2}, "kv_tier": True},
                 "kv_tier", id="kwargs0-speculative"),
    pytest.param({"lora": object()}, "lora", id="kwargs2-lora"),
    pytest.param({"quantize_weights": "int8"}, "quantize_weights",
                 id="kwargs3-quantize_weights"),
    pytest.param({"kv_dtype": "int8"}, "kv_dtype", id="kwargs4-kv_dtype"),
    pytest.param({"kv_tier": True}, "kv_tier", id="kwargs6-kv_tier"),
    pytest.param({"logprobs": True}, "logprobs", id="kwargs7-logprobs"),
    pytest.param({"overlap": True}, "overlap", id="kwargs8-overlap"),
])
def test_unported_options_raise(kwargs, name):
    """Every option outside the slice raises NotImplementedError naming
    itself (and ROADMAP queue A item 6): none is quietly ignored. The
    options ported since (``PORTED``) serve a request instead: the
    stream of the session without them, with a finite log p <= 0 per
    token under logprobs=True, and steps of the overlapped engine under
    overlap=True."""
    _, tm = make_cb_pair("gpt", seed=3)
    kw = dict(slots=1, max_prompt_len=8, kv_block_size=16, chunk=2)
    if name in PORTED:
        prompt = np.arange(3, 9)
        out = {}
        for opts in ({}, kwargs):
            sess = tserving.ContinuousBatchingSession(
                tm, **dict(dict(overlap=False), **opts), **kw)
            req = tserving.Request(0, prompt, 5)
            sess.submit(req)
            out[bool(opts)] = sess.run()[0]
        np.testing.assert_array_equal(out[True], out[False])
        if name == "logprobs":
            lps = np.asarray(req.token_logprobs)
            assert len(lps) == 5 and np.isfinite(lps).all()
            assert (lps <= 0).all() and not sess._overlap
        else:
            assert sess._overlap and sess._ov.overlapped > 0
        return
    with pytest.raises(NotImplementedError, match=name) as e:
        tserving.ContinuousBatchingSession(tm, **kwargs, **kw)
    assert "queue A item 6" in str(e.value)
    # the off values of the same knobs are accepted
    tserving.ContinuousBatchingSession(
        tm, overlap=False, logprobs=False, kv_tier=False, kv_dtype="none",
        quantize_weights=None, **kw)
