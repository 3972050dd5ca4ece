"""The models' default generate() in the port against the JAX package's.

Shadows tests/test_paged_kv.py :36 and :56 (a dense prefill and one-token
decode steps against one causal pass; here against the JAX package's
dense-cache forward and the port's paged one), :84 (greedy paged equals
dense equals cache-free), :203 (``max_new_tokens=0`` returns the prompt),
tests/test_llama.py :193 (the cached greedy Llama stream, kv heads 2)
and :215 (eos padding, early stop, sampling), and tests/test_models.py
:136 (GPT's cached and cache-free streams, sampling and eos options):
the same tiny fp32 models in both packages (bridge.load_jax_state), the
same prompts (numpy, from a seed). Greedy streams of the dense cache
(the default), of ``use_cache=False`` (GPT) and of the eager paged loop
(``use_paged_kv=True, aot=False``) must equal the JAX package's dense
stream and the port's AOT paged stream byte for byte, at kv heads 2 and
1 for Llama. Sampled streams are the port's own draws (Philox, not the
JAX package's threefry): checked for shape and eos, and equal across
calls with one seed.

Also the dense decode step's route: one query row against the cache
(Sq = 1 < Sk) reaches the native-layout flash forward K4 (its plain
version here on the CPU), for MHA and for TinyLlama's 32:4 grouped
query, where the JAX package's TPU gates send it to its dense ``_sdpa``
(a documented route difference, ROADMAP queue C). Hidden states are
compared at fp32 tolerance 1e-4, as in tests/test_torch_models.py.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import flash_attention as jfa
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.incubate.nn.functional import fused_ops
from paddle_tpu_torch.incubate.nn.functional.paged_kv import (
    PagedCache, alloc_block_tables, init_block_cache)
from paddle_tpu_torch.inference.serving import get_model_adapter
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattention
from paddle_tpu_torch.nn.functional import norm

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["gpt", "llama-kv2", "llama-kv1"]


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Sessions are reference cycles whose memz and flight-recorder
    providers stay registered until the collector frees them: free this
    file's before the next file in the process runs."""
    yield
    gc.collect()


def make_pair(name, seed=9):
    """(jax model, port model) of gpt_tiny / llama_tiny (kv heads 2 or
    1) with identical fp32 weights, on the CPU."""
    paddle.seed(seed)
    if name == "gpt":
        jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny())
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    else:
        kvh = int(name[-1])
        jm = jllama.LlamaForCausalLM(jllama.llama_tiny(num_kv_heads=kvh))
        tm = tllama.LlamaForCausalLM(tllama.llama_tiny(num_kv_heads=kvh),
                                     device="cpu")
    jm.eval()
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(seed, b, s):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(
        "int64")


def _jax_generate(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


@pytest.mark.parametrize("name", MODELS)
def test_dense_cache_forward_matches_jax_and_paged(name):
    """Shadows test_paged_kv.py:36 and :56: a dense-cache prefill of 11
    tokens (B=2) and three one-token steps give the JAX package's
    dense-cache hidden states and caches, and the port's paged forward's
    hidden states."""
    jm, tm = make_pair(name)
    jb = jm.gpt if name == "gpt" else jm.llama
    tb = tm.gpt if name == "gpt" else tm.llama
    L = tm.cfg.num_layers
    ids = _ids(1, 2, 14)
    jc, tc = [(None, None)] * L, [(None, None)] * L
    ad = get_model_adapter(tm)
    bt, nb = alloc_block_tables(2, tm.cfg.max_seq_len, 4, device="cpu")
    pc = [PagedCache(*init_block_cache(nb, ad.kv_heads, 4, ad.head_dim,
                                       device="cpu"), bt,
                     torch.zeros(2, dtype=torch.int32))
          for _ in range(L)]
    with torch.inference_mode():
        for lo, hi in ((0, 11), (11, 12), (12, 13), (13, 14)):
            jh, jc = jb(paddle.to_tensor(ids[:, lo:hi]), caches=jc,
                        pos_offset=lo)
            th, tc = tb(torch.tensor(ids[:, lo:hi]), caches=tc,
                        pos_offset=lo)
            ph, pc = tb(torch.tensor(ids[:, lo:hi]), caches=pc,
                        pos_offset=pc[0].seq_lens)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh.numpy()),
                                       **TOL)
            np.testing.assert_allclose(th.numpy(), ph.numpy(), **TOL)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        assert tuple(tk.shape) == tuple(jk.shape)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk.numpy()), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_greedy_streams_of_every_path_equal_jax(name):
    """Shadows test_paged_kv.py:84, test_llama.py:193 and
    test_models.py:136: the default dense generate, the eager paged loop,
    the AOT paged session and (GPT) use_cache=False give the JAX
    package's dense greedy stream byte for byte; GPT at a ragged prompt
    length of 77 (B=2), Llama at 12 (B=2)."""
    jm, tm = make_pair(name)
    ids = _ids(2, 2, 77 if name == "gpt" else 12)
    want = _jax_generate(jm, ids, max_new_tokens=8)
    assert want.shape == (2, ids.shape[1] + 8)
    paths = {"dense": {}, "paged eager": dict(use_paged_kv=True, aot=False,
                                              kv_block_size=8),
             "paged aot": dict(use_paged_kv=True, kv_block_size=8)}
    if name == "gpt":
        paths["no cache"] = dict(use_cache=False)
    for path, kw in paths.items():
        got = tm.generate(ids, max_new_tokens=8, **kw)
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


@pytest.mark.parametrize("name", ["gpt", "llama-kv2"])
def test_eos_padding_zero_and_clamped_lengths_equal_jax(name):
    """Shadows test_llama.py:215 and test_paged_kv.py:203: with an eos
    that row 0 emits at its second step, rows keep emitting eos once they
    have and the loop stops when every row has (the JAX package's
    output, shape included, dense and eager paged); max_new_tokens=0
    returns the prompt; a prompt 4 short of max_seq_len gets 4 tokens."""
    jm, tm = make_pair(name, seed=10)
    ids = _ids(10, 2, 6)
    greedy = _jax_generate(jm, ids, max_new_tokens=6)
    eos = int(greedy[0, 7])
    want = _jax_generate(jm, ids, max_new_tokens=6, eos_token_id=eos)
    for kw in ({}, dict(use_paged_kv=True, aot=False, kv_block_size=8)):
        got = tm.generate(ids, max_new_tokens=6, eos_token_id=eos, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    row = list(want[0, 6:])
    assert all(t == eos for t in row[row.index(eos):])
    zero = tm.generate(ids, max_new_tokens=0)
    np.testing.assert_array_equal(zero.numpy(), ids)
    long_ids = _ids(11, 1, tm.cfg.max_seq_len - 4)
    got = tm.generate(long_ids, max_new_tokens=10)
    want = _jax_generate(jm, long_ids, max_new_tokens=10)
    assert got.shape == (1, tm.cfg.max_seq_len)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gpt", "llama-kv2"])
def test_sampled_generate_shape_eos_and_seed(name):
    """Shadows the sampling halves of test_llama.py:215 and
    test_models.py:136 within the port: sampled streams have the greedy
    shape, repeat under one seed on every eager path, differ under
    another, and pad with eos once a row emits it."""
    _, tm = make_pair(name, seed=12)
    ids = _ids(12, 2, 6)
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.9, top_k=20,
              top_p=0.95)
    paths = [{}, dict(use_paged_kv=True, aot=False, kv_block_size=8)]
    if name == "gpt":
        paths.append(dict(use_cache=False))
    outs = []
    for extra in paths:
        a = tm.generate(ids, seed=3, **kw, **extra)
        b = tm.generate(ids, seed=3, **kw, **extra)
        assert a.shape == (2, 12) and torch.equal(a, b), extra
        outs.append(a)
    assert not torch.equal(tm.generate(ids, seed=4, **kw), outs[0])
    eos = int(outs[0][0, 7])
    e = tm.generate(ids, seed=3, eos_token_id=eos, **kw).numpy()
    assert e.shape[1] <= 12
    for row in e[:, 6:]:
        row = list(row)
        if eos in row:
            assert all(t == eos for t in row[row.index(eos):])


def test_speculative_needs_the_aot_path():
    """As in the JAX package: ``speculative=`` off the AOT paged path is a
    ValueError, for both families."""
    for name in ("gpt", "llama-kv2"):
        _, tm = make_pair(name)
        with pytest.raises(ValueError, match="AOT serving path"):
            tm.generate(_ids(0, 1, 4), max_new_tokens=2, speculative={})


@pytest.mark.parametrize("name", ["gpt", "llama-kv2"])
def test_dense_generate_runs_k4_and_the_norm_once_a_layer(name):
    """The dense loop's launches, here as plain-version calls: n_new
    forwards (the prefill and n_new - 1 one-token steps), so K4 runs
    L x n_new times and the norm (2L + 1) x n_new times; the dense
    ``_sdpa`` never runs."""
    _, tm = make_pair(name)
    kern = (norm.LAYER_NORM_KERNEL if name == "gpt"
            else fused_ops.RMS_NORM_KERNEL)
    for k in (kern, tfa.FLASH_FWD_KERNEL):
        k.reset_counts()
    dense = tattention._sdpa
    calls = []
    tattention._sdpa = lambda *a, **k: calls.append(1)
    try:
        tm.generate(_ids(3, 2, 10), max_new_tokens=5)
    finally:
        tattention._sdpa = dense
    L = tm.cfg.num_layers
    assert tfa.FLASH_FWD_KERNEL.plain_calls == L * 5
    assert kern.plain_calls == (2 * L + 1) * 5
    assert not calls


@pytest.mark.parametrize("h,kvh,d", [(16, 16, 128), (32, 4, 64)])
@pytest.mark.parametrize("sk", [1, 77])
def test_decode_step_route_is_native_k4(monkeypatch, h, kvh, d, sk):
    """One query row against Sk keys, causal aligned bottom-right (a dense
    decode step), MHA at GPT-3 1.3B's head dim and TinyLlama's 32:4: the
    port's sdpa takes the native-layout route to K4 (its plain version on
    the CPU, one call) and gives the JAX package's sdpa output, while the
    JAX package routes the shape to its dense ``_sdpa`` even with its
    kernels enabled (``_nl_ok`` wants a 128-row q block and
    ``_pallas_ok`` Sq >= 8: TPU tiling gates, which the port does not
    copy)."""
    rs = np.random.RandomState(sk + h)
    q = rs.randn(2, 1, h, d).astype(np.float32)
    k = rs.randn(2, sk, kvh, d).astype(np.float32)
    v = rs.randn(2, sk, kvh, d).astype(np.float32)
    assert tfa._gqa_route(h, kvh, d) == "native"
    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", True)
    assert jfa._gqa_route(2, 1, sk, h, d, kvh) == "reference"
    if kvh == h:
        assert not jfa._pallas_ok(jnp_struct(2, 1, h, d),
                                  jnp_struct(2, sk, h, d),
                                  jnp_struct(2, sk, h, d))
    monkeypatch.setattr(jfa, "FORCE_PALLAS_INTERPRET", False)
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=True)
    tfa.FLASH_FWD_KERNEL.reset_counts()
    got = TF.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), is_causal=True)
    assert tfa.FLASH_FWD_KERNEL.plain_calls == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-5)


def jnp_struct(*shape):
    import jax
    import jax.numpy as jnp

    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("b,s", [(2, 1), (1, 1), (2, 77), (1, 9)])
def test_packed_views_pass_the_kernel_operand_check(b, s):
    """GPT's dense path hands K4 the packed projection's q, k, v column
    views ([B, S, 3E] -> [B, S, E] at row stride 3E). At S = 1 (a decode
    step) torch gives such a view a stride(1) of E, which says nothing
    about where the next batch row starts: the kernels step rows by
    stride(0) there (``_row_stride``), and the operand check takes it (a
    card run of the dense decode found the check refusing it). A view
    whose rows are not one stride apart is still refused."""
    e = 128
    qkv = torch.zeros(b, s, 3 * e, dtype=torch.bfloat16)
    q5 = qkv.reshape(b, s, 3, 4, 32)
    for i in range(3):
        x = q5[:, :, i].reshape(b, s, e)
        assert x.data_ptr() == qkv[..., i * e:].data_ptr()
        tfa._check_operand("q", x, torch.bfloat16, x.device, e)
        if b * s > 1:                 # one row has no row stride
            assert tfa._row_stride(x) == 3 * e
    if b > 1 and s > 1:
        bad = torch.zeros(b, s + 1, e, dtype=torch.bfloat16)[:, :s]
        with pytest.raises(ValueError, match="one stride"):
            tfa._check_operand("q", bad, torch.bfloat16, bad.device, e)
