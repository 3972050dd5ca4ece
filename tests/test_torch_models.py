"""The port's models on the paged-cache path against the JAX package's.

Shadows tests/test_gqa_native.py and tests/test_paged_kv.py at the model
level: the same weights (bridge.load_jax_state), token ids, pools and
tables go through ``make_run_model`` of both packages, for a prefill
with ragged lengths and a decode step after it. Last-position logits and
the returned pools are compared at fp32 tolerance 1e-4: every matmul
sums in another order in XLA and in torch (about 1e-6 relative each),
and two layers of attention, MLP and norms compound that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as jllama_tiny
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def make_pair(family, seed=9):
    """(jax model, port model) with identical weights, fp32, on the CPU."""
    paddle.seed(seed)
    if family == "llama":
        jm = JLlama(jllama_tiny(num_kv_heads=2))
        tm = tllama.LlamaForCausalLM(tllama.llama_tiny(num_kv_heads=2),
                                     device="cpu")
    else:
        jm = JGPT(jgpt_tiny())
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    jm.eval()
    load_jax_state(tm, jax_state(jm))
    return jm, tm


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_port_state_dict_names_and_shapes_match_jax(family):
    jm, tm = make_pair(family)
    js = jax_state(jm)
    ts = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert ts == {k: tuple(v.shape) for k, v in js.items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), js[k])


def test_bridge_rejects_mismatched_state():
    jm, tm = make_pair("gpt")
    js = jax_state(jm)
    with pytest.raises(KeyError):
        load_jax_state(tm, {k: v for k, v in js.items()
                            if k != "gpt.ln_f.bias"})
    bad = dict(js)
    bad["gpt.ln_f.bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        load_jax_state(tm, bad)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_make_run_model_prefill_and_decode_match_jax(family):
    jm, tm = make_pair(family)
    ja = jserving.get_model_adapter(jm)
    ta = tserving.get_model_adapter(tm)
    assert (ta.kv_heads, ta.head_dim, ta.num_layers) == \
        (ja.kv_heads, ja.head_dim, ja.num_layers)
    params = dict(jm.state_dict())
    names = sorted(params)
    jrun = jserving.make_run_model(jm, ja, params, names)
    trun = tserving.make_run_model(tm, ta)
    pvals = [params[n]._value for n in names]

    b, s, bs = 2, 8, 4
    bt, nb = tserving.alloc_block_tables(b, ta.max_seq_len, bs, device="cpu")
    shape = (nb, ta.kv_heads, bs, ta.head_dim)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 1000, (b, s)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    zeros = np.zeros(shape, np.float32)
    L = ta.num_layers

    jlv, jkc, jvc, jsl = jrun(
        pvals, jnp.asarray(ids), (jnp.asarray(zeros),) * L,
        (jnp.asarray(zeros),) * L, jnp.asarray(bt.numpy()),
        jnp.zeros((b,), jnp.int32), jnp.asarray(0, jnp.int32),
        new_lens=jnp.asarray(lens), last_idx=jnp.asarray(lens - 1))
    tlv, tkc, tvc, tsl = trun(
        torch.tensor(ids), tuple(torch.zeros(shape) for _ in range(L)),
        tuple(torch.zeros(shape) for _ in range(L)), bt,
        torch.zeros((b,), dtype=torch.int32), 0,
        new_lens=torch.tensor(lens), last_idx=torch.tensor(lens - 1))
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), **TOL)
    for t, j in zip(tkc + tvc, jkc + jvc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

    # one decode step at each sequence's own position
    tok = np.array([[3], [700]], np.int32)
    jlv2, jkc2, _, jsl2 = jrun(pvals, jnp.asarray(tok), jkc, jvc,
                               jnp.asarray(bt.numpy()), jsl, jsl)
    tlv2, tkc2, _, tsl2 = trun(torch.tensor(tok), tkc, tvc, bt, tsl, tsl)
    np.testing.assert_array_equal(tsl2.numpy(), np.asarray(jsl2))
    np.testing.assert_allclose(tlv2.numpy(), np.asarray(jlv2), **TOL)
    for t, j in zip(tkc2, jkc2):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("flag", ["tensor_parallel", "sequence_parallel",
                                  "segment_parallel"])
def test_gpt_parallel_configs_raise(flag):
    with pytest.raises(NotImplementedError):
        tgpt.GPTForCausalLM(tgpt.gpt_tiny(**{flag: True}), device="cpu")
