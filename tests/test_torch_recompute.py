"""Recompute (distributed.fleet.recompute, GPTConfig / LlamaConfig
``recompute=True``) against the JAX package's, and against the port
without it.

Shadows tests/test_flash_native_layout.py::test_recompute_with_flash_kernels
(gradients with and without recompute agree) and bench.py's recipes,
which set ``recompute=True``. A two-layer fp32 GPT from the JAX
package's weights (bridge.load_jax_state) at E=160, H=2, so its head
dim, 80, takes the dense fallback (``_reference_attention``; no kernel
takes d=80); the JAX side runs its compiled step (``jit.to_static``) with
its own recompute (``jax.checkpoint``). Llama against JAX:
tests/test_torch_recompute_llama.py (one JAX model a file keeps each
file's time down). Within the port, GPT at d=32 and llama_tiny's width
at GQA 4:2 run the plain K4/K5 on the CPU.

Tolerances. Against JAX: loss and every gradient within 1e-5 relative
and 1e-5 of each tensor's largest value absolute (tests/test_torch_train.py's
fp32 bound: every matmul sums in another order in XLA and in torch).
Within the port, recompute against none: equal bytes (the recomputed
forward runs the same operations on the same values), in fp32 and in
bf16 under amp O2, with dropout 0.1 (the masks drawn again from the same
stream state), and with the attention route's flag changed between the
forward and the backward.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
import paddle_tpu_torch as ptt
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.core.generator import rng_tracker
from paddle_tpu_torch.distributed.fleet import (recompute,
                                                recompute_sequential)
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

# few distinct weight shapes (vocab = positions, FFN = 3E), so the JAX
# package compiles few initializers
GPT80 = dict(vocab_size=64, hidden_size=160, num_layers=2, num_heads=2,
             max_seq_len=64, intermediate_size=480)
LLAMA = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64)
B, S = 2, 24


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, S + 1)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _port(family, state=None, **kw):
    if family == "gpt":
        m = tgpt.GPTForCausalLM(tgpt.GPTConfig(**{**GPT80, **kw}),
                                device="cpu")
    else:
        m = tllama.LlamaForCausalLM(tllama.LlamaConfig(**{**LLAMA, **kw}),
                                    device="cpu")
    if state is not None:
        load_jax_state(m, state)
    return m


def _port_grads(m, x, y, o2=False):
    with ptt.amp.auto_cast(enable=o2, level="O2"):
        _, loss = m(torch.tensor(x), labels=torch.tensor(y))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _assert_same_bytes(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    assert ga.keys() == gb.keys()
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def jax_grads(jm, x, y):
    """(state, loss, {name: gradient}) of the JAX model's compiled
    forward and backward on one batch."""
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    names, params = zip(*jm.named_parameters())

    @paddle.jit.to_static(state_objects=[jm])
    def step(x_, y_):
        _, loss = jm(x_, labels=y_)
        loss.backward()
        return loss, [p.grad for p in params]

    loss, grads = step(paddle.to_tensor(x), paddle.to_tensor(y))
    return state, np.asarray(loss.numpy()), {
        n: np.asarray(g.numpy()) for n, g in zip(names, grads)}


def check_against_jax(family, jm):
    """Loss and every gradient of the port's model with recompute match
    the JAX model's (which recomputes too); without recompute the port
    gives the same bytes."""
    x, y = _batch(64)
    state, jloss, jgrads = jax_grads(jm, x, y)
    fk = tfa.FLASH_FWD_KERNEL
    before = fk.plain_calls
    with_rc = _port_grads(_port(family, state, recompute=True), x, y)
    plain = _port_grads(_port(family, state), x, y)
    # d=80 takes no kernel; Llama's d=32 runs the plain K4 once a layer in
    # each forward and again in the recompute
    assert fk.plain_calls - before == (0 if family == "gpt" else 2 * 3)
    _close(with_rc[0], jloss)
    for n, g in with_rc[1].items():
        _close(g, jgrads[n])
    _assert_same_bytes(with_rc, plain)


def test_recompute_matches_jax_and_equals_no_recompute():
    """GPT with recompute against the JAX package's; its head dim, 80,
    runs the dense fallback on both sides (the head-dim-80 GPT step of
    the slice)."""
    paddle.seed(11)
    check_against_jax("gpt", JGPT(JGPTConfig(**GPT80, recompute=True)))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_recompute_under_amp_o2_gives_the_same_bytes(family):
    """bf16 under amp O2: the recompute runs in the backward, after
    auto_cast has exited, and must see the forward's amp state (else its
    dtypes differ and torch's checkpoint refuses it): the same bytes as
    without recompute."""
    kw = dict(hidden_size=128, num_heads=4) if family == "gpt" else {}
    runs = []
    for rc in (False, True):     # the same weights: the same seed
        m = _port(family, None, recompute=rc, **kw)
        ptt.amp.decorate(m, level="O2")
        runs.append(_port_grads(m, *_batch(64, 1), o2=True))
    assert runs[0][0].dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in runs[0][1].values())
    _assert_same_bytes(*runs)


def test_recompute_replays_dropout_masks():
    """GPT with dropout 0.1 under a seed: the recompute draws the
    forward's masks again (the dropout streams' state is saved with the
    block), so its gradients equal the run without recompute; another
    seed gives other gradients."""
    runs = []
    for rc, s in ((False, 5), (True, 5), (True, 6)):
        m = _port("gpt", None, hidden_size=128, num_heads=4, dropout=0.1,
                  recompute=rc)
        rng_tracker.manual_seed(s)
        runs.append(_port_grads(m, *_batch(64, 2)))
    _assert_same_bytes(runs[0], runs[1])
    assert not torch.equal(runs[1][0], runs[2][0])


def test_recompute_replays_the_forward_flags(monkeypatch):
    """A flag changed between the forward and the backward does not
    change the recomputed block: with FLAGS_use_fused_attention on in the
    forward and off at the backward, gradients equal a fused run's."""
    x, y = _batch(64, 3)
    runs = []
    for rc in (False, True):
        m = _port("gpt", None, recompute=rc, hidden_size=128, num_heads=4)
        monkeypatch.setitem(ptt.core.flags._flags, "use_fused_attention",
                            True)
        _, loss = m(torch.tensor(x), labels=torch.tensor(y))
        monkeypatch.setitem(ptt.core.flags._flags, "use_fused_attention",
                            False)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}))
    _assert_same_bytes(*runs)


def test_recompute_sequential_and_kwargs():
    """recompute_sequential over two segments of four layers, and
    recompute of a function with a keyword argument, give the plain
    run's output and gradients."""
    torch.manual_seed(0)
    layers = torch.nn.Sequential(*[torch.nn.Linear(8, 8) for _ in range(4)])
    x = torch.randn(3, 8, requires_grad=True)
    plain = layers(x)
    plain.sum().backward()
    want = [p.grad.clone() for p in layers.parameters()] + [x.grad.clone()]
    layers.zero_grad()
    x.grad = None
    out = recompute_sequential({"segments": 2}, layers, x)
    assert torch.equal(out, plain)
    out.sum().backward()
    got = [p.grad for p in layers.parameters()] + [x.grad]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y = recompute(lambda a, scale=1.0: layers(a) * scale, x, scale=2.0)
    assert torch.equal(y, plain * 2.0)
