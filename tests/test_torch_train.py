"""The port's GPT and Llama training steps against the JAX package's.

Shadows tests/test_models.py::test_gpt_tiny_trains and the training
recipes of bench.py (`bench_gpt`, `bench_llama`: AdamW with
multi_precision and use_multi_tensor, amp O2 bf16) at the gpt_tiny width
(2 layers, E=128, 4 heads, S=128) and the llama_tiny width (2 layers,
E=128, 4 heads of d=32, with 2 kv heads (GQA 2:1) or 1 (MQA)). The same
weights (bridge.load_jax_state) and token ids go through both packages
on the CPU. The JAX side runs its compiled train step
(`paddle.jit.to_static`, as `bench_gpt` does) and its CPU dispatch:
`flash_attention_packed` reaches `_reference_attention` and Llama's sdpa
the dense grouped `_sdpa` (the Pallas kernels need
FORCE_PALLAS_INTERPRET, which these tests leave unset), LayerNorm
reaches `_ln_ref` with its autodiff backward and RMSNorm `_rms_norm_ref`;
the port runs its plain versions of K1-K5 through the Functions a card
uses. The kernels themselves are held against those plain versions on
the card by chip_smoke.py, which also checks a card-against-CPU gpt_tiny
step.

Tolerances. fp32 logits, loss and gradients: 1e-5 relative and 1e-5 of
each tensor's largest value absolute; every matmul sums in another order
in XLA and in torch (about 1e-7 relative each), which the probes put
below 1e-7 absolute here. Three fp32 AdamW steps: losses 1e-5 relative;
weights: at least 99.9% of all elements within 1e-6, and every element
within 1e-4, a tenth of one step's lr. Adam divides each gradient by its
own running RMS, so an element whose gradient is near 0 (below the eps
scale) moves by an amount its gradient's last bits decide, and those
differ with the summation order (the probes saw 0.04% of elements past
1e-6, the worst at 1.9e-5). O2 bf16: losses within 1e-3
relative, since every activation rounds to bf16 at other places in the
two frameworks.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
import paddle_tpu_torch as ptt
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.incubate.nn.functional import fused_ops as tfused
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn.functional import norm as tnorm

B, S, LR = 2, 128, 1e-3


def _pair(seed=9, num_layers=2):
    """(jax model, port model) with identical fp32 weights, on the CPU: the
    gpt_tiny width, at its 2 layers unless asked for fewer."""
    paddle.seed(seed)
    if num_layers == 2:
        jm = JGPT(jgpt_tiny())
        tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    else:
        kw = dict(vocab_size=1024, hidden_size=128, num_layers=num_layers,
                  num_heads=4, max_seq_len=128)
        jm = JGPT(JGPTConfig(**kw))
        tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw), device="cpu")
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _llama_pair(kv_heads, seed=9, num_layers=2):
    """(jax model, port model) Llama with identical fp32 weights, on the
    CPU: the llama_tiny width with ``kv_heads`` kv heads."""
    kw = dict(vocab_size=1024, hidden_size=128, num_layers=num_layers,
              num_heads=4, num_kv_heads=kv_heads, max_seq_len=128)
    paddle.seed(seed)
    jm = JLlama(JLlamaConfig(**kw))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**kw), device="cpu")
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 1024, (B, S + 1)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _jax_steps(jm, x, y, steps, o2):
    """`steps` AdamW steps of the JAX model through `paddle.jit.to_static`
    (the compiled train step of bench.py's `bench_gpt`; one compile
    serves every step). Returns (losses, (logits, grads) of the first
    step)."""
    opt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                 learning_rate=LR, use_multi_tensor=True,
                                 multi_precision=True)
    if o2:
        jm, opt = paddle.amp.decorate(models=jm, optimizers=opt, level="O2",
                                      dtype="bfloat16")
    params = list(jm.parameters())

    @paddle.jit.to_static(state_objects=[jm, opt])
    def step(x_, y_):
        with paddle.amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            logits, loss = jm(x_, labels=y_)
        loss.backward()
        grads = [p.grad for p in params]
        opt.step()
        opt.clear_grad()
        return logits, loss, grads

    losses, first = [], None
    for _ in range(steps):
        logits, loss, grads = step(paddle.to_tensor(x), paddle.to_tensor(y))
        losses.append(float(np.asarray(loss.numpy())))
        if first is None:
            names = [n for n, _ in jm.named_parameters()]
            first = (logits.numpy(),
                     {n: np.asarray(g.numpy()) for n, g in zip(names, grads)})
    return losses, first


@pytest.fixture(scope="module")
def jax_fp32_run():
    """Three fp32 AdamW steps of the JAX model from the shared weights:
    the first step's logits, loss and gradients, the loss trajectory and
    the final weights."""
    jm, _ = _pair()
    x, y = _batch()
    losses, (logits, grads) = _jax_steps(jm, x, y, 3, o2=False)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return dict(x=x, y=y, losses=losses, logits=logits, grads=grads,
                state=state)


@pytest.fixture(scope="module", params=[2, 1], ids=["gqa2", "mqa"])
def jax_llama_fp32_run(request):
    """As jax_fp32_run, for llama_tiny with 2 kv heads and with 1."""
    jm, _ = _llama_pair(request.param)
    x, y = _batch(1)
    losses, (logits, grads) = _jax_steps(jm, x, y, 3, o2=False)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return dict(kv_heads=request.param, x=x, y=y, losses=losses,
                logits=logits, grads=grads, state=state)


def _port_steps(tm, x, y, steps, o2):
    opt = ptt.optimizer.AdamW(parameters=tm.parameters(), learning_rate=LR,
                              use_multi_tensor=True, multi_precision=True)
    if o2:
        tm, opt = ptt.amp.decorate(models=tm, optimizers=opt, level="O2",
                                   dtype="bfloat16")
    losses = []
    for _ in range(steps):
        with ptt.amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            _, loss = tm(torch.tensor(x), labels=torch.tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, opt


def test_gpt_tiny_logits_loss_and_grads_match_jax(jax_fp32_run):
    _, tm = _pair()
    ref = jax_fp32_run
    tlogits, tloss = tm(torch.tensor(ref["x"]), labels=torch.tensor(ref["y"]))
    tloss.backward()
    assert tlogits.shape == (B, S, 1024) and tloss.dim() == 0
    _close(tlogits.detach().numpy(), ref["logits"])
    _close(tloss.item(), ref["losses"][0])
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrads) == set(ref["grads"]) and len(tgrads) == 28
    for name, g in tgrads.items():
        assert g is not None, name
        _close(g.numpy(), ref["grads"][name])


def test_gpt_tiny_adamw_three_steps_match_jax(jax_fp32_run):
    """fp32: the loss trajectory and every final weight."""
    _, tm = _pair()
    ref = jax_fp32_run
    tl, _ = _port_steps(tm, ref["x"], ref["y"], 3, o2=False)
    _close(tl, ref["losses"])
    assert tl[2] < tl[0]
    errs = []
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref["state"][name], rtol=0,
                                   atol=1e-4, err_msg=name)
        errs.append(np.abs(p.numpy() - ref["state"][name]).ravel())
    assert (np.concatenate(errs) <= 1e-6).mean() >= 0.999


def test_gpt_tiny_o2_bf16_adamw_steps_match_jax():
    """amp O2 in bf16 with fp32 masters, the recipe of the train step:
    the parameters become bf16, the masters and moments stay fp32, and
    the loss (fp32: cross_entropy is amp black-listed) follows JAX's over
    two steps (one layer: the JAX side's O2 compile is the cost here)."""
    jm, tm = _pair(num_layers=1)
    x, y = _batch(2)
    jl, _ = _jax_steps(jm, x, y, 2, o2=True)
    tl, opt = _port_steps(tm, x, y, 2, o2=True)
    _close(tl, jl, rtol=1e-3)
    assert tl[1] < tl[0]
    params = list(tm.parameters())
    assert all(p.dtype == torch.bfloat16 for p in params)
    assert all(opt._master_weights[id(p)].dtype == torch.float32
               for p in params)
    for p in params:
        torch.testing.assert_close(
            p.float(), opt._master_weights[id(p)].to(torch.bfloat16).float(),
            rtol=0, atol=0)


def test_train_step_runs_the_plain_kernels_once_per_layer_on_cpu():
    """One forward + backward of gpt_tiny: per layer one flash forward and
    backward, two LayerNorms each way, plus the final LayerNorm; no
    kernel launch on a CPU tensor."""
    _, tm = _pair()
    x, y = _batch()
    ks = (tfa.FLASH_FWD_KERNEL, tfa.FLASH_BWD_KERNEL,
          tnorm.LAYER_NORM_KERNEL, tnorm.LAYER_NORM_BWD_KERNEL)
    before = [(k.plain_calls, k.launches) for k in ks]
    _, loss = tm(torch.tensor(x), labels=torch.tensor(y))
    loss.backward()
    n = tm.cfg.num_layers
    assert [(k.plain_calls - p, k.launches - l)
            for k, (p, l) in zip(ks, before)] == [
        (n, 0), (n, 0), (2 * n + 1, 0), (2 * n + 1, 0)]


def test_llama_tiny_gqa_logits_loss_and_grads_match_jax(jax_llama_fp32_run):
    """fp32 logits, loss and all 21 gradients of llama_tiny (GQA 2:1 and
    MQA): the k/v projections' gradients come out at the kv width."""
    ref = jax_llama_fp32_run
    _, tm = _llama_pair(ref["kv_heads"])
    tlogits, tloss = tm(torch.tensor(ref["x"]), labels=torch.tensor(ref["y"]))
    tloss.backward()
    assert tlogits.shape == (B, S, 1024) and tloss.dim() == 0
    _close(tlogits.detach().numpy(), ref["logits"])
    _close(tloss.item(), ref["losses"][0])
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrads) == set(ref["grads"]) and len(tgrads) == 21
    assert tgrads["llama.layers.0.self_attn.k_proj.weight"].shape == (
        128, 32 * ref["kv_heads"])
    for name, g in tgrads.items():
        assert g is not None, name
        _close(g.numpy(), ref["grads"][name])


def test_llama_tiny_gqa_adamw_three_steps_match_jax(jax_llama_fp32_run):
    """fp32: the loss trajectory and every final weight (tolerances as
    the GPT steps')."""
    ref = jax_llama_fp32_run
    _, tm = _llama_pair(ref["kv_heads"])
    tl, _ = _port_steps(tm, ref["x"], ref["y"], 3, o2=False)
    _close(tl, ref["losses"])
    assert tl[2] < tl[0]
    errs = []
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref["state"][name], rtol=0,
                                   atol=1e-4, err_msg=name)
        errs.append(np.abs(p.numpy() - ref["state"][name]).ravel())
    assert (np.concatenate(errs) <= 1e-6).mean() >= 0.999


def test_llama_tiny_o2_bf16_adamw_steps_match_jax():
    """amp O2 in bf16 with fp32 masters at GQA 2:1 (one layer): decorate
    gives every parameter the dtype the JAX package's decorate gives it
    (all bf16, RMSNorm weights included), the masters stay fp32, and the
    losses follow JAX's over two steps within 1e-3 relative."""
    jm, tm = _llama_pair(2, num_layers=1)
    x, y = _batch(3)
    jl, _ = _jax_steps(jm, x, y, 2, o2=True)
    tl, opt = _port_steps(tm, x, y, 2, o2=True)
    _close(tl, jl, rtol=1e-3)
    assert tl[1] < tl[0]
    jdt = {n: str(p.dtype).split(".")[-1] for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert str(p.dtype).split(".")[-1] == jdt[n], n
        assert opt._master_weights[id(p)].dtype == torch.float32


def test_llama_train_step_runs_the_plain_kernels_once_per_layer_on_cpu():
    """One forward + backward of llama_tiny (GQA 2:1): per layer one
    flash forward and backward, two RMSNorms, plus the final RMSNorm; no
    kernel launch on a CPU tensor."""
    _, tm = _llama_pair(2)
    x, y = _batch()
    ks = (tfa.FLASH_FWD_KERNEL, tfa.FLASH_BWD_KERNEL,
          tfused.RMS_NORM_KERNEL)
    before = [(k.plain_calls, k.launches) for k in ks]
    _, loss = tm(torch.tensor(x), labels=torch.tensor(y))
    loss.backward()
    n = tm.cfg.num_layers
    assert [(k.plain_calls - p, k.launches - l)
            for k, (p, l) in zip(ks, before)] == [
        (n, 0), (n, 0), (2 * n + 1, 0)]


@pytest.mark.slow
def test_gpt_1p3b_width_loss_trajectory_matches_jax():
    """GPT-3 1.3B's width (E 2048, 16 heads of d=128, vocab 50304,
    positions 2048) at 2 layers, from bridged weights: five fp32 AdamW
    steps at lr 1e-4 on one batch of S=256 (B=2): the loss trajectories
    of both packages agree within 1e-5 relative plus 1e-5 of the first
    loss absolute (fp32 sums in other orders, as in the gpt_tiny steps;
    AdamW carries each step's rounding into the next, and the probes saw
    the relative gap grow to 1.0e-5 at the fifth step, 2e-6 absolute, as
    the loss fell to 0.2), and the loss falls. Slow: about 30 s and 10 GB
    on the CPU at this width."""
    kw = dict(vocab_size=50304, hidden_size=2048, num_layers=2,
              num_heads=16, max_seq_len=2048)
    paddle.seed(21)
    jm = JGPT(JGPTConfig(**kw))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw), device="cpu")
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 50304, (2, 257)).astype(np.int64)
    x, y = ids[:, :-1], ids[:, 1:]
    opt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                 learning_rate=1e-4, use_multi_tensor=True,
                                 multi_precision=True)

    @paddle.jit.to_static(state_objects=[jm, opt])
    def step(x_, y_):
        _, loss = jm(x_, labels=y_)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    jl = [float(np.asarray(step(paddle.to_tensor(x),
                                paddle.to_tensor(y)).numpy()))
          for _ in range(5)]
    del jm, opt, step
    topt = ptt.optimizer.AdamW(parameters=tm.parameters(), learning_rate=1e-4,
                               use_multi_tensor=True, multi_precision=True)
    tl = []
    for _ in range(5):
        _, loss = tm(torch.tensor(x), labels=torch.tensor(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
    print(f"losses: jax {jl}, port {tl}")
    _close(tl, jl)
    assert tl[-1] < tl[0]


def test_unported_llama_training_options_raise():
    """Recompute is ported (tests/test_torch_recompute*.py): a llama_tiny
    with it gives the logits of one without, byte for byte; no Llama
    training option raises any more."""
    cfg = dict(num_kv_heads=2)
    rm = tllama.LlamaForCausalLM(tllama.llama_tiny(recompute=True, **cfg),
                                 device="cpu")
    pm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    x = torch.tensor(_batch()[0])
    assert torch.equal(rm(x), pm(x))


def test_unported_training_options_raise(monkeypatch):
    """The training options of the JAX package's recipes are ported
    (tests/test_torch_optimizer.py, test_torch_recompute*.py,
    test_torch_dropout_loss.py): FLAGS_use_fused_attention at a head dim
    outside the kernels' (here 128 / 8 = 16) takes the dense fallback and
    gives the native route's logits (within 1e-5, two dense attention
    orders); recompute, pure low-precision O2 and the AdamW options below
    construct. What stays unported raises: decorate(master_grad=True) and
    string regularizers; a moment_dtype typo is a ValueError."""
    _, tm = _pair()
    x = torch.tensor(_batch()[0])
    narrow = tgpt.GPTForCausalLM(tgpt.GPTConfig(
        vocab_size=1024, hidden_size=128, num_layers=1, num_heads=8,
        max_seq_len=128), device="cpu")
    want = narrow(x)
    monkeypatch.setitem(ptt.core.flags._flags, "use_fused_attention", True)
    _close(narrow(x).detach(), want.detach())
    monkeypatch.setitem(ptt.core.flags._flags, "use_fused_attention", False)
    rm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(recompute=True), device="cpu")
    rm(x)
    opt = ptt.optimizer.AdamW(parameters=tm.parameters())
    ptt.amp.decorate(models=tm, optimizers=opt, level="O2",
                     master_weight=False)
    assert opt._multi_precision is False
    for kw in ({"moment_dtype": "bfloat16"}, {"stochastic_rounding": True},
               {"amsgrad": True},
               {"grad_clip": ptt.nn.ClipGradByGlobalNorm(1.0)},
               {"apply_decay_param_fun": lambda n: True}):
        ptt.optimizer.AdamW(parameters=tm.parameters(), **kw)
    with pytest.raises(NotImplementedError):
        ptt.amp.decorate(models=tm, level="O2", master_grad=True)
    with pytest.raises(NotImplementedError):
        ptt.optimizer.SGD(parameters=tm.parameters(), weight_decay="L2")
    with pytest.raises(ValueError):
        ptt.optimizer.AdamW(parameters=tm.parameters(), moment_dtype="bf16")


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(reduction, dtype):
    """Shadows the cross_entropy cases of tests/test_nn_optimizer.py: the
    JAX package's `nn.functional.cross_entropy` (hard labels) on
    logits [N, C] against integer labels with some at ignore_index, in
    the input's dtype (fp32 arithmetic inside on both sides; the result
    is rounded to the input dtype, so bf16 allows one bf16 ulp)."""
    import paddle_tpu.nn.functional as JF

    rs = np.random.RandomState(3)
    x = (rs.randn(24, 50) * 3).astype(np.float32)
    y = rs.randint(0, 50, (24,)).astype(np.int64)
    y[[2, 7, 19]] = -100
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(x).astype(dtype), paddle.to_tensor(y),
        reduction=reduction).astype("float32").numpy())
    got = ptt.nn.functional.cross_entropy(
        torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(y),
        reduction=reduction)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got.float().numpy() - want) <= ulp)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_dtypes_follow_the_jax_lists(level):
    """Under auto_cast the port's functionals cast as the JAX package's
    op registry does (paddle_tpu/amp/state.py): matmul-class ops run in
    bf16 at O1 and O2, gray ops only at O2, cross_entropy (black-listed)
    in fp32, rope and swiglu (amp "allow" ops) in bf16 at O1 and O2;
    outside auto_cast nothing is cast."""
    from paddle_tpu.amp import state as jstate

    F = ptt.nn.functional
    x = torch.randn(4, 8)
    w = torch.randn(8, 8)
    q = torch.randn(1, 4, 2, 8)
    with ptt.amp.auto_cast(level=level, dtype="bfloat16"):
        for op, policy in (("linear", "allow"), ("gelu", "promote"),
                           ("cross_entropy", "allow"), ("fused_rope", "allow"),
                           ("swiglu", "allow")):
            prev = jstate.set_amp(True, dtype="bfloat16", level=level)
            try:
                want = jstate.amp_cast_dtype(op, policy)
            finally:
                jstate.restore_amp(prev)
            got = ptt.amp.state.amp_cast_dtype(op, policy)
            assert got == want, op
        assert F.linear(x, w).dtype == torch.bfloat16
        assert F.gelu(x).dtype == (torch.bfloat16 if level == "O2"
                                   else torch.float32)
        logits = torch.randn(4, 8).to(torch.bfloat16)
        assert F.cross_entropy(logits, torch.zeros(4, dtype=torch.long)
                               ).dtype == torch.float32
        rq, rk = tfused.fused_rotary_position_embedding(q, q[:, :, :1])
        assert rq.dtype == rk.dtype == torch.bfloat16
        assert tfused.swiglu(x, x).dtype == torch.bfloat16
    assert F.linear(x, w).dtype == torch.float32
    assert tfused.fused_rotary_position_embedding(q, q)[0].dtype == \
        torch.float32
    assert tfused.swiglu(x, x).dtype == torch.float32
