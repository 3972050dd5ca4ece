"""The port's head-major flash attention route and whole-block fused
attention op against the JAX package's.

Shadows tests/test_fused_ops.py (test_flash_pallas_kernel_interpret_mode
:162, test_flash_pallas_backward_kernels :184,
test_flash_backward_two_kernel_fallback :215,
test_fused_self_attention_matches_unfused :356,
test_fused_self_attention_pallas_interpret :406),
tests/test_flash_native_layout.py::test_nl_ineligible_shapes_fall_back
(:151, the route off the native layout) and
tests/test_gqa_native.py::test_mqa_keeps_flash_via_repeat_ramp (:127).
The CUDA kernels K6/K7 run only on a card (chip_smoke.py holds them
against these plain versions there); here a CPU tensor runs the plain
versions ``_hm_forward_ref`` / ``_hm_backward_ref`` through the same
``_FlashHM`` Function the card uses. Each test names what it holds them
against:
- the Pallas kernels ``_fwd_kernel_single`` / ``_fwd_kernel`` /
  ``_bwd_fused_kernel`` run in interpret mode, called directly
  (``_flash_forward_pallas`` / ``_flash_backward_fused`` interpret off a
  TPU) or through ``_fused_mha_impl`` with ``FORCE_PALLAS_INTERPRET``
  set by monkeypatch, or
- the dense jnp math the JAX models take on the CPU without that flag
  (``_attend_hm_reference`` in the fused op, ``_reference_attention``
  on FLAGS_flash_native_layout=0).

Every test that needs FLAGS_use_fused_attention or
FLAGS_flash_native_layout sets it in both packages through the
``both_flags`` fixture, which restores every flag it set in ``finally``
(module fixtures that run the JAX side restore theirs before returning).

Tolerances. fp32 attention: 1e-5 absolute and relative; the two sides
sum the same fp32 terms in other orders (tiles, online rescaling). bf16:
2^-8 of the tensor's largest value (at most one bf16 ulp of it): both
sides round the same fp32 quantities to bf16 (p before P.V and dV, ds
before dK and dQ). Models and the fused op in fp32: 1e-5 relative and
1e-5 of each tensor's largest value absolute (every matmul sums in
another order in XLA and in torch); three fp32 AdamW steps: losses 1e-5
relative, every weight within 1e-4 and 99.9% within 1e-6 (Adam divides a
near-zero gradient by its own tiny RMS, so such an element's step follows
that gradient's last bits; tests/test_torch_train.py states the same);
O2 bf16 losses: 1e-3 relative (activations round to bf16 at other
places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import state as jamp
from paddle_tpu.core import flags as jflags
from paddle_tpu.incubate.nn.functional import flash_attention as fa
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
import paddle_tpu_torch as ptt
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, LR = 2, 128, 1e-3
TINY = dict(vocab_size=1024, hidden_size=128, num_heads=4, max_seq_len=128)


@pytest.fixture
def both_flags():
    """set(name, value): FLAGS_<name> in both packages; every flag set is
    restored to its earlier value in ``finally``."""
    saved = []

    def set_(name, value):
        saved.append((name, jflags.get_flag(name), tflags.get_flag(name)))
        jflags.set_flags({name: value})
        tflags.set_flags({name: value})

    try:
        yield set_
    finally:
        for name, jv, tv in reversed(saved):
            jflags.set_flags({name: jv})
            tflags.set_flags({name: tv})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, \
            f"max err {np.abs(got - want).max()} > {tol}"


def _close_rel(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _hm_inputs(b, s, h, d, seed, dtype):
    """(jax, torch) head-major [B*H,S,D] q, k, v and an output gradient,
    made from numpy [B,S,H,D] arrays as the JAX tests make them."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    jdt, tdt = DTYPES[dtype]
    return ([fa._bhsd(jnp.asarray(a, jdt)) for a in arrs],
            [tfa._bhsd(torch.tensor(a).to(tdt)) for a in arrs])


@pytest.mark.parametrize("blocks", [None, (64, 128)], ids=["one_tile",
                                                            "tiled"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,d", [(1, 256, 2, 64), (2, 256, 2, 32)])
def test_hm_plain_matches_pallas_interpret(b, s, h, d, causal, blocks):
    """Shadows test_fused_ops.py:162 and :184. Against the Pallas kernels
    in interpret mode: out and lse of `_flash_forward_pallas` and dq, dk,
    dv of the one-pass `_flash_backward_fused`, at the default blocks
    (one 256 tile: `_fwd_kernel_single`) and at (64, 128) blocks (the
    streaming `_fwd_kernel`, and dq summed over kv blocks in the
    whole-sequence scratch)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _hm_inputs(b, s, h, d, b * d + causal,
                                                    "float32")
    bq, bk = blocks or (None, None)
    jout, jlse = fa._flash_forward_pallas(jq, jk, jv, causal, bq, bk)
    jgrads = fa._flash_backward_fused(jq, jk, jv, jout, jlse, jg, causal,
                                      bq, bk)
    fk, bkern = tfa.FLASH_FWD_HM_KERNEL, tfa.FLASH_BWD_HM_KERNEL
    before = (fk.plain_calls, bkern.plain_calls)
    tout, tlse = tfa._flash_forward_hm(tq, tk, tv, causal)
    tgrads = tfa._flash_backward_hm(tq, tk, tv, tout, tlse, tg, causal)
    assert (fk.plain_calls, bkern.plain_calls) == (before[0] + 1,
                                                   before[1] + 1)
    _close(tout, jout)
    _close(tlse, jlse)
    for got, want in zip(tgrads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_hm_plain_bf16_matches_pallas_interpret(causal):
    """bf16 at (1, 256, 2, 64): p and ds are cast to bf16 before their
    products on both sides; against the Pallas kernels in interpret mode
    through the custom-vjp `_flash_hm` and the port's `_FlashHM`."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _hm_inputs(1, 256, 2, 64, 21,
                                                    "bfloat16")
    jout, pull = jax.vjp(lambda q, k, v: fa._flash_hm(q, k, v, causal),
                         jq, jk, jv)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tout = tfa._flash_hm(*ts, causal)
    tout.backward(tg)
    assert tout.dtype == torch.bfloat16
    _close(tout, jout, "bfloat16")
    for t, want in zip(ts, pull(jg)):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, want, "bfloat16")


def test_hm_backward_above_the_dq_scratch_budget_raises_naming_k8(
        monkeypatch):
    """Shadows test_fused_ops.py:215. The JAX package picks the one-pass
    backward while Sq*D*4 <= _DQ_SCRATCH_BYTES (4 MiB, so S <= 8192 at
    D=128) and the two-kernel K8 above it; the port keeps the budget, runs
    its one-pass K7 up to it and raises naming K8 above it, on the CPU as
    on a card (the check comes before the device dispatch)."""
    assert tfa._DQ_SCRATCH_BYTES == fa._DQ_SCRATCH_BYTES == 4 << 20
    _, (tq, tk, tv, tg) = _hm_inputs(1, 256, 2, 32, 3, "float32")
    out, lse = tfa._flash_forward_hm(tq, tk, tv, True)
    monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES", 256 * 32 * 4)
    tfa._flash_backward_hm(tq, tk, tv, out, lse, tg, True)
    monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES", 256 * 32 * 4 - 1)
    with pytest.raises(NotImplementedError, match="K8"):
        tfa._flash_backward_hm(tq, tk, tv, out, lse, tg, True)
    monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES", 0)
    with pytest.raises(NotImplementedError, match="_bwd_dq_kernel"):
        tfa._flash_backward_hm(tq, tk, tv, out, lse, tg, True)


def _fused_inputs(b, s, e, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, e).astype(np.float32)
    wqkv = (rs.randn(e, 3 * e) * 0.05).astype(np.float32)
    bqkv = (rs.randn(3 * e) * 0.1).astype(np.float32)
    wo = (rs.randn(e, e) * 0.05).astype(np.float32)
    bo = (rs.randn(e) * 0.1).astype(np.float32)
    g = rs.randn(b, s, e).astype(np.float32)
    return [x, wqkv, bqkv, wo, bo], g


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("b,h", [(2, 2), (2, 4), (1, 2)])
def test_fused_self_attention_matches_pallas_interpret(monkeypatch, b, h,
                                                       with_bias):
    """Shadows test_fused_ops.py:356 and :406: the whole-block op's value
    and the gradients of x, both weights and (when given) both biases,
    against the JAX `_fused_mha_impl` (the op `fused_self_attention`
    registers) on the Pallas head-major kernels in interpret mode
    (FORCE_PALLAS_INTERPRET), at E=128 over 2 heads of d=64 and 4 of
    d=32, S=128, causal; None biases ride through on both sides. At B=1
    the port's head-major q, k, v are strided views of the projection."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    arrs, g = _fused_inputs(b, 128, 128, seed=h + 10 * with_bias + b)
    if not with_bias:
        arrs[2] = arrs[4] = None
    live = [i for i, a in enumerate(arrs) if a is not None]

    def jfn(*xs):
        full = list(arrs)
        for i, x in zip(live, xs):
            full[i] = x
        return fa._fused_mha_impl(*full, num_heads=h, causal=True)

    jout, pull = jax.vjp(jfn, *(jnp.asarray(arrs[i]) for i in live))
    jgrads = pull(jnp.asarray(g))
    ts = [None if a is None else torch.tensor(a, requires_grad=True)
          for a in arrs]
    fk = tfa.FLASH_FWD_HM_KERNEL
    before = fk.plain_calls
    tout = tfa.fused_self_attention(*ts, num_heads=h, causal=True)
    tout.backward(torch.tensor(g))
    assert fk.plain_calls == before + 1
    _close_rel(tout, jout)
    for i, want in zip(live, jgrads):
        _close_rel(ts[i].grad, want)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_fused_self_attention_is_an_amp_allow_op(level):
    """`fused_self_attention` casts as the JAX package's
    OpDef(..., amp="allow") does: bf16 inputs and output under auto_cast
    at O1 and O2, fp32 outside it."""
    prev = jamp.set_amp(True, dtype="bfloat16", level=level)
    try:
        want = jamp.amp_cast_dtype("fused_self_attention", "allow")
    finally:
        jamp.restore_amp(prev)
    arrs, _ = _fused_inputs(1, 16, 64, seed=4)
    ts = [torch.tensor(a) for a in arrs]
    with ptt.amp.auto_cast(level=level, dtype="bfloat16"):
        assert ptt.amp.state.amp_cast_dtype(
            "fused_self_attention", "allow") == want == "bfloat16"
        assert tfa.fused_self_attention(*ts, num_heads=2).dtype == \
            torch.bfloat16
    assert tfa.fused_self_attention(*ts, num_heads=2).dtype == torch.float32


# ---------------------------------------------------------------------------
# models on the two flags
# ---------------------------------------------------------------------------

def _gpt_pair(num_layers=2, seed=9):
    kw = dict(TINY, num_layers=num_layers)
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**kw))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**kw), device="cpu")
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _llama_pair(kv_heads, seed=9):
    kw = dict(TINY, num_layers=2, num_kv_heads=kv_heads)
    paddle.seed(seed)
    jm = JLlama(JLlamaConfig(**kw))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**kw), device="cpu")
    load_jax_state(tm, {k: np.asarray(v._value)
                        for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 1024, (B, S + 1)).astype(np.int64)
    return ids[:, :-1], ids[:, 1:]


def _jax_steps(jm, x, y, steps, o2):
    """`steps` AdamW steps of the JAX model through `paddle.jit.to_static`
    (bench.py's `bench_gpt` recipe); (losses, (logits, grads) of the first
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
    return losses


def _jax_run_with(flag, value, make, steps, seed):
    """The JAX model's fp32 AdamW steps with FLAGS_<flag> = value (set in
    the JAX package only, restored in finally): logits, gradients and
    losses of the run, and its final weights."""
    old = jflags.get_flag(flag)
    jflags.set_flags({flag: value})
    try:
        jm, _ = make()
        x, y = _batch(seed)
        losses, (logits, grads) = _jax_steps(jm, x, y, steps, o2=False)
    finally:
        jflags.set_flags({flag: old})
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    return dict(x=x, y=y, losses=losses, logits=logits, grads=grads,
                state=state)


@pytest.fixture(scope="module")
def jax_fused_run():
    """Three fp32 AdamW steps of the JAX gpt_tiny with
    FLAGS_use_fused_attention: its fused op reaches the dense
    `_attend_hm_reference` on the CPU (FORCE_PALLAS_INTERPRET unset)."""
    return _jax_run_with("use_fused_attention", True, _gpt_pair, 3, 4)


def _route_calls():
    ks = (tfa.FLASH_FWD_HM_KERNEL, tfa.FLASH_BWD_HM_KERNEL,
          tfa.FLASH_FWD_KERNEL, tfa.FLASH_BWD_KERNEL)
    return [k.plain_calls + k.launches for k in ks]


def _check_model_step(tm, ref, n_grads):
    """One forward and backward of the port model on ref's batch: logits,
    loss and every gradient against the JAX run's first step; returns the
    head-major and native calls (forward, backward) it made."""
    before = _route_calls()
    tlogits, tloss = tm(torch.tensor(ref["x"]), labels=torch.tensor(ref["y"]))
    tloss.backward()
    calls = [a - b for a, b in zip(_route_calls(), before)]
    _close_rel(tlogits, ref["logits"])
    _close_rel(tloss.item(), ref["losses"][0])
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(tgrads) == set(ref["grads"]) and len(tgrads) == n_grads
    for name, g in tgrads.items():
        assert g is not None, name
        _close_rel(g, ref["grads"][name])
    return calls


def test_gpt_tiny_fused_attention_logits_loss_and_grads_match_jax(
        jax_fused_run, both_flags):
    """FLAGS_use_fused_attention: every block runs `fused_self_attention`
    (one head-major forward and backward per layer, no native-layout
    call); fp32 logits, loss and all 28 gradients against the JAX model
    on the same flag (dense jnp attention inside its fused op)."""
    both_flags("use_fused_attention", True)
    _, tm = _gpt_pair()
    calls = _check_model_step(tm, jax_fused_run, 28)
    assert calls == [2, 2, 0, 0]


def test_gpt_tiny_fused_attention_adamw_three_steps_match_jax(
        jax_fused_run, both_flags):
    """fp32: the loss trajectory and every final weight of three AdamW
    steps with FLAGS_use_fused_attention (against the dense jnp math)."""
    both_flags("use_fused_attention", True)
    _, tm = _gpt_pair()
    ref = jax_fused_run
    tl = _port_steps(tm, ref["x"], ref["y"], 3, o2=False)
    _close_rel(tl, ref["losses"])
    assert tl[2] < tl[0]
    errs = []
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref["state"][name], rtol=0,
                                   atol=1e-4, err_msg=name)
        errs.append(np.abs(p.numpy() - ref["state"][name]).ravel())
    assert (np.concatenate(errs) <= 1e-6).mean() >= 0.999


def test_gpt_tiny_fused_attention_o2_bf16_losses_match_jax(both_flags):
    """amp O2 in bf16 with fp32 masters and FLAGS_use_fused_attention
    (one layer): the fused op runs in bf16 (an amp "allow" op) and the
    losses of two AdamW steps follow JAX's (dense jnp attention) within
    1e-3 relative."""
    both_flags("use_fused_attention", True)
    jm, tm = _gpt_pair(num_layers=1)
    x, y = _batch(6)
    jl, _ = _jax_steps(jm, x, y, 2, o2=True)
    tl = _port_steps(tm, x, y, 2, o2=True)
    _close_rel(tl, jl, rtol=1e-3)
    assert tl[1] < tl[0]


@pytest.fixture(scope="module")
def jax_hm_gpt_run():
    """One fp32 step of the JAX gpt_tiny on FLAGS_flash_native_layout=0:
    `_flash_packed_impl` unpacks and, off a TPU without
    FORCE_PALLAS_INTERPRET, reaches `_reference_attention`."""
    return _jax_run_with("flash_native_layout", False, _gpt_pair, 1, 7)


@pytest.fixture(scope="module", params=[2, 1], ids=["gqa2", "mqa"])
def jax_hm_llama_run(request):
    """As jax_hm_gpt_run for llama_tiny with 2 kv heads and with 1: sdpa's
    "ramp" route repeats k, v, then (on the CPU) `_reference_attention`."""
    kvh = request.param
    run = _jax_run_with("flash_native_layout", False,
                        lambda: _llama_pair(kvh), 1, 8)
    run["kv_heads"] = kvh
    return run


def test_gpt_tiny_head_major_route_matches_jax(jax_hm_gpt_run, both_flags):
    """FLAGS_flash_native_layout=0: `flash_attention_packed` unpacks the
    [B,S,3E] projection into the head-major kernels (route counter: one
    head-major forward and backward per layer, no native-layout call);
    fp32 logits, loss and all 28 gradients against the JAX model on the
    same flag (dense jnp attention)."""
    both_flags("flash_native_layout", False)
    _, tm = _gpt_pair()
    calls = _check_model_step(tm, jax_hm_gpt_run, 28)
    assert calls == [2, 2, 0, 0]


def test_llama_tiny_head_major_ramp_matches_jax(jax_hm_llama_run,
                                                both_flags):
    """FLAGS_flash_native_layout=0 at GQA 2:1 and MQA: sdpa takes the
    "ramp" (k, v repeated to the 4 q heads, then the head-major kernels;
    no native-layout call); fp32 logits, loss and all 21 gradients, the
    k/v projections' at the kv width, against the JAX model on the same
    flag (dense jnp attention)."""
    both_flags("flash_native_layout", False)
    ref = jax_hm_llama_run
    _, tm = _llama_pair(ref["kv_heads"])
    assert tfa._gqa_route(4, ref["kv_heads"], 32) == "ramp"
    calls = _check_model_step(tm, ref, 21)
    assert calls == [2, 2, 0, 0]
    assert tm.llama.layers[0].self_attn.k_proj.weight.grad.shape == (
        128, 32 * ref["kv_heads"])


def test_mqa_ramp_keeps_flash_and_matches_pallas_interpret(monkeypatch,
                                                           both_flags):
    """Shadows test_gqa_native.py:127: on FLAGS_flash_native_layout=0,
    MQA (4:1, d=64) sdpa reaches the head-major flash Function through the
    kv-sized repeat, never a dense path; out and gradients against the
    JAX sdpa on the same route (the Pallas head-major kernels in
    interpret mode)."""
    import paddle_tpu.nn.functional as JF

    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    both_flags("flash_native_layout", False)
    b, s, h, kvh, d = 1, 128, 4, 1, 64
    rs = np.random.RandomState(11)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, kvh, d).astype(np.float32)
    v = rs.randn(b, s, kvh, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    assert fa._gqa_route(b, s, s, h, d, kvh) == "ramp"

    def jsdpa(q_, k_, v_):
        return JF.scaled_dot_product_attention(
            paddle.to_tensor(q_), paddle.to_tensor(k_), paddle.to_tensor(v_),
            is_causal=True)._value

    jout, pull = jax.vjp(jsdpa, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    before = _route_calls()
    tout = ptt.nn.functional.scaled_dot_product_attention(*ts, is_causal=True)
    tout.backward(torch.tensor(g))
    assert [a - b_ for a, b_ in zip(_route_calls(), before)] == [1, 1, 0, 0]
    _close(tout, jout)
    for t, want in zip(ts, pull(jnp.asarray(g))):
        _close(t.grad, want)
