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
The CUDA kernels K6/K7/K8 run only on a card (chip_smoke.py holds them
against these plain versions there); here a CPU tensor runs the plain
versions ``_hm_forward_ref`` / ``_hm_backward_ref`` (K7) /
``_hm_backward_split_ref`` (K8, above ``_DQ_SCRATCH_BYTES``) through the
same ``_FlashHM`` Function the card uses. Each test names what it holds
them against:
- the Pallas kernels ``_fwd_kernel_single`` / ``_fwd_kernel`` /
  ``_bwd_fused_kernel`` / ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` run
  in interpret mode, called directly (``_flash_forward_pallas`` /
  ``_flash_backward_fused`` / ``_flash_backward_pallas`` interpret off a
  TPU) or through the models and ``_fused_mha_impl`` with
  ``FORCE_PALLAS_INTERPRET`` set, or
- the dense jnp math the JAX models take on the CPU without that flag
  (``_attend_hm_reference`` in the fused op, ``_reference_attention``
  on FLAGS_flash_native_layout=0).
The two-kernel backward K8 is reached by lowering ``_DQ_SCRATCH_BYTES``
(in both packages where both run it) below Sq*D*4 of the small shapes;
every test that lowers it restores it in ``finally`` or by monkeypatch.

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


def _split_inputs(g, sq, sk, d, seed, dtype):
    """(jax, torch) head-major q [G,Sq,D], k, v [G,Sk,D] and an output
    gradient [G,Sq,D], made from numpy arrays."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(g, n, d).astype(np.float32) for n in (sq, sk, sk, sq)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _route_counts():
    """Plain calls of K7 and K8."""
    return (tfa.FLASH_BWD_HM_KERNEL.plain_calls,
            tfa.FLASH_BWD_HM_SPLIT_KERNEL.plain_calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,sq,sk,d,blocks", [
    (2, 256, 256, 64, (64, 128)), (2, 128, 256, 32, (64, 64))],
    ids=["square", "ragged"])
def test_hm_split_plain_matches_pallas_two_kernel_interpret(
        monkeypatch, g, sq, sk, d, blocks, causal, dtype):
    """Shadows test_fused_ops.py:215. With `_DQ_SCRATCH_BYTES` lowered
    to 0 in both packages, the JAX package's `_flash_backward_pallas`
    runs its two-kernel backward (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) in
    interpret mode and the port's `_flash_backward_hm` runs K8's plain
    version (and not K7's); dq, dk, dv on the same q, k, v, output
    gradient and the JAX forward's out and lse, at several tiles (the
    given blocks), Sq == Sk and a ragged Sq < Sk. The port's plain K6 is
    held against the JAX forward on the way."""
    monkeypatch.setattr(fa, "_DQ_SCRATCH_BYTES", 0)
    monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES", 0)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _split_inputs(
        g, sq, sk, d, sq + d + causal, dtype)
    bq, bk = blocks
    jout, jlse = fa._flash_forward_pallas(jq, jk, jv, causal, bq, bk)
    jgrads = fa._flash_backward_pallas(jq, jk, jv, jout, jlse, jg, causal,
                                       bq, bk)
    tout, tlse = tfa._flash_forward_hm(tq, tk, tv, causal)
    _close(tout, jout, dtype)
    _close(tlse, jlse)
    before = _route_counts()
    tgrads = tfa._flash_backward_hm(
        tq, tk, tv, torch.tensor(_np(jout)).to(tq.dtype),
        torch.tensor(_np(jlse)), tg, causal)
    assert _route_counts() == (before[0], before[1] + 1)
    for got, want in zip(tgrads, jgrads):
        assert got.dtype == tq.dtype
        _close(got, want, dtype)


def test_hm_backward_above_the_dq_scratch_budget_raises_naming_k8(
        monkeypatch):
    """Shadows test_fused_ops.py:215 (the name is kept from when the port
    raised above the budget). The JAX package picks the one-pass backward
    while Sq*D*4 <= _DQ_SCRATCH_BYTES (4 MiB, so S <= 8192 at D=128) and
    the two-kernel K8 above it; so does the port: at the budget K7's
    plain version runs, one byte above it K8's, each counted by its own
    plain_calls on the CPU, and both give the same dq, dk, dv (the same
    arithmetic)."""
    assert tfa._DQ_SCRATCH_BYTES == fa._DQ_SCRATCH_BYTES == 4 << 20
    _, (tq, tk, tv, tg) = _hm_inputs(1, 256, 2, 32, 3, "float32")
    out, lse = tfa._flash_forward_hm(tq, tk, tv, True)
    runs = []
    for budget, want in ((256 * 32 * 4, (1, 0)), (256 * 32 * 4 - 1, (0, 1)),
                         (0, (0, 1))):
        monkeypatch.setattr(tfa, "_DQ_SCRATCH_BYTES", budget)
        before = _route_counts()
        runs.append(tfa._flash_backward_hm(tq, tk, tv, out, lse, tg, True))
        assert tuple(a - b for a, b in zip(_route_counts(), before)) == want
    for k7, k8 in zip(runs[0], runs[1]):
        assert torch.equal(k7, k8)


def test_k8_wrapper_rejects_cpu_tensors_and_the_dispatch_other_devices():
    """K8's wrapper takes only CUDA tensors (no CPU fallback), and the
    head-major backward raises on a device that is neither the card nor
    the CPU."""
    x = torch.randn(2, 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_hm_split_cuda(x, x, x, x, torch.zeros(2, 64), x, True)
    m = torch.empty(2, 64, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa._flash_backward_hm(m, m, m, m, torch.empty(2, 64, device="meta"),
                               m, True)


def test_fused_op_passes_b1_projection_views_in_place(monkeypatch):
    """At B=1 `_fused_mha_impl` hands the head-major Function views of
    its projection (group stride D, row stride 3E, with and without the
    bias), which the kernels read in place; at B=2 a transposing copy
    (contiguous [B*H,S,D])."""
    seen = []
    real = tfa._flash_hm

    def spy(qh, kh, vh, causal):
        seen.append((qh.stride(), kh.stride(), vh.stride(),
                     qh.is_contiguous()))
        return real(qh, kh, vh, causal)
    monkeypatch.setattr(tfa, "_flash_hm", spy)
    s, e, h = 16, 64, 2
    d = e // h
    for b, with_bias in ((1, True), (1, False), (2, True)):
        arrs, _ = _fused_inputs(b, s, e, seed=b)
        ts = [torch.tensor(a) for a in arrs]
        if not with_bias:
            ts[2] = ts[4] = None
        tfa.fused_self_attention(*ts, num_heads=h, causal=True)
    view = (d, 3 * e, 1)
    assert seen[0][:3] == seen[1][:3] == (view,) * 3
    assert not seen[0][3] and not seen[1][3]
    assert seen[2][3]


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


# ---------------------------------------------------------------------------
# the two-kernel backward (K8) in the models
# ---------------------------------------------------------------------------

def _spy_jax_backward_kernels(counts):
    """Wrap the JAX package's backward kernel bodies so that each trace
    of one counts; returns a function that restores them."""
    saved = {}
    for name in ("_bwd_dq_kernel", "_bwd_dkv_kernel", "_bwd_fused_kernel"):
        orig = saved[name] = getattr(fa, name)

        def spy(*args, _name=name, _orig=orig, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(*args, **kw)
        setattr(fa, name, spy)

    def restore():
        for name, orig in saved.items():
            setattr(fa, name, orig)
    return restore


def _jax_split_run(flag, value, steps, seed):
    """`_jax_run_with` with the JAX package's Pallas kernels in interpret
    mode (FORCE_PALLAS_INTERPRET) and `_DQ_SCRATCH_BYTES` lowered to 0, so
    that its head-major backward is the two-kernel one; everything is
    restored in finally. The run records which backward kernels were
    traced."""
    counts = {}
    old = fa.FORCE_PALLAS_INTERPRET, fa._DQ_SCRATCH_BYTES
    restore = _spy_jax_backward_kernels(counts)
    fa.FORCE_PALLAS_INTERPRET, fa._DQ_SCRATCH_BYTES = True, 0
    try:
        run = _jax_run_with(flag, value, _gpt_pair, steps, seed)
    finally:
        fa.FORCE_PALLAS_INTERPRET, fa._DQ_SCRATCH_BYTES = old
        restore()
    run["jax_kernels"] = counts
    return run


@pytest.fixture
def port_split_budget():
    """The port's `_DQ_SCRATCH_BYTES` lowered to 0 (K8 on every head-major
    backward), restored in finally."""
    old = tfa._DQ_SCRATCH_BYTES
    tfa._DQ_SCRATCH_BYTES = 0
    try:
        yield
    finally:
        tfa._DQ_SCRATCH_BYTES = old


def _split_route_calls():
    """[K6, K7, K8, K4, K5] plain calls and launches."""
    ks = (tfa.FLASH_FWD_HM_KERNEL, tfa.FLASH_BWD_HM_KERNEL,
          tfa.FLASH_BWD_HM_SPLIT_KERNEL, tfa.FLASH_FWD_KERNEL,
          tfa.FLASH_BWD_KERNEL)
    return [k.plain_calls + k.launches for k in ks]


@pytest.fixture(scope="module")
def jax_fused_split_run():
    """Three fp32 AdamW steps of the JAX gpt_tiny with
    FLAGS_use_fused_attention, its fused op on the Pallas head-major
    kernels in interpret mode and the two-kernel backward."""
    return _jax_split_run("use_fused_attention", True, 3, 12)


def _model_step_calls(tm, ref, n_grads):
    before = _split_route_calls()
    _check_model_step(tm, ref, n_grads)
    return [a - b for a, b in zip(_split_route_calls(), before)]


def test_gpt_tiny_fused_two_kernel_backward_matches_jax(
        jax_fused_split_run, both_flags, port_split_budget):
    """FLAGS_use_fused_attention with `_DQ_SCRATCH_BYTES` lowered in both
    packages: every layer's backward is the two-kernel one on both sides
    (the JAX run traced `_bwd_dq_kernel` and `_bwd_dkv_kernel`, never
    `_bwd_fused_kernel`; the port ran K8's plain version, never K7's);
    fp32 logits, loss and all 28 gradients of one step."""
    both_flags("use_fused_attention", True)
    ref = jax_fused_split_run
    assert ref["jax_kernels"].get("_bwd_dq_kernel", 0) > 0
    assert ref["jax_kernels"].get("_bwd_dkv_kernel", 0) > 0
    assert "_bwd_fused_kernel" not in ref["jax_kernels"]
    _, tm = _gpt_pair()
    assert _model_step_calls(tm, ref, 28) == [2, 0, 2, 0, 0]


def test_gpt_tiny_fused_two_kernel_adamw_three_steps_match_jax(
        jax_fused_split_run, both_flags, port_split_budget):
    """fp32: the loss trajectory and every final weight of three AdamW
    steps with FLAGS_use_fused_attention on the two-kernel backward in
    both packages. Losses 1e-5 relative; 99.9% of the weights within
    1e-6 and every weight within 1e-4, except where the first step's
    gradient is fp32 rounding noise (within 1e-6 of its tensor's largest
    value): Adam's first step is lr * sign(g), so such an element moves
    by lr either way on the two sides and is held to Adam's own bound,
    lr a step (this batch has one, at 1e-10 with opposite signs)."""
    both_flags("use_fused_attention", True)
    _, tm = _gpt_pair()
    ref = jax_fused_split_run
    tl = _port_steps(tm, ref["x"], ref["y"], 3, o2=False)
    _close_rel(tl, ref["losses"])
    assert tl[2] < tl[0]
    errs = []
    for name, p in tm.state_dict().items():
        err = np.abs(p.numpy() - ref["state"][name])
        g = np.abs(ref["grads"][name])
        noise = g <= 1e-6 * g.max()
        assert err[~noise].max(initial=0.0) <= 1e-4, name
        assert err[noise].max(initial=0.0) <= 3 * LR, name
        errs.append(err.ravel())
    assert (np.concatenate(errs) <= 1e-6).mean() >= 0.999


def test_long_context_route_difference_native_k5_vs_jax_k8(
        both_flags, port_split_budget):
    """The documented route difference above the one-pass budget. On
    default flags the JAX package leaves the native layout there (its
    `_nl_ok` caps Sq at the same VMEM budget), unpacks and runs K6 with
    the two-kernel backward K8 (traced here in interpret mode with the
    budget lowered); the port keeps its native K4/K5, whose backward has
    no whole-sequence scratch and no such cap. Both give the same fp32
    logits, loss and all 28 gradients of one gpt_tiny step."""
    both_flags("flash_native_layout", True)
    ref = _jax_split_run("flash_native_layout", True, 1, 13)
    assert ref["jax_kernels"].get("_bwd_dq_kernel", 0) > 0
    assert "_bwd_fused_kernel" not in ref["jax_kernels"]
    _, tm = _gpt_pair()
    assert _model_step_calls(tm, ref, 28) == [0, 0, 0, 2, 2]


# ---------------------------------------------------------------------------
# the bf16 head-major backward's schedule (csrc/flash_bwd_sm90.cu)
# ---------------------------------------------------------------------------

# (Sq, Sk): Sq = 1, Sq < Sk and Sq > Sk, multiples of the kernel's tiles (64
# q rows, 128 kv rows) and not
SCHEDULE_SHAPES = [(1, 1), (1, 100), (1, 300), (64, 64), (64, 128),
                   (77, 100), (77, 300), (100, 77), (128, 128), (128, 256),
                   (130, 130), (200, 77), (256, 256), (300, 1000),
                   (513, 1000), (1000, 513), (63, 129), (129, 63),
                   (192, 320), (2048, 2048)]


def _live_blocks(sq, sk, causal, tq, tk):
    """[q tiles, kv tiles] bool, brute force: the blocks of the attention
    mask (bottom-right causal: q row r sees keys k <= r + Sk - Sq) that
    hold a visible (q row < Sq, key < Sk) pair."""
    keep = np.ones((sq, sk), bool)
    if causal:
        keep = np.arange(sk)[None, :] <= np.arange(sq)[:, None] + (sk - sq)
    nq, nkv = -(-sq // tq), -(-sk // tk)
    padded = np.zeros((nq * tq, nkv * tk), bool)
    padded[:sq, :sk] = keep
    return padded.reshape(nq, tq, nkv, tk).any(axis=(1, 3))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", SCHEDULE_SHAPES)
def test_hm_bwd_schedule_matches_the_mask(sq, sk, causal):
    """`hm_bwd_schedule`, the live-tile arithmetic of the bf16 K7 (its
    counters, one per q tile of 64 rows, and their targets) mirrored by
    `Schedule` in csrc/flash_bwd_sm90.cuh, against a brute-force count of
    the non-empty blocks of the mask: each q tile's live kv tiles (of 128
    rows) run from 0 to its `last`, without a gap, so the CTA of kv tile j
    adds its dq partial once the counter reads j; a q tile that sees no
    key is None (its dq is 0); and each kv tile's live q tiles run from the
    kernel's `q_first` (first visible row // 64) to the last q tile, the
    q tiles whose `last` reaches that kv tile."""
    blocks = _live_blocks(sq, sk, causal, tfa.HM_BWD_TILE_Q,
                          tfa.HM_BWD_TILE_KV)
    tiles = tfa.hm_bwd_schedule(sq, sk, causal)
    assert len(tiles) == blocks.shape[0]
    for i, row in enumerate(blocks):
        live = np.flatnonzero(row)
        if not live.size:
            assert tiles[i] is None
            continue
        assert tiles[i] == (0, int(live[-1]))
        assert (live == np.arange(live[-1] + 1)).all()
    for j, col in enumerate(blocks.T):
        first_row = j * tfa.HM_BWD_TILE_KV - (sk - sq)
        q_first = (first_row // tfa.HM_BWD_TILE_Q
                   if causal and first_row > 0 else 0)
        live = np.flatnonzero(col)
        assert (live == np.arange(q_first, blocks.shape[0])).all()
        assert q_first == min(i for i, tile in enumerate(tiles)
                              if tile is not None and tile[1] >= j)


def _tiled_hm_backward(q, k, v, out, lse, dout, causal):
    """The bf16 K7's algorithm in plain fp32 torch: for each q tile of
    `hm_bwd_schedule`, its live kv tiles in ascending order; per pair p =
    exp(q k^T * scale - lse) (masked: 0), dp = dO v^T, ds = p (dp -
    delta); dq's partials ds k summed over the kv tiles in that order (the
    kernel's ordered add), dk += ds^T q and dv += p^T dO; dq and dk
    scaled at the end. q [G,Sq,D], k, v [G,Sk,D] -> (dq, dk, dv)."""
    g, sq, d = q.shape
    sk = k.shape[1]
    tq, tk = tfa.HM_BWD_TILE_Q, tfa.HM_BWD_TILE_KV
    scale = 1.0 / np.sqrt(d)
    delta = (dout * out).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for i, tile in enumerate(tfa.hm_bwd_schedule(sq, sk, causal)):
        if tile is None:
            continue
        qs = slice(i * tq, min(sq, (i + 1) * tq))
        rows = torch.arange(qs.start, qs.stop)[:, None]
        acc = torch.zeros(g, qs.stop - qs.start, d)
        for j in range(tile[0], tile[1] + 1):
            ks = slice(j * tk, min(sk, (j + 1) * tk))
            keys = torch.arange(ks.start, ks.stop)[None, :]
            s = q[:, qs] @ k[:, ks].transpose(1, 2) * scale
            p = torch.exp(s - lse[:, qs, None])
            if causal:
                p = torch.where(keys <= rows + sk - sq, p, torch.zeros(()))
            dp = dout[:, qs] @ v[:, ks].transpose(1, 2)
            ds = p * (dp - delta[:, qs, None])
            acc = acc + ds @ k[:, ks]
            dk[:, ks] += ds.transpose(1, 2) @ q[:, qs]
            dv[:, ks] += p.transpose(1, 2) @ dout[:, qs]
        dq[:, qs] = acc * scale
    return dq, dk * scale, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,sq,sk", [(2, 77, 300), (2, 1, 100), (2, 200, 77),
                                     (2, 130, 130), (1, 256, 256)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tiled_hm_backward_matches_the_plain_k7(g, sq, sk, d, causal):
    """The kernel's tiled order (`_tiled_hm_backward`) against the port's
    plain K7 `_hm_backward_ref` (whole-sequence products), fp32, at
    ragged Sq < Sk, Sq > Sk (rows that see no key), Sq = 1, several tiles
    and every head dim of the kernel. Tolerance 1e-5 absolute and
    relative: the same fp32 terms summed in other orders."""
    _, (tq, tk, tv, tg) = _split_inputs(g, sq, sk, d, sq + sk + d, "float32")
    out, lse = tfa._flash_forward_hm(tq, tk, tv, causal)
    want = tfa._hm_backward_ref(tq, tk, tv, out, lse, tg, causal)
    for got, ref in zip(_tiled_hm_backward(tq, tk, tv, out, lse, tg, causal),
                        want):
        _close(got, ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,sq,sk", [(2, 256, 256), (2, 128, 256)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tiled_hm_backward_matches_pallas_k7_interpret(g, sq, sk, d, causal):
    """The kernel's tiled order against the JAX package's one-pass
    `_flash_backward_fused` (`_bwd_fused_kernel`, interpret mode off a
    TPU) at its blocks of 64 q rows and 128 keys, the Hopper kernel's
    tiles: the TPU kernel too sums dq over kv blocks in ascending order,
    through its sequential grid. fp32, on the JAX forward's out and lse;
    tolerance 1e-5 absolute and relative (the TPU kernel scales each
    partial, the tiled order scales the sum)."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _split_inputs(g, sq, sk, d, 7 * d,
                                                       "float32")
    jout, jlse = fa._flash_forward_pallas(jq, jk, jv, causal, 64, 128)
    jgrads = fa._flash_backward_fused(jq, jk, jv, jout, jlse, jg, causal,
                                      64, 128)
    tgrads = _tiled_hm_backward(tq, tk, tv, torch.tensor(_np(jout)),
                                torch.tensor(_np(jlse)), tg, causal)
    for got, want in zip(tgrads, jgrads):
        _close(got, want)


@pytest.mark.parametrize("name", ["FLASH_BWD_HM_KERNEL",
                                  "FLASH_BWD_HM_FP32_KERNEL",
                                  "FLASH_BWD_HM_SPLIT_KERNEL",
                                  "FLASH_BWD_HM_SPLIT_FP32_KERNEL",
                                  "FLASH_FWD_KERNEL", "FLASH_FWD_FP32_KERNEL",
                                  "FLASH_FWD_HM_KERNEL",
                                  "FLASH_FWD_HM_FP32_KERNEL",
                                  "FLASH_BWD_KERNEL", "FLASH_BWD_FP32_KERNEL"])
def test_hm_backward_entry_points_match_their_bindings(name):
    """Each attention entry point (bf16 in csrc/flash_fwd_sm90.cu and
    csrc/flash_bwd_sm90.cu, fp32 in the earlier sources) is declared in
    its source with the arguments its ctypes binding passes: pointers,
    int64 strides and ints in that order, then the stream."""
    import ctypes
    import re

    kernel = getattr(tfa, name)
    src = kernel.source.read_text()
    found = re.findall(r'extern "C" int ' + kernel.symbol + r"\((.*?)\)\s*\{",
                       src, re.S)
    assert len(found) == 1, f"{kernel.symbol} not declared once in " \
                            f"{kernel.source.name}"
    kinds = {ctypes.c_void_p: "void*", ctypes.c_int64: "int64_t",
             ctypes.c_int: "int"}
    params = [" ".join(p.split()[:-1]).replace("const ", "").replace(" *",
                                                                      "*")
              for p in found[0].split(",")]
    assert params == [kinds[a] for a in kernel.argtypes]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", SCHEDULE_SHAPES)
def test_fwd_schedule_matches_the_mask(sq, sk, causal, d):
    """`fwd_schedule`, the live kv tiles of the bf16 forward's CTAs (q
    tiles of 128 rows, kv tiles of `fwd_tile_kv(d)` keys: 64 at D <= 64,
    128 at D=128; `Schedule::kv_last` in
    csrc/flash_bwd_sm90.cuh), against a brute-force count of the
    non-empty blocks of the mask: each q tile's live kv tiles run from 0
    to its `last` without a gap (so the kernel never visits a fully
    masked tile), and a q tile that sees no key is None (its out is 0)."""
    blocks = _live_blocks(sq, sk, causal, tfa.FWD_TILE_Q,
                          tfa.fwd_tile_kv(d))
    tiles = tfa.fwd_schedule(sq, sk, causal, d)
    assert len(tiles) == blocks.shape[0]
    for i, row in enumerate(blocks):
        live = np.flatnonzero(row)
        if not live.size:
            assert tiles[i] is None
            continue
        assert tiles[i] == (0, int(live[-1]))
        assert (live == np.arange(live[-1] + 1)).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", SCHEDULE_SHAPES)
def test_k5_kv_schedule_matches_the_mask(sq, sk, causal):
    """`k5_kv_schedule`, the q tiles (of 64 rows) that bf16 K5's kv kernel
    walks for each kv tile of 128 keys, against the brute-force mask:
    exactly the q tiles with a visible pair in the kv tile, the last
    first."""
    blocks = _live_blocks(sq, sk, causal, tfa.K5_TILE_Q, tfa.K5_TILE_KV)
    walks = tfa.k5_kv_schedule(sq, sk, causal)
    assert len(walks) == blocks.shape[1]
    for j, col in enumerate(blocks.T):
        assert walks[j] == sorted(np.flatnonzero(col).tolist(),
                                  reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g,sq,sk", [(2, 256, 256), (2, 128, 256)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tiled_forward_hm_matches_pallas_k6_interpret(g, sq, sk, d, causal):
    """The bf16 forward's tiled order in head-major form
    (`flash_tiled.forward_tiled_hm`: q tiles of 128 rows, kv tiles of 128
    keys at D=128 and 64 at D <= 64, the softmax in exp2) against the JAX
    package's `_flash_forward_pallas` (`_fwd_kernel`, interpret mode off a
    TPU) at blocks of 128 q rows and the kernel's kv tile, and against the
    port's plain K6
    `_hm_forward_ref`; fp32 at 1e-5 absolute and relative (the same fp32
    terms in another order, exp2(x log2 e) for exp(x))."""
    from paddle_tpu_torch.testing import flash_tiled

    (jq, jk, jv, _), (tq, tk, tv, _) = _split_inputs(g, sq, sk, d, 5 * d + sq,
                                                     "float32")
    jout, jlse = fa._flash_forward_pallas(jq, jk, jv, causal, 128,
                                          tfa.fwd_tile_kv(d))
    out, lse = flash_tiled.forward_tiled_hm(tq, tk, tv, causal)
    _close(out, jout)
    _close(lse, jlse.reshape(g, sq))
    rout, rlse = tfa._hm_forward_ref(tq, tk, tv, causal)
    _close(out, rout)
    _close(lse, rlse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hm_forward_routes_bf16_and_fp32_to_their_own_kernels(monkeypatch,
                                                              dtype):
    """`flash_fwd_hm_cuda` launches K6's warpgroup entry
    (`ptt_flash_fwd_hm`, csrc/flash_fwd_sm90.cu) in bf16 and the earlier
    kernel's (`ptt_flash_fwd_hm_fp32`, csrc/flash_fwd.cu) in fp32, each
    through its own Kernel object, with the arguments its binding
    declares. `launch` is recorded, not run, and the device check is
    passed by a tensor that reports a CUDA device; CPU tensors take the
    plain version and any other device raises (`_flash_forward_hm`)."""
    calls = []

    def record(self, device, *args):
        calls.append((self.symbol, self.source.name, len(args)))

    monkeypatch.setattr(type(tfa.FLASH_FWD_HM_KERNEL), "launch", record)
    x = torch.zeros(2, 8, 64, dtype=dtype)
    plain = tfa.FLASH_FWD_HM_KERNEL.plain_calls
    tfa._flash_forward_hm(x, x, x, True)                  # CPU: plain
    assert calls == [] and tfa.FLASH_FWD_HM_KERNEL.plain_calls == plain + 1
    with pytest.raises(ValueError, match="unsupported device"):
        tfa._flash_forward_hm(x.to("meta"), x.to("meta"), x.to("meta"), True)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    orig_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        orig_empty(*a, **kw))
    tfa.flash_fwd_hm_cuda(x, x, x, True)
    kernel = (tfa.FLASH_FWD_HM_KERNEL if dtype == torch.bfloat16
              else tfa.FLASH_FWD_HM_FP32_KERNEL)
    assert calls == [(kernel.symbol, kernel.source.name,
                      len(kernel.argtypes) - 1)]
