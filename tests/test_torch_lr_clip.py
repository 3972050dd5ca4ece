"""The port's LR schedulers and gradient clipping against the JAX
package's (the Adam / AdamW tests are in test_torch_optimizer.py).

Shadows tests/test_nn_optimizer.py (test_lr_schedulers,
test_grad_clip_global_norm). Gradients are numpy arrays from a seed,
the same in both packages.

Tolerances. Schedulers: equal floats (the same Python arithmetic).
Clipping: fp32 within 1e-6 relative (the norms sum in another order);
bf16 within one bf16 ulp (2^-8 relative: the fp32 product before the
rounding may differ in its last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Parameter as JParameter
import paddle_tpu_torch as ptt

# ---------------------------------------------------------------------------
# LR schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                  learning_rate=1.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12], [0.1, 0.05, 0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=10,
                                              end_lr=0.001, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=10, end_lr=0.001, cycle=True),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-4, T_max=10), warmup_steps=5,
        start_lr=0.0, end_lr=1e-4),
    "linear_warmup_float": lambda m: m.LinearWarmup(
        0.05, warmup_steps=5, start_lr=0.0, end_lr=0.1),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "multi_step": lambda m: m.MultiStepDecay(0.1, milestones=[3, 8, 20],
                                             gamma=0.5),
    "step": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.5),
    "lambda": lambda m: m.LambdaDecay(0.1, lr_lambda=lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(
        0.1, lr_lambda=lambda e: 0.9),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=10,
                                               eta_min=0.001),
    "cosine_warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1),
    "one_cycle_cos": lambda m: m.OneCycleLR(0.1, total_steps=30),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=30, anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                   step_size_down=6),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                               mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                             mode="exp_range",
                                             exp_gamma=0.9),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=10),
}
# ReduceOnPlateau's metrics: a fall, a plateau, a fall
PLATEAU = [1.0, 0.9, 0.9, 0.9, 0.9, 0.8] * 5


def _advance(s, i):
    if isinstance(s, (paddle.optimizer.lr.ReduceOnPlateau,
                      ptt.optimizer.lr.ReduceOnPlateau)):
        s.step(PLATEAU[i])
    else:
        s.step()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax_with_state_dict_round_trip(name):
    """30 steps of each scheduler give the JAX package's learning rates
    exactly; at step 15 the port's state_dict moves into a fresh port
    scheduler, which goes on as the JAX one does."""
    build = SCHEDULERS[name]
    js, ts = build(paddle.optimizer.lr), build(ptt.optimizer.lr)
    for i in range(30):
        if i == 15:
            fresh = build(ptt.optimizer.lr)
            fresh.set_state_dict(ts.state_dict())
            ts = fresh
        assert ts.get_lr() == js.get_lr(), (name, i)
        assert ts() == js(), (name, i)
        _advance(js, i)
        _advance(ts, i)


def test_optimizer_reads_its_scheduler():
    """The optimizer reads the scheduler's value at each step and refuses
    set_lr under one, as the JAX package's does."""
    sched = ptt.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ptt.optimizer.SGD(learning_rate=sched, parameters=[p])
    lrs = []
    for _ in range(4):
        lrs.append(opt.get_lr())
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    assert lrs == [0.1, 0.1, 0.05, 0.05]
    np.testing.assert_allclose(p.detach().numpy(), -0.3, rtol=1e-6)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
    opt.set_lr_scheduler(ptt.optimizer.lr.StepDecay(1.0, step_size=1))
    assert opt.get_lr() == 1.0
    with pytest.raises(TypeError):
        ptt.optimizer.SGD(learning_rate="0.1", parameters=[p])


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------

GRAD_SHAPES = [(8, 16), (4, 4, 3)]


def _grads(dtype, scale):
    rs = np.random.RandomState(3)
    gs = [(rs.randn(*s) * scale).astype(np.float32) for s in GRAD_SHAPES]
    if dtype == "bfloat16":
        gs = [np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
              for g in gs]
    return gs


def _pairs(dtype, scale):
    """[(jax param, jax grad)], [(port param, port grad)]."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jpg, tpg = [], []
    for g in _grads(dtype, scale):
        jp = JParameter(jnp.zeros(g.shape, jdt))
        jp.grad = paddle.to_tensor(jnp.asarray(g, jdt))
        tp = torch.nn.Parameter(torch.zeros(g.shape, dtype=tdt))
        tp.grad = torch.tensor(g).to(tdt)
        jpg.append((jp, jp.grad))
        tpg.append((tp, tp.grad))
    return jpg, tpg


def _assert_grads_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


CLIPS = {
    "by_value": lambda nn: nn.ClipGradByValue(0.05, min=-0.02),
    "by_norm": lambda nn: nn.ClipGradByNorm(0.5),
    "by_global_norm": lambda nn: nn.ClipGradByGlobalNorm(1.0),
    "by_global_norm_inactive": lambda nn: nn.ClipGradByGlobalNorm(1e3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_class_matches_jax(kind, dtype):
    """Each clip class maps the same (param, grad) list as the JAX
    package's; the gradients keep their dtype and p.grad is unchanged."""
    jpg, tpg = _pairs(dtype, 0.3)
    jout = CLIPS[kind](paddle.nn)(jpg)
    before = [g.clone() for _, g in tpg]
    tout = CLIPS[kind](ptt.nn)(tpg)
    for (tp, tg), (_, jg), old in zip(tout, jout, before):
        assert tg.dtype == tp.dtype
        assert torch.equal(tp.grad, old)
        _assert_grads_close(tg, jg._value, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["norm_2", "norm_inf", "value"])
def test_clip_functions_match_jax(fn, dtype):
    """clip_grad_norm_ (2 and infinity norms) and clip_grad_value_ change
    p.grad in place as the JAX package's do; the norm is returned."""
    jpg, tpg = _pairs(dtype, 0.3)
    jps, tps = [p for p, _ in jpg], [p for p, _ in tpg]
    if fn == "value":
        paddle.nn.clip_grad_value_(jps, 0.1)
        ptt.nn.clip_grad_value_(tps, 0.1)
    else:
        norm_type = 2.0 if fn == "norm_2" else float("inf")
        jn = paddle.nn.clip_grad_norm_(jps, 0.5, norm_type=norm_type)
        tn = ptt.nn.clip_grad_norm_(tps, 0.5, norm_type=norm_type)
        _assert_grads_close(tn.reshape(1), jnp.reshape(jn._value, (1,)),
                            dtype)
    for jp, tp in zip(jps, tps):
        _assert_grads_close(tp.grad, jp.grad._value, dtype)
