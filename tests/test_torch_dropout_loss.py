"""Training-mode dropout and the rest of cross_entropy: the port against
the JAX package (the dense attention fallback is in
test_torch_dense_fallback.py).

Shadows tests/test_nn_optimizer.py::test_dropout_train_eval,
::test_losses and ::test_cross_entropy_probs_input. Inputs are numpy
arrays from a seed.

Dropout draws its masks from the port's own streams (Philox on a card,
torch's CPU generator here; the JAX package uses threefry), so masks are
held by their keep rate (within 5 binomial standard deviations), their
structure (``axis``, the scales of both modes) and equal bytes under the
same seed, not against JAX.

Tolerances. cross_entropy values and input gradients: 1e-6 relative and
1e-6 of the largest value absolute (fp32 on both sides; the reductions
sum in another order).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.generator import rng_tracker
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt

F = ptt.nn.functional


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _binomial_ok(kept, n, keep):
    sd = math.sqrt(n * keep * (1 - keep))
    return abs(kept - n * keep) <= 5 * sd


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_keep_rate_modes_and_seed():
    """upscale_in_train keeps 1-p of the elements at x / (1-p);
    downscale_in_infer keeps them at x in training and scales by (1-p) at
    inference; the same seed gives the same bytes, another seed other
    masks; p=0 and eval are the identity, p=1 zeros."""
    x = torch.ones(400, 500)
    rng_tracker.manual_seed(3)
    y = F.dropout(x, p=0.3)
    kept = int((y != 0).sum())
    assert _binomial_ok(kept, x.numel(), 0.7)
    assert set(y.unique().tolist()) == {0.0, np.float32(1 / 0.7).item()}
    rng_tracker.manual_seed(3)
    assert torch.equal(F.dropout(x, p=0.3), y)
    assert not torch.equal(F.dropout(x, p=0.3), y)   # the stream moved
    down = F.dropout(x, p=0.3, mode="downscale_in_infer")
    assert set(down.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(F.dropout(x, p=0.3, training=False,
                                 mode="downscale_in_infer"),
                       x * (1.0 - 0.3))
    assert F.dropout(x, p=0.3, training=False) is x
    assert F.dropout(x, p=0.0) is x
    assert torch.equal(F.dropout(x, p=1.0), torch.zeros_like(x))
    with pytest.raises(ValueError):
        F.dropout(x, p=0.3, mode="upscale")


def test_unseeded_dropout_stream_leaves_numpy_global_state_alone():
    """Before any seed the stream picks a seed of its own, from a private
    draw: numpy's global sequence is the same whether dropout ran first
    or not."""
    from paddle_tpu_torch.core.generator import RNGTracker

    before = np.random.get_state()
    RNGTracker().generator("cpu")
    after = np.random.get_state()
    assert before[0] == after[0] and before[2:] == after[2:]
    assert np.array_equal(before[1], after[1])


@pytest.mark.parametrize("axis", [0, 1, [0, 2]])
def test_dropout_axis_shares_the_mask_along_the_other_axes(axis):
    """With ``axis``, one draw per index of those axes, repeated along
    the others (dropout2d / dropout3d drop whole channels)."""
    x = torch.ones(64, 48, 5)
    y = F.dropout(x, p=0.5, axis=axis)
    axes = [axis] if isinstance(axis, int) else axis
    other = tuple(d for d in range(3) if d not in axes)
    mask = y != 0
    assert torch.equal(mask.all(dim=other), mask.any(dim=other))
    n = math.prod(x.shape[a] for a in axes)
    assert _binomial_ok(int(mask.all(dim=other).sum()), n, 0.5)
    img = torch.ones(16, 32, 4, 4)
    m2 = F.dropout2d(img, p=0.5) != 0
    assert torch.equal(m2.all(dim=(2, 3)), m2.any(dim=(2, 3)))
    m3 = F.dropout3d(torch.ones(8, 16, 2, 3, 3), p=0.5) != 0
    assert torch.equal(m3.all(dim=(2, 3, 4)), m3.any(dim=(2, 3, 4)))


def test_alpha_dropout_keeps_zero_mean_and_unit_variance():
    """alpha_dropout on standard normal input keeps mean 0 and variance
    1 (within 0.02 over 10^6 elements); dropped elements all take one
    value; eval is the identity."""
    x = torch.randn(1000, 1000, generator=torch.Generator().manual_seed(1))
    y = F.alpha_dropout(x, p=0.2)
    assert abs(float(y.mean())) < 0.02 and abs(float(y.var()) - 1) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - 0.2) * (1 + 0.2 * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * 0.2
    dropped = y[(y - (a * alpha_p + b)).abs() < 1e-6]
    assert _binomial_ok(dropped.numel(), x.numel(), 0.2)
    assert F.alpha_dropout(x, p=0.2, training=False) is x


def test_dropout_layer_train_eval_and_amp():
    """Shadows test_dropout_train_eval: the layer drops in training and
    is the identity in eval; under amp O2 it runs in bf16, as the JAX
    package's dropout_op."""
    d = ptt.nn.Dropout(0.5)
    x = torch.ones(100, 100)
    y = d(x)
    assert (y == 0).any()
    d.eval()
    assert torch.equal(d(x), x)
    d.train()
    with ptt.amp.auto_cast(level="O2"):
        assert d(x).dtype == torch.bfloat16
    with ptt.amp.auto_cast(level="O1"):
        assert d(x).dtype == torch.float32


def test_gpt_dropout_trains_and_eval_is_deterministic():
    """A GPT with dropout 0.1: training forwards draw masks (two differ,
    the same seed repeats), eval forwards equal each other."""
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(dropout=0.1), device="cpu")
    ids = torch.tensor(np.random.RandomState(0).randint(0, 1024, (2, 16)))
    rng_tracker.manual_seed(1)
    a = m(ids)
    b = m(ids)
    rng_tracker.manual_seed(1)
    assert torch.equal(m(ids), a) and not torch.equal(a, b)
    m.eval()
    assert torch.equal(m(ids), m(ids))


def test_sdpa_training_dropout_takes_the_dense_route():
    """scaled_dot_product_attention with dropout_p in training runs the
    dense ``_sdpa`` (the kernels have no dropout: no K4 call), drops
    probabilities at the rate asked, and repeats under the same seed;
    outside training it is the kernel route."""
    rs = np.random.RandomState(0)
    q = torch.tensor(rs.randn(2, 64, 4, 32), dtype=torch.float32)
    k, v = (torch.tensor(rs.randn(2, 64, 2, 32), dtype=torch.float32)
            for _ in range(2))
    fk = tfa.FLASH_FWD_KERNEL
    before = fk.plain_calls
    rng_tracker.manual_seed(9)
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                       is_causal=True)
    rng_tracker.manual_seed(9)
    b = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                       is_causal=True)
    assert fk.plain_calls == before and torch.equal(a, b)
    plain = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2,
                                           is_causal=True, training=False)
    assert fk.plain_calls == before + 1
    assert not torch.allclose(a, plain)
    # with v = 1 each output is the sum of its kept, rescaled probabilities
    ones = F.scaled_dot_product_attention(q, k, torch.ones_like(v),
                                          dropout_p=0.2)
    assert abs(float(ones.mean()) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------

N, C = 12, 10


def _ce_inputs(case):
    rs = np.random.RandomState(4)
    shape = (N, C, 3) if case.get("axis") == 1 else (N, C)
    x = rs.randn(*shape).astype(np.float32)
    if not case.get("use_softmax", True):
        x = np.abs(x) / np.abs(x).sum(axis=1, keepdims=True)
    if case.get("soft_label"):
        lab = rs.rand(*shape).astype(np.float32)
        lab = lab / lab.sum(axis=1, keepdims=True)
    else:
        lab = rs.randint(0, C, (N, 3) if case.get("axis") == 1 else (N,))
        lab[1] = -100                           # ignore_index
    return x, lab


CE_CASES = {
    "soft": dict(soft_label=True),
    "soft_smoothed_sum": dict(soft_label=True, label_smoothing=0.1,
                              reduction="sum"),
    "soft_probs": dict(soft_label=True, use_softmax=False,
                       reduction="none"),
    "weight_mean": dict(weight=True),
    "weight_none": dict(weight=True, reduction="none"),
    "smoothing": dict(label_smoothing=0.2),
    "probs_smoothing": dict(use_softmax=False, label_smoothing=0.1),
    "axis1_weight_sum": dict(axis=1, weight=True, reduction="sum"),
}


@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_cross_entropy_options_match_jax(name):
    """Soft labels (with softmax or on probabilities), class weights,
    label smoothing, use_softmax=False and a class axis of 1, each with a
    reduction: the JAX package's value and input gradient."""
    case = dict(CE_CASES[name])
    x, lab = _ce_inputs(case)
    kw = {k: v for k, v in case.items() if k != "weight"}
    w = (np.linspace(0.5, 1.5, C).astype(np.float32)
         if case.get("weight") else None)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jl = paddle.nn.functional.cross_entropy(
        jx, paddle.to_tensor(lab),
        weight=None if w is None else paddle.to_tensor(w), **kw)
    paddle.sum(jl).backward()
    tx = torch.tensor(x, requires_grad=True)
    tl = F.cross_entropy(tx, torch.tensor(lab),
                         weight=None if w is None else torch.tensor(w), **kw)
    tl.sum().backward()
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(tl.detach(), jl.numpy(), 1e-6)
    _close(tx.grad, jx.grad.numpy(), 1e-6)


def test_softmax_with_cross_entropy_matches_jax():
    """Per-position losses and, with return_softmax, the softmax."""
    x, lab = _ce_inputs({})
    jloss, jsm = paddle.nn.functional.softmax_with_cross_entropy(
        paddle.to_tensor(x), paddle.to_tensor(lab[:, None]),
        return_softmax=True)
    tloss, tsm = F.softmax_with_cross_entropy(
        torch.tensor(x), torch.tensor(lab[:, None]), return_softmax=True)
    _close(tloss, jloss.numpy(), 1e-6)
    _close(tsm, jsm.numpy(), 1e-6)
