"""The port's quantization package and int8 paged-KV ops against the JAX
package's.

Shadows tests/test_quantization.py (PTQ convert, weight-only int8, QAT
steps, the 2-bit weight quanter, int8 execution and its wrapper rule)
and tests/test_quant_serving.py :75 (the int8 tree grid), :95 (the int4
grid) and :122 (the knob resolution). The same numpy inputs go through
both packages: weight payloads and scales, int4 packing and the
quantized KV pools are byte-equal; int8 execution's int32 product is
exact; float outputs are held within the stated fp32 tolerance. The
reference's tests run LeNet; the port has no Conv2D yet (ROADMAP queue A
item 7), so the models here are Linear stacks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as jF
import paddle_tpu.quantization as jq
import paddle_tpu_torch as ptt
import paddle_tpu_torch.quantization as tq
from paddle_tpu.incubate.nn.functional import paged_kv as jpk
from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.incubate.nn.functional import paged_kv as tpk
from paddle_tpu_torch.inference import serving as tserving

# fp32 outputs of float products computed by XLA's and torch's CPU
# matmuls (other summation orders) on values of order 1-10: a few ulps
FP32_ATOL = 1e-5


def _np(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# ---------------------------------------------------------------------------
# weight grids: byte-equal payloads and scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_tree_int8_bytes_equal_jax(dtype):
    """Shadows test_quant_serving.py:75: rank-2 entries only, int8
    payloads and f32 per-output-channel steps byte-equal to the JAX
    package's (a bf16 weight's step is taken in bf16 in both), the
    dequantized image within a half step, bits=5 refused."""
    rs = np.random.RandomState(0)
    tree = {"w1": rs.randn(32, 48).astype(np.float32),
            "w2": rs.randn(48, 16).astype(np.float32),
            "bias": rs.randn(16).astype(np.float32)}
    jt = {k: _j(v).astype(dtype) for k, v in tree.items()}
    tt = {k: _t(v).to(getattr(torch, dtype)) for k, v in tree.items()}
    jqt, jsc = jq.quantize_weight_tree(jt)
    tqt, tsc = tq.quantize_weight_tree(tt)
    assert set(tqt) == set(tsc) == set(jqt) == {"w1", "w2"}
    for n in tqt:
        assert tqt[n].dtype == torch.int8 and tsc[n].dtype == torch.float32
        np.testing.assert_array_equal(tqt[n].numpy(), _np(jqt[n]))
        np.testing.assert_array_equal(tsc[n].numpy(), _np(jsc[n]))
        deq = tq.dequantize_weight(tqt[n], tsc[n], torch.float32).numpy()
        bound = np.abs(tree[n]).max(axis=0) / 254.0 + 1e-9
        if dtype == "float32":
            assert (np.abs(deq - tree[n]) <= bound[None, :]).all()
    with pytest.raises(ValueError):
        tq.quantize_weight_tree(tt, bits=5)


def test_quantize_weight_tree_int4_bytes_equal_jax():
    """Shadows test_quant_serving.py:95: rows not a multiple of the group
    (100 -> 128 padded, 64 packed rows, 2 groups of scales), packed bytes
    and group scales byte-equal; the dequantized image equal to the JAX
    package's and within group absmax / 14."""
    w = np.random.RandomState(1).randn(100, 24).astype(np.float32)
    jqt, jsc = jq.quantize_weight_tree({"w": _j(w)}, bits=4, group_size=64)
    tqt, tsc = tq.quantize_weight_tree({"w": _t(w)}, bits=4, group_size=64)
    assert tuple(tqt["w"].shape) == (64, 24) and tqt["w"].dtype == torch.int8
    assert tuple(tsc["w"].shape) == (2, 24)
    np.testing.assert_array_equal(tqt["w"].numpy(), _np(jqt["w"]))
    np.testing.assert_array_equal(tsc["w"].numpy(), _np(jsc["w"]))
    deq = tq.dequantize_weight(tqt["w"], tsc["w"], torch.float32, rows=100,
                               group_size=64).numpy()
    jdeq = _np(jq.dequantize_weight(jqt["w"], jsc["w"], jnp.float32,
                                    rows=100, group_size=64))
    assert deq.shape == w.shape
    np.testing.assert_array_equal(deq, jdeq)
    assert float(np.abs(deq - w).max()) <= float(np.abs(w).max()) / 14 + 1e-9


def test_int4_pack_and_unpack_every_byte_equal_jax():
    """_unpack_int4 over all 256 byte values, and _pack_int4 of every
    (low, high) pair of int4 values, equal the JAX package's (torch's
    int8 shifts against JAX's); unpacking inverts packing."""
    allb = np.arange(256, dtype=np.uint8).view(np.int8).reshape(1, 256)
    np.testing.assert_array_equal(tq._unpack_int4(_t(allb)).numpy(),
                                  _np(jq._unpack_int4(_j(allb))))
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(vals, vals, indexing="ij")).reshape(2, -1)
    packed = tq._pack_int4(_t(pairs)).numpy()
    np.testing.assert_array_equal(packed, _np(jq._pack_int4(_j(pairs))))
    np.testing.assert_array_equal(tq._unpack_int4(_t(packed)).numpy(), pairs)
    odd = np.random.RandomState(2).randint(-7, 8, (5, 3)).astype(np.int8)
    np.testing.assert_array_equal(tq._pack_int4(_t(odd)).numpy(),
                                  _np(jq._pack_int4(_j(odd))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weight_bytes_equal_jax(bits, dtype):
    """dequantize_weight is (q.float() * scale).to(dtype) in both
    packages, in that order: byte-equal images."""
    w = np.random.RandomState(3).randn(96, 40).astype(np.float32)
    jqt, jsc = jq.quantize_weight_tree({"w": _j(w)}, bits=bits)
    q, s = _t(_np(jqt["w"])), _t(_np(jsc["w"]))
    got = tq.dequantize_weight(q, s, getattr(torch, dtype), rows=96)
    want = jq.dequantize_weight(jqt["w"], jsc["w"], jnp.dtype(dtype),
                                rows=96)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    with pytest.raises(ValueError):
        tq.dequantize_weight(q, s, torch.float32) if bits == 4 else \
            tq.dequantize_weight(q, s.reshape(1, -1), torch.float32)


# ---------------------------------------------------------------------------
# fake quant, PTQ, QAT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [None, "O1"])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fake_quant_forward_and_ste_gradient_equal_jax(level, bits):
    """fake_quant's output and its straight-through gradient equal the
    JAX package's, fp32 and under amp O1 (both run the op in fp32 there).
    O2 is the next test."""
    rs = np.random.RandomState(4)
    x = (rs.randn(6, 10) * 3).astype(np.float32)
    g = rs.randn(6, 10).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = ptt.to_tensor(x, place="cpu", stop_gradient=False)
    if level is None:
        jy, ty = jq.fake_quant(jx, 2.5, bits), tq.fake_quant(tx, 2.5, bits)
    else:
        with paddle.amp.auto_cast(level=level):
            jy = jq.fake_quant(jx, 2.5, bits)
        with ptt.amp.auto_cast(level=level):
            ty = tq.fake_quant(tx, 2.5, bits)
    np.testing.assert_array_equal(ty.detach().numpy(), _np(jy))
    (jy * paddle.to_tensor(g)).sum().backward()
    (ty * _t(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    np.testing.assert_array_equal(tx.grad.numpy(), g)


def test_fake_quant_o2_runs_in_fp32_where_the_jax_package_casts():
    """ROADMAP queue C item 5: fake_quant is an amp="block" op; the
    port's registry forces fp32 for it under O2, the JAX package's runs
    it in bf16. Recorded so that a change on either side shows."""
    x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    with paddle.amp.auto_cast(level="O2"):
        jy = jq.fake_quant(paddle.to_tensor(x), 2.0)
    with ptt.amp.auto_cast(level="O2"):
        ty = tq.fake_quant(ptt.to_tensor(x, place="cpu"), 2.0)
    assert str(_np(jy).dtype) == "bfloat16" and ty.dtype == torch.float32
    np.testing.assert_array_equal(
        ty.numpy(), _np(jq.fake_quant(paddle.to_tensor(x), 2.0)))


class JMLP(jnn.Layer):
    def __init__(self, d_in=16, d_hid=32, d_out=8):
        super().__init__()
        self.fc1 = jnn.Linear(d_in, d_hid)
        self.fc2 = jnn.Linear(d_hid, d_out)

    def forward(self, x):
        return self.fc2(jF.relu(self.fc1(x)))


class TMLP(torch.nn.Module):
    def __init__(self, d_in=16, d_hid=32, d_out=8):
        super().__init__()
        self.fc1 = ptt.nn.Linear(d_in, d_hid, device="cpu")
        self.fc2 = ptt.nn.Linear(d_hid, d_out, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def mlp_pair(seed=0, **kw):
    """(JAX MLP, port MLP) with identical fp32 weights."""
    paddle.seed(seed)
    jm = JMLP(**kw)
    tm = TMLP(**kw)
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(_t(_np(dict(jm.named_parameters())[n])))
    return jm, tm


def _run(model, x):
    if isinstance(model, torch.nn.Module):
        return model(ptt.to_tensor(x, place="cpu")).detach().numpy()
    return _np(model(paddle.to_tensor(x)))


X = np.random.RandomState(0).randn(8, 16).astype(np.float32)


def test_ptq_convert_equals_jax():
    """Shadows test_quantization.py:22: calibrate 4 passes, convert;
    the converted model's outputs equal the JAX package's within
    FP32_ATOL, its frozen scales equal, and the unconverted model is
    untouched (not inplace)."""
    jm, tm = mlp_pair(0)
    ref = _run(tm, X)
    outs, scales = {}, {}
    for pkg, m in ((jq, jm), (tq, tm)):
        ptq = pkg.PTQ(pkg.QuantConfig(
            activation=pkg.AbsmaxObserver(quant_bits=8),
            weight=pkg.AbsmaxObserver(quant_bits=8)))
        qm = ptq.quantize(m)
        for i in range(4):
            _run(qm, X * (1 + i / 4))
        conv = ptq.convert(qm)
        outs[pkg] = _run(conv, X)
        scales[pkg] = [(l._act_scale, l._w_scale) for l in
                       (conv.fc1, conv.fc2)]
    np.testing.assert_allclose(scales[tq], scales[jq], rtol=1e-6)
    np.testing.assert_allclose(outs[tq], outs[jq], atol=FP32_ATOL, rtol=0)
    rel = np.abs(outs[tq] - ref).max() / np.abs(ref).max()
    assert 0 < rel < 0.1, rel
    np.testing.assert_array_equal(_run(tm, X), ref)


def test_qat_steps_equal_jax():
    """Shadows test_quantization.py:58: activation and weight fake-quant
    quanters, 3 SGD steps in each package: equal losses and gradients
    within FP32_ATOL, the loss falling (straight-through gradients)."""
    jm, tm = mlp_pair(1)
    y = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    losses = {}
    for pkg, m in ((jq, jm), (tq, tm)):
        qat = pkg.QAT(pkg.QuantConfig(
            activation=pkg.FakeQuanterWithAbsMaxObserver(quant_bits=8),
            weight=pkg.FakeQuanterWithAbsMaxObserver(quant_bits=8)))
        qm = qat.quantize(m)
        port = pkg is tq
        opt = (ptt.optimizer.SGD(learning_rate=0.05,
                                 parameters=qm.parameters()) if port else
               paddle.optimizer.SGD(learning_rate=0.05,
                                    parameters=qm.parameters()))
        losses[pkg] = []
        for _ in range(3):
            if port:
                out = qm(ptt.to_tensor(X, place="cpu"))
                loss = ((out - _t(y)) ** 2).mean()
            else:
                out = qm(paddle.to_tensor(X))
                loss = ((out - paddle.to_tensor(y)) ** 2).mean()
            loss.backward()
            losses[pkg].append(float(_np(loss.detach() if port else loss)))
            grads = [(_np(p.grad) if not port else p.grad.numpy())
                     for p in (qm.fc1._inner.weight, qm.fc2._inner.weight)]
            losses[pkg].append(grads)
            opt.step()
            opt.clear_grad()
    for a, b in zip(losses[tq], losses[jq]):
        if isinstance(a, list):
            for ga, gb in zip(a, b):
                np.testing.assert_allclose(ga, gb, atol=FP32_ATOL, rtol=0)
        else:
            assert abs(a - b) <= FP32_ATOL, (a, b)
    assert losses[tq][-2] < losses[tq][0]


def test_qat_weight_quanter_actually_quantizes():
    """Shadows test_quantization.py:80: a 2-bit weight fake-quanter's
    output is what the inner Linear computes with (it differs from fp32
    and equals the JAX package's), and the gradient reaches the weight."""
    outs, grads = {}, {}
    paddle.seed(2)
    jl = jnn.Linear(8, 8)
    tl = ptt.nn.Linear(8, 8, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(_t(_np(jl.weight)))
        tl.bias.copy_(_t(_np(jl.bias)))
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    ref = _run(tl, x)
    for pkg, lin in ((jq, jl), (tq, tl)):
        qlin = pkg.QAT(pkg.QuantConfig(
            activation=None,
            weight=pkg.FakeQuanterWithAbsMaxObserver(quant_bits=2))
        ).quantize(lin)
        outs[pkg] = _run(qlin, x)
        if pkg is tq:
            (qlin(ptt.to_tensor(x, place="cpu")) ** 2).mean().backward()
            grads[pkg] = qlin._inner.weight.grad
        else:
            (qlin(paddle.to_tensor(x)) ** 2).mean().backward()
            grads[pkg] = qlin._inner.weight.grad
    assert not np.allclose(outs[tq], ref, atol=1e-4)
    np.testing.assert_allclose(outs[tq], outs[jq], atol=FP32_ATOL, rtol=0)
    assert grads[tq] is not None and grads[jq] is not None
    np.testing.assert_allclose(grads[tq].numpy(), _np(grads[jq]),
                               atol=FP32_ATOL, rtol=0)


def test_weight_only_int8_equals_jax():
    """Shadows test_quantization.py:39: every Linear becomes a
    QuantedLinear with int8 storage (1 byte an element) byte-equal to the
    JAX package's, outputs within FP32_ATOL of its and within 5% of the
    float model."""
    jm, tm = mlp_pair(3)
    ref = _run(tm, X)
    jw, tw = jq.quantize_weight_only(jm), tq.quantize_weight_only(tm)
    qls = [m for m in tw.modules() if isinstance(m, tq.QuantedLinear)]
    assert len(qls) == 2
    for tl, jl in zip(qls, (jw.fc1, jw.fc2)):
        assert tl.weight_int8.dtype == torch.int8
        assert tl.weight_int8.nbytes == tl.weight_int8.numel()
        np.testing.assert_array_equal(tl.weight_int8.numpy(),
                                      _np(jl.weight_int8))
        np.testing.assert_array_equal(tl.scales.numpy(), _np(jl.scales))
    out = _run(tw, X)
    np.testing.assert_allclose(out, _run(jw, X), atol=FP32_ATOL, rtol=0)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 0.05


# ---------------------------------------------------------------------------
# int8 execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 64), (40, 64)])
def test_int8_exec_linear_int32_product_exact(shape):
    """Shadows test_quantization.py:102: the int8 payload and steps
    byte-equal the JAX package's; the int32 product of the quantized
    activations equals JAX's int8 dot_general exactly, and so the whole
    output (the same f32 rescale); within the quantization error of the
    float Linear."""
    paddle.seed(0)
    jl = jnn.Linear(64, 32)
    tl = ptt.nn.Linear(64, 32, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(_t(_np(jl.weight)))
        tl.bias.copy_(_t(_np(jl.bias)))
    jx_ = jq.Int8ExecLinear(jl)
    tx_ = tq.Int8ExecLinear(tl)
    np.testing.assert_array_equal(tx_.weight_int8.numpy(),
                                  _np(jx_.weight_int8))
    np.testing.assert_array_equal(tx_.steps.numpy(), _np(jx_.steps))
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    step = np.float32(max(np.abs(x).max(), 1e-9)) / np.float32(127.0)
    xq = np.clip(np.round(x / step), -127, 127).astype(np.int8)
    want = jax.lax.dot_general(_j(xq.reshape(-1, 64)),
                               _np(jx_.weight_int8),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq._int_mm(_t(xq.reshape(-1, 64)), tx_.weight_int8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = _run(tx_, x)
    np.testing.assert_array_equal(out, _run(jx_, x))
    ref = _run(tl, x)
    assert np.abs(out - ref).max() < 0.15 * np.abs(ref).max()


def test_int8_exec_matches_fake_quant_sim_and_jax():
    """Shadows test_quantization.py:127: the calibrated int8 execution
    path reproduces the PTQ simulation (same scales) and equals the JAX
    package's int8 path."""
    paddle.seed(1)
    jl = jnn.Linear(32, 16)
    tl = ptt.nn.Linear(32, 16, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(_t(_np(jl.weight)))
        tl.bias.copy_(_t(_np(jl.bias)))
    calib = np.random.RandomState(1).randn(16, 32).astype(np.float32)
    x = np.random.RandomState(2).randn(4, 32).astype(np.float32)
    got = {}
    for pkg, lin in ((jq, jl), (tq, tl)):
        ptq = pkg.PTQ(pkg.QuantConfig(activation=pkg.AbsmaxObserver(),
                                      weight=pkg.AbsmaxObserver()))
        q = ptq.quantize(lin)
        _run(q, calib)
        sim = ptq.convert(q)
        ex = pkg.convert_to_int8_exec(sim)
        assert isinstance(ex, pkg.Int8ExecLinear)
        got[pkg] = (_run(sim, x), _run(ex, x))
    np.testing.assert_allclose(got[tq][1], got[tq][0], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[tq][1], got[jq][1], atol=FP32_ATOL,
                               rtol=0)


def test_dynamic_int8_exec_skips_quant_wrapper_inners():
    """Shadows test_quantization.py:176: dynamic=True leaves a Linear
    owned by a quant wrapper alone (the wrapper reads ._inner.weight),
    and lowers the bare Linears of a GPT block stack: 2 layers x 4."""
    lin = ptt.nn.Linear(8, 8, device="cpu")
    ptq = tq.PTQ(tq.QuantConfig(activation=tq.AbsmaxObserver(),
                                weight=tq.AbsmaxObserver()))
    q = ptq.quantize(lin)
    m = tq.convert_to_int8_exec(q, dynamic=True)
    m(torch.randn(2, 8))
    assert not isinstance(getattr(m, "_inner", None), tq.Int8ExecLinear)
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    torch.manual_seed(2)
    model = GPTForCausalLM(GPTConfig(vocab_size=256, hidden_size=64,
                                     num_layers=2, num_heads=2,
                                     max_seq_len=64), device="cpu")
    model.eval()
    qm = tq.convert_to_int8_exec(model, dynamic=True)
    assert sum(isinstance(l, tq.Int8ExecLinear)
               for l in qm.modules()) == 2 * 4
    ids = torch.as_tensor(np.random.RandomState(3).randint(0, 256, (1, 16)))
    with torch.no_grad():
        lf, lq = model(ids), qm(ids)
    lf, lq = (lf[0] if isinstance(lf, tuple) else lf,
              lq[0] if isinstance(lq, tuple) else lq)
    assert (lf.argmax(-1) == lq.argmax(-1)).float().mean() > 0.8


# ---------------------------------------------------------------------------
# serving knobs
# ---------------------------------------------------------------------------

KNOB_VALUES = [None, False, "", "none", "int8", "int4", "int7", "fp8"]
ENV_VALUES = [None, "int8", "int4", "1", "on", "bogus"]


@pytest.mark.parametrize("env_w", ENV_VALUES)
@pytest.mark.parametrize("env_kv", ENV_VALUES)
def test_resolve_quant_knobs_equal_jax(monkeypatch, env_w, env_kv):
    """Shadows test_quant_serving.py:122: for every knob value and
    environment setting, the port resolves (or refuses with ValueError)
    as the JAX package does."""
    for name, v in (("PADDLE_SERVING_QUANT_WEIGHTS", env_w),
                    ("PADDLE_SERVING_QUANT_KV", env_kv)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    for w in KNOB_VALUES:
        for kv in KNOB_VALUES:
            res = []
            for pkg in (jserving, tserving):
                try:
                    res.append(pkg._resolve_quant_knobs(w, kv))
                except ValueError:
                    res.append("ValueError")
            assert res[0] == res[1], (w, kv, res)


def test_quant_knobs_are_registered():
    from paddle_tpu_torch.core.flags import PADDLE_ENV_KNOBS

    assert {"PADDLE_SERVING_QUANT_WEIGHTS",
            "PADDLE_SERVING_QUANT_KV"} <= PADDLE_ENV_KNOBS
    assert os.environ.get("PADDLE_SERVING_QUANT_WEIGHTS") is None


# ---------------------------------------------------------------------------
# int8 paged-KV ops
# ---------------------------------------------------------------------------

def _kv_case(rs, b, s, h, kvh, d, nb, bs, mb, start):
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = (rs.randn(b, s, kvh, d) * 2).astype(np.float32)
    v = rs.randn(b, s, kvh, d).astype(np.float32)
    kc = rs.randint(-127, 128, (nb, kvh, bs, d)).astype(np.int8)
    vc = rs.randint(-127, 128, (nb, kvh, bs, d)).astype(np.int8)
    ks = rs.rand(nb, bs).astype(np.float32) * 0.02
    vs = rs.rand(nb, bs).astype(np.float32) * 0.02
    bt = rs.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    return q, k, v, kc, ks, vc, vs, bt, np.asarray(start, np.int32)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (4, 1)])
def test_quant_paged_attention_equals_jax(h, kvh):
    """block_attention_quant_gqa_impl against the JAX package's on the
    same pools: payloads and scales byte-equal after the writes, the
    output within FP32_ATOL; the packed MHA form and the registry entry
    too."""
    rs = np.random.RandomState(h * 10 + kvh)
    case = _kv_case(rs, b=3, s=5, h=h, kvh=kvh, d=8, nb=12, bs=4, mb=4,
                    start=[0, 3, 6])
    q, k, v, kc, ks, vc, vs, bt, start = case
    new = np.asarray([5, 4, 2], np.int32)
    jout = jpk.block_attention_quant_gqa_impl(
        *map(_j, (q, k, v, kc, ks, vc, vs, bt, start, new)))
    targs = [_t(a) for a in (q, k, v, kc, ks, vc, vs, bt, start, new)]
    tout = tpk.block_attention_quant_gqa_impl(*targs)
    for name, a, b_ in zip(("kc", "ks", "vc", "vs"), tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_),
                                      err_msg=name)
    assert tout[1] is targs[3] and tout[2] is targs[4]      # in place
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=FP32_ATOL, rtol=0)
    if h == kvh:
        qkv = np.stack([q, k, v], axis=2)
        targs = [_t(a) for a in (qkv, kc, ks, vc, vs, bt, start, new)]
        t2 = tpk.block_multihead_attention_quant(
            targs[0], *targs[1:5], targs[6], targs[7], block_tables=targs[5])
        np.testing.assert_array_equal(t2[0].numpy(), tout[0].numpy())
        for a, b_ in zip(t2[1:], jout[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    else:
        targs = [_t(a) for a in (q, k, v, kc, ks, vc, vs, bt, start, new)]
        t2 = tpk.block_grouped_query_attention_quant(
            *targs[:7], targs[8], targs[9], block_tables=targs[7])
        np.testing.assert_array_equal(t2[0].numpy(), tout[0].numpy())
    assert "block_grouped_query_attention_quant" in ptt.ops.OPS


def test_quant_kv_write_drops_payload_and_scale_together():
    """Positions past a row's table capacity and sentinel table entries
    drop BOTH writes: every pool byte and scale outside the kept
    positions is unchanged, the kept ones equal the JAX package's
    (whose scatter drops with mode="drop")."""
    rs = np.random.RandomState(7)
    nb, bs, kvh, d = 6, 4, 2, 8
    k = (rs.randn(2, 6, kvh, d) * 3).astype(np.float32)
    kc = rs.randint(-127, 128, (nb, kvh, bs, d)).astype(np.int8)
    ks = rs.rand(nb, bs).astype(np.float32)
    # row 0: 2 blocks, start 5 -> positions 5..10, 8..10 past capacity;
    # row 1: its second entry is the sentinel (nb)
    bt = np.asarray([[1, 3], [4, nb]], np.int32)
    start = np.asarray([5, 1], np.int32)
    tkc, tks = _t(kc), _t(ks)
    tpk._write_tokens_quant(tkc, tks, _t(k), _t(bt), _t(start))
    jkc, jks = jpk._write_tokens_quant(_j(kc), _j(ks), _j(k), _j(bt),
                                       _j(start))
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    written = {(1, 1), (1, 2), (1, 3), (3, 0), (3, 1), (3, 2), (3, 3),
               (4, 1), (4, 2), (4, 3)}
    for blk in range(nb):
        for slot in range(bs):
            if (blk, slot) not in written:
                assert tks[blk, slot] == ks[blk, slot]
                np.testing.assert_array_equal(tkc[blk, :, slot].numpy(),
                                              kc[blk, :, slot])
    # every position dropped: nothing changes at all
    tkc, tks = _t(kc), _t(ks)
    tpk._write_tokens_quant(tkc, tks, _t(k), _t(np.full((2, 2), nb,
                                                         np.int32)),
                            _t(start))
    np.testing.assert_array_equal(tkc.numpy(), kc)
    np.testing.assert_array_equal(tks.numpy(), ks)


def test_quantize_kv_and_gather_equal_jax():
    """_quantize_kv (per-token absmax over heads and dims, round half to
    even at exact halves) and _gather_kv_quant byte-equal the JAX
    package's, a zero token included."""
    rs = np.random.RandomState(8)
    vals = (rs.randn(2, 5, 2, 8) * 4).astype(np.float32)
    vals[0, 0] = 0.0
    vals[1, 1, 0, 0] = 127.0                       # absmax 127: step 1
    vals[1, 1, 1, :4] = [0.5, 1.5, 2.5, -0.5]      # exact halves
    vals[1, 1, 1, 4:] = 0.0
    tqv, tst = tpk._quantize_kv(_t(vals))
    jqv, jst = jpk._quantize_kv(_j(vals))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tqv[1, 1, 1, :4].tolist() == [0, 2, 2, 0]
    kc = rs.randint(-127, 128, (5, 2, 4, 8)).astype(np.int8)
    ks = rs.rand(5, 4).astype(np.float32)
    bt = np.asarray([[2, 0], [4, 5]], np.int32)    # 5: clamped
    np.testing.assert_array_equal(
        tpk._gather_kv_quant(_t(kc), _t(ks), _t(bt)).numpy(),
        np.asarray(jpk._gather_kv_quant(_j(kc), _j(ks),
                                        _j(np.minimum(bt, 4)))))
    jp = jpk.init_block_cache_quant(3, 2, 4, 8)
    tp = tpk.init_block_cache_quant(3, 2, 4, 8, device="cpu")
    for a, b_ in zip(tp, jp):
        assert a.dtype == getattr(torch, str(b_.dtype))
        assert tuple(a.shape) == tuple(b_.shape) and not a.any()
    assert (tpk.kv_block_bytes(2, 2, 8, 32, kv_dtype="int8")
            == jpk.kv_block_bytes(2, 2, 8, 32, kv_dtype="int8"))
