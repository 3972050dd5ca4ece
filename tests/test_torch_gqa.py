"""The port's grouped-query attention against the JAX package's.

Shadows tests/test_gqa_native.py and the sdpa dispatch test of
tests/test_flash_native_layout.py. The CUDA kernels run only on a card
(chip_smoke.py holds them against these plain versions there); here a
CPU tensor runs the plain versions ``_nl_forward_ref`` /
``_nl_backward_ref`` through the same ``torch.autograd.Function`` the card
uses, and each test names what it holds them against:
- the Pallas kernels ``_fwd_nl_single`` / ``_fwd_nl_stream`` /
  ``_bwd_nl_fused`` run in interpret mode through ``fa._flash_nl``
  (``FORCE_PALLAS_INTERPRET`` set by monkeypatch), whose grouped backward
  folds the expanded per-q-head dk/dv onto the kv heads, or
- ``fa._reference_attention`` / the JAX ``_sdpa`` (XLA) where the Pallas
  kernels do not take the shape (MQA at d=64, a mask, d=16).

Tolerances. fp32: 1e-5 absolute and relative; both sides sum the same
fp32 terms in other orders (tiles, online rescaling, the grouped dk/dv
over H/KVH heads), which the probes put below 2e-6 at magnitudes 1-30.
bf16: 2^-8 of the tensor's largest value (at most one bf16 ulp of it);
both sides round the same fp32 quantities to bf16 (p before P.V and dV,
ds before dK and dQ) and a value near a rounding boundary may round the
other way. Grouped bf16 dk and dv add, per element, 2^-8 of the sum of
the magnitudes of the H/KVH per-q-head terms: the JAX kernel writes those
terms at the expanded width in bf16 (each rounded, by up to half an ulp,
at most 2^-8 of itself) and folds them outside the kernel, where the
port sums them in fp32 and rounds once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.nn.functional import flash_attention as fa
from paddle_tpu.incubate.nn.functional import fused_ops as jfused
import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.incubate.nn.functional import fused_ops as tfused

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mk(b, sq, sk, h, kvh, d, seed, dtype="float32"):
    """(jax arrays, torch tensors) of q [B,Sq,H*D], k, v [B,Sk,KVH*D] and
    an output gradient [B,Sq,H*D], from numpy."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(b, sq, h * d), rs.randn(b, sk, kvh * d),
            rs.randn(b, sk, kvh * d), rs.randn(b, sq, h * d)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a.astype(np.float32), jdt) for a in arrs],
            [torch.tensor(a.astype(np.float32)).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32", folded=0.0):
    """``folded``: per element, the summed magnitudes of the bf16 terms
    the JAX side rounded before its grouped fold (bf16 only)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -8 * (np.abs(want).max() + folded)
        err = np.abs(got - want)
        assert (err <= tol).all(), \
            f"max err {err.max()}, worst over tolerance {(err - tol).max()}"


def _port_grads(h, causal, tq, tk, tv, tg):
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tfa._flash_nl(*ts, causal, h)
    out.backward(tg)
    return out, [t.grad for t in ts]


def _pallas_vs_plain(h, kvh, d, causal, b=2, s=128, seed=0,
                     dtype="float32"):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _mk(b, s, s, h, kvh, d, seed,
                                             dtype)
    jout, pull = jax.vjp(lambda q, k, v: fa._flash_nl(q, k, v, causal, h),
                         jq, jk, jv)
    tout, tgrads = _port_grads(h, causal, tq, tk, tv, tg)
    jo, jlse = fa._nl_forward((jq, jk, jv), (0, 0, 0), b, s, s, h, d, causal,
                              kvh=kvh)
    # the JAX kernel's dk, dv at the expanded width, before its fold
    _, jdk, jdv = fa._nl_backward((jq, jk, jv), (0, 0, 0), jo, jlse, jg, b,
                                  s, s, h, d, causal, kvh=kvh)
    folded = [0.0] + [np.abs(_np(x)).reshape(b, s, kvh, h // kvh, d).sum(
        3).reshape(b, s, kvh * d) for x in (jdk, jdv)]
    _close(tout, jout, dtype)
    for got, want, f in zip(tgrads, pull(jg), folded):
        _close(got, want, dtype, f)
    assert tgrads[1].shape == tk.shape and tgrads[2].shape == tv.shape
    _close(tfa._nl_forward_ref(tq, tk, tv, h, causal)[1],
           jlse.reshape(b, h, s))


@pytest.mark.parametrize("h,kvh", [(16, 2), (8, 2)])  # 8:1 and 4:1
@pytest.mark.parametrize("causal", [False, True])
def test_grouped_plain_matches_pallas_interpret(monkeypatch, h, kvh, causal):
    """Shadows test_gqa_native.py::test_nl_gqa_kernels_match_dense: out,
    lse and dq/dk/dv at d=64, S=128 (one K/V block, `_fwd_nl_single`)."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    assert fa._nl_ok(2, 128, 128, h, 64, kvh=kvh)
    _pallas_vs_plain(h, kvh, 64, causal)


def test_grouped_plain_matches_pallas_interpret_streaming(monkeypatch):
    """Shadows test_nl_gqa_streaming_path: S=256 with (128, 64) blocks
    forced through BLOCK_CACHE, so the forward is `_fwd_nl_stream` and the
    backward sweeps several blocks (8:2, causal)."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    s, d = 256, 64
    keys = (("flash_nl", s, s, d, True), ("flash_nl_bwd", s, s, d, True))
    for key in keys:
        monkeypatch.setitem(fa.BLOCK_CACHE, key, (128, 64))
    _pallas_vs_plain(8, 2, d, True, b=1, s=s, seed=3)


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_plain_matches_pallas_interpret_small_group(monkeypatch,
                                                            causal):
    """Shadows test_nl_gqa_small_group_branch: rep 2 below the TPU's four
    heads per lane block (d=32, 8:4), the per-head select branch."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    assert fa._nl_ok(1, 128, 128, 8, 32, kvh=4)
    _pallas_vs_plain(8, 4, 32, causal, b=1, seed=5)


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_plain_bf16_matches_pallas_interpret(monkeypatch, causal):
    """bf16 at 8:2, d=64: p and ds are cast to bf16 before their products
    on both sides, and dk/dv sum four q heads' terms."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    _pallas_vs_plain(8, 2, 64, causal, b=1, seed=8, dtype="bfloat16")


@pytest.mark.parametrize("causal", [False, True])
def test_mqa_and_ragged_plain_match_reference_attention(causal):
    """MQA (4:1 at d=64, which the TPU kernels reach only through a
    kv-sized repeat) and a ragged Sq=77 against Sk=100 (8:2), through the
    native route here: against `fa._reference_attention` (XLA)."""
    for b, sq, sk, h, kvh, d, seed in ((1, 128, 128, 4, 1, 64, 11),
                                       (2, 77, 100, 8, 2, 32, 12)):
        (jq, jk, jv, jg), (tq, tk, tv, tg) = _mk(b, sq, sk, h, kvh, d, seed)

        def ref(q, k, v):
            return fa._reference_attention(
                q.reshape(b, sq, h, d), k.reshape(b, sk, kvh, d),
                v.reshape(b, sk, kvh, d), causal).reshape(b, sq, h * d)

        jout, pull = jax.vjp(ref, jq, jk, jv)
        tout, tgrads = _port_grads(h, causal, tq, tk, tv, tg)
        _close(tout, jout)
        for got, want in zip(tgrads, pull(jg)):
            _close(got, want)


def test_grouped_plain_route_never_repeats_k_or_v():
    """The north star's no-K/V-repeat contract on the plain route: a
    forward and backward at 8:1 call no repeat, repeat_interleave,
    expand, tile or broadcast_to, and no intermediate the size of k
    repeated to the q heads is made from k or v."""
    calls = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            calls.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    _, (tq, tk, tv, tg) = _mk(1, 64, 64, 16, 2, 32, seed=4)
    tk.requires_grad_()
    tv.requires_grad_()
    with Spy():
        out = tfa._flash_nl(tq, tk, tv, True, 16)
        out.backward(tg)
    assert calls, "the spy saw no torch call"
    banned = {"repeat", "repeat_interleave", "expand", "expand_as", "tile",
              "broadcast_to"}
    assert not banned & set(calls), sorted(banned & set(calls))
    assert tk.grad.shape == tk.shape and tv.grad.shape == tv.shape


def test_sdpa_gqa_routes_through_flash_and_matches_jax(monkeypatch):
    """Shadows test_flash_native_layout.py::
    test_gqa_routes_through_flash_and_matches_reference and
    test_gqa_native.py::test_mqa_keeps_flash_via_repeat_ramp: sdpa at 4:2
    and MQA 4:1 (d=64) reaches the flash Function (one plain forward and
    one plain backward here) and matches the JAX sdpa on its flash path
    (Pallas in interpret mode), forward and gradients."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    fk, bk = tfa.FLASH_FWD_KERNEL, tfa.FLASH_BWD_KERNEL
    for kvh, seed in ((2, 9), (1, 10)):
        b, s, h, d = 1, 128, 4, 64
        rs = np.random.RandomState(seed)
        q = rs.randn(b, s, h, d).astype(np.float32)
        k = rs.randn(b, s, kvh, d).astype(np.float32)
        v = rs.randn(b, s, kvh, d).astype(np.float32)
        g = rs.randn(b, s, h, d).astype(np.float32)

        def jsdpa(q_, k_, v_):
            out = JF.scaled_dot_product_attention(
                paddle.to_tensor(q_), paddle.to_tensor(k_),
                paddle.to_tensor(v_), is_causal=True)
            return out._value

        jout, pull = jax.vjp(jsdpa, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v))
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        before = (fk.plain_calls, bk.plain_calls)
        tout = ptt.nn.functional.scaled_dot_product_attention(
            *ts, is_causal=True)
        tout.backward(torch.tensor(g))
        assert (fk.plain_calls, bk.plain_calls) == (before[0] + 1,
                                                    before[1] + 1)
        _close(tout, jout)
        for t, want in zip(ts, pull(jnp.asarray(g))):
            _close(t.grad, want)


def test_sdpa_gqa_with_mask_is_grouped():
    """Shadows test_gqa_native.py::test_sdpa_gqa_with_mask_is_grouped: a
    mask (and d=16) sends sdpa to the dense `_sdpa` in plain torch, which
    contracts q grouped against the shared kv heads: against the JAX
    `_sdpa`, forward and gradients, with no flash call."""
    b, s, h, kvh, d = 2, 32, 8, 2, 16
    rs = np.random.RandomState(7)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, kvh, d).astype(np.float32)
    v = rs.randn(b, s, kvh, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    mask = np.broadcast_to(np.tril(np.ones((s, s), bool))[None, None],
                           (b, 1, s, s)).copy()

    def jsdpa(q_, k_, v_):
        return JF.scaled_dot_product_attention(
            paddle.to_tensor(q_), paddle.to_tensor(k_), paddle.to_tensor(v_),
            attn_mask=paddle.to_tensor(mask))._value

    jout, pull = jax.vjp(jsdpa, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    fk = tfa.FLASH_FWD_KERNEL
    before = fk.plain_calls
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tout = ptt.nn.functional.scaled_dot_product_attention(
        *ts, attn_mask=torch.tensor(mask))
    tout.backward(torch.tensor(g))
    assert fk.plain_calls == before
    _close(tout, jout)
    for t, want in zip(ts, pull(jnp.asarray(g))):
        _close(t.grad, want)


def test_sdpa_training_dropout_raises():
    x = torch.randn(1, 8, 2, 32)
    with pytest.raises(NotImplementedError):
        ptt.nn.functional.scaled_dot_product_attention(
            x, x[:, :, :1], x[:, :, :1], dropout_p=0.1, training=True)


@pytest.mark.parametrize("pos_offset", [0, 5])
def test_rope_pos_offset_matches_jax(pos_offset):
    """The no-cache rope (positions pos_offset + arange(S), one table for
    the batch) against the JAX package's, and against the position_ids
    path at the same positions; q with 4 heads, k with 2."""
    rs = np.random.RandomState(13)
    q = rs.randn(2, 16, 4, 32).astype(np.float32)
    k = rs.randn(2, 16, 2, 32).astype(np.float32)
    jq, jk = jfused.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k), theta=500.0,
        pos_offset=pos_offset)
    tq, tk = tfused.fused_rotary_position_embedding(
        torch.tensor(q), torch.tensor(k), theta=500.0, pos_offset=pos_offset)
    _close(tq, jq.numpy())
    _close(tk, jk.numpy())
    ids = torch.arange(16)[None, :].expand(2, 16) + pos_offset
    pq, pk = tfused.fused_rotary_position_embedding(
        torch.tensor(q), torch.tensor(k), theta=500.0, position_ids=ids)
    torch.testing.assert_close(pq, tq, rtol=0, atol=0)
    torch.testing.assert_close(pk, tk, rtol=0, atol=0)


@pytest.mark.parametrize("h,kvh,d", [(16, 2, 64), (8, 2, 64), (8, 4, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_grouped_tiled_orders_match_pallas_interpret(monkeypatch, h, kvh, d,
                                                     causal):
    """The bf16 kernels' grouped orders (paddle_tpu_torch/testing/
    flash_tiled.py): the forward, whose CTA reads kv head h // rep in
    place, against the JAX `_nl_forward` (out, lse); and K5, whose kv
    kernel sums dK and dV over the group's q heads in ascending order in
    one pass and writes them once at the kv width, against `_flash_nl`'s
    VJP (`_bwd_nl_fused` at the expanded width, then the fold of
    `_flash_nl_bwd`); Pallas in interpret mode, S=128, fp32 at 1e-5
    absolute and relative (the same fp32 terms summed in other orders)."""
    from paddle_tpu_torch.testing import flash_tiled

    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s = 1, 128
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _mk(b, s, s, h, kvh, d,
                                             seed=h + kvh + d + causal)
    jout, jlse = fa._nl_forward((jq, jk, jv), (0, 0, 0), b, s, s, h, d,
                                causal, kvh=kvh)
    _, pull = jax.vjp(lambda q, k, v: fa._flash_nl(q, k, v, causal, h),
                      jq, jk, jv)
    out, lse = flash_tiled.forward_tiled(tq, tk, tv, h, causal)
    _close(out, jout)
    _close(lse, jlse.reshape(b, h, s))
    grads = flash_tiled.backward_tiled(
        tq, tk, tv, torch.tensor(_np(jout)),
        torch.tensor(_np(jlse)).reshape(b, h, s), tg, h, causal)
    for got, want in zip(grads, pull(jg)):
        assert got.shape == tuple(want.shape)
        _close(got, want)
