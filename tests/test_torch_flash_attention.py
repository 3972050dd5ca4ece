"""The port's native-layout flash attention (plain versions of K4/K5 and
the autograd Functions around them) against the JAX package.

Shadows tests/test_flash_native_layout.py. The CUDA kernels run only on
a card (chip_smoke.py holds them against these plain versions there);
here a CPU tensor runs the plain versions ``_nl_forward_ref`` /
``_nl_backward_ref`` through the same ``torch.autograd.Function``s the
card uses, and each test names what it holds them against:
- the Pallas kernels ``_fwd_nl_single`` / ``_fwd_nl_stream`` /
  ``_bwd_nl_fused`` run in interpret mode through ``fa._flash_nl``,
  ``fa._flash_nl_packed`` and ``fa._nl_forward`` (with
  ``FORCE_PALLAS_INTERPRET`` set by monkeypatch), or
- ``fa._reference_attention`` (the XLA path) where the Pallas kernels
  cannot tile the shape (a ragged S).

Tolerances. fp32: 1e-5 absolute and relative; the two sides sum the same
fp32 terms in other orders (tiles, online rescaling), which the probes
put near 1e-6 at magnitudes 1-4. bf16: 2^-8 of the tensor's largest
value (at most one bf16 ulp of it); both sides round the same fp32
quantities to bf16 (p before P.V, ds before the dk/dq products) and a
value that sits near a rounding boundary may round the other way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import flash_attention as fa
from paddle_tpu_torch import core
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa
from paddle_tpu_torch.testing import flash_tiled

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, \
            f"max err {np.abs(got - want).max()} > {tol}"


def _jax_vjp(fn, args, g):
    out, pull = jax.vjp(fn, *args)
    return out, pull(g)


def _torch_grads(fn, args, g):
    ts = [a.clone().requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(g)
    return out, [t.grad for t in ts]


def _pair(arrs, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,d", [(2, 64), (2, 128)])
def test_flash_nl_plain_matches_pallas_interpret(monkeypatch, h, d, causal):
    """out, lse and dq/dk/dv of `_flash_nl` at S=128 (one K/V block:
    `_fwd_nl_single`; d=64 packs hpb=2 heads per lane block, d=128 one)."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s = 2, 128
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _pair(
        _arrays((b, s, h * d), 4, seed=d + causal), "float32")
    jout, jgrads = _jax_vjp(lambda q, k, v: fa._flash_nl(q, k, v, causal, h),
                            (jq, jk, jv), jg)
    tout, tgrads = _torch_grads(
        lambda q, k, v: tfa._flash_nl(q, k, v, causal, h), (tq, tk, tv), tg)
    _close(tout, jout, "float32")
    for got, want in zip(tgrads, jgrads):
        _close(got, want, "float32")
    _, jlse = fa._nl_forward((jq, jk, jv), (0, 0, 0), b, s, s, h, d, causal)
    _, tlse = tfa._nl_forward_ref(tq, tk, tv, h, causal)
    _close(tlse, jlse.reshape(b, h, s), "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_nl_packed_plain_matches_pallas_interpret(monkeypatch, causal):
    """`_flash_nl_packed` over one [B,S,3E] array and its gradient, the
    packed route GPT training takes (d=64, 4 heads)."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s, h, d = 2, 128, 4, 64
    (jqkv, jg), (tqkv, tg) = _pair(
        _arrays((b, s, 3 * h * d), 1, seed=7) + _arrays((b, s, h * d), 1, 8),
        "float32")
    jout, (jd,) = _jax_vjp(lambda x: fa._flash_nl_packed(x, causal, h),
                           (jqkv,), jg)
    tout, (td,) = _torch_grads(
        lambda x: tfa._flash_nl_packed(x, causal, h), (tqkv,), tg)
    _close(tout, jout, "float32")
    _close(td, jd, "float32")


def test_flash_nl_streaming_plain_matches_pallas_interpret(monkeypatch):
    """S=256 with (128, 64) blocks forced through BLOCK_CACHE: the
    streaming online-softmax forward `_fwd_nl_stream` and a multi-block
    backward sweep."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s, h, d = 1, 256, 2, 64
    keys = (("flash_nl", s, s, d, True), ("flash_nl_bwd", s, s, d, True))
    for key in keys:
        fa.BLOCK_CACHE[key] = (128, 64)
    try:
        (jq, jk, jv, jg), (tq, tk, tv, tg) = _pair(
            _arrays((b, s, h * d), 4, seed=3), "float32")
        jout, jgrads = _jax_vjp(
            lambda q, k, v: fa._flash_nl(q, k, v, True, h), (jq, jk, jv), jg)
        _, jlse = fa._nl_forward((jq, jk, jv), (0, 0, 0), b, s, s, h, d,
                                 True)
    finally:
        for key in keys:
            fa.BLOCK_CACHE.pop(key, None)
    tout, tgrads = _torch_grads(
        lambda q, k, v: tfa._flash_nl(q, k, v, True, h), (tq, tk, tv), tg)
    _close(tout, jout, "float32")
    for got, want in zip(tgrads, jgrads):
        _close(got, want, "float32")
    _close(tfa._nl_forward_ref(tq, tk, tv, h, True)[1],
           jlse.reshape(b, h, s), "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_nl_packed_bf16_plain_matches_pallas_interpret(monkeypatch,
                                                            causal):
    """bf16 inputs: p and ds are cast to bf16 before their products on
    both sides (d=128, the GPT-3 1.3B head width)."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s, h, d = 1, 128, 2, 128
    (jqkv, jg), (tqkv, tg) = _pair(
        _arrays((b, s, 3 * h * d), 1, seed=11) + _arrays((b, s, h * d), 1,
                                                         12), "bfloat16")
    jout, (jd,) = _jax_vjp(lambda x: fa._flash_nl_packed(x, causal, h),
                           (jqkv,), jg)
    tout, (td,) = _torch_grads(
        lambda x: tfa._flash_nl_packed(x, causal, h), (tqkv,), tg)
    assert tout.dtype == td.dtype == torch.bfloat16
    _close(tout, jout, "bfloat16")
    e = h * d
    for i in range(3):
        _close(td[..., i * e:(i + 1) * e], jd[..., i * e:(i + 1) * e],
               "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_nl_plain_ragged_matches_reference_attention(causal):
    """S=77 (no 128-row tiling exists, so the Pallas path cannot run it):
    forward and gradients against `fa._reference_attention`."""
    b, s, h, d = 2, 77, 2, 64
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _pair(
        _arrays((b, s, h * d), 4, seed=77), "float32")

    def ref(q, k, v):
        return fa._reference_attention(
            q.reshape(b, s, h, d), k.reshape(b, s, h, d),
            v.reshape(b, s, h, d), causal).reshape(b, s, h * d)

    jout, jgrads = _jax_vjp(ref, (jq, jk, jv), jg)
    tout, tgrads = _torch_grads(
        lambda q, k, v: tfa._flash_nl(q, k, v, causal, h), (tq, tk, tv), tg)
    _close(tout, jout, "float32")
    for got, want in zip(tgrads, jgrads):
        _close(got, want, "float32")


def test_flash_attention_packed_runs_the_plain_versions_on_cpu():
    """The public entry on a CPU tensor: one plain forward and one plain
    backward per call, no kernel launch."""
    fk, bk = tfa.FLASH_FWD_KERNEL, tfa.FLASH_BWD_KERNEL
    before = (fk.plain_calls, bk.plain_calls, fk.launches, bk.launches)
    qkv = torch.randn(2, 16, 3 * 64, requires_grad=True)
    out = tfa.flash_attention_packed(qkv, 2, causal=True)
    assert out.shape == (2, 16, 64)
    out.sum().backward()
    assert qkv.grad.shape == qkv.shape
    assert (fk.plain_calls, bk.plain_calls, fk.launches, bk.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])


def test_unported_attention_routes_raise(monkeypatch):
    """The dense fallback of `flash_attention_fused` (a head dim outside
    HEAD_DIMS) is a later slice on either FLAGS_flash_native_layout; kv
    heads that do not divide the q heads are an error (grouped query
    itself is ported: tests/test_torch_gqa.py; the head-major route and
    its two-kernel backward: tests/test_torch_flash_hm.py)."""
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_fused(torch.randn(1, 8, 2, 16),
                                  torch.randn(1, 8, 1, 16),
                                  torch.randn(1, 8, 1, 16), True)
    with pytest.raises(ValueError):
        tfa._flash_nl(torch.randn(1, 8, 3 * 32), torch.randn(1, 8, 64),
                      torch.randn(1, 8, 64), True, 3)
    monkeypatch.setitem(core.flags._flags, "flash_native_layout", False)
    with pytest.raises(NotImplementedError, match="dense fallback"):
        tfa.flash_attention_packed(torch.randn(1, 8, 3 * 32), 2, True)
    with pytest.raises(NotImplementedError, match="dense fallback"):
        tfa.flash_attention_fused(torch.randn(1, 8, 4, 16),
                                  torch.randn(1, 8, 2, 16),
                                  torch.randn(1, 8, 2, 16), True)


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers take only CUDA tensors: no CPU fallback."""
    x = torch.randn(1, 8, 64)
    with pytest.raises(ValueError):
        tfa.flash_fwd_cuda(x, x, x, 1, True)
    with pytest.raises(ValueError):
        tfa.flash_bwd_cuda(x, x, x, x, torch.zeros(1, 1, 8), x, 1, True,
                           x, x, x)


# The bf16 kernels' tiled orders (paddle_tpu_torch/testing/flash_tiled.py:
# the forward of csrc/flash_fwd_sm90.cu, K5 on csrc/flash_bwd_sm90.cu's kv
# and dq kernels) in fp32. Cases (B, Sq, Sk, H, KVH, D): MHA at d=32 over
# two q tiles, 32:4, 8:2 at d=128, MQA, Sq < Sk, Sq > Sk (the first rows
# see no key), Sq = 1 and a ragged end past two kv tiles.
TILED_CASES = [(2, 130, 130, 4, 4, 32), (1, 200, 200, 32, 4, 64),
               (2, 77, 77, 8, 2, 128), (1, 150, 150, 4, 1, 64),
               (1, 77, 300, 8, 2, 64), (1, 300, 77, 4, 4, 32),
               (2, 1, 100, 4, 2, 128), (1, 257, 257, 2, 2, 128)]


def _tiled_inputs(b, sq, sk, h, kvh, d, seed):
    rs = np.random.RandomState(seed)
    return [torch.tensor(rs.randn(*shape).astype(np.float32))
            for shape in ((b, sq, h * d), (b, sk, kvh * d), (b, sk, kvh * d),
                          (b, sq, h * d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d", TILED_CASES)
def test_tiled_forward_matches_the_plain_k4(b, sq, sk, h, kvh, d, causal):
    """The bf16 forward's order (q tiles of 128 rows, kv tiles of 128 keys
    at D=128 and 64 at D <= 64 up to `fwd_schedule`'s last live one, the
    softmax in exp2 with the
    scale folded into one multiply-add, P V one tile late) against the
    port's plain K4 `_nl_forward_ref`, fp32. Rows that see no key (causal
    Sq > Sk) give out 0 and lse log(1e-30), as the plain version. 1e-5
    absolute and relative: the same fp32 terms in another order, and
    exp2(x log2 e) for exp(x)."""
    q, k, v, _ = _tiled_inputs(b, sq, sk, h, kvh, d, sq + sk + d)
    out, lse = flash_tiled.forward_tiled(q, k, v, h, causal)
    rout, rlse = tfa._nl_forward_ref(q, k, v, h, causal)
    _close(out, rout, "float32")
    _close(lse, rlse, "float32")
    if causal and sq > sk:
        blind = sq - sk                       # rows before the first key
        assert (out[:, :blind] == 0).all()
        np.testing.assert_allclose(_np(lse[:, :, :blind]), np.log(1e-30),
                                   rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d", TILED_CASES)
def test_tiled_k5_backward_matches_the_plain_k5(b, sq, sk, h, kvh, d,
                                                causal):
    """bf16 K5's order (kv kernel: kv tiles of 128 keys, the group's q
    heads in ascending order, each over its live q tiles of 64 rows last
    first, dK and dV summed over the whole group in registers and written
    once; dq kernel: q tiles of 128 rows over kv tiles in ascending order)
    against the port's plain K5 `_nl_backward_ref`, fp32, on the plain
    forward's out and lse. 1e-5 absolute and relative: the same fp32 terms
    in another order."""
    q, k, v, g = _tiled_inputs(b, sq, sk, h, kvh, d, 3 * sq + sk + d)
    out, lse = tfa._nl_forward_ref(q, k, v, h, causal)
    want = tfa._nl_backward_ref(q, k, v, out, lse, g, h, causal)
    got = flash_tiled.backward_tiled(q, k, v, out, lse, g, h, causal)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        _close(x, y, "float32")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,d", [(2, 64), (2, 128)])
def test_tiled_forward_and_k5_match_pallas_interpret(monkeypatch, h, d,
                                                     causal):
    """The tiled forward and K5 orders against the JAX package's
    `_nl_forward` and `_flash_nl`'s VJP (`_bwd_nl_fused`), the Pallas
    kernels in interpret mode, MHA at S=256 with (128, 64) blocks forced
    (the streaming forward `_fwd_nl_stream`), fp32 at 1e-5 absolute and
    relative."""
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    b, s = 1, 256
    for key in (("flash_nl", s, s, d, causal), ("flash_nl_bwd", s, s, d,
                                                 causal)):
        monkeypatch.setitem(fa.BLOCK_CACHE, key, (128, 64))
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _pair(
        _arrays((b, s, h * d), 4, seed=d + 2 * causal), "float32")
    jout, jlse = fa._nl_forward((jq, jk, jv), (0, 0, 0), b, s, s, h, d,
                                causal)
    _, jgrads = _jax_vjp(lambda q, k, v: fa._flash_nl(q, k, v, causal, h),
                         (jq, jk, jv), jg)
    out, lse = flash_tiled.forward_tiled(tq, tk, tv, h, causal)
    _close(out, jout, "float32")
    _close(lse, jlse.reshape(b, h, s), "float32")
    grads = flash_tiled.backward_tiled(tq, tk, tv, torch.tensor(_np(jout)),
                                       torch.tensor(_np(jlse)).reshape(
                                           b, h, s), tg, h, causal)
    for got, want in zip(grads, jgrads):
        _close(got, want, "float32")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_native_wrappers_route_bf16_and_fp32_to_their_own_kernels(
        monkeypatch, dtype):
    """`flash_fwd_cuda` and `flash_bwd_cuda` launch the warpgroup entries
    (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu) in bf16 and the
    earlier exact-FMA ones (csrc/flash_fwd.cu, csrc/flash_bwd.cu) in fp32,
    each through its own Kernel object: the bf16 entry gets the dtype
    code last, the fp32 entry none. `launch` is recorded, not run, and
    the device check is passed by a tensor that reports a CUDA device."""
    calls = []

    def record(self, device, *args):
        calls.append((self.symbol, self.source.name, args))

    monkeypatch.setattr(type(tfa.FLASH_FWD_KERNEL), "launch", record)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    q = torch.zeros(1, 8, 2 * 64, dtype=dtype)
    lse = torch.zeros(1, 2, 8)
    orig_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        orig_empty(*a, **kw))
    tfa.flash_fwd_cuda(q, q, q, 2, True)
    tfa.flash_bwd_cuda(q, q, q, q, lse, q, 2, True, q, q, q)
    bf16 = dtype == torch.bfloat16
    want = ([("ptt_flash_fwd", "flash_fwd_sm90.cu"),
             ("ptt_flash_bwd", "flash_bwd_sm90.cu")] if bf16 else
            [("ptt_flash_fwd_fp32", "flash_fwd.cu"),
             ("ptt_flash_bwd_fp32", "flash_bwd.cu")])
    assert [c[:2] for c in calls] == want
    for symbol, _, args in calls:
        kernel = next(k for k in (tfa.FLASH_FWD_KERNEL,
                                  tfa.FLASH_FWD_FP32_KERNEL,
                                  tfa.FLASH_BWD_KERNEL,
                                  tfa.FLASH_BWD_FP32_KERNEL)
                      if k.symbol == symbol)
        assert len(args) == len(kernel.argtypes) - 1       # + the stream
        if bf16:
            assert args[-1] == 1                           # ptt::kBFloat16
