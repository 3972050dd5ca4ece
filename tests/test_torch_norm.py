"""The port's norm kernels' plain versions against the JAX package.

Shadows tests/test_pallas_norm.py (LayerNorm kernel in interpret mode)
and the RMSNorm checks of tests/test_fused_ops.py. The CUDA kernels
themselves run only on a card: chip_smoke.py holds them against these
plain versions there. Here the plain versions (what a CPU tensor runs)
are held against the JAX references ``_rms_norm_ref`` / ``_ln_ref`` and
against the Pallas kernel bodies run in interpret mode.

Tolerances: fp32 1e-5 (the two frameworks sum a row in different
orders); bf16 one ulp of the output (an fp32 difference in the last bit
can round the other way).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import fused_ops as jfused
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu_torch.incubate.nn.functional import fused_ops as tfused
from paddle_tpu_torch.nn.functional import norm as tnorm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, d, dtype, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, d).astype(np.float32) * 2.0 + 0.5
    w = rng.randn(d).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    to_j = lambda a: jnp.asarray(a, jdt)
    to_t = lambda a: torch.tensor(a).to(tdt)
    return (to_j(x), to_j(w), to_j(b)), (to_t(x), to_t(w), to_t(b))


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    # one bf16 ulp at the reference's magnitude (8 significant bits)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), \
        f"max err {np.max(np.abs(got - want))}"


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(16, 256), (5, 128), (13, 200)])
def test_rms_norm_plain_matches_jax_ref(rows, d, dtype):
    (jx, jw, _), (tx, tw, _) = _inputs(rows, d, dtype, seed=rows + d)
    want = jfused._rms_norm_ref(jx, jw, None, 1e-6)
    got = tfused._rms_norm_ref(tx, tw, 1e-6)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(_np(got), _np(want), dtype)


def _rms_pallas_interpret(x, w, eps):
    """The Pallas kernel body `_rms_norm_kernel` under the BlockSpecs of
    `_rms_norm_pallas`, run in interpret mode (`_rms_norm_pallas` itself
    passes no interpret flag)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rows, d = x.shape
    block_rows = 256 if rows % 256 == 0 else (8 if rows % 8 == 0 else rows)
    return pl.pallas_call(
        functools.partial(jfused._rms_norm_kernel, epsilon=eps),
        grid=(rows // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((d,), lambda i: (0,),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((block_rows, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, d), x.dtype),
        interpret=True)(x, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_pallas_kernel_interpret(dtype):
    (jx, jw, _), (tx, tw, _) = _inputs(16, 256, dtype, seed=3)
    want = _rms_pallas_interpret(jx, jw, 1e-6)
    got = tfused._rms_norm_ref(tx, tw, 1e-6)
    _assert_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_wb", [True, False])
@pytest.mark.parametrize("rows,d", [(16, 256), (5, 128), (13, 200)])
def test_layer_norm_plain_matches_jax_ref(rows, d, with_wb, dtype):
    (jx, jw, jb), (tx, tw, tb) = _inputs(rows, d, dtype, seed=rows * d)
    if not with_wb:
        jw = jb = tw = tb = None
    want = jnorm._ln_ref(jx, jw, jb, 1e-5, (1,))
    got = tnorm._ln_ref(tx, tw, tb, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_wb", [True, False])
def test_layer_norm_plain_matches_pallas_kernel_interpret(
        monkeypatch, with_wb, dtype):
    monkeypatch.setattr(jnorm, "FORCE_PALLAS_INTERPRET", True)
    (jx, jw, jb), (tx, tw, tb) = _inputs(24, 256, dtype, seed=11)
    if not with_wb:
        jw = jb = tw = tb = None
    want = jnorm._ln_pallas(jx, jw, jb, 1e-5)
    got = tnorm._ln_ref(tx, tw, tb, 1e-5)
    _assert_close(_np(got), _np(want), dtype)


def test_functionals_take_the_plain_version_on_cpu():
    """A CPU tensor runs the plain version (counted), keeps any leading
    shape, and never reaches a kernel launch."""
    (_, _, _), (tx, tw, tb) = _inputs(6, 64, "float32", seed=5)
    x3 = tx.reshape(2, 3, 64)
    rk, lk = tfused.RMS_NORM_KERNEL, tnorm.LAYER_NORM_KERNEL
    r0, l0, rl, ll = rk.plain_calls, lk.plain_calls, rk.launches, lk.launches
    y = tfused.fused_rms_norm(x3, tw, epsilon=1e-6)
    z = tnorm.layer_norm(x3, 64, tw, tb, 1e-5)
    assert y.shape == z.shape == (2, 3, 64)
    torch.testing.assert_close(y.reshape(6, 64),
                               tfused._rms_norm_ref(tx, tw, 1e-6))
    assert (rk.plain_calls, lk.plain_calls) == (r0 + 2, l0 + 1)
    assert (rk.launches, lk.launches) == (rl, ll)


def test_kernel_wrappers_reject_cpu_tensors():
    """The kernel wrappers take only CUDA tensors: no CPU fallback."""
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        tfused.rms_norm_cuda(x, torch.ones(8), 1e-6)
    with pytest.raises(ValueError):
        tnorm.layer_norm_cuda(x, None, None, 1e-5)


# -- backward: K3's plain version and the autograd Functions ---------------
# Shadows the backward checks of tests/test_pallas_norm.py. Tolerances as
# above for dx; dw/db sum over rows, so fp32 allows 1e-5 of the largest
# value and bf16 one ulp of it (the sums run in other orders).

def _assert_sum_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        tol = 2.0 ** -8 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_bwd_plain_matches_pallas_kernel_interpret(monkeypatch,
                                                              dtype):
    """`_ln_bwd_ref` against `_ln_bwd_pallas` (the `_ln_bwd_kernel` body)
    in interpret mode: dx, dw, db."""
    monkeypatch.setattr(jnorm, "FORCE_PALLAS_INTERPRET", True)
    (jx, jw, _), (tx, tw, _) = _inputs(24, 256, dtype, seed=21)
    (jg, _, _), (tg, _, _) = _inputs(24, 256, dtype, seed=22)
    jdx, jdw, jdb = jnorm._ln_bwd_pallas(jx, jw, jg, 1e-5)
    tdx, tdw, tdb = tnorm._ln_bwd_ref(tx, tw, tg, 1e-5)
    assert tdx.dtype == tdw.dtype == tdb.dtype == DTYPES[dtype][1]
    _assert_close(_np(tdx), _np(jdx), dtype)
    _assert_sum_close(_np(tdw), _np(jdw), dtype)
    _assert_sum_close(_np(tdb), _np(jdb), dtype)


def _jax_pull(fn, args, g):
    _, pull = jax.vjp(fn, *args)
    return pull(g)


def _torch_pull(fn, args, g):
    ts = [a.clone().requires_grad_() for a in args]
    fn(*ts).backward(g)
    return [t.grad for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_function_grads_match_jax_custom_vjp(monkeypatch, dtype):
    """x, weight and bias gradients through the port's `layer_norm`
    Function (the dispatch a card takes, with the plain versions on the
    CPU) against the JAX package's `_ln_fused` custom VJP, whose backward
    is `_ln_bwd_pallas` in interpret mode."""
    monkeypatch.setattr(jnorm, "FORCE_PALLAS_INTERPRET", True)
    (jx, jw, jb), (tx, tw, tb) = _inputs(16, 128, dtype, seed=31)
    (jg, _, _), (tg, _, _) = _inputs(16, 128, dtype, seed=32)
    jgrads = _jax_pull(
        lambda x, w, b: jnorm._ln_fused(x, w, b, 1e-5, (1,), True, True),
        (jx, jw, jb), jg)
    tgrads = _torch_pull(lambda x, w, b: tnorm.layer_norm(x, 128, w, b),
                         (tx, tw, tb), tg)
    _assert_close(_np(tgrads[0]), _np(jgrads[0]), dtype)
    for got, want in zip(tgrads[1:], jgrads[1:]):
        assert got.dtype == DTYPES[dtype][1]
        _assert_sum_close(_np(got), _np(want), dtype)


def test_layer_norm_function_without_params_grads_match_jax():
    """No weight or bias: dx alone, against the JAX vjp of `_ln_ref`."""
    (jx, _, _), (tx, _, _) = _inputs(12, 96, "float32", seed=41)
    (jg, _, _), (tg, _, _) = _inputs(12, 96, "float32", seed=42)
    (jdx,) = _jax_pull(lambda x: jnorm._ln_ref(x, None, None, 1e-5, (1,)),
                       (jx,), jg)
    (tdx,) = _torch_pull(lambda x: tnorm.layer_norm(x, 96), (tx,), tg)
    _assert_close(_np(tdx), _np(jdx), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_function_grads_match_jax_vjp(dtype):
    """x and weight gradients through the port's `fused_rms_norm`
    Function against `jax.vjp` of `_rms_norm_ref` (the JAX package's
    `_rms_bwd`)."""
    (jx, jw, _), (tx, tw, _) = _inputs(16, 256, dtype, seed=51)
    (jg, _, _), (tg, _, _) = _inputs(16, 256, dtype, seed=52)
    jdx, jdw = _jax_pull(lambda x, w: jfused._rms_norm_ref(x, w, None, 1e-6),
                         (jx, jw), jg)
    tdx, tdw = _torch_pull(
        lambda x, w: tfused.fused_rms_norm(x, w, epsilon=1e-6), (tx, tw), tg)
    assert tdx.dtype == tdw.dtype == DTYPES[dtype][1]
    _assert_close(_np(tdx), _np(jdx), dtype)
    _assert_sum_close(_np(tdw), _np(jdw), dtype)


def test_norm_backward_runs_the_plain_version_on_cpu():
    """On a CPU tensor the LayerNorm Function's backward is `_ln_bwd_ref`
    (counted); no kernel is launched."""
    bk = tnorm.LAYER_NORM_BWD_KERNEL
    before = (bk.plain_calls, bk.launches)
    x = torch.randn(3, 5, 32, requires_grad=True)
    w = torch.randn(32, requires_grad=True)
    b = torch.randn(32, requires_grad=True)
    tnorm.layer_norm(x, 32, w, b).square().sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == b.grad.shape == (32,)
    assert (bk.plain_calls, bk.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError):
        tnorm.layer_norm_bwd_cuda(x.detach().reshape(15, 32), None,
                                  x.detach().reshape(15, 32), 1e-5)
