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
