"""The dense attention fallback (shapes no kernel takes: head dims
outside 32 / 64 / 128, grouped shapes the ramp cannot take): the port
against the JAX package.

Shadows the dense branches of the JAX package's attention
(``_reference_attention``, ``_attend_hm_reference``). Inputs are numpy
arrays from a seed. Tolerance: 1e-5 relative and 1e-5 of the largest
value absolute, as the fp32 attention checks of
tests/test_torch_flash_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn.functional import flash_attention as jfa
import paddle_tpu_torch as ptt
from paddle_tpu_torch.incubate.nn.functional import flash_attention as tfa


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", [(2, 16, 2, 80, 2), (1, 12, 4, 16, 2),
                                   (1, 12, 6, 32, 4)],
                         ids=["d80", "d16_gqa", "kvh_not_dividing"])
def test_dense_fallback_matches_jax(shape):
    """Shapes no kernel takes (head dims 80 and 16; 4 kv heads against 6
    q heads) run ``_reference_attention`` in both packages: output and
    gradients in fp32, causal; the kernels' plain versions are not
    called. (At 6:4 the grouped contraction has no meaning and both
    packages raise.)"""
    b, s, h, d, kvh = shape
    rs = np.random.RandomState(6)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k, v = (rs.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    if h % kvh:
        with pytest.raises(RuntimeError):
            tfa.flash_attention_fused(*map(torch.tensor, (q, k, v)), True)
        with pytest.raises(TypeError):
            jfa._reference_attention(q, k, v, True)
        return
    g = rs.randn(b, s, h, d).astype(np.float32)
    jout, pull = jax.vjp(lambda *a: jfa._reference_attention(*a, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    fk = tfa.FLASH_FWD_KERNEL
    before = fk.plain_calls
    out = tfa.flash_attention_fused(*ts, True)
    out.backward(torch.tensor(g))
    assert fk.plain_calls == before
    _close(out.detach(), jout, 1e-5)
    for t, want in zip(ts, pull(jnp.asarray(g))):
        _close(t.grad, want, 1e-5)


def test_dense_fallback_routes_agree(monkeypatch):
    """At head dim 80 the packed entry (either FLAGS_flash_native_layout)
    and the whole-block fused op (``_attend_hm_reference``) give the same
    attention as flash_attention_fused; the head-major dense fallback
    matches the JAX package's ``_attend_hm_reference``."""
    rs = np.random.RandomState(7)
    qkv = torch.tensor(rs.randn(2, 16, 3 * 160), dtype=torch.float32)
    want = tfa.flash_attention_fused(
        *(qkv.reshape(2, 16, 3, 2, 80)[:, :, i] for i in range(3)),
        True).reshape(2, 16, 160)
    got = tfa.flash_attention_packed(qkv, 2, True)
    assert torch.equal(got, want)
    monkeypatch.setitem(ptt.core.flags._flags, "flash_native_layout", False)
    assert torch.equal(tfa.flash_attention_packed(qkv, 2, True), want)
    qh, kh, vh = (rs.randn(4, 16, 80).astype(np.float32) for _ in range(3))
    _close(tfa._attend_hm_reference(*map(torch.tensor, (qh, kh, vh)), True),
           jfa._attend_hm_reference(qh, kh, vh, True), 1e-5)
