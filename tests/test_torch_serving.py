"""The port's GenerationSession against the JAX package's.

Shadows tests/test_paged_kv.py (AOT session parity, ragged prompts, eos
trimming), tests/test_gqa_native.py (Llama-GQA through the session) and
tests/test_prefix_cache.py (batch-repeated-prompt shared prefill). With
the same weights (bridge.load_jax_state) and prompts, greedy token
streams must be byte-identical. Sampled streams cannot match JAX's bit
for bit (threefry against Philox draws): the masking rules are held
exactly on equal logits, and a sampled port session is held to one
stream per seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.inference import serving as tserving

from test_torch_models import make_pair

FAMILIES = ["llama", "gpt"]


def _np(out):
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


def _prompts(b, s, seed):
    return np.random.RandomState(seed).randint(1, 1000, (b, s)).astype(
        np.int64)


@pytest.mark.parametrize("family", FAMILIES)
def test_fixed_prompt_greedy_streams_equal_jax(family):
    jm, tm = make_pair(family)
    ids = _prompts(3, 10, seed=1)
    kw = dict(batch=3, prompt_len=10, max_new_tokens=8, kv_block_size=4)
    want = _np(jserving.GenerationSession(jm, **kw).generate(ids))
    got = tserving.GenerationSession(tm, **kw).generate(ids)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 18)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_ragged_prompt_greedy_streams_equal_jax(family):
    jm, tm = make_pair(family, seed=21)
    ids = _prompts(3, 12, seed=7)
    lens = np.array([5, 12, 9])
    for r, n in enumerate(lens):
        ids[r, n:] = 0                           # right padding
    kw = dict(batch=3, prompt_len=12, max_new_tokens=6, kv_block_size=4,
              ragged_prompts=True)
    want = _np(jserving.GenerationSession(jm, **kw).generate(
        ids, prompt_lens=lens))
    got = tserving.GenerationSession(tm, **kw).generate(
        ids, prompt_lens=lens)
    assert tuple(got.shape) == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_shared_prefill_greedy_streams_equal_jax(family):
    """A batch of identical prompts takes the shared batch-1 prefill with
    a copy-on-write tail block (prompt 10 over blocks of 4), in both
    packages, and equals the unshared port session."""
    jm, tm = make_pair(family, seed=12)
    rep = np.tile(_prompts(1, 10, seed=7), (3, 1))
    kw = dict(batch=3, prompt_len=10, max_new_tokens=6, kv_block_size=4)
    jsess = jserving.GenerationSession(jm, **kw)
    want = _np(jsess.generate(rep))
    assert jsess._prefill_shared is not None
    tsess = tserving.GenerationSession(tm, **kw)
    got = tsess.generate(rep)
    assert tsess._shared_plan is not None            # shared path taken
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tserving.GenerationSession(tm, prefix_sharing=False, **kw)
    np.testing.assert_array_equal(plain.generate(rep).numpy(), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_eos_trim_equals_jax(family):
    """model.generate(use_paged_kv=True) with an eos that the stream
    emits at its third step: both packages trim after it."""
    jm, tm = make_pair(family, seed=11)
    ids = _prompts(1, 6, seed=2)
    kw = dict(max_new_tokens=8, use_paged_kv=True, kv_block_size=4)
    probe = tm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(probe, _np(jm.generate(ids, **kw)))
    eos = int(probe[0, 8])
    want = _np(jm.generate(ids, eos_token_id=eos, **kw))
    got = tm.generate(ids, eos_token_id=eos, **kw)
    assert got.shape[1] < probe.shape[1]
    np.testing.assert_array_equal(got.numpy(), want)


def test_aot_generate_reuses_sessions_per_shape_class():
    _, tm = make_pair("gpt", seed=3)
    ids = _prompts(2, 8, seed=1)
    a = tm.generate(ids, max_new_tokens=4, use_paged_kv=True,
                    kv_block_size=8)
    b = tm.generate(_prompts(2, 8, seed=2), max_new_tokens=4,
                    use_paged_kv=True, kv_block_size=8)
    assert len(tm._serving_sessions) == 1
    assert a.shape == b.shape == (2, 12)
    same = tm.generate(ids, max_new_tokens=0, use_paged_kv=True)
    assert same is ids


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (7, 0.6)])
def test_sample_logits_masks_equal_jax(monkeypatch, top_k, top_p):
    """The reference's masking with its categorical draw replaced by the
    identity returns the masked logits; the port's mask_logits must give
    the same -inf pattern and values."""
    lv = np.random.RandomState(top_k).randn(4, 64).astype(np.float32) * 3
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: logits)
    want = np.asarray(jserving.sample_logits(
        jnp.asarray(lv), jax.random.PRNGKey(0), True, 0.7, top_k, top_p))
    got = tserving.mask_logits(torch.tensor(lv), 0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sample_logits_draws_only_unmasked_tokens():
    lv = torch.tensor(np.random.RandomState(0).randn(8, 64), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    kept = torch.isfinite(tserving.mask_logits(lv, 1.0, 3, 1.0))
    for _ in range(20):
        tok = tserving.sample_logits(lv, g, True, 1.0, 3, 1.0)
        assert kept[torch.arange(8), tok].all()
    assert torch.equal(tserving.sample_logits(lv, g, False),
                       torch.argmax(lv, dim=-1))


@pytest.mark.parametrize("family", FAMILIES)
def test_sampled_port_session_is_deterministic_per_seed(family):
    _, tm = make_pair(family, seed=5)
    ids = _prompts(2, 8, seed=3)
    kw = dict(batch=2, prompt_len=8, max_new_tokens=8, kv_block_size=4,
              do_sample=True, temperature=0.9, top_k=20, top_p=0.95)
    sess = tserving.GenerationSession(tm, **kw)
    a = sess.generate(ids, seed=3)
    b = tserving.GenerationSession(tm, **kw).generate(ids, seed=3)
    c = sess.generate(ids, seed=4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    # the shared-prefill path draws the same stream as the plain one
    rep = np.tile(ids[:1], (2, 1))
    shared = sess.generate(rep, seed=7)
    plain = tserving.GenerationSession(tm, prefix_sharing=False,
                                       **kw).generate(rep, seed=7)
    np.testing.assert_array_equal(shared.numpy(), plain.numpy())
