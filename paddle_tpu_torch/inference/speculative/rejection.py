"""Host-side acceptance rules for speculative decoding. Counterpart of
paddle_tpu/inference/speculative/rejection.py (copied, numpy).

The continuous session folds acceptance INTO the verify program
(``verify.acceptance_fold``); this module keeps the plain numpy ORACLE
of the same rules — what the device fold must agree with
decision-for-decision when fed the identical uniforms (see
``UniformStream``) — and remains the live accept path for the batch
session and any host-accept fallback. The guarantees read directly:

- greedy: the emitted stream is the target's argmax chain — a draft
  token survives iff it equals the argmax at its position, and the
  first mismatch is replaced by the argmax itself, so speculation on
  or off produces byte-identical tokens.
- sampled: exact rejection sampling (Leviathan et al., "Fast Inference
  from Transformers via Speculative Decoding"). With proposal
  distribution q and target p, draft token d is accepted with
  min(1, p(d)/q(d)); the first rejection resamples from the normalized
  residual max(p - q, 0). The emitted distribution is exactly p at
  every position. Our proposers are deterministic (greedy drafts /
  n-gram lookup), i.e. q is one-hot at d: accept with p(d), and the
  residual is p with p(d) zeroed — still exactly p overall.
"""
from __future__ import annotations

import numpy as np

__all__ = ["UniformStream", "filtered_probs", "greedy_accept",
           "rejection_accept", "sample_from"]


class UniformStream:
    """A np.random.Generator stand-in that replays a FIXED uniform
    sequence — the bridge for oracle tests: draw one row of the device
    fold's [cap] uniforms, feed it here, and ``rejection_accept``
    consumes the exact draws the fused fold consumed (accept tests
    first, terminal draw next), so acceptance decisions and the
    boundary token must match the device outputs exactly."""

    def __init__(self, values):
        self._values = [float(v) for v in np.asarray(values).reshape(-1)]
        self._i = 0

    def random(self) -> float:
        v = self._values[self._i]
        self._i += 1
        return v


def filtered_probs(logits, temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0):
    """numpy mirror of serving.mask_logits' filtering: the probability
    vector(s) the session's categorical draw picks from. logits [..., V]
    -> probs [..., V] (float64)."""
    lv = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = np.partition(lv, -top_k, axis=-1)[..., [-top_k]]
        lv = np.where(lv < kth, -np.inf, lv)
    if top_p < 1.0:
        sorted_desc = -np.sort(-lv, axis=-1)
        e = np.exp(sorted_desc - sorted_desc[..., :1])
        probs = e / e.sum(-1, keepdims=True)
        cum = np.cumsum(probs, axis=-1)
        cutoff_idx = np.sum(cum < top_p, axis=-1, keepdims=True)
        cutoff = np.take_along_axis(sorted_desc, cutoff_idx, axis=-1)
        lv = np.where(lv < cutoff, -np.inf, lv)
    lv = lv - lv.max(-1, keepdims=True)
    e = np.exp(lv)
    return e / e.sum(-1, keepdims=True)


def sample_from(rng, probs) -> int:
    """One categorical draw from a (normalized) probability vector via
    inverse-cdf — robust to float mass not summing to exactly 1."""
    cum = np.cumsum(probs)
    return int(min(np.searchsorted(cum, rng.random() * cum[-1],
                                   side="right"),
                   len(probs) - 1))


def greedy_accept(scores, drafts):
    """(emitted_tokens, n_accepted) for one slot. scores is [m, V]
    logits OR the precomputed argmax chain [m] (a greedy verify program
    computes argmax on device so only m ints cross to host); position j
    conditions on the last committed token plus drafts[:j]; drafts
    [m-1]. Always emits n_accepted + 1 tokens: the accepted draft
    prefix plus either the correction at the first mismatch or the
    bonus token after a fully accepted window."""
    arg = np.asarray(scores)
    if arg.ndim > 1:
        arg = arg.argmax(-1)
    emitted = []
    for j, d in enumerate(np.asarray(drafts).reshape(-1)):
        if int(arg[j]) != int(d):
            emitted.append(int(arg[j]))       # correction; j accepted
            return emitted, j
        emitted.append(int(d))
    emitted.append(int(arg[len(emitted)]))    # bonus token
    return emitted, len(emitted) - 1


def rejection_accept(logits, drafts, rng, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0,
                     draft_probs=None):
    """(emitted_tokens, n_accepted) for one slot under SAMPLED decoding.
    logits [m, V] fp32 target scores; drafts [m-1] proposed tokens;
    draft_probs [m-1, V] is the proposal distribution per position, or
    None for deterministic proposers (one-hot q at the draft token).
    rng is a np.random.Generator — the only entropy source, so pinned
    seeds replay exactly."""
    p = filtered_probs(logits, temperature, top_k, top_p)
    emitted = []
    drafts = np.asarray(drafts).reshape(-1)
    for j, d in enumerate(drafts):
        d = int(d)
        pj = p[j]
        q_d = 1.0 if draft_probs is None else float(draft_probs[j, d])
        if q_d > 0.0 and rng.random() < min(1.0, pj[d] / q_d):
            emitted.append(d)
            continue
        # first rejection: resample from the normalized residual
        if draft_probs is None:
            res = pj.copy()
            res[d] = 0.0
        else:
            res = np.maximum(pj - draft_probs[j], 0.0)
        z = res.sum()
        emitted.append(sample_from(rng, res if z > 0.0 else pj))
        return emitted, j
    emitted.append(sample_from(rng, p[len(drafts)]))    # bonus token
    return emitted, len(drafts)
