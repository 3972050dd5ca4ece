"""Activation recomputation (gradient checkpointing). Counterpart of
paddle_tpu/distributed/fleet/recompute.py (parity:
python/paddle/distributed/fleet/recompute/recompute.py).

``recompute(function, *args)`` runs ``function`` now and keeps only its
inputs; the backward runs it again to rebuild what its gradients need.
This is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
where the JAX package wraps the block in ``jax.checkpoint``, with the
port's own forward-time state carried into the second run, which happens
inside ``loss.backward()`` (after ``amp.auto_cast`` has exited, and on
the autograd engine's thread):
- the amp state (``amp/state.py``, thread-local, not ``torch.autocast``,
  which is the only amp state torch's checkpoint restores);
- every FLAG (the attention route reads ``flash_native_layout`` and
  ``use_fused_attention``);
- the dropout streams (``core.generator.rng_tracker``: explicit
  generators, which ``preserve_rng_state`` does not save), so the second
  run draws the same masks, as ``jax.checkpoint`` replays its key.
Each is restored to its value at the time of the backward afterwards.
The second run gives the forward's values bit for bit (the kernels are
deterministic), so gradients with and without recompute are equal.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ...amp import state as amp_state
from ...core.flags import get_flags, set_flags
from ...core.generator import rng_tracker


def _replay(function, args, kwargs, amp, flags, rng):
    """``function(*args, **kwargs)`` under the forward's amp state, flags
    and (``rng`` not None) dropout streams, each restored after."""
    prev = amp_state.current_amp(), get_flags(), rng_tracker.get_state()
    amp_state.restore_amp(amp)
    set_flags(flags)
    if rng is not None:
        rng_tracker.set_state(rng)
    try:
        return function(*args, **kwargs)
    finally:
        amp_state.restore_amp(prev[0])
        set_flags(prev[1])
        rng_tracker.set_state(prev[2])


def recompute(function, *args, preserve_rng_state=True, use_reentrant=None,
              **kwargs):
    """Run ``function(*args, **kwargs)`` now, recompute its intermediates
    in the backward. ``use_reentrant`` is accepted for API parity and
    ignored (always the non-reentrant checkpoint); with
    ``preserve_rng_state`` (the default) the second run draws the same
    random numbers as the first, torch's default generators and the
    dropout streams alike."""
    amp = amp_state.current_amp()
    flags = get_flags()
    rng = rng_tracker.get_state() if preserve_rng_state else None
    runs = [0]

    def run(*a, **kw):
        runs[0] += 1
        if runs[0] == 1:
            return function(*a, **kw)
        return _replay(function, a, kw, amp, flags, rng)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False,
        preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run ``functions`` (a sequence of layers, or an ``nn.Sequential``)
    one after another in ``ctx["segments"]`` recomputed segments (one by
    default); ``kwargs`` are :func:`recompute`'s."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg_size = max(1, len(funcs) // max(1, segments))
    out = args
    for i in range(0, len(funcs), seg_size):
        def run_chunk(*xs, _chunk=funcs[i:i + seg_size]):
            y = xs
            for f in _chunk:
                y = f(*y) if isinstance(y, tuple) else f(y)
                y = y if isinstance(y, tuple) else (y,)
            return y[0] if len(y) == 1 else y

        out = recompute(run_chunk, *(out if isinstance(out, tuple)
                                     else (out,)), **kwargs)
        out = out if isinstance(out, tuple) else (out,)
    return out[0] if isinstance(out, tuple) and len(out) == 1 else out


__all__ = ["recompute", "recompute_sequential"]
