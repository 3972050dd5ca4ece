"""Random state. Counterpart of paddle_tpu/core/generator.py.

Where the JAX package splits PRNG keys out of a global stream, the port
passes an explicit ``torch.Generator``. The two give different numbers
for the same seed; tests make their inputs with numpy.

Dropout draws from :data:`rng_tracker` (the JAX package's
``_rng_tracker``, nn/functional/common.py:105, without its named
streams, which only tensor parallelism uses): one ``torch.Generator`` per
device, seeded from :func:`seed`'s value. Its whole state is read and
restored by ``get_state`` / ``set_state``, which recompute uses to draw a
block's masks again.
"""
from __future__ import annotations

import numpy as np
import torch

from .place import resolve_device


class RNGTracker:
    """The dropout stream: one generator per device, made at first use
    from the tracker's seed (a random one until :meth:`manual_seed`, as
    the JAX package's default generator)."""

    def __init__(self):
        self._seed = None
        self._generators = {}

    def manual_seed(self, s: int) -> None:
        self._seed = int(s)
        self._generators.clear()

    def generator(self, device) -> torch.Generator:
        """The stream's generator on ``device``."""
        device = torch.device(device)
        g = self._generators.get(device)
        if g is None:
            if self._seed is None:
                # a private draw: the caller's global numpy stream
                # does not depend on whether dropout ran first
                self._seed = int(np.random.default_rng().integers(
                    0, 2 ** 31 - 1))
            g = self._generators[device] = torch.Generator(device=device)
            g.manual_seed(self._seed)
        return g

    def get_state(self):
        """The state of every generator made so far."""
        return {k: g.get_state() for k, g in self._generators.items()}

    def set_state(self, state) -> None:
        """Restore :meth:`get_state`'s result: generators made since are
        dropped (made again from the seed at their next use)."""
        for k in list(self._generators):
            if k not in state:
                del self._generators[k]
        for k, st in state.items():
            g = self._generators.get(k)
            if g is None:
                g = self._generators[k] = torch.Generator(device=k)
            g.set_state(st)


rng_tracker = RNGTracker()


def new_generator(s: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (default: the card) seeded
    with ``s``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(s))
    return g


def seed(s: int, device=None) -> torch.Generator:
    """paddle.seed's counterpart: reseeds the dropout streams with ``s``
    and returns :func:`new_generator` (s, device)."""
    rng_tracker.manual_seed(s)
    return new_generator(s, device)


__all__ = ["RNGTracker", "new_generator", "rng_tracker", "seed"]
