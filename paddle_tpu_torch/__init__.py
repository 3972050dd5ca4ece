"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference this port is held
against; the port imports nothing of it (nor of JAX). Entry points run
on the card unless the caller passes ``device="cpu"``. Every TPU kernel
on a ported path is a hand-written Hopper kernel under ``csrc/``.

Ported so far: paged-KV serving of the Llama and GPT models
(``model.generate(ids, use_paged_kv=True)``, ``GenerationSession``) and
GPT and Llama (grouped-query) training (``model(ids, labels=...)``,
``loss.backward()``, ``optimizer.AdamW``, ``amp.decorate`` /
``amp.auto_cast``).
"""
from . import amp, core, inference, models, nn, optimizer
from .core import CPUPlace, CUDAPlace, seed, set_flags

__all__ = ["CPUPlace", "CUDAPlace", "amp", "core", "inference", "models",
           "nn", "optimizer", "seed", "set_flags"]
