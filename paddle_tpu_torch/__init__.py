"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference this port is held
against; the port imports nothing of it (nor of JAX). Entry points run
on the card unless the caller passes ``device="cpu"``. Every TPU kernel
on a ported path is a hand-written Hopper kernel under ``csrc/``.

Ported so far: paged-KV serving of the Llama and GPT models
(``model.generate(ids, use_paged_kv=True)``, ``GenerationSession``).
"""
from . import core, inference, models, nn
from .core import CPUPlace, CUDAPlace, seed

__all__ = ["CPUPlace", "CUDAPlace", "core", "inference", "models", "nn",
           "seed"]
