"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference this port is held
against; the port imports nothing of it (nor of JAX). Entry points run
on the card unless the caller passes ``device="cpu"``. Every TPU kernel
on a ported path is a hand-written Hopper kernel under ``csrc/``.

Ported so far: paged-KV serving of the Llama and GPT models
(``model.generate(ids, use_paged_kv=True)``, ``GenerationSession``, and
continuous batching with prefix caching, ``ContinuousBatchingSession``,
with its metrics, events and traces in ``observability``),
GPT and Llama (grouped-query) training (``model(ids, labels=...)``,
``loss.backward()``, ``optimizer.AdamW`` / ``Adam`` / ``SGD`` with
``optimizer.lr`` schedulers, ``nn.ClipGradBy*`` and state dicts,
``amp.decorate`` / ``amp.auto_cast``, with the JAX package's single-chip
recipe: recompute, bf16 moments with stochastic rounding and no fp32
masters; dropout), and the custom-op extension API
(``ops.register_op`` with a custom VJP, ``utils.cpp_extension.load``,
``PyLayer``, ``to_tensor``). There is no Tensor wrapper class:
``torch.Tensor`` is the tensor.
"""
from . import (amp, analysis, autograd, core, distributed, inference,
               models, nn, observability, ops, optimizer, utils)
from .autograd import PyLayer
from .core import CPUPlace, CUDAPlace, seed, set_flags
from .tensor import to_tensor

__all__ = ["CPUPlace", "CUDAPlace", "PyLayer", "amp", "analysis",
           "autograd", "core", "distributed", "inference", "models", "nn",
           "observability", "ops", "optimizer", "seed", "set_flags",
           "to_tensor", "utils"]
