"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference this port is held
against; the port imports nothing of it (nor of JAX). Entry points run
on the card unless the caller passes ``device="cpu"``. Every TPU kernel
on a ported path is a hand-written Hopper kernel under ``csrc/``.

Ported so far: paged-KV serving of the Llama and GPT models
(``model.generate(ids, use_paged_kv=True)``, ``GenerationSession``),
GPT and Llama (grouped-query) training (``model(ids, labels=...)``,
``loss.backward()``, ``optimizer.AdamW`` / ``optimizer.SGD``,
``amp.decorate`` / ``amp.auto_cast``), and the custom-op extension API
(``ops.register_op`` with a custom VJP, ``utils.cpp_extension.load``,
``PyLayer``, ``to_tensor``). There is no Tensor wrapper class:
``torch.Tensor`` is the tensor.
"""
from . import amp, autograd, core, inference, models, nn, ops, optimizer, utils
from .autograd import PyLayer
from .core import CPUPlace, CUDAPlace, seed, set_flags
from .tensor import to_tensor

__all__ = ["CPUPlace", "CUDAPlace", "PyLayer", "amp", "autograd", "core",
           "inference", "models", "nn", "ops", "optimizer", "seed",
           "set_flags", "to_tensor", "utils"]
