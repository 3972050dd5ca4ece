"""SGD and AdamW. Counterpart of paddle_tpu/optimizer/optimizers.py, cut
to the ported slices.

SGD's update is the JAX package's (``SGD._update_param``), in fp32 on the
master weights: with g the gradient in fp32 and wd the L2 coefficient,
  p <- p - lr * (g + wd * p)
then the parameter is the master rounded to its dtype.

AdamW's update is the JAX package's (``Adam._update_param`` /
``_fused_update``, whose per-tensor and flat-buffer paths compute the
same fp32 arithmetic), on the master weights: with g the gradient in fp32
and per-parameter bias corrections c1 = 1 - beta1^t, c2 = 1 - beta2^t
(the powers kept in fp32 as the JAX package keeps them),
  p <- p * (1 - lr * coeff)            (decoupled decay, first)
  m <- beta1 m + (1 - beta1) g,  v <- beta2 v + (1 - beta2) g^2
  p <- p - lr * (m / c1) / (sqrt(v / c2) + eps)
then the parameter is the master rounded to its dtype. One set of
``torch._foreach_*`` ops updates every parameter, whatever
``use_multi_tensor`` says (the JAX package has no Pallas kernel for
it). bf16 moments with stochastic rounding, amsgrad, lazy mode,
per-parameter lr ratios and decay selection are not ported and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(weight_decay, str):
            raise NotImplementedError(
                "string regularizer modes are not ported; pass a float "
                "L2 coefficient")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._coeff = (None if weight_decay is None
                       else float(getattr(weight_decay, "coeff",
                                          weight_decay)))

    def _update(self, params):
        p32s = [self._param32(p) for p in params]
        gs = [p.grad.float() for p in params]
        if self._coeff is not None:
            gs = torch._foreach_add(gs, torch._foreach_mul(p32s, self._coeff))
        torch._foreach_sub_(p32s, torch._foreach_mul(
            gs, float(np.float32(self._learning_rate))))
        self._write_back(params, p32s)


class AdamW(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=None, stochastic_rounding=False):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "lr_ratio / apply_decay_param_fun are not ported (every "
                "parameter is decayed)")
        if lazy_mode or amsgrad or stochastic_rounding or moment_dtype not in (
                None, "float32", torch.float32):
            raise NotImplementedError(
                "lazy_mode, amsgrad, bf16 moments (moment_dtype) and "
                "stochastic_rounding are not ported")
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        # per parameter (by identity): [m, v, beta1_pow, beta2_pow]
        self._state = {}

    def _param_state(self, p):
        st = self._state.get(id(p))
        if st is None:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            st = [z, torch.zeros_like(z), np.float32(1.0), np.float32(1.0)]
            self._state[id(p)] = st
        return st

    def _update(self, params):
        lr = np.float32(self._learning_rate)
        b1, b2 = self._beta1, self._beta2
        p32s, gs, ms, vs, c1s, c2s = [], [], [], [], [], []
        for p in params:
            st = self._param_state(p)
            st[2] = np.float32(st[2] * np.float32(b1))
            st[3] = np.float32(st[3] * np.float32(b2))
            p32s.append(self._param32(p))
            gs.append(p.grad.float())
            ms.append(st[0])
            vs.append(st[1])
            c1s.append(float(np.float32(1.0) - st[2]))
            c2s.append(float(np.float32(1.0) - st[3]))
        torch._foreach_mul_(p32s, float(np.float32(1.0) - lr * np.float32(
            self._coeff)))
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1.0 - b2))
        step = torch._foreach_div(ms, c1s)        # m / c1
        denom = torch._foreach_div(vs, c2s)       # v / c2
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_mul_(step, float(lr))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(p32s, step)
        self._write_back(params, p32s)


__all__ = ["AdamW", "SGD"]
