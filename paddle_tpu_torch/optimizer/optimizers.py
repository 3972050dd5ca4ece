"""SGD, Adam and AdamW. Counterpart of paddle_tpu/optimizer/optimizers.py,
cut to the ported slices (``Momentum``, ``Adagrad``, ``RMSProp``,
``Adadelta``, ``Adamax``, ``Lamb``, ``NAdam``, ``RAdam`` and ``LBFGS`` wait:
ROADMAP queue A item 7).

Every update is the JAX package's fp32 arithmetic in ``torch._foreach_*``
ops, on the fp32 value :meth:`Optimizer._param32` gives (the master, an
fp32 parameter in place, or a copy of a low-precision one), written back
by :meth:`Optimizer._finish_update` (through the master; for bf16
parameters without masters, by stochastic rounding when asked). The JAX
package has no Pallas kernel for any of it, so the port has none either.

SGD (``SGD._update_param``): with g the fp32 gradient and wd the L2
coefficient, p <- p - lr * (g + wd * p); the write-back rounds to
nearest (no stochastic rounding, as in the JAX package).

Adam (``Adam._update_param`` / ``_update_param_cached`` /
``_fused_update``, which compute the same fp32 arithmetic): with
per-parameter bias corrections c1 = 1 - beta1^t, c2 = 1 - beta2^t (the
powers kept in fp32),
  g <- g + wd * p                      (Adam: coupled L2)
  p <- p * (1 - lr * coeff)            (AdamW: decoupled decay, first)
  m <- beta1 m + (1 - beta1) g,  v <- beta2 v + (1 - beta2) g^2
  v_max <- max(v_max, v)               (amsgrad; v_max in place of v below)
  p <- p - lr * (m / c1) / (sqrt(v / c2) + eps)
with m and v computed in fp32 and stored in ``moment_dtype`` (the update
reads the fp32 values, not the stored ones). AdamW folds its decay into
the one fp32 value the write-back rounds (the JAX package's
``_pending_decay_factor``): a separate bf16 write of p * (1 - lr * coeff)
would round back to p and drop the decay without masters.

``use_multi_tensor`` (the JAX package's flat-buffer path, ``_fused_update``):
parameters of at most 2^18 elements (``_FUSE_MAX_NUMEL``) keep fp32
moments whatever ``moment_dtype`` says; larger ones store
``moment_dtype``. Without it, amsgrad, ``lr_ratio`` or
``apply_decay_param_fun`` every parameter stores ``moment_dtype``, as in
the JAX package's per-tensor path. The port keeps no flat buffer (the JAX
package splits big tensors off only because XLA serialises a concat of
them): each parameter keeps its own moments (the JAX package's state-dict
layout), and one update covers all the parameters whose state is fp32 in
place (fp32 moments, and a master or a fp32 parameter). The others need
fp32 temporaries (of bf16 moments, of a parameter without a master), so
they are updated in groups of at most ``_GROUP_NUMEL`` elements, which
bounds those temporaries' memory. ``lazy_mode`` only changes sparse gradients
in Paddle; the gradients here are dense, and it is accepted and changes
nothing, as in the JAX package. As in the JAX package, ``lr_ratio(p)``
scales the decoupled decay of ``p``, not its Adam step, and
``apply_decay_param_fun`` is called with the parameter's name
(:class:`Optimizer`).
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class SGD(Optimizer):
    def _update(self, params_grads, lr):
        ps = [p for p, _ in params_grads]
        p32s = [self._param32(p) for p in ps]
        gs = self._apply_decay(p32s, [g.float() for _, g in params_grads])
        torch._foreach_sub_(p32s, torch._foreach_mul(gs, float(lr)))
        for p, new32 in zip(ps, p32s):
            self._finish_update(p, new32)


class Adam(Optimizer):
    # parameters at or below this size keep fp32 moments under
    # use_multi_tensor (the JAX package's flat buffer)
    _FUSE_MAX_NUMEL = 1 << 18
    # the most elements one update of parameters needing fp32
    # temporaries covers (a larger parameter is a group of its own): at
    # most 7 fp32 values an element, about 1.75 GiB, live at the pass's
    # peak
    _GROUP_NUMEL = 1 << 26

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=None, stochastic_rounding=False):
        """``moment_dtype="bfloat16"`` stores m and v in bf16 (the update
        math stays fp32) and ``stochastic_rounding=True`` makes the
        master-weight-free bf16 write-back unbiased: the JAX package's
        plan for GPT-3 1.3B and TinyLlama-1.1B on one chip."""
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = bool(amsgrad)
        self._use_multi_tensor = bool(use_multi_tensor)
        self._moment_dtype = moment_dtype
        self._stochastic_rounding = bool(stochastic_rounding)
        self._moment_store_dtype()   # validate at construction, not step 1

    def _decay_factors(self, ps, lr):
        """Per parameter, the decoupled decay factor or None (Adam: none;
        its L2 is coupled)."""
        return [None] * len(ps)

    def _update(self, params_grads, lr):
        in_place, rest = [], []
        for p, g in params_grads:
            fp32 = (self._moment("moment1", p).dtype == torch.float32
                    and self._moment("moment2", p).dtype == torch.float32
                    and (p.dtype == torch.float32
                         or self._master_weight(p) is not None))
            (in_place if fp32 else rest).append((p, g))
        groups = [in_place] if in_place else []
        size = self._GROUP_NUMEL
        for p, g in rest:
            if size + p.numel() > self._GROUP_NUMEL:
                groups.append([])
                size = 0
            groups[-1].append((p, g))
            size += p.numel()
        for group in groups:
            self._adam(group, lr)

    def _fp32_moments(self, p):
        """Whether ``p`` keeps fp32 moments whatever ``moment_dtype`` says
        (the small tensors of ``use_multi_tensor``)."""
        return (self._use_multi_tensor and not self._amsgrad
                and p.numel() <= self._FUSE_MAX_NUMEL)

    def _moment(self, name, p):
        """Moment ``name`` of ``p``: fp32 for a small tensor under
        ``use_multi_tensor`` (a loaded entry is cast, as the JAX package's
        flat buffer casts it), ``moment_dtype`` otherwise (a loaded entry
        keeps its dtype)."""
        if not self._fp32_moments(p):
            return self._accum(name, p, dtype=self._moment_store_dtype())
        m = self._accum(name, p, cast_pending=True)
        if m.dtype != torch.float32:
            m = self._accumulators[name][self._name(p)] = m.float()
        return m

    def _adam(self, params_grads, lr):
        """One Adam update of ``params_grads`` (see the module docstring)."""
        b1, b2 = self._beta1, self._beta2
        ps = [p for p, _ in params_grads]
        ms = [self._moment("moment1", p) for p in ps]
        vs = [self._moment("moment2", p) for p in ps]
        c1s, c2s = [], []
        for p in ps:
            for key, beta, cs in (("beta1_pow", b1, c1s),
                                  ("beta2_pow", b2, c2s)):
                power = np.float32(self._accum(key, p, init=1.0)
                                   * np.float32(beta))
                self._accumulators[key][self._name(p)] = power
                cs.append(float(np.float32(1.0) - power))
        p32s = [self._param32(p) for p in ps]
        decayed = [(p32, f) for p32, f in zip(p32s,
                                              self._decay_factors(ps, lr))
                   if f is not None]
        if decayed:
            torch._foreach_mul_([p32 for p32, _ in decayed],
                                [f for _, f in decayed])
        gs = self._apply_decay(p32s, [g.float() for _, g in params_grads])
        m32s = [m if m.dtype == torch.float32 else m.float() for m in ms]
        v32s = [v if v.dtype == torch.float32 else v.float() for v in vs]
        torch._foreach_mul_(m32s, b1)
        torch._foreach_add_(m32s, torch._foreach_mul(gs, 1.0 - b1))
        torch._foreach_mul_(v32s, b2)
        torch._foreach_add_(v32s, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1.0 - b2))
        for m, m32, v, v32 in zip(ms, m32s, vs, v32s):
            if m is not m32:
                m.copy_(m32)
            if v is not v32:
                v.copy_(v32)
        if self._amsgrad:
            vmaxs = [self._accum("moment2_max", p) for p in ps]
            torch._foreach_maximum_(vmaxs, v32s)
            v32s = vmaxs
        step = torch._foreach_div(m32s, c1s)          # m / c1
        denom = torch._foreach_div(v32s, c2s)         # v / c2
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_mul_(step, float(lr))
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(p32s, step)
        for p, new32 in zip(ps, p32s):
            self._finish_update(p, new32)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False,
                 moment_dtype=None, stochastic_rounding=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor=use_multi_tensor, name=name,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         stochastic_rounding=stochastic_rounding)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        if lr_ratio is not None or apply_decay_param_fun is not None:
            # per-parameter lr / decay selection takes the per-tensor path
            self._use_multi_tensor = False

    def _decay_factors(self, ps, lr):
        """1 - lr * coeff in fp32 (lr times ``lr_ratio(p)`` if given), or
        None where ``apply_decay_param_fun`` excludes the parameter."""
        out = []
        for p in ps:
            fun = self._apply_decay_param_fun
            if fun is not None and not fun(self._name(p)):
                out.append(None)
                continue
            lr_p = lr if self._lr_ratio is None else np.float32(
                lr * np.float32(self._lr_ratio(p)))
            out.append(float(np.float32(1.0) - lr_p * np.float32(
                self._coeff)))
        return out


__all__ = ["Adam", "AdamW", "SGD"]
