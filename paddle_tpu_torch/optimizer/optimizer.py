"""Optimizer base. Counterpart of paddle_tpu/optimizer/optimizer.py, cut
to what the training slice runs: ``step`` / ``clear_grad`` / ``get_lr`` /
``set_lr`` and fp32 master weights (``multi_precision``).

Updates run in place on the parameters, the masters and the optimizer
state (the JAX package rebinds new arrays; in place saves the memory of
a second copy of each). LR schedulers, gradient clipping, L2
regularizers and state dicts are not ported and raise.
"""
from __future__ import annotations

import numbers

import torch


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError("LR schedulers are not ported; pass "
                                      "a float learning_rate")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._multi_precision = bool(multi_precision)
        # per parameter (by identity): fp32 master weight, state tensors
        self._master_weights = {}
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    # -- masters ----------------------------------------------------------
    def _master_weight(self, p):
        """The fp32 master of a low-precision parameter under
        ``multi_precision`` (created from the parameter at first use), or
        None."""
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        m = self._master_weights.get(id(p))
        if m is None:
            m = p.detach().float().clone()
            self._master_weights[id(p)] = m
        return m

    def _param32(self, p):
        """The fp32 value the update reads and writes: the master, or the
        parameter itself when it is fp32 (updated in place)."""
        m = self._master_weight(p)
        if m is not None:
            return m
        if p.dtype != torch.float32:
            raise NotImplementedError(
                "updating low-precision parameters without fp32 master "
                "weights (multi_precision=False) is not ported")
        return p.data

    # -- step -------------------------------------------------------------
    def _params_with_grads(self):
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        ps = self._params_with_grads()
        self._step_count += 1
        if ps:
            self._update(ps)

    def _update(self, params):
        raise NotImplementedError

    def _write_back(self, params, new32):
        """Round the fp32 results into low-precision parameters that have
        masters (fp32 parameters were updated in place)."""
        for p, v in zip(params, new32):
            if v.data_ptr() != p.data_ptr():
                p.copy_(v)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


__all__ = ["Optimizer"]
