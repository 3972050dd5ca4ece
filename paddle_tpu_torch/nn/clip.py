"""Gradient clipping. Counterpart of paddle_tpu/nn/clip.py (parity:
python/paddle/nn/clip.py).

A clip object maps the optimizer's [(param, grad)] list to a new one (the
gradients are new tensors; ``p.grad`` is left as it is). Norms and the
scale factor are 0-d tensors on the gradients' device, so clipping reads
nothing back to the host. A gradient is scaled in the dtype jnp's
promotion gives the product (a bf16 gradient times the fp32 factor is
computed in fp32, then rounded to bf16), as the JAX package does.
"""
from __future__ import annotations

import torch


def _scaled(g, factor):
    """``g * factor`` computed in the promoted dtype, in ``g``'s dtype."""
    dt = torch.promote_types(g.dtype, factor.dtype)
    return (g.to(dt) * factor).to(g.dtype)


def _clipped(p, g):
    """Whether clipping touches this pair (a gradient of a trainable
    parameter)."""
    return g is not None and p.requires_grad


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            norm = torch.linalg.vector_norm(g.float().reshape(-1))
            factor = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                 max=1.0)
            out.append((p, _scaled(g, factor)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        factor = torch.clamp(
            self.clip_norm / torch.clamp(global_norm, min=1e-12), max=1.0)
        return [(p, _scaled(g, factor) if _clipped(p, g) else g)
                for p, g in params_grads]


def _param_list(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place so that their total ``norm_type``
    norm is at most ``max_norm``; returns the total norm (before
    clipping) as a 0-d tensor. The infinity norm is taken in the
    gradients' dtype, the others in fp32, as in the JAX package."""
    params = [p for p in _param_list(parameters) if p.grad is not None]
    if not params:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        dt = params[0].grad.dtype
        for p in params[1:]:
            dt = torch.promote_types(dt, p.grad.dtype)
        total = torch.stack([p.grad.abs().amax().to(dt)
                             for p in params]).amax()
    else:
        total = torch.pow(
            sum(torch.sum(p.grad.float().abs() ** norm_type)
                for p in params), 1.0 / norm_type)
    factor = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    with torch.no_grad():
        for p in params:
            p.grad.copy_(_scaled(p.grad, factor))
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` to [-clip_value, clip_value] in place."""
    with torch.no_grad():
        for p in _param_list(parameters):
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)


__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_"]
