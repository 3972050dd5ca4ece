"""Loss functionals. Counterpart of paddle_tpu/nn/functional/loss.py,
cut to ``cross_entropy`` and ``softmax_with_cross_entropy``."""
from __future__ import annotations

import torch

from ...amp.state import autocast


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) over the class axis ``axis``, the JAX package's
    ``_cross_entropy``, in fp32, returned in the input's dtype (fp32 under
    amp, which black-lists cross_entropy).

    Hard labels (integers; a size-1 class axis is squeezed):
    ``logsumexp(x) - x[label]`` without an fp32 log-softmax of the whole
    input; positions whose label is ``ignore_index`` contribute 0 and,
    under ``reduction="mean"``, are not counted; ``weight`` [C] scales
    each position by its class's weight (the mean divides by the kept
    positions' weight sum); ``label_smoothing`` e gives
    -(1 - e) log p[label] - e mean(log p). Soft labels (``soft_label``: a
    distribution over the class axis, smoothed as (1 - e) y + e / C):
    -sum(y log p); ``weight`` and ``ignore_index`` do not apply, as in the
    JAX package."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    input, label, weight = autocast("cross_entropy", "allow", input, label,
                                    weight)
    axis = axis % input.dim()
    n_classes = input.shape[axis]
    if soft_label:
        logits = input.float()
        if use_softmax:
            logp = torch.log_softmax(logits, dim=axis)
        else:
            logp = torch.log(torch.clamp(logits, 1e-15, 1.0))
        labels = label.float()
        if label_smoothing > 0:
            labels = (labels * (1 - label_smoothing)
                      + label_smoothing / n_classes)
        loss = -torch.sum(labels * logp, dim=axis)
        return _reduce(loss, reduction).to(input.dtype)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(input, axis, safe.unsqueeze(axis)).squeeze(
        axis).float()
    xf = input.float()
    if use_softmax:
        lse = torch.logsumexp(xf, dim=axis)
        picked_logp = picked - lse
    else:
        # the input holds probabilities
        picked_logp = torch.log(torch.clamp(picked, 1e-15, 1.0))
    if label_smoothing > 0:
        if use_softmax:
            mean_logp = xf.mean(dim=axis) - lse
        else:
            mean_logp = torch.log(torch.clamp(xf, 1e-15, 1.0)).mean(dim=axis)
        nll = (-(1 - label_smoothing) * picked_logp
               - label_smoothing * mean_logp)
    else:
        nll = -picked_logp
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    if weight is not None:
        w = weight.float()[safe]
        nll = nll * w
        if reduction == "mean":
            denom = torch.where(valid, w, zero).sum()
            return (torch.where(valid, nll, zero).sum()
                    / torch.clamp(denom, min=1e-12)).to(input.dtype)
    nll = torch.where(valid, nll, zero)
    if reduction == "mean":
        denom = torch.clamp(valid.float().sum(), min=1.0)
        return (nll.sum() / denom).to(input.dtype)
    return _reduce(nll, reduction).to(input.dtype)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position cross entropy (``reduction="none"``) and, with
    ``return_softmax``, the softmax of ``logits`` over ``axis`` (fp32
    under amp, which black-lists softmax)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if return_softmax:
        (logits,) = autocast("softmax", "promote", logits)
        return loss, torch.softmax(logits, dim=axis)
    return loss


__all__ = ["cross_entropy", "softmax_with_cross_entropy"]
