"""Loss functionals. Counterpart of paddle_tpu/nn/functional/loss.py, cut
to the hard-label cross entropy the training slice runs."""
from __future__ import annotations

import torch

from ...amp.state import autocast


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of logits ``input`` [..., C] against integer
    ``label`` [...] (or [..., 1]): ``logsumexp(x) - x[label]`` in fp32
    without an fp32 log-softmax of the whole input, positions whose label
    is ``ignore_index`` contributing 0 and, under ``reduction="mean"``,
    not counted. Returns the input's dtype (fp32 under amp, which
    black-lists cross_entropy). Class weights, soft labels, label
    smoothing, ``use_softmax=False`` and a class axis other than the last
    are not ported and raise."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis, with no "
            "weight, soft labels or label smoothing, are ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (input,) = autocast("cross_entropy", "allow", input)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(input, -1, safe.unsqueeze(-1)).squeeze(-1).float()
    nll = torch.logsumexp(input.float(), dim=-1) - picked
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        denom = valid.float().sum().clamp_min(1.0)
        return (nll.sum() / denom).to(input.dtype)
    if reduction == "sum":
        return nll.sum().to(input.dtype)
    return nll.to(input.dtype)


__all__ = ["cross_entropy"]
