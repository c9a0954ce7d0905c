"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py, the
subset the Transformer path uses): ``cross_entropy`` and
``softmax_with_cross_entropy``, computed in f32 as the reference does."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """Parity: paddle ``F.cross_entropy`` (loss.py:36-77), in f32.

    Hard labels (class ids along ``axis``, or with a size-1 ``axis``):
    ``-(1 - ls) · logp[label] - ls · mean(logp)`` (``ls`` the
    ``label_smoothing``), times ``weight[label]``, 0 where the label is
    ``ignore_index``; ``reduction="mean"`` divides the sum by the valid
    count (the summed weights of the valid labels with ``weight``), at
    least 1.  Soft labels: ``-sum(target · logp)`` with the target
    smoothed toward uniform, and a plain mean.  ``use_softmax=False`` takes
    ``input`` as probabilities (``log(max(input, 1e-12))``)."""
    x = input.float()
    logp = torch.log_softmax(x, dim=axis) if use_softmax else \
        torch.log(x.clamp_min(1e-12))
    nclass = x.shape[axis]
    if soft_label:
        tgt = label.float()
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / nclass
        loss = -(tgt * logp).sum(dim=axis)
        valid = None
    else:
        lbl = label
        if lbl.dim() == x.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            loss = -(1 - label_smoothing) * picked - \
                label_smoothing * logp.mean(dim=axis)
        else:
            loss = -picked
        w = weight.float()[safe] if weight is not None else None
        if w is not None:
            loss = loss * w
        loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if valid is not None:
            denom = torch.where(valid, w, 0.0).sum() if w is not None \
                else valid.float().sum()
            return loss.sum() / denom.clamp_min(1.0)
        return loss.mean()
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """The unreduced loss with ``axis`` kept at size 1 (loss.py:80-88),
    and the softmax of ``logits`` with ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
