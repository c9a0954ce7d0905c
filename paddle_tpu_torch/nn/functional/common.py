"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py,
the subset the Transformer path uses): ``linear``, ``dropout`` and
``label_smooth``.

``dropout`` draws its keep-mask from an explicit ``torch.Generator``
where the reference takes ``rng_key`` (or its global key); with ``p > 0``
in training and no generator it raises, as the port's ``Dropout`` layer
does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["linear", "dropout", "label_smooth"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    """``y = x @ weight + bias`` with the reference's ``weight [in, out]``
    layout (common.py:22-35)."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def dropout(x: torch.Tensor, p: float = 0.5,
            axis: Union[None, int, Sequence[int]] = None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Paddle's dropout (common.py:38-68): ``upscale_in_train`` keeps an
    element with probability ``1 - p`` and divides it by ``1 - p``;
    ``downscale_in_infer`` keeps it as it is in training and multiplies by
    ``1 - p`` at inference.  With ``axis`` one draw is shared along the
    other dims (the mask has size 1 there).  ``p == 1`` gives zeros."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be 'upscale_in_train' or "
                         f"'downscale_in_infer', got {mode!r}")
    if p == 0.0 or not training:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError(
            "dropout with p > 0 in training mode needs an explicit "
            "torch.Generator (generator=...)")
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def label_smooth(label: torch.Tensor,
                 prior_dist: Optional[torch.Tensor] = None,
                 epsilon: float = 0.1, name=None) -> torch.Tensor:
    """``(1 - epsilon) · label + epsilon · prior`` (uniform ``1 / K`` over
    the last dim's K classes without ``prior_dist``; common.py:232-236)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]
