"""Common layers (counterpart of paddle_tpu/nn/layers/common.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """Inverted ("upscale_in_train") dropout.  Identity in eval mode and
    at ``p == 0``; otherwise it draws its mask from the explicit
    ``generator`` it was given."""

    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must lie in [0, 1), got {p}")
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError(
                "Dropout with p > 0 in training mode needs an explicit "
                "torch.Generator (Dropout(p, generator=...))")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"
