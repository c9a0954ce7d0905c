"""Normalization layers (counterpart of paddle_tpu/nn/layers/norm.py)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..functional.norm import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm with the reference's parameter names (``weight`` ones,
    ``bias`` zeros), created directly on ``device``."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


class RMSNorm(nn.Module):
    """The Llama-family RMS norm with the reference's parameter name
    (``weight``, ones), created directly on ``device`` in ``dtype`` (the
    model's dtype; the reference's default is float32)."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-6, *, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self) -> str:
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")
