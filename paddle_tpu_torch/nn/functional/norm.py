"""Normalization functionals (counterpart of paddle_tpu/nn/functional/
norm.py).  LayerNorm is plain PyTorch here, as it is XLA on the JAX
serving path: the reference's Pallas LayerNorm is gated to the TPU."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor,
               normalized_shape: Union[int, Sequence[int]],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` dims with the
    reference's rounding: half-precision inputs are normalized in f32 and
    cast back ONCE, before the affine (norm.py:52-61)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y
