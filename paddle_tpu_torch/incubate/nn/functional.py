"""Fused-op entry points (counterpart of paddle_tpu/incubate/nn/
functional.py, the norm and SwiGLU subset).

``fused_rms_norm`` and ``fused_layer_norm`` are the reference's public
entry points to its RMSNorm and LayerNorm kernels; here they reach the
port's fused-norm kernels through ``nn.functional.rms_norm`` /
``layer_norm`` (the kernel on CUDA tensors, its plain version on CPU
tensors, no fallback).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...nn.functional import layer_norm, rms_norm, silu

__all__ = ["fused_layer_norm", "fused_rms_norm", "swiglu"]


def fused_rms_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                   norm_bias: Optional[torch.Tensor] = None,
                   epsilon: float = 1e-6,
                   begin_norm_axis: int = -1) -> torch.Tensor:
    """RMSNorm of ``x`` over its last dim (functional.py:161-185); the
    output keeps x's dtype.  ``norm_bias`` and a leading
    ``begin_norm_axis`` are refused: the kernel takes neither and no
    caller needs them yet."""
    if norm_bias is not None or begin_norm_axis not in (-1, x.dim() - 1):
        raise NotImplementedError(
            "fused_rms_norm takes the last-dim, weight-only form (the "
            "fused-norm kernel's); norm_bias and a leading begin_norm_axis "
            "are not ported")
    return rms_norm(x, norm_weight, epsilon).to(x.dtype)


def fused_layer_norm(x: torch.Tensor, norm_weight: torch.Tensor,
                     norm_bias: torch.Tensor, epsilon: float = 1e-5,
                     residual: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last dim of ``x (+ bias) (+ residual)``
    (functional.py:188-195)."""
    h = x
    if bias is not None:
        h = h + bias
    if residual is not None:
        h = h + residual
    return layer_norm(h, (h.shape[-1],), norm_weight, norm_bias, epsilon)


def swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``silu(x) · y``; with ``y`` None, x's two halves of the last dim
    (functional.py:198-203)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return silu(x) * y
