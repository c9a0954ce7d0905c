"""Normalization functionals (counterpart of paddle_tpu/nn/functional/
norm.py).

The last-dim affine form of each norm goes through the fused-norm
``autograd.Function`` (``kernels/fused_norm.py``): ``layer_norm`` with a
weight and a bias, ``rms_norm`` (which has no other form) with a weight.  On CUDA that
is always the kernel pair, on the CPU always its plain version: the
reference's routing rule ("norms: XLA always", a TPU sweep where XLA fused
the norm into its neighbours) does not carry over to eager PyTorch.  Both
devices round as the reference's kernels do: the affine in f32 and one
cast, where the reference's XLA form casts before the affine (the two
agree in f32 and differ by at most one output ulp in 16-bit types).

Any other ``layer_norm`` form (no weight or bias, more than the last dim)
raises on a CUDA tensor, naming the form the kernel takes; on the CPU it
is the reference's XLA form, cast before the affine.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ...kernels.fused_norm import LayerNormFunction, RMSNormFunction

__all__ = ["layer_norm", "rms_norm"]


def _unfused(x: torch.Tensor, what: str, form: str) -> None:
    if x.device.type == "cuda":
        raise NotImplementedError(
            f"{what} on a CUDA tensor takes the fused-norm kernel, which "
            f"normalizes the last dim {form}; got another form")


def layer_norm(x: torch.Tensor,
               normalized_shape: Union[int, Sequence[int]],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` dims."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if tuple(normalized_shape) == (x.shape[-1],) and weight is not None \
            and bias is not None:
        return LayerNormFunction.apply(x, weight, bias, epsilon)
    _unfused(x, "layer_norm", "with a weight and a bias [h]")
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """The Llama-family norm over the last dim: ``x · rsqrt(mean(x²) +
    eps) · weight``, the kernels' one form (no bias, no leading
    ``begin_norm_axis``: no caller needs them)."""
    if weight is None or tuple(weight.shape) != (x.shape[-1],):
        raise ValueError(
            f"rms_norm normalizes the last dim with a weight [h]: got x "
            f"{tuple(x.shape)}, weight "
            f"{None if weight is None else tuple(weight.shape)}")
    return RMSNormFunction.apply(x, weight, epsilon)
