"""Activation functionals (counterpart of paddle_tpu/nn/functional/
activation.py, the subset the GPT, Llama and Transformer paths use)."""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from ...device import resolve_dtype

__all__ = ["gelu", "log_softmax", "relu", "silu", "softmax"]


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)``, as ``jax.nn.relu``."""
    return F.relu(x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` the GPT blocks
    use, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU ``x · sigmoid(x)``, as ``jax.nn.silu``."""
    return F.silu(x)


def softmax(x: torch.Tensor, axis: int = -1,
            dtype: Union[None, str, torch.dtype] = None) -> torch.Tensor:
    """Softmax over ``axis``, after a cast to ``dtype`` when given."""
    if dtype is not None:
        x = x.to(resolve_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1,
                dtype: Union[None, str, torch.dtype] = None) -> torch.Tensor:
    """Log-softmax over ``axis``, after a cast to ``dtype`` when given."""
    if dtype is not None:
        x = x.to(resolve_dtype(dtype))
    return torch.log_softmax(x, dim=axis)
