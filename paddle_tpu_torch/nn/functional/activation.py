"""Activation functionals (counterpart of paddle_tpu/nn/functional/
activation.py, the subset the GPT and Llama paths use)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu", "silu"]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` the GPT blocks
    use, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU ``x · sigmoid(x)``, as ``jax.nn.silu``."""
    return F.silu(x)
