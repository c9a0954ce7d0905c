"""Containers (counterpart of paddle_tpu/nn/layers/container.py)."""

from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    """The reference's ``LayerList``: sublayers registered under ``"0"``,
    ``"1"``, ... so state-dict keys read ``h.0.qkv.weight`` as in JAX."""
