"""Common layers (counterpart of paddle_tpu/nn/layers/common.py).

Parameters are created directly on ``device`` and drawn from an explicit
``torch.Generator``, so a multi-billion-parameter model is never
materialised on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..functional.input import embedding

__all__ = ["Dropout", "Embedding", "Linear"]


def xavier_normal(shape, *, device, dtype, generator) -> nn.Parameter:
    """A ``[fan_in, fan_out]`` parameter drawn from N(0, 2 / (fan_in +
    fan_out)), the reference's ``XavierNormal``."""
    fan_in, fan_out = shape
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in, out]`` (the reference's
    layout), XavierNormal-initialised; the bias starts at zero and
    ``bias_attr=False`` drops it."""

    def __init__(self, in_features: int, out_features: int,
                 bias_attr: Optional[bool] = None, *, device: torch.device,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = xavier_normal((in_features, out_features),
                                    device=device, dtype=dtype,
                                    generator=generator)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(out_features,
                                                 device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Embedding(nn.Module):
    """A ``[num_embeddings, embedding_dim]`` table drawn from N(0, std²)
    (the reference's default std is 1; GPT-MoE passes 0.02, its
    ``ParamAttr``), looked up with ``jnp.take``'s fill semantics
    (:func:`..functional.embedding`).  ``padding_idx`` is not ported: no
    model of the port uses it."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 std: float = 1.0):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        w = torch.empty((num_embeddings, embedding_dim), device=device,
                        dtype=dtype)
        w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


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
