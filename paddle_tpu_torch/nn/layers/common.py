"""Common layers (counterpart of paddle_tpu/nn/layers/common.py).

Parameters are created directly on ``device`` and drawn from an explicit
``torch.Generator``, so a multi-billion-parameter model is never
materialised on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ...device import resolve_device
from ..functional.common import dropout
from ..functional.input import embedding

__all__ = ["Dropout", "Embedding", "Linear", "check_no_weight_attr"]


def xavier_normal(shape, *, device, dtype, generator) -> nn.Parameter:
    """A ``[fan_in, fan_out]`` parameter drawn from N(0, 2 / (fan_in +
    fan_out)), the reference's ``XavierNormal``."""
    fan_in, fan_out = shape
    w = torch.empty(shape, device=device, dtype=dtype)
    w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
    return nn.Parameter(w)


def check_no_weight_attr(weight_attr) -> None:
    """Raise on a ``weight_attr``: the port draws every weight from the
    reference's default initializer and an explicit ``generator=``."""
    if weight_attr is not None:
        raise NotImplementedError(
            "weight_attr: ParamAttr and the initializer zoo are not ported "
            "yet (ROADMAP queue 1 item 10); the port draws weights from the "
            "reference's default initializers and an explicit generator=")


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in, out]`` (the reference's
    layout), XavierNormal-initialised; the bias starts at zero and
    ``bias_attr=False`` drops it.  The positional parameters are the
    reference's (common.py:28-29: ``in_features, out_features,
    weight_attr, bias_attr, name``); ``weight_attr`` must be None (queue 1
    item 10).  ``device`` (default: the card, ``device.resolve_device``),
    ``dtype`` and ``generator`` are keyword-only."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_weight_attr(weight_attr)
        device = resolve_device(device)
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
    """Paddle's ``Dropout(p, axis, mode)`` over :func:`..functional.
    dropout` (``upscale_in_train`` by default).  Identity in eval mode and
    at ``p == 0`` (``downscale_in_infer`` scales by ``1 - p`` in eval);
    otherwise it draws its mask from the explicit ``generator`` it was
    given."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout p must lie in [0, 1], got {p}")
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.axis, self.training, self.mode,
                       generator=self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"
