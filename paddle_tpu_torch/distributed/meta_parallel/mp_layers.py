"""Megatron-style layers at tensor-parallel degree 1 (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py).

The port keeps the reference's parameter names and layouts: a Linear
weight is ``[in, out]`` and computes ``x @ w + b``; the embedding table is
``[num_embeddings, dim]``.  Sharding across cards comes with the
tensor-parallel slice; here every layer holds its full weight.
Parameters are created directly on ``device`` and initialised from an
explicit ``torch.Generator``, so a multi-billion-parameter model is never
materialised on the host.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn.functional.input import embedding
from ...nn.layers.common import Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_cross_entropy"]


class _Linear(Linear):
    """``y = x @ weight + bias`` with ``weight [in, out]`` (the reference's
    ``F.linear`` layout); bias starts at zero."""

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, *, device: torch.device,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         device=device, dtype=dtype, generator=generator)


class ColumnParallelLinear(_Linear):
    """Column-split Linear; at tp=1 the whole ``[in, out]`` weight."""


class RowParallelLinear(_Linear):
    """Row-split Linear; at tp=1 the whole ``[in, out]`` weight."""


class VocabParallelEmbedding(nn.Module):
    """Embedding lookup with ``jnp.take``'s fill semantics
    (mp_layers.py:137): a negative id wraps once (numpy-style), and an id
    that is still out of range yields a NaN row.  Nothing raises, and on
    the card no device-side assert can fire: every gathered index is
    clamped in range before the lookup and the fill is applied after."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        w = torch.empty((num_embeddings, embedding_dim), device=device,
                        dtype=dtype)
        w.normal_(0.0, 0.02, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


def parallel_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                           ignore_index: int = -100) -> torch.Tensor:
    """Per-token softmax cross entropy over the vocab (last) axis at tp=1
    (mp_layers.py:222-242): a stable logsumexp in f32, the label's logit
    picked, and a loss of 0 where ``label == ignore_index``."""
    x = logits.float()
    # the max only stabilises the sum: its gradient terms cancel exactly
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = torch.gather(x, -1, safe[..., None])
    return torch.where(valid, (lse - picked)[..., 0], 0.0)
