"""Lookup functionals (counterpart of paddle_tpu/nn/functional/input.py)."""

from __future__ import annotations

import torch

__all__ = ["embedding"]


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Rows of ``weight`` with ``jnp.take``'s fill semantics (input.py:
    18-28): a negative id wraps once (numpy-style) and an id still out of
    range gives a NaN row.  Nothing raises, and on the card no
    device-side assert can fire: every gathered index is clamped in range
    before the lookup and the fill is applied after."""
    n = weight.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = weight[idx.clamp(0, n - 1)]
    return rows.masked_fill(~valid[..., None], float("nan"))
