"""The head dims the attention kernels are built for, and the zero padding
that lets them take any other head dim up to 128.

``decode_attention`` and the three flash kernels are instantiated for
head dims 64 and 128 (16-byte rows, 64-column TMA boxes, wgmma widths).
A smaller head dim (gpt_tiny's and llama_tiny's 16, or 32, 96, ...) is
padded with zero columns up to the next built one, with the scale taken
from the true head dim, and the outputs are sliced back.  This is exact:
zero columns add nothing to ``q . k``, give zero output columns and zero
dq / dk / dv columns, and leave ``delta = rowsum(dO * O)`` unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["KERNEL_HEAD_DIMS", "kernel_head_dim", "pad_head_dim"]

KERNEL_HEAD_DIMS = (64, 128)


def kernel_head_dim(d: int) -> int:
    """The built head dim a head dim of ``d`` runs at: the smallest of
    :data:`KERNEL_HEAD_DIMS` that holds it.  Raises above 128."""
    for built in KERNEL_HEAD_DIMS:
        if 0 < d <= built:
            return built
    raise ValueError(f"head_dim {d} unsupported; the kernels are built for "
                     f"{KERNEL_HEAD_DIMS} and take any smaller head_dim "
                     f"zero-padded to the next of them")


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``d`` (a new contiguous
    tensor), or ``t`` itself when it is already that wide."""
    extra = d - t.shape[-1]
    return t if extra == 0 else F.pad(t, (0, extra))
