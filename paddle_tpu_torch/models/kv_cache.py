"""KV-cache position plumbing for the decoder models (counterpart of
paddle_tpu/models/kv_cache.py).

A layer's cache is the tuple ``(k_buf, v_buf, pos)`` with
``k_buf/v_buf [batch, max_len, heads, dim]``.  ``pos`` is a Python int
(every row at the same offset) or an int tensor ``[batch]`` of per-row
offsets (continuous batching).  The serving engine passes even a
prefill chunk's one offset as a ``[1]`` tensor: the tensor branches
never read a value on the host, so a CUDA graph of the chunk replays at
whatever offset the tensor holds.

Where JAX returns new buffers, these functions update the given buffers
IN PLACE and return them; the reference donates the same buffers, so the
memory behaviour is the same.  They keep the JAX indexing semantics that
torch does not give for free:

  * ``append_kv`` clamps each write start to ``[0, max_len - s]`` like
    ``dynamic_update_slice`` (a free serving slot's position keeps
    growing past ``max_len``; its write lands on the last row);
  * ``gather_block_rows`` clips out-of-range block ids (``mode="clip"``);
  * ``scatter_block_rows`` drops destinations outside the pool after
    wrapping negative ones once (``mode="drop"``).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["append_kv", "cache_lens", "gather_block_rows",
           "scatter_block_rows"]

Pos = Union[int, torch.Tensor]


def _is_per_row(pos: Pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() >= 1


def _words(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t [b, n, h, d]`` viewed as 8-byte words ``[b, n, h * d *
    itemsize / 8]`` (the same memory), or None where its layout allows no
    such view.  An index copy's cost goes by element: in words it moves
    the same bytes in a quarter of the 16-bit elements."""
    try:
        return t.view(*t.shape[:-2], -1).view(torch.int64)
    except RuntimeError:
        return None


def append_kv(pk: torch.Tensor, pv: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, pos: Pos):
    """Write the fresh chunk ``k/v [b, s, h, d]`` into ``pk/pv
    [b, max_len, h, d]`` at ``pos`` (int, or ``[b]`` per-row offsets),
    each start clamped to ``[0, max_len - s]``.  Returns ``(pk, pv)``."""
    b, s = k.shape[:2]
    max_len = pk.shape[1]
    if _is_per_row(pos):
        start = pos.to(device=pk.device, dtype=torch.long).clamp(
            0, max_len - s)
        cols = start[:, None] + torch.arange(s, device=pk.device)
        rows = torch.arange(b, device=pk.device)[:, None]
        for dst, src in ((pk, k), (pv, v)):
            wd, ws = _words(dst), _words(src)
            if wd is None or ws is None:
                wd, ws = dst, src
            wd[rows, cols] = ws
    else:
        start = min(max(int(pos), 0), max_len - s)
        pk[:, start:start + s] = k
        pv[:, start:start + s] = v
    return pk, pv


def gather_block_rows(block_buf: torch.Tensor, idx,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather block rows ``idx`` (ids clipped into range) out of
    ``block_buf [num_blocks, block_len, h, d]`` and flatten them into one
    ``[n * block_len, h, d]`` cache row: a new tensor, or written in
    place into ``out`` (a contiguous ``[n * block_len, h, d]`` row) and
    returned."""
    nb, bl, h, d = block_buf.shape
    idx = torch.as_tensor(idx, device=block_buf.device).long().clamp(0,
                                                                     nb - 1)
    if out is not None:
        torch.index_select(block_buf, 0, idx, out=out.view(-1, bl, h, d))
        return out
    return block_buf.index_select(0, idx).reshape(-1, h, d)


def scatter_block_rows(block_buf: torch.Tensor, row: torch.Tensor,
                       dest) -> torch.Tensor:
    """Split the cache row ``row [n * block_len, h, d]`` into block_len
    pieces and write piece j into ``block_buf[dest[j]]`` in place.  A
    negative ``dest`` wraps once; one still outside ``[0, num_blocks)``
    is dropped, so one call writes any subset of a prompt's blocks.
    ``dest`` is best given on the host (numpy or a CPU tensor): the kept
    entries are then chosen without a device sync."""
    nb, bl, h, d = block_buf.shape
    pieces = row.reshape(-1, bl, h, d)
    dest = torch.as_tensor(np.asarray(dest) if not isinstance(
        dest, torch.Tensor) else dest).long()
    dest = torch.where(dest < 0, dest + nb, dest)
    keep = torch.nonzero((dest >= 0) & (dest < nb)).flatten()
    if keep.numel():
        block_buf.index_copy_(0, dest[keep].to(block_buf.device),
                              pieces.index_select(
                                  0, keep.to(block_buf.device)))
    return block_buf


def cache_lens(pos: Pos, s: int, batch: int,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-row valid cache lengths AFTER appending an ``s``-token chunk at
    ``pos`` — the ``seq_lens`` decode attention masks by.  An int ``pos``
    broadcasts to every row (on ``device``); a ``[batch]`` tensor gives
    each row its own length."""
    if _is_per_row(pos):
        return (pos.to(torch.int32) + s).to(torch.int32)
    return torch.full((batch,), int(pos) + s, dtype=torch.int32,
                      device=device)
