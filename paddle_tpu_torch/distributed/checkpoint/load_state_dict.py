"""Shard-aware load (counterpart of
paddle_tpu/distributed/checkpoint/load_state_dict.py).

Every destination names the region it needs: a tensor the whole global
tensor, a :class:`~..sharding_utils.ShardedTensor` each of its pieces.
Each region is assembled on the host from the saved shards that overlap
it and copied into the destination in place, so a checkpoint written
under one layout loads under any other, and the device holds no second
copy of the state.  A region the shards do not cover raises.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Sequence

import numpy as np
import torch

from ...device import from_host_array
from ..sharding_utils import ShardedTensor
from .metadata import Metadata, TensorMeta

__all__ = ["load_state_dict"]


def _merged_metadata(path: str) -> Metadata:
    frags = sorted(glob.glob(os.path.join(path, "metadata_p*.json")))
    legacy = os.path.join(path, "metadata.json")
    if os.path.exists(legacy):
        frags.append(legacy)
    if not frags:
        raise FileNotFoundError(f"no checkpoint metadata under {path!r}")
    merged = Metadata()
    for frag in frags:
        with open(frag) as f:
            md = Metadata.from_json(f.read())
        merged.extra.update(md.extra)
        for name, tm in md.tensors.items():
            if name in merged.tensors:
                merged.tensors[name].shards.extend(tm.shards)
            else:
                merged.tensors[name] = tm
    return merged


class _ShardReader:
    """The npz files, opened at first use; the last array read is kept
    (the pieces of one destination tensor come one after another)."""

    def __init__(self, path: str):
        self.path = path
        self._files: dict = {}
        self._last = (None, None)

    def get(self, file: str, key: str) -> np.ndarray:
        if self._last[0] != (file, key):
            if file not in self._files:
                self._files[file] = np.load(os.path.join(self.path, file))
            self._last = ((file, key), self._files[file][key])
        return self._last[1]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._last = (None, None)


def _as_f32_bits(data: np.ndarray) -> np.ndarray:
    """A bf16 shard as float32: raw 16-bit patterns (the reference's
    ``<V2``) widened bit for bit; float data as it is."""
    if data.dtype.itemsize == 2 and data.dtype.kind in "Vui":
        return (data.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return data.astype(np.float32)


def _assemble(tm: TensorMeta, reader: _ShardReader,
              offset: Sequence[int], shape: Sequence[int]) -> torch.Tensor:
    """The region ``offset`` + ``shape`` of ``tm`` from every overlapping
    saved shard, on the host in the saved dtype."""
    bf16 = tm.dtype == "bfloat16"
    out = np.zeros(shape, dtype=np.float32 if bf16 else np.dtype(tm.dtype))
    covered = np.zeros(shape, dtype=bool)
    for sh in tm.shards:
        lo = [max(a, b) for a, b in zip(sh.global_offset, offset)]
        hi = [min(a + n, b + m) for a, n, b, m in
              zip(sh.global_offset, sh.local_shape, offset, shape)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        data = reader.get(sh.file, sh.key)
        src = tuple(slice(l - o, h - o)
                    for l, h, o in zip(lo, hi, sh.global_offset))
        dst = tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi, offset))
        out[dst] = _as_f32_bits(data[src]) if bf16 else data[src]
        covered[dst] = True
    if not covered.all():
        raise ValueError(
            f"checkpoint does not fully cover tensor {tm.name!r} region at "
            f"{list(offset)} of shape {list(shape)} (missing "
            f"{int((~covered).sum())} elements)")
    return from_host_array(out, tm.dtype)


def load_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    strict: bool = True) -> Dict[str, object]:
    """Fill ``state_dict`` (name -> tensor or ``ShardedTensor``, whose
    shape, dtype, device and layout are kept) in place from the checkpoint
    at ``path`` and return it; a name the checkpoint lacks raises under
    ``strict`` (else that destination is left as it is).  The reference
    returns new arrays; a torch destination is written into."""
    md = _merged_metadata(path)
    reader = _ShardReader(path)
    try:
        with torch.no_grad():
            for name, dst in state_dict.items():
                tm = md.tensors.get(name)
                if tm is None:
                    if strict:
                        raise KeyError(f"tensor {name!r} not in checkpoint "
                                       f"{path!r}")
                    continue
                shape = tuple(dst.shape)
                if tuple(tm.global_shape) != shape:
                    raise ValueError(
                        f"shape mismatch for {name!r}: checkpoint "
                        f"{tm.global_shape} vs target {list(shape)}")
                pieces = dst.pieces if isinstance(dst, ShardedTensor) \
                    else [((0,) * len(shape), dst)]
                for off, t in pieces:
                    t.copy_(_assemble(tm, reader, off, tuple(t.shape)))
    finally:
        reader.close()
    return state_dict
