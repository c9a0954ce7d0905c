"""Shard-aware save (counterpart of
paddle_tpu/distributed/checkpoint/save_state_dict.py).

A value is a tensor (one shard at offset 0) or a
:class:`~..sharding_utils.ShardedTensor`, whose pieces list every element
once: a replica is never written twice and a ZeRO slice once.  Each
writer (``PADDLE_TRAINER_ID``, 0 for the single controller) writes
``data_p{i}.npz`` and its metadata fragment ``metadata_p{i}.json``.

16-bit floats: numpy has no bfloat16 without ``ml_dtypes``, which the
port does not depend on.  The reference writes a bf16 array as its raw bits
(``<V2``), which its own loader cannot cast back; the port writes a bf16
piece widened to float32 (exact) under the dtype name ``"bfloat16"``
(``device.host_array``), which both loaders read, and reads the reference's raw bits.

``async_save=True``: the device-to-host snapshot is taken before the call
returns, so the saved state is the state at the call; the files are
written on a thread.  A later save to the same path joins that write
first (the rendezvous), and ``wait_for_pending_saves`` joins them all; a
failed write raises there (save_state_dict.py:36-75).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ...device import dtype_name, host_array
from ..sharding_utils import ShardedTensor
from .metadata import Metadata, ShardMeta, TensorMeta

__all__ = ["save_state_dict", "wait_for_pending_saves"]


class _PendingSave:
    """An in-flight write: its thread and the exception it hit, raised at
    the join."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def join_and_raise(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(
                "async checkpoint write failed; the checkpoint on disk is "
                "incomplete") from self.error


# in-flight writes by absolute path; _SAVE_LOCK guards the registry and
# spans each save's rendezvous and registration
_INFLIGHT: Dict[str, _PendingSave] = {}
_SAVE_LOCK = threading.Lock()


def wait_for_pending_saves(path: Optional[str] = None) -> None:
    """Join the in-flight save to ``path`` (or every one); raises if a
    joined write failed."""
    with _SAVE_LOCK:
        if path is not None:
            pending = [_INFLIGHT.pop(os.path.abspath(path), None)]
        else:
            pending = list(_INFLIGHT.values())
            _INFLIGHT.clear()
    for p in pending:
        if p is not None:
            p.join_and_raise()


def _pieces(x):
    if isinstance(x, ShardedTensor):
        return tuple(x.shape), x.dtype, x.pieces
    x = torch.as_tensor(x)
    return tuple(x.shape), x.dtype, [((0,) * x.dim(), x)]


def save_state_dict(state_dict: Dict[str, object], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False,
                    extra: Optional[dict] = None):
    """Write ``state_dict`` (name -> tensor or ``ShardedTensor``; None
    entries skipped) under the directory ``path``.  Returns the writing
    thread under ``async_save`` (join it, or ``wait_for_pending_saves``),
    else None."""
    apath = os.path.abspath(path)
    with _SAVE_LOCK:
        prev = _INFLIGHT.pop(apath, None)
        if prev is not None:
            prev.join_and_raise()
        for k in [k for k, v in _INFLIGHT.items()
                  if not v.thread.is_alive() and v.error is None]:
            del _INFLIGHT[k]
        return _save_locked(state_dict, path, apath, async_save, extra)


def _save_locked(state_dict, path, apath, async_save, extra):
    os.makedirs(path, exist_ok=True)
    pidx = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    md = Metadata(extra=extra or {})
    data_file = f"data_p{pidx}.npz"
    arrays = {}
    for name, x in state_dict.items():
        if x is None:
            continue
        shape, dtype, pieces = _pieces(x)
        tm = md.tensors[name] = TensorMeta(name=name,
                                           global_shape=list(shape),
                                           dtype=dtype_name(dtype))
        for i, (offset, t) in enumerate(pieces):
            key = f"{name}.shard{i}"
            arrays[key] = host_array(t)
            tm.shards.append(ShardMeta(file=data_file, key=key,
                                       global_offset=[int(o) for o in offset],
                                       local_shape=list(t.shape)))

    def write():
        np.savez(os.path.join(path, data_file), **arrays)
        frag = os.path.join(path, f"metadata_p{pidx}.json")
        tmp = frag + ".tmp"
        with open(tmp, "w") as f:
            f.write(md.to_json())
        os.replace(tmp, frag)

    if not async_save:
        write()
        return None
    pending = _PendingSave()

    def guarded_write():
        try:
            write()
        except BaseException as e:       # raised at join_and_raise
            pending.error = e

    pending.thread = threading.Thread(target=guarded_write, daemon=True)
    _INFLIGHT[apath] = pending
    pending.thread.start()
    return pending.thread
