"""``paddle.save`` / ``paddle.load`` (counterpart of
paddle_tpu/framework/io.py): a tree of dicts, lists, tuples and scalars
with tensors as numpy arrays, pickled after the reference's magic bytes.

The reference writes its arrays as numpy.  numpy has no bfloat16 without
``ml_dtypes``, so a bf16 tensor is written widened to float32 (exact)
inside a :class:`StoredTensor` naming ``"bfloat16"`` (the port's storage
rule, ``device.host_array``, which the shard-aware checkpoint keeps too),
and read back as bf16.  Every other tensor is a plain
numpy array, which the reference's ``load`` reads as it is.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Union

import numpy as np
import torch

from ..device import dtype_name, from_host_array, host_array

__all__ = ["save", "load", "StoredTensor"]

_MAGIC = b"PDTPU001"


@dataclasses.dataclass
class StoredTensor:
    """A tensor whose dtype numpy lacks: its values widened to float32,
    and the dtype's name."""
    dtype: str
    array: np.ndarray


def _to_numpy_tree(obj: Any):
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            return StoredTensor(dtype_name(obj.dtype), host_array(obj))
        return host_array(obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_to_numpy_tree(v) for v in obj]
        try:
            return type(obj)(vals)
        except TypeError:  # namedtuple
            return type(obj)(*vals)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_to_numpy_tree(obj), f, protocol=protocol)


def _to_torch_tree(obj: Any, return_numpy: bool, device):
    if isinstance(obj, StoredTensor):
        if return_numpy:
            return obj.array
        return from_host_array(obj.array, obj.dtype, device)
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else torch.from_numpy(obj).to(device)
    if isinstance(obj, dict):
        return {k: _to_torch_tree(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        vals = [_to_torch_tree(v, return_numpy, device) for v in obj]
        try:
            return type(obj)(vals)
        except TypeError:
            return type(obj)(*vals)
    return obj


def load(path: str, return_numpy: bool = False,
         device: Union[str, torch.device] = "cpu", **configs) -> Any:
    """The saved tree with its arrays as tensors on ``device`` (numpy
    arrays with ``return_numpy``)."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            f.seek(0)
        obj = pickle.load(f)
    return _to_torch_tree(obj, return_numpy, device)
