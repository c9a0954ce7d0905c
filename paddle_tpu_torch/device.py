"""Device and dtype rules shared by every entry point of the port.

Entry points run on the card unless the caller asks otherwise:
``resolve_device(None)`` is ``cuda``, and with no CUDA device present it
raises instead of quietly running on the host.  Tests and CPU users pass
``device="cpu"`` explicitly.

Host storage: numpy has no bfloat16 without ``ml_dtypes``, which the port
does not depend on, so a bf16 tensor is stored widened to float32 (exact)
beside its dtype name (``host_array`` / ``dtype_name``) and narrowed again
on the way back (``from_host_array``).  ``framework/io.py`` and the
shard-aware checkpoint both store tensors by this rule.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "resolve_dtype", "DTYPES", "dtype_name",
           "host_array", "from_host_array"]

# the config dtype names the JAX package uses (GPTConfig.dtype, ...)
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point builds on: ``device`` if given, else the
    current CUDA device.  Raises when CUDA is asked for (or defaulted to)
    and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to build on "
            "the host")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype: Union[None, str, torch.dtype],
                  default: Optional[str] = None) -> torch.dtype:
    """Map a config dtype name (``"float32"``, ``"bfloat16"``,
    ``"float16"``) or a ``torch.dtype`` to a ``torch.dtype``."""
    if dtype is None:
        dtype = default
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}; expected one of "
            f"{sorted(DTYPES)} or a torch.dtype") from None


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).split(".")[-1]


def host_array(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy, bf16 widened to float32: a
    snapshot, even of a host tensor updated in place later."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).contiguous().numpy()


def from_host_array(a: np.ndarray, name: str,
                    device: Union[None, str, torch.device] = None
                    ) -> torch.Tensor:
    """``a`` (stored by ``host_array``) as a tensor of the dtype named
    ``name`` on ``device`` (the host if None)."""
    t = torch.from_numpy(a)
    if name == "bfloat16":
        t = t.to(torch.bfloat16)
    return t if device is None else t.to(device)
