"""Device and dtype rules shared by every entry point of the port.

Entry points run on the card unless the caller asks otherwise:
``resolve_device(None)`` is ``cuda``, and with no CUDA device present it
raises instead of quietly running on the host.  Tests and CPU users pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "resolve_dtype", "DTYPES"]

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
