"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX reference (``paddle_tpu``), built for an
NVIDIA H100.  Plain tensor code is PyTorch; every TPU kernel on a ported
path is a hand-written CUDA kernel (``kernels/csrc``) beside its plain
PyTorch version.  The package imports torch, numpy and the standard
library only — never jax, never ``paddle_tpu``.

Entry points build on the card unless told otherwise (``device.py``):
with no CUDA device they raise and ask for ``device="cpu"``.
"""

from .device import DTYPES, resolve_device, resolve_dtype

__version__ = "0.1.0"

__all__ = ["DTYPES", "resolve_device", "resolve_dtype"]
