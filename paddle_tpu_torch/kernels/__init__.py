"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version in a module named after the reference's (``decode_attention``).
Sources live in ``csrc/`` and are built at first use (``_build.py``);
importing this package compiles nothing."""
from .flash_attention import flash_attention_varlen, flash_attention_with_lse

__all__ = ["flash_attention_varlen", "flash_attention_with_lse"]
