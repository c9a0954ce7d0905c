"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version in a module named after the reference's (``decode_attention``).
Sources live in ``csrc/`` and are built at first use (``_build.py``);
importing this package compiles nothing."""
