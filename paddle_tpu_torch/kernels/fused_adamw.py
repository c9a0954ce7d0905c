"""Fused AdamW update of one parameter tensor, in place (counterpart of
paddle_tpu/kernels/fused_adamw.py).

  * :func:`fused_adamw` launches the hand-written CUDA kernel
    (``csrc/fused_adamw.cu``, built for ``sm_90a`` at first use) for CUDA
    tensors and takes :func:`fused_adamw_reference`, the plain PyTorch
    version, for CPU tensors.  There is no routing table and no fallback.

One pass reads ``(p, g, m, v)`` and writes ``(p, m, v)`` in place, in
f32 (fused_adamw.py:25-43)::

    m = beta1 m + (1 - beta1) g
    v = beta2 v + (1 - beta2) g g
    p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)

with ``bc1 = 1 - beta1^t`` and ``bc2 = 1 - beta2^t`` for the 1-based step
``t``, all scalars in f32.  ``p`` is f32 (a master) or the parameter dtype;
``g`` may come in its own dtype and is cast inside; ``m`` and ``v`` are
f32.  ``low``, when given, receives the updated ``p`` cast to its dtype in
the same pass (the low-precision parameter of a master).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["fused_adamw", "fused_adamw_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _scalars(lr, beta1, beta2, epsilon, weight_decay, step):
    """The kernel's seven f32 scalars ``(lr, beta1, beta2, eps, wd, bc1,
    bc2)`` as Python floats, each exactly an f32 value; the bias
    corrections are taken in f32 as the reference does (:71-79)."""
    f = np.float32
    bc1 = f(1.0) - f(beta1) ** f(step)
    bc2 = f(1.0) - f(beta2) ** f(step)
    return tuple(float(f(x)) for x in (lr, beta1, beta2, epsilon,
                                       weight_decay, bc1, bc2))


def _check(p, g, m, v, low):
    if g.shape != p.shape or m.shape != p.shape or v.shape != p.shape:
        raise ValueError(f"p, g, m, v shapes differ: {tuple(p.shape)}, "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"m and v must be float32, got {m.dtype} and "
                         f"{v.dtype}")
    if low is not None and low.shape != p.shape:
        raise ValueError(f"low {tuple(low.shape)} must have p's shape "
                         f"{tuple(p.shape)}")


def fused_adamw_reference(p, g, m, v, *, lr, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, weight_decay=0.0, step=1,
                          low: Optional[torch.Tensor] = None) -> None:
    """Plain version: the same f32 arithmetic, in place."""
    _check(p, g, m, v, low)
    lr, b1, b2, eps, wd, bc1, bc2 = _scalars(lr, beta1, beta2, epsilon,
                                             weight_decay, step)
    one_b1, one_b2 = float(np.float32(1 - b1)), float(np.float32(1 - b2))
    g32 = g.float()
    p32 = p.float()
    m.copy_(b1 * m + one_b1 * g32)
    v.copy_(b2 * v + one_b2 * g32 * g32)
    new_p = p32 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p32)
    p.copy_(new_p)
    if low is not None:
        low.copy_(new_p)


def fused_adamw(p, g, m, v, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                weight_decay=0.0, step=1,
                low: Optional[torch.Tensor] = None) -> None:
    """One AdamW step on one tensor, in place: the CUDA kernel on the
    current stream for CUDA tensors, the plain version for CPU tensors.
    The kernel raises on what it does not take: mixed devices, a p, g or
    low dtype other than float32/float16/bfloat16 (low: 16-bit only), or
    p, m, v, low not contiguous (g is made contiguous)."""
    _check(p, g, m, v, low)
    if p.device.type != "cuda":
        return fused_adamw_reference(p, g, m, v, lr=lr, beta1=beta1,
                                     beta2=beta2, epsilon=epsilon,
                                     weight_decay=weight_decay, step=step,
                                     low=low)
    dev = p.device
    named = [("g", g), ("m", m), ("v", v)] + \
        ([("low", low)] if low is not None else [])
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"fused_adamw: {name} is on {t.device}, p on "
                             f"{dev}")
    for name, t in (("p", p), ("g", g)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"fused_adamw: unsupported {name} dtype "
                             f"{t.dtype}")
    if low is not None and low.dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"fused_adamw: low must be float16 or bfloat16, "
                         f"got {low.dtype}")
    for name, t in [("p", p), ("m", m), ("v", v)] + named[3:]:
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw updates {name} in place and "
                             f"needs it contiguous")
    g = g.contiguous()
    ptrs = [t.data_ptr() for t in (p, g, m, v)] + \
        ([low.data_ptr()] if low is not None else [])
    vec = int(all(x % 16 == 0 for x in ptrs))
    from ._build import load
    lib = load("fused_adamw")
    with torch.cuda.device(dev):
        rc = lib.fused_adamw_launch(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            low.data_ptr() if low is not None else None,
            _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype],
            _DTYPE_CODES[low.dtype] if low is not None else 0, p.numel(),
            *_scalars(lr, beta1, beta2, epsilon, weight_decay, step),
            vec, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed with CUDA "
                           f"error {rc}")
    fused_adamw.launches += 1


# launches of the CUDA kernel since the count was last set to 0
fused_adamw.launches = 0
