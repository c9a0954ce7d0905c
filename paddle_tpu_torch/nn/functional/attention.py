"""Attention functionals (counterpart of paddle_tpu/nn/functional/
attention.py).  Layout is the reference's ``[batch, seq, heads, head_dim]``.

``scaled_dot_product_attention`` always takes the flash path
(``kernels/flash_attention.py``): the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors.  The reference routes to its Pallas kernel
only at seq >= 2048 (a TPU measurement) and falls back to XLA on error;
the port has no threshold and no fallback.  ``sdpa_reference`` is the
dense form, kept for the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention", "sdpa_reference"]


def sdpa_reference(query, key, value, is_causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dense softmax(QK^T)V with the reference's masking (attention.py:
    56-89): f32 logits, masked logits at the f32 minimum (not -inf),
    probabilities cast to v's dtype before the second product."""
    b, sq, h, d = query.shape
    sk, kh = key.shape[1], key.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        i = torch.arange(sq, device=query.device)[:, None]
        j = torch.arange(sk, device=query.device)[None, :]
        logits = logits + torch.where(j <= i + (sk - sq), 0.0,
                                      torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """Parity: paddle ``F.scaled_dot_product_attention`` (``[B, S, H, D]``
    layout), differentiable, through the flash kernels.  Raises on what
    the flash path does not compute: an ``attn_mask``, or dropout while
    training."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask is not supported by "
            "the port's flash path (causal or full attention only)")
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "scaled_dot_product_attention: attention dropout is not "
            "supported by the port's flash path; pass dropout_p=0 or "
            "training=False")
    return flash_attention(query, key, value, causal=is_causal)
