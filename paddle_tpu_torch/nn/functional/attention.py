"""Attention functionals (counterpart of paddle_tpu/nn/functional/
attention.py).  Layout is the reference's ``[batch, seq, heads, head_dim]``.

``scaled_dot_product_attention`` chooses its route by its arguments, as
the reference does: with no ``attn_mask`` and no dropout in training it
takes the flash path (``kernels/flash_attention.py``: the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors); otherwise the dense
form ``sdpa_reference`` (f32 logits, the mask at the f32 minimum or
added, dropout on the f32 probabilities), counted in
``scaled_dot_product_attention.dense_calls`` and run under the profiler
range ``DENSE_RANGE``.  The reference also sends
unmasked calls below seq 2048 (a TPU measurement) to the dense form and
falls back to it when its kernel fails; the port has no threshold and no
fallback.  ``flash_attention`` is Paddle's ``(out, softmax)`` form of it.

``flash_attn_unpadded`` is Paddle's varlen API (total-token packed
``[T, H, D]`` with ``cu_seqlens``): on CUDA it takes the segment-id flash
kernels (``flash_attention_varlen``) wherever the reference's kernel route
computes the right function, and the reference's dense segment-masked
form otherwise (causal with q / k packs that differ) and on the CPU, as
the reference does.  The route is decided by value; a kernel failure
raises (the reference's warn-and-fall-back is not ported).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch.profiler import record_function

from ...kernels.flash_attention import (flash_attention as _flash,
                                        flash_attention_varlen)
from .common import dropout

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention", "sdpa_reference"]

# the profiler range around each dense call of
# ``scaled_dot_product_attention`` (its forward ops; their backward nodes
# carry the same sequence numbers)
DENSE_RANGE = "sdpa.dense"

_WARNED = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        logging.getLogger("paddle_tpu_torch").warning(msg)


def sdpa_reference(query, key, value, attn_mask=None,
                   dropout_p: float = 0.0, is_causal: bool = False,
                   scale: Optional[float] = None, training: bool = True, *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Dense softmax(QK^T)V with the reference's masking (attention.py:
    55-89): f32 logits; the causal mask and a bool ``attn_mask`` (True
    keeps) put masked logits at the f32 minimum, never -inf, so a row
    with every key masked averages them all as the reference does; a
    numeric ``attn_mask`` is added in f32; softmax in f32, dropout (drawn
    from ``generator``) on the f32 probabilities in training, which are
    then cast to v's dtype before the second product.  ``attn_mask``
    broadcasts against the logits ``[B, H, Sq, Sk]``."""
    b, sq, h, d = query.shape
    sk, kh = key.shape[1], key.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    f32_min = torch.finfo(torch.float32).min
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        i = torch.arange(sq, device=query.device)[:, None]
        j = torch.arange(sk, device=query.device)[None, :]
        logits = logits + torch.where(j <= i + (sk - sq), 0.0, f32_min)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, f32_min)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=True, generator=generator)
    probs = probs.to(v.dtype)
    return torch.matmul(probs, v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None, *,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Parity: paddle ``F.scaled_dot_product_attention`` (``[B, S, H, D]``
    layout), differentiable.  The arguments choose the route, as in the
    reference (attention.py:100-115): no ``attn_mask`` and no dropout in
    training -> the flash kernels (any sequence length, no fallback: a
    kernel failure raises); otherwise the dense ``sdpa_reference``,
    counted in ``scaled_dot_product_attention.dense_calls``.  Attention
    dropout draws from ``generator`` (the reference draws from its global
    key); training with ``dropout_p > 0`` and no generator raises."""
    if attn_mask is None and not (dropout_p > 0.0 and training):
        return _flash(query, key, value, causal=is_causal)
    scaled_dot_product_attention.dense_calls += 1
    with record_function(DENSE_RANGE):
        return sdpa_reference(query, key, value, attn_mask, dropout_p,
                              is_causal, training=training,
                              generator=generator)


# calls that took the dense form since the count was last set to 0
scaled_dot_product_attention.dense_calls = 0


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """Parity: paddle ``F.flash_attention.flash_attention`` ->
    ``(out, None)``, through :func:`scaled_dot_product_attention` (no
    softmax is returned, as in the reference)."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training=training)
    return out, None


def _segment_ids(cu_seqlens: torch.Tensor, total: int) -> torch.Tensor:
    """int32 ``[total]`` segment ids of a pack from its cumulative lengths
    (reference :141-142): token i counts the interior boundaries at or
    before it; a boundary at ``total`` or past it is dropped."""
    starts = cu_seqlens[1:-1]
    starts = starts[starts < total]
    return torch.bincount(starts, minlength=total).cumsum(0).to(torch.int32)


def _varlen_dense(query, key, value, seg_q, seg_k, cu_q, cu_k, scale,
                  causal):
    """The reference's dense route (:192-204): f32 logits, the
    same-segment mask (per-segment causal with ``causal``) at the f32
    minimum, probabilities cast to v's dtype before the second product.
    k/v may carry fewer heads (repeated here)."""
    t, h = query.shape[:2]
    tk, kh = key.shape[:2]
    if kh != h:
        key = key.repeat_interleave(h // kh, dim=1)
        value = value.repeat_interleave(h // kh, dim=1)
    logits = torch.einsum("qhd,khd->hqk", query.float(), key.float()) * scale
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(t, device=query.device) - cu_q[seg_q.long()]
        pos_k = torch.arange(tk, device=query.device) - cu_k[seg_k.long()]
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    logits = logits.masked_fill(~mask[None], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(value.dtype)
    return torch.einsum("hqk,khd->qhd", probs, value)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale: float,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, name=None,
                        assume_aligned: Optional[bool] = None):
    """Varlen API parity: query ``[T, H, D]``, key/value ``[Tk, KVH, D]``
    packed end to end, ``cu_seqlens_*`` the cumulative sequence lengths
    (``[0, n0, n0 + n1, ...]``); a query attends only to keys of its own
    sequence.  Returns ``(out [T, H, D], None)``.

    On CUDA the segment-id flash kernels run whenever they compute the
    reference's function: non-causal, or causal with the q and k packs
    equal.  The cumulative lengths are always concrete here, so their
    values decide; ``assume_aligned`` (the reference's promise for traced
    lengths) is accepted for signature parity and ignored.
    Causal with packs that differ is per-sequence causal, which the
    kernels' global causal mask does not compute: that call, and every
    call on the CPU, takes the dense form (counted in
    ``flash_attn_unpadded.dense_calls``).  ``dropout > 0`` raises, and so
    does, on CUDA, a head_dim the kernels do not take."""
    if dropout > 0.0:
        raise NotImplementedError(
            "flash_attn_unpadded: dropout > 0 is not supported by the "
            "port's varlen path; pass dropout=0.0")
    t, tk = query.shape[0], key.shape[0]
    cu_q = torch.as_tensor(cu_seqlens_q, device=query.device).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=query.device).long()
    seg_q, seg_k = _segment_ids(cu_q, t), _segment_ids(cu_k, tk)
    aligned = not causal or (t == tk and torch.equal(cu_q, cu_k))
    if query.device.type == "cuda" and aligned:
        out = flash_attention_varlen(query[None], key[None], value[None],
                                     seg_q[None], seg_k[None], causal=causal,
                                     scale=scale)
        return out[0], None
    if not aligned:
        _warn_once("varlen_unaligned",
                   "flash_attn_unpadded: causal with q / k packs that "
                   "differ is per-sequence causal, which the segment "
                   "kernels do not compute; using the dense path")
    flash_attn_unpadded.dense_calls += 1
    return _varlen_dense(query, key, value, seg_q, seg_k, cu_q, cu_k, scale,
                         causal), None


# calls that took the dense form since the count was last set to 0
flash_attn_unpadded.dense_calls = 0
