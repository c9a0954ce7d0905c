"""Flash attention, forward and backward (counterpart of paddle_tpu/
kernels/flash_attention.py, with and without segment ids).

Three hand-written CUDA kernels (``csrc/flash_attention.cu``, built for
``sm_90a`` at first use), each beside its plain PyTorch version with the
reference's exact semantics:

  * :func:`flash_attention_fwd` gives ``out`` and ``lse`` (f32);
  * :func:`flash_attention_bwd_dq` gives ``dq``;
  * :func:`flash_attention_bwd_dkv` gives ``dk, dv``.

A wrapper launches its kernel for CUDA tensors and takes its plain version
for CPU tensors; there is no routing table and no fallback.
:func:`flash_attention` is the differentiable entry point: a
``torch.autograd.Function`` that saves ``(q, k, v, out, lse)`` and runs dq
then dkv in backward, through the same wrappers (so the CPU tests run the
same fwd / dq / dkv decomposition as the card).
:func:`flash_attention_varlen` is the same with segment ids (packed
sequences: a query sees only keys of its own segment, the reference's
``_flash_core_seg``); :func:`flash_attention_with_lse` is the forward
with its ``lse``.

Semantics (flash_attention.py:77-299): f32 scores, softmax and
accumulation, one final cast; the bottom-right causal mask
``kpos <= qpos + (Sk - Sq)``, and with segment ids ``q_segments [B, Sq]``
/ ``k_segments [B, Sk]`` (int32) only same-segment pairs on top of it; a
query row that sees no key gives ``out = 0`` and ``lse = -inf``, and its
backward takes ``lse_safe = 0`` (its dq, and the dk / dv of a key no query
sees, are 0).  ``delta = rowsum(dO * out)`` is computed outside the
kernels (:311).  The reference's TPU tiling arguments (``block_q``,
``block_k``, ``interpret``) have no counterpart.

Layouts are the reference's ``[B, S, H, D]``; k/v may have fewer heads
(``H % KVH == 0``), read by kv-head index ``h // (H // KVH)``; dk/dv come
back with the kv heads' shape (the group's query heads summed in f32).
``lse`` and ``delta`` are ``[B, H, Sq]``.  The kernels read q/k/v/dO in
place through their strides (views of a fused QKV projection are fine).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .head_dim import kernel_head_dim, pad_head_dim

__all__ = ["flash_attention", "flash_attention_varlen",
           "flash_attention_with_lse", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_fwd_reference", "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the 16-bit forward returns this + a CUresult when a tensor map is refused
_TMA_REFUSED = 2000


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention wants q [B, Sq, H, D] and k/v "
                         "[B, Sk, KVH, D]")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    kb, _, kh, kd = k.shape
    if kb != b or kd != d:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} in batch or head_dim")
    if kh < 1 or h % kh:
        raise ValueError(f"heads {h} is not a multiple of kv_heads {kh}")


def _segments(q, k, q_segments, k_segments):
    """Raise unless the segment ids are both None or contiguous int32
    ``[B, Sq]`` / ``[B, Sk]`` tensors on q's device."""
    if (q_segments is None) != (k_segments is None):
        raise ValueError("pass both q_segments and k_segments, or neither")
    if q_segments is None:
        return
    for name, ids, x in (("q_segments", q_segments, q),
                         ("k_segments", k_segments, k)):
        want = [x.shape[0], x.shape[1]]
        if (ids.dtype != torch.int32 or list(ids.shape) != want
                or not ids.is_contiguous() or ids.device != q.device):
            raise ValueError(
                f"{name} must be a contiguous int32 {want} tensor on "
                f"{q.device}, got {ids.dtype} {list(ids.shape)} on "
                f"{ids.device}{'' if ids.is_contiguous() else ' (strided)'}")


def _ptr(ids):
    return None if ids is None else ids.data_ptr()


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


# ---------------------------------------------------------------- plain
def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """k/v ``[B, S, KVH, D]`` as f32 ``[B, H, S, D]`` (kv head h // rep)."""
    kh = x.shape[2]
    x = x.float().transpose(1, 2)
    return x if kh == h else x.repeat_interleave(h // kh, dim=1)


def _scores(q, k, scale, causal, scale_first, q_segments=None,
            k_segments=None):
    """f32 ``[B, H, Sq, Sk]`` scores, masked keys at -inf.  The reference
    scales q before the product in the forward (:97) and the product
    after it in the backward (:223)."""
    qf = q.float().transpose(1, 2)
    kf = _heads(k, q.shape[2])
    if scale_first:
        s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    else:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos + (sk - sq), float("-inf"))
    if q_segments is not None:
        other = q_segments[:, None, :, None] != k_segments[:, None, None, :]
        s = s.masked_fill(other, float("-inf"))
    return s


def _lse_safe(lse):
    return torch.where(lse == float("-inf"), 0.0, lse)[..., None]


def flash_attention_fwd_reference(q, k, v, scale: Optional[float] = None,
                                  causal: bool = False, q_segments=None,
                                  k_segments=None):
    """Plain version of the forward kernel: ``(out [B, Sq, H, D] in q's
    dtype, lse [B, H, Sq] f32)``."""
    _check(q, k, v)
    s = _scores(q, k, _scale(scale, q.shape[-1]), causal, True, q_segments,
                k_segments)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.matmul(p, _heads(v, q.shape[2])) / l_safe
    lse = torch.where(l == 0.0, float("-inf"), m + torch.log(l_safe))
    return out.transpose(1, 2).to(q.dtype), lse[..., 0]


def _probs(q, k, lse, scale, causal, q_segments, k_segments):
    return torch.exp(_scores(q, k, scale, causal, False, q_segments,
                             k_segments) - _lse_safe(lse))


def flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                     scale: Optional[float] = None,
                                     causal: bool = False, q_segments=None,
                                     k_segments=None) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq [B, Sq, H, D]`` in q's dtype."""
    _check(q, k, v)
    scale = _scale(scale, q.shape[-1])
    h = q.shape[2]
    p = _probs(q, k, lse, scale, causal, q_segments, k_segments)
    dp = torch.matmul(dout.float().transpose(1, 2),
                      _heads(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, _heads(k, h)) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                      scale: Optional[float] = None,
                                      causal: bool = False, q_segments=None,
                                      k_segments=None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel: ``(dk, dv)`` with k/v's shape and
    dtypes; a kv head sums its query heads in f32."""
    _check(q, k, v)
    scale = _scale(scale, q.shape[-1])
    b, _, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    p = _probs(q, k, lse, scale, causal, q_segments, k_segments)
    dof = dout.float().transpose(1, 2)
    dp = torch.matmul(dof, _heads(v, h).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)                 # [B,H,Sk,D]
    dk = torch.matmul(ds.transpose(-1, -2),
                      q.float().transpose(1, 2)) * scale

    def per_kv_head(x):
        return x.view(b, kh, h // kh, sk, d).sum(2).transpose(1, 2)
    return per_kv_head(dk).to(k.dtype), per_kv_head(dv).to(v.dtype)


# -------------------------------------------------------------- kernels
def _check_cuda(name, tensors):
    """Raise on anything the kernels do not take."""
    dev = tensors[0][1].device
    dtype = tensors[0][1].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype}; the kernels take "
                         f"float32, float16 and bfloat16")
    for tname, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype}, q is {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must be contiguous in its "
                             f"last dim")
        # rows are read with 16-byte vector loads
        es = t.element_size()
        if t.data_ptr() % 16 or any(st * es % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {tname} rows must start on 16-byte "
                             f"boundaries (data pointer and strides)")


def _check_tma(name, tensors):
    """Raise on a layout the 16-bit kernels' TMA copies cannot address:
    every dim of more than one row needs a positive byte stride below
    2**40 (the 16-byte alignment is ``_check_cuda``'s)."""
    for tname, t in tensors:
        es = t.element_size()
        for dim in range(3):
            st = t.stride(dim)
            if t.shape[dim] > 1 and not 0 < st * es < 2 ** 40:
                raise ValueError(
                    f"{name}: {tname}'s stride {st} in dim {dim} cannot be "
                    f"read by TMA (it needs a positive byte stride below "
                    f"2**40 for every dim of more than one row)")


def _stats(name, t, shape, dev):
    if t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, q on {dev}")
    return t.contiguous()


def _padded(*tensors):
    """The operands zero-padded to the head dim the kernels run at
    (``head_dim.kernel_head_dim``); raises above 128."""
    dp = kernel_head_dim(tensors[0].shape[-1])
    return [pad_head_dim(t, dp) for t in tensors]


def _unpad(t, d):
    """A kernel output at the padded head dim, sliced back to ``d``."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _dims(q, k):
    b, sq, h, d = q.shape
    return b, sq, k.shape[1], h, k.shape[2], d


def _run(fn_name, dev, args):
    from ._build import load
    fn = getattr(load("flash_attention"), fn_name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc >= _TMA_REFUSED:
        raise ValueError(f"{fn_name}: the driver refuses a TMA tensor map "
                         f"of q/k/v/dout (cuTensorMapEncodeTiled returned "
                         f"CUresult {rc - _TMA_REFUSED})")
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed with CUDA "
                           f"error {rc}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, causal: bool = False,
                        q_segments: Optional[torch.Tensor] = None,
                        k_segments: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Sq, H, D], lse [B, H, Sq] f32)``: the CUDA kernel for
    CUDA tensors (raises on what it does not take: mixed devices or
    dtypes, a head_dim above 128, rows not on 16-byte boundaries, a
    16-bit layout TMA cannot address, segment ids that are not
    contiguous int32 ``[B, Sq]`` / ``[B, Sk]`` on q's device; a head_dim
    other than 64 / 128 is zero-padded to the next of them, the scale
    kept at the true head_dim, and the outputs sliced back), the plain
    version for CPU tensors."""
    _check(q, k, v)
    _segments(q, k, q_segments, k_segments)
    if q.device.type != "cuda":
        return flash_attention_fwd_reference(q, k, v, scale, causal,
                                             q_segments, k_segments)
    d = q.shape[-1]
    scale = _scale(scale, d)
    q, k, v = _padded(q, k, v)
    _check_cuda("flash_attention_fwd", [("q", q), ("k", k), ("v", v)])
    if q.dtype != torch.float32:
        _check_tma("flash_attention_fwd", [("q", q), ("k", k), ("v", v)])
    b, sq, sk, h, kh, dp = _dims(q, k)
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _run("flash_attention_fwd", q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(q_segments), _ptr(k_segments),
        _DTYPE_CODES[q.dtype], b, sq, sk, h, kh, dp,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(bool(causal))))
    flash_attention_fwd.launches += 1
    return _unpad(out, d), lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                           scale: Optional[float] = None,
                           causal: bool = False, q_segments=None,
                           k_segments=None) -> torch.Tensor:
    """``dq [B, Sq, H, D]``: the CUDA kernel for CUDA tensors (raises on
    what it does not take, as :func:`flash_attention_fwd` does, dout
    included), the plain version for CPU tensors."""
    _check(q, k, v)
    _segments(q, k, q_segments, k_segments)
    if q.device.type != "cuda":
        return flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                                scale, causal, q_segments,
                                                k_segments)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    scale = _scale(scale, d)
    q, k, v, dout = _padded(q, k, v, dout)
    operands = [("q", q), ("k", k), ("v", v), ("dout", dout)]
    _check_cuda("flash_attention_bwd_dq", operands)
    if q.dtype != torch.float32:
        _check_tma("flash_attention_bwd_dq", operands)
    b, sq, sk, h, kh, dp = _dims(q, k)
    lse = _stats("lse", lse, (b, h, sq), q.device)
    delta = _stats("delta", delta, (b, h, sq), q.device)
    dq = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    _run("flash_attention_bwd_dq", q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(q_segments),
        _ptr(k_segments), _DTYPE_CODES[q.dtype], b, sq, sk, h, kh, dp,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], scale, int(bool(causal))))
    flash_attention_bwd_dq.launches += 1
    return _unpad(dq, d)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                            scale: Optional[float] = None,
                            causal: bool = False, q_segments=None,
                            k_segments=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` with k/v's shape: the CUDA kernel for CUDA tensors
    (raises on what it does not take, as :func:`flash_attention_fwd` does,
    dout included), the plain version for CPU tensors."""
    _check(q, k, v)
    _segments(q, k, q_segments, k_segments)
    if q.device.type != "cuda":
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                 scale, causal, q_segments,
                                                 k_segments)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    d = q.shape[-1]
    scale = _scale(scale, d)
    q, k, v, dout = _padded(q, k, v, dout)
    operands = [("q", q), ("k", k), ("v", v), ("dout", dout)]
    _check_cuda("flash_attention_bwd_dkv", operands)
    if q.dtype != torch.float32:
        _check_tma("flash_attention_bwd_dkv", operands)
    b, sq, sk, h, kh, dp = _dims(q, k)
    lse = _stats("lse", lse, (b, h, sq), q.device)
    delta = _stats("delta", delta, (b, h, sq), q.device)
    dk = torch.empty((b, sk, kh, dp), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, kh, dp), dtype=v.dtype, device=q.device)
    _run("flash_attention_bwd_dkv", q.device, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(q_segments), _ptr(k_segments), _DTYPE_CODES[q.dtype], b, sq, sk,
        h, kh, dp,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], scale, int(bool(causal))))
    flash_attention_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


# launches of each CUDA kernel since its count was last set to 0
flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


# ------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """The reference's custom_vjp pairs (:415-432, and :436-461 with
    segment ids): forward saves ``(q, k, v, out, lse, q_segments,
    k_segments)``; backward computes delta, then dq, then dk/dv, and gives
    the ids no gradient (the reference's float0 cotangents)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segments, k_segments, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, q_segments,
                                       k_segments)
        ctx.save_for_backward(q, k, v, out, lse, q_segments, k_segments)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, qs, ks = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.scale,
                                    ctx.causal, qs, ks)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         ctx.scale, ctx.causal, qs, ks)
        return dq, dk, dv, None, None, None, None


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on ``[B, S, H, D]`` (k/v may carry
    fewer heads); ``scale`` defaults to ``1 / sqrt(D)``."""
    _check(query, key, value)
    return _FlashAttention.apply(query, key, value, None, None,
                                 _scale(scale, query.shape[-1]),
                                 bool(causal))


def flash_attention_varlen(query: torch.Tensor, key: torch.Tensor,
                           value: torch.Tensor, q_segments, k_segments,
                           causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Segment-masked (varlen / packed) flash attention; differentiable.

    query ``[B, Sq, H, D]``, key/value ``[B, Sk, KVH, D]``; ``q_segments``
    ``[B, Sq]`` / ``k_segments`` ``[B, Sk]`` integer ids (taken as int32
    on query's device): only same-segment (query, key) pairs attend, so a
    pack of documents attends within each one.  Use ids that match
    nothing (e.g. -1 for queries, -2 for keys) for padding; its rows give
    0.  With ``causal`` the bottom-right causal mask applies on top."""
    _check(query, key, value)
    qs, ks = (torch.as_tensor(ids, dtype=torch.int32,
                              device=query.device).contiguous()
              for ids in (q_segments, k_segments))
    return _FlashAttention.apply(query, key, value, qs, ks,
                                 _scale(scale, query.shape[-1]),
                                 bool(causal))


def flash_attention_with_lse(query: torch.Tensor, key: torch.Tensor,
                             value: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: ``(out [B, Sq, H, D], lse [B, H, Sq] f32)``, the
    log-sum-exp that combines partial attentions (ring attention)."""
    return flash_attention_fwd(query, key, value, scale, causal)
