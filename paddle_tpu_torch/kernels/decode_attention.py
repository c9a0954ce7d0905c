"""Decode attention: a short block of fresh queries against a KV cache
with per-row valid lengths (counterpart of paddle_tpu/kernels/
decode_attention.py).

  * :func:`decode_attention` launches the hand-written CUDA kernels
    (``csrc/decode_attention.cu``, built for ``sm_90a`` at first use): in
    16 bits, a split-KV walk at ``sq == 1`` (the blocks' partial softmaxes
    go through a workspace kept per device and stream, merged by the last
    block of each row) and a wgmma kernel for longer chunks;
  * :func:`decode_attention_reference` is the plain PyTorch version with
    exactly the reference's masking and rounding;
  * :func:`decode_attention_auto` dispatches on where the tensors live:
    a CUDA tensor always goes to the kernel, a CPU tensor always to the
    plain version.  There is no routing table and no fallback.

Layouts are the reference's: q ``[B, sq, H, D]``, k/v caches
``[B, S_max, KVH, D]`` (``H % KVH == 0``, grouped-query heads by
``h // (H // KVH)``), seq_lens ``[B]`` = valid cache rows per batch row,
counting the fresh chunk.  With ``causal_tail`` query ``t`` sees cache
rows ``kpos <= seq_len - sq + t``.  A query that sees no row yields 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .head_dim import kernel_head_dim, pad_head_dim

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_attention_auto"]

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# cache rows each block of the 16-bit sq == 1 kernel walks (a multiple of
# its 32-row tile); the grid is sized from S_max, never from seq_lens
_SPLIT_ROWS = 256
# the launch returns 2000 + the CUresult of a refused tensor map
_TMA_REFUSED = 2000
# (device index, stream) -> (f32 partials, int32 counters): the sq == 1
# kernel's workspace.  Its counters are zeros between calls (the kernel
# resets them), so it is allocated once and only ever grown.  A CUDA graph
# may hold the pointers of a workspace a larger call replaced, so a
# replaced pair is kept alive in _RETIRED, never freed.
_workspaces = {}
_RETIRED = []


def _workspace(dev, stream, n_part, n_count):
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_count:
        if ws is not None:
            _RETIRED.append(ws)
            n_part = max(n_part, ws[0].numel())
            n_count = max(n_count, ws[1].numel())
        ws = _workspaces[key] = (
            torch.empty(n_part, dtype=torch.float32, device=dev),
            torch.zeros(n_count, dtype=torch.int32, device=dev))
    return ws


def _check(q, k_cache, v_cache, seq_lens):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError("decode_attention wants q [B, sq, H, D] and k/v "
                         "[B, S_max, KVH, D]")
    b, sq, h, d = q.shape
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"vs {tuple(v_cache.shape)}")
    kb, _, kh, kd = k_cache.shape
    if kb != b or kd != d:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)} in batch or head_dim")
    if kh < 1 or h % kh:
        raise ValueError(f"heads {h} is not a multiple of kv_heads {kh}")
    if tuple(seq_lens.shape) != (b,):
        raise ValueError(f"seq_lens must be [{b}], got "
                         f"{tuple(seq_lens.shape)}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, seq_lens: torch.Tensor,
                     scale: Optional[float] = None,
                     causal_tail: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns a new
    ``[B, sq, H, D]`` tensor.  Raises on anything the kernel does not
    take: an input that requires grad while grad is enabled (the kernel
    has no backward), tensors off the card, mixed devices or dtypes, a
    dtype other than float32/float16/bfloat16, a head_dim above 128, a
    last dim that is not contiguous, or rows not on 16-byte boundaries.
    q/k/v are read in place through their strides (views from a fused
    QKV projection are fine); a head_dim other than 64 / 128 is
    zero-padded to the next of them (``head_dim.pad_head_dim``, the
    scale kept at the true head_dim) and the output sliced back."""
    _check(q, k_cache, v_cache, seq_lens)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError(
            "decode_attention has no backward and would drop the gradient "
            "of its inputs; call it under torch.no_grad() (training "
            "attention goes through kernels.flash_attention)")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA tensors; got "
                         f"{dev} (decode_attention_auto takes CPU tensors "
                         f"to the plain version)")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes "
                         f"float32, float16 and bfloat16")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dp = kernel_head_dim(d)
    q, k_cache, v_cache = (pad_head_dim(t, dp)
                           for t in (q, k_cache, v_cache))
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        # rows are read with 16-byte vector loads
        es = t.element_size()
        if t.data_ptr() % 16 or any(st * es % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must start on 16-byte "
                             f"boundaries (data pointer and strides)")
    if seq_lens.is_floating_point():
        raise ValueError("seq_lens must be an integer tensor")
    from ._build import load
    lib = load("decode_attention")
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((b, sq, h, dp), dtype=q.dtype, device=dev)
    s_max = k_cache.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = count = None
        if sq == 1 and q.dtype != torch.float32:
            splits = max(1, -(-s_max // _SPLIT_ROWS))
            part, count = _workspace(dev, stream, b * h * splits * (2 + dp),
                                     b * h)
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(),
            _DTYPE_CODES[q.dtype], b, sq, h, k_cache.shape[2], s_max, dp,
            *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
            scale, int(bool(causal_tail)), _SPLIT_ROWS, stream)
    if rc >= _TMA_REFUSED:
        raise ValueError(f"decode_attention: cuTensorMapEncodeTiled refuses "
                         f"a TMA tensor map of q/k/v (CUresult "
                         f"{rc - _TMA_REFUSED})")
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with "
                           f"CUDA error {rc}")
    decode_attention.launches += 1
    return out if dp == d else out[..., :d].contiguous()


# launches of the CUDA kernel since the count was last set to 0
decode_attention.launches = 0


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, seq_lens: torch.Tensor,
                               scale: Optional[float] = None,
                               causal_tail: bool = True) -> torch.Tensor:
    """Dense form with exactly the reference's semantics
    (decode_attention.py:158-185): f32 scores, softmax and accumulation,
    one final cast, masked rows give 0."""
    _check(q, k_cache, v_cache, seq_lens)
    b, sq, h, d = q.shape
    kh = k_cache.shape[2]
    if kh != h:
        k_cache = k_cache.repeat_interleave(h // kh, dim=2)
        v_cache = v_cache.repeat_interleave(h // kh, dim=2)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k_cache.float()) * scale
    s_max = k_cache.shape[1]
    kpos = torch.arange(s_max, device=q.device)[None, None, None, :]
    lens = seq_lens.to(device=q.device, dtype=torch.long)[:, None, None,
                                                          None]
    valid = kpos < lens
    if causal_tail:
        qpos = torch.arange(sq, device=q.device)[None, None, :, None]
        valid = valid & (kpos <= lens - sq + qpos)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqs,bshd->bqhd", p, v_cache.float())
    return out.to(q.dtype)


def decode_attention_auto(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, seq_lens: torch.Tensor,
                          scale: Optional[float] = None,
                          causal_tail: bool = True) -> torch.Tensor:
    """The models' decode attention: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    fn = decode_attention if q.device.type == "cuda" \
        else decode_attention_reference
    return fn(q, k_cache, v_cache, seq_lens, scale=scale,
              causal_tail=causal_tail)
