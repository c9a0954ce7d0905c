"""Fused RMSNorm and LayerNorm, forward and backward (counterpart of
paddle_tpu/kernels/fused_norm.py).

Four hand-written CUDA kernels (``csrc/fused_norm.cu``, built for
``sm_90a`` at first use), each beside its plain PyTorch version with the
reference kernel's arithmetic:

  * :func:`rms_norm_fwd`   ``(y, rstd)``         (``_rms_fwd_kernel`` :22)
  * :func:`rms_norm_bwd`   ``(dx, dw)``          (``_rms_bwd_kernel`` :30)
  * :func:`layer_norm_fwd` ``(y, mean, rstd)``   (``_ln_fwd_kernel`` :167)
  * :func:`layer_norm_bwd` ``(dx, dw, db)``      (``_ln_bwd_kernel`` :179)

A wrapper launches its kernel for CUDA tensors and takes its plain version
for CPU tensors; there is no routing table and no fallback.  The
differentiable entry points are :class:`RMSNormFunction` and
:class:`LayerNormFunction` (``torch.autograd.Function``), which run the
forward wrapper and, in backward, the backward wrapper on the saved
``(x, w, rstd)`` / ``(x, w, b, mean, rstd)``.

Numerics (fused_norm.py:22-51, :167-205): x ``[rows, h]`` in f32, f16 or
bf16; w (and b) ``[h]`` in x's dtype or f32; statistics, affine and
gradients in f32; y and dx cast once to x's dtype; the statistics are
f32 ``[rows, 1]``; dw (and db) are summed over every row in f32 and cast
to w's dtype.  Unlike the TPU kernel there is no row blocking: any row
count and any ``h`` are taken (rows of whole 16-byte groups are read 16
bytes at a time, others element by element).

The backward is two launches (:func:`bwd_plan` sizes the first): a row
kernel whose blocks each walk many rows and write one f32 partial row of
dw (and db), then a column sum of those rows in a fixed order, so two
calls give the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rms_norm_fwd", "rms_norm_bwd", "layer_norm_fwd",
           "layer_norm_bwd", "rms_norm_fwd_reference",
           "rms_norm_bwd_reference", "layer_norm_fwd_reference",
           "layer_norm_bwd_reference", "RMSNormFunction",
           "LayerNormFunction", "bwd_plan"]

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# threads of a backward row block (kBwdThreads in csrc/fused_norm.cu)
BWD_THREADS = 512


# --------------------------------------------------------------- checks
def _check(name: str, x, w, b=None, stats=(), g=None) -> None:
    """Shapes and dtypes every version takes: x ``[rows, h]``, w (and b)
    ``[h]`` in x's dtype or f32 (b in w's dtype), each statistic f32
    ``[rows, 1]``, g like x."""
    if x.dim() != 2:
        raise ValueError(f"{name} wants x [rows, h], got {list(x.shape)}")
    rows, h = x.shape
    dtype = x.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported x dtype {dtype}; the "
                         f"kernels take float32, float16 and bfloat16")
    for vname, v in (("w", w), ("b", b)):
        if v is None:
            continue
        if v.shape != (h,):
            raise ValueError(f"{name}: {vname} must be [{h}], got "
                             f"{list(v.shape)}")
        if v.dtype is not dtype and v.dtype is not torch.float32:
            raise ValueError(f"{name}: {vname} must be x's dtype {dtype} "
                             f"or float32, got {v.dtype}")
    if b is not None and b.dtype is not w.dtype:
        raise ValueError(f"{name}: b is {b.dtype}, w is {w.dtype}; they "
                         f"must match")
    for sname, s in stats:
        if s.dtype is not torch.float32 or s.shape != (rows, 1):
            raise ValueError(f"{name}: {sname} must be float32 [{rows}, 1], "
                             f"got {s.dtype} {list(s.shape)}")
    if g is not None and (g.shape != x.shape or g.dtype is not dtype):
        raise ValueError(f"{name}: g must match x {dtype} "
                         f"{list(x.shape)}, got {g.dtype} {list(g.shape)}")


def _check_cuda(name: str, tensors) -> int:
    """Raise on what the kernels do not take (mixed devices, a tensor not
    contiguous).  Returns 1 when the ``[rows, h]`` and ``[h]`` tensors
    among ``tensors`` (the f32 statistics are read one by one) all start
    on 16-byte boundaries and hold rows of whole 16-byte groups: the
    kernels' vector path."""
    dev = tensors[0][1].device
    h = tensors[0][1].shape[-1]
    vec = 1
    for tname, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if vec and tname != "mean" and tname != "rstd" and (
                t.data_ptr() % 16 or h * t.element_size() % 16):
            vec = 0
    return vec


# the library's entry points, resolved at their first launch
_ENTRY = {}


def _launch(fn_name: str, dev: torch.device, args) -> None:
    fn = _ENTRY.get(fn_name)
    if fn is None:
        from ._build import load
        fn = _ENTRY[fn_name] = getattr(load("fused_norm"), fn_name)
    # the raw handle of the device's current stream (torch.cuda.
    # current_stream builds a Stream object for it on every call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed with CUDA "
                           f"error {rc}")


def _tpr_log2(h: int, n: int) -> int:
    """log2 of the threads of a backward row segment for rows of ``h``
    taken ``n`` elements a group: the fewest (a power of two) whose groups
    cover the row, a thread holding 2 groups of 16 bytes or 8 scalars
    (kBwdVpt); -1 past ``BWD_THREADS`` of them (the long-row kernel)."""
    vpt = 2 if n > 1 else 8
    tpr_log2 = (-(-(h // n) // vpt) - 1).bit_length()
    return -1 if (1 << tpr_log2) > BWD_THREADS else tpr_log2


def bwd_plan(rows: int, h: int, n: int, per_card: int) -> Tuple[int, int]:
    """The backward row kernel's launch for x ``[rows, h]`` taken ``n``
    elements a group (16-byte groups, or 1): ``(tpr_log2, blocks)``.  A
    row is a segment of ``1 << tpr_log2`` threads (:func:`_tpr_log2`) and
    ``BWD_THREADS >> tpr_log2`` rows share a block; ``tpr_log2`` -1 takes
    the long-row kernel, a block a row at a time.  ``blocks`` (the
    partial rows of dw / db): the fewest that walk the rows in as many
    turns as ``per_card`` blocks (what fits on the card at once) would,
    so that every block takes as many turns, or one fewer."""
    tpr_log2 = _tpr_log2(h, n)
    units = rows if tpr_log2 < 0 else -(-rows // (BWD_THREADS >> tpr_log2))
    turns = -(-units // per_card)
    return tpr_log2, -(-units // turns)


# backward blocks that fit on a device at once, by (device index, rms, x
# and w dtype codes, vec, long rows)
_PER_CARD = {}


def _per_card(dev: torch.device, key) -> int:
    n = _PER_CARD.get((dev.index, *key))
    if n is None:
        from ._build import load
        with torch.cuda.device(dev):
            n = load("fused_norm").fused_norm_bwd_blocks(*key)
        if n < 1:
            raise RuntimeError(f"fused_norm_bwd_blocks failed for {key}")
        _PER_CARD[(dev.index, *key)] = n
    return n


# ---------------------------------------------------------------- plain
def rms_norm_fwd_reference(x, w, eps: float):
    """``(y, rstd)``: ``y = x·rstd·w`` in f32, cast once; ``rstd`` f32
    ``[rows, 1]`` (fused_norm.py:22-27)."""
    _check("rms_norm_fwd", x, w)
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rstd * w.float()).to(x.dtype), rstd


def rms_norm_bwd_reference(x, w, rstd, g):
    """``(dx, dw)``: ``dx = rstd·(g·w − x̂·mean(g·w·x̂))``, ``dw = Σ_rows
    g·x̂`` in f32 cast to w's dtype (fused_norm.py:30-51)."""
    _check("rms_norm_bwd", x, w, stats=(("rstd", rstd),), g=g)
    xhat = x.float() * rstd
    gw = g.float() * w.float()
    mean_gx = (gw * xhat).mean(-1, keepdim=True)
    dx = (rstd * (gw - xhat * mean_gx)).to(x.dtype)
    return dx, (g.float() * xhat).sum(0).to(w.dtype)


def layer_norm_fwd_reference(x, w, b, eps: float):
    """``(y, mean, rstd)``: ``y = (x−μ)·rstd·w + b`` in f32, cast once,
    with the two-pass variance about μ (fused_norm.py:167-176)."""
    _check("layer_norm_fwd", x, w, b)
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * rstd * w.float() + b.float()).to(x.dtype), mu, rstd


def layer_norm_bwd_reference(x, w, mean, rstd, g):
    """``(dx, dw, db)``: ``dx = rstd·(g·w − mean(g·w) − x̂·mean(g·w·x̂))``,
    ``dw = Σ_rows g·x̂`` and ``db = Σ_rows g`` in f32 cast to w's dtype
    (fused_norm.py:179-205)."""
    _check("layer_norm_bwd", x, w, stats=(("mean", mean), ("rstd", rstd)),
           g=g)
    xhat = (x.float() - mean) * rstd
    g32 = g.float()
    gw = g32 * w.float()
    mean_gw = gw.mean(-1, keepdim=True)
    mean_gx = (gw * xhat).mean(-1, keepdim=True)
    dx = (rstd * (gw - mean_gw - xhat * mean_gx)).to(x.dtype)
    return dx, (g32 * xhat).sum(0).to(w.dtype), g32.sum(0).to(w.dtype)


# -------------------------------------------------------------- kernels
def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [rows, h], rstd [rows, 1] f32)``: the CUDA kernel for CUDA
    tensors (raises on mixed devices or a tensor not contiguous), the
    plain version for CPU tensors."""
    _check("rms_norm_fwd", x, w)
    if x.device.type != "cuda":
        return rms_norm_fwd_reference(x, w, eps)
    vec = _check_cuda("rms_norm_fwd", [("x", x), ("w", w)])
    rows, h = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    if rows:
        _launch("fused_norm_fwd", x.device, (
            x.data_ptr(), w.data_ptr(), None, y.data_ptr(), None,
            rstd.data_ptr(), 1, _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
            rows, h, float(eps), vec))
        rms_norm_fwd.launches += 1
    return y, rstd


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                 g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)``: the CUDA kernel pair (the row walk, then the column
    sum of its partial rows) for CUDA tensors, the plain version for CPU
    tensors."""
    _check("rms_norm_bwd", x, w, stats=(("rstd", rstd),), g=g)
    if x.device.type != "cuda":
        return rms_norm_bwd_reference(x, w, rstd, g)
    return _bwd("rms_norm_bwd", x, w, None, rstd, g)


def layer_norm_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y [rows, h], mean, rstd [rows, 1] f32)``: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check("layer_norm_fwd", x, w, b)
    if x.device.type != "cuda":
        return layer_norm_fwd_reference(x, w, b, eps)
    vec = _check_cuda("layer_norm_fwd", [("x", x), ("w", w), ("b", b)])
    rows, h = x.shape
    y = torch.empty_like(x)
    # sizes as arguments: a tuple costs more host time to parse
    mean = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
    if rows:
        _launch("fused_norm_fwd", x.device, (
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), 0, _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[w.dtype], rows, h, float(eps), vec))
        layer_norm_fwd.launches += 1
    return y, mean, rstd


def layer_norm_bwd(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dw, db)``: the CUDA kernel pair for CUDA tensors, the plain
    version for CPU tensors."""
    _check("layer_norm_bwd", x, w, stats=(("mean", mean), ("rstd", rstd)),
           g=g)
    if x.device.type != "cuda":
        return layer_norm_bwd_reference(x, w, mean, rstd, g)
    return _bwd("layer_norm_bwd", x, w, mean, rstd, g)


def _bwd(name: str, x, w, mean, rstd, g):
    rms = mean is None
    rows, h = x.shape
    named = [("x", x), ("w", w), ("rstd", rstd), ("g", g)] + \
        ([] if rms else [("mean", mean)])
    vec = _check_cuda(name, named)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = None if rms else torch.empty_like(w)
    if not rows:
        dw.zero_()
        return (dx, dw) if rms else (dx, dw, db.zero_())
    xc, wc = _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype]
    n = 16 // x.element_size() if vec else 1
    tpr_log2, blocks = bwd_plan(rows, h, n, _per_card(
        x.device, (int(rms), xc, wc, vec, int(_tpr_log2(h, n) < 0))))
    part = torch.empty((1 if rms else 2) * blocks, h, dtype=torch.float32,
                       device=x.device)
    _launch("fused_norm_bwd", x.device, (
        x.data_ptr(), w.data_ptr(), None if rms else mean.data_ptr(),
        rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        None if rms else db.data_ptr(), part.data_ptr(), int(rms), xc, wc,
        rows, h, tpr_log2, blocks, vec))
    if rms:
        rms_norm_bwd.launches += 1
        return dx, dw
    layer_norm_bwd.launches += 1
    return dx, dw, db


# launches of each CUDA kernel since its count was last set to 0
rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0
layer_norm_fwd.launches = 0
layer_norm_bwd.launches = 0


# ------------------------------------------------------------- autograd
class RMSNormFunction(torch.autograd.Function):
    """RMSNorm over the last dim of ``x [..., h]`` with weight ``[h]``
    (the reference's ``_rms_core`` custom_vjp, :64-92): forward saves
    ``(x, w, rstd)``, backward runs :func:`rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, rstd = rms_norm_fwd(x2, weight, eps)
        ctx.save_for_backward(x2, weight, rstd)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, gy):
        x2, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x2, w, rstd, gy.reshape(x2.shape).contiguous())
        return dx.view(ctx.shape), dw, None


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last dim of ``x [..., h]`` with weight and bias
    ``[h]`` (``_ln_core``, :218-248): forward saves ``(x, w, b, mean,
    rstd)``, backward runs :func:`layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, bias, mean, rstd)
        ctx.shape = x.shape
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, gy):
        x2, w, _, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, w, mean, rstd,
                                    gy.reshape(x2.shape).contiguous())
        return dx.view(ctx.shape), dw, db, None
