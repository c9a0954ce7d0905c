"""Decode block: a transformer layer's decode step as two fused kernels
(counterpart of paddle_tpu/kernels/decode_block.py).

  * :func:`decode_block_attn` — norm1 -> q/k/v projection -> bias ->
    rotary -> the fresh K/V row stored into the ``KVPool`` slabs in place
    at ``min(pos, S-1)`` -> online-softmax attention over the live rows
    ``kpos < min(pos, S-1)`` with the fresh row (in the storage dtype)
    folded in last;
  * :func:`decode_block_mlp` — out-projection + residual -> norm2 -> MLP
    (gelu_tanh, exact gelu, or SwiGLU) -> residual;
  * :func:`decode_block_layer` — the pair, with the tiles
    :func:`plan_decode_block` approves.

A CUDA tensor always goes to the hand-written kernels
(``csrc/decode_block.cu``, built for ``sm_90a`` at first use); a CPU
tensor always goes to the plain PyTorch version, which has exactly the
kernels' semantics (:func:`decode_block_reference` is the pair of plain
halves).  There is no fallback: a CUDA tensor the kernels do not take
raises, and so does a failed build or launch.  Each wrapper counts its
kernel launches in ``.launches``.

Masking contract (the reference's): with ``pos`` a slot's cache length
before the step, streamed rows ``kpos < min(pos, S-1)`` are valid and
the fresh token is written at ``min(pos, S-1)`` and always attends to
itself, so a free slot (pos 0) attends only to itself and a full slot
(pos >= S) overwrites its last row.

Planning differs from the TPU's.  There, the attention block keeps a kv
head's weight slices and the MLP block the whole out-projection resident
in a 12 MiB VMEM budget, which refuses gpt3_6_7b.  On Hopper weights
stream through shared memory in tiles, so nothing large stays resident;
:func:`plan_decode_block` sizes the two tiles the kernels take —
``block_k`` (K/V rows per attention tile) and ``block_f`` (input rows
per projection chunk, the ffn tile of the down-projection) — against the
shared memory one block may use (232,448 bytes on an H100), and reports
what the kernels allocate at those tiles.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .decode_attention import decode_attention_reference

__all__ = ["decode_block_attn", "decode_block_mlp", "decode_block_layer",
           "decode_block_attn_reference", "decode_block_mlp_reference",
           "decode_block_reference", "plan_decode_block", "fusion_legal",
           "resolve_fused_decode", "gemv", "gemv_reference", "plan_gemv",
           "gemv_blocks", "SMEM_BUDGET"]

# shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET = 232_448

# launch geometry of csrc/decode_block.cu
_THREADS = 256
_WARPS = _THREADS // 32
_ROWS = 8                       # batch rows per projection block
_ROW_STEP = 64                  # K slices are whole multiples of this
_SM_BLOCKS = 264                # projection blocks that fill an H100 (2 x 132)
_MAX_BLOCK_K = 64
_MAX_BLOCK_F = 2048
# the register-resident attention path: block_k 64 (8 rows x 8 warps)
_FAST_BLOCK_K = 64
_FAST_HEAD_DIMS = (64, 128)
_FAST_REPS = (1, 2, 4, 8)

# the bf16 weights' stream kernel (csrc/gemv.cuh, gemv_stream_kernel):
# persistent blocks, at most one per SM, each streaming its units of 64
# weight rows x 128 output columns through a ring of TMA stages into
# mma.sync for up to 16 batch rows
_STRIP = 128                    # output columns of a strip
_TILE = 64                      # weight rows of a unit (one ring stage)
_STREAM_ROWS = 16               # batch rows of a block (one MMA's M)
_MAX_STAGES = 12
_MAX_SPLIT_K = 8                # K splits a merge reads at most
_STAGE_BYTES = _TILE * _STRIP * 2   # a stage's weight tile [64, 128] bf16
_PART_SLOT = _STREAM_ROWS * _STRIP   # floats of one workspace slot
_STREAM_SHARED = 424            # sizeof(StreamShared): barriers, row stats
_H100_SMS = 132
# the launch returns 2000 + the CUresult of a refused tensor map
_TMA_REFUSED = 2000

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
_ACTS = {"gelu_tanh": 1, "gelu": 2}
_NORMS = ("layer", "rms")

# ------------------------------------------------------------- ctypes args
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


class _GemvArgs(ctypes.Structure):
    """Mirror of ``GemvArgs`` in csrc/gemv.cuh."""
    _fields_ = [("inp", _P), ("stats", _P), ("nw", _P), ("nb", _P),
                ("w", _P * 3), ("bias", _P * 3), ("res", _P), ("out", _P),
                ("part", _P), ("counters", _P), ("ld_in", _LL),
                ("ld_w", _LL * 3), ("ld_res", _LL), ("ld_out", _LL),
                ("rows", _I), ("K", _I), ("N", _I), ("seg_end", _I * 3),
                ("in_mode", _I), ("in_f32", _I), ("res_f32", _I),
                ("out_f32", _I), ("act", _I), ("kc", _I), ("ksplit", _I),
                ("dtype", _I), ("stages", _I), ("grid", _I)]


class _AttnArgs(ctypes.Structure):
    """Mirror of ``AttnArgs`` in csrc/decode_block.cu."""
    _fields_ = [("qkv", _P), ("cos", _P), ("sin", _P), ("k_slab", _P),
                ("v_slab", _P), ("pos", _P), ("out", _P),
                ("ld_qkv", _LL), ("k_sb", _LL), ("k_ss", _LL), ("k_sh", _LL),
                ("v_sb", _LL), ("v_ss", _LL), ("v_sh", _LL),
                ("B", _I), ("H", _I), ("KH", _I), ("Dh", _I), ("S", _I),
                ("block_k", _I), ("pos_stride", _I), ("dtype", _I),
                ("scale", ctypes.c_float)]


# ------------------------------------------------------------------- norms
def _norm_f32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              norm: str, eps: float) -> torch.Tensor:
    """The models' norm numerics: f32, two-pass LayerNorm (mean, then the
    variance about it) or RMSNorm, affine applied after the rsqrt."""
    if norm == "layer":
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + eps) * w
        return y + b if b is not None else y
    ms = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(ms + eps) * w
    return y + b if b is not None else y


# ======================================================== planning / legality
def _gemv_cols(itemsize: int) -> int:
    """Output columns of one projection block: 32 lanes x 16 bytes."""
    return 32 * (16 // itemsize)


def _k_slice(k: int, n: int, rows: int, itemsize: int, cap: int):
    """``(kc, ksplit)`` of one projection ``[rows, k] x [k, n]``: split K
    into as many slices as one wave of the card holds (a second, mostly
    empty wave nearly doubles the projection's time), each slice a
    multiple of 64 rows and at most ``cap`` rows."""
    tiles = -(-n // _gemv_cols(itemsize)) * -(-rows // _ROWS)
    split = max(1, min(-(-k // _ROW_STEP), _SM_BLOCKS // tiles))
    kc = -(-k // split)
    kc = min(cap, -(-kc // _ROW_STEP) * _ROW_STEP)
    return kc, -(-k // kc)


def _gemv_smem(kc: int, itemsize: int) -> int:
    """Shared memory of one projection block: the staged input slice
    [kc, 8] f32, whose space the warps' sums [8 warps, 8, columns] f32
    reuse, plus the rows' norm statistics and the last-block flag."""
    return 4 * max(kc * _ROWS, _WARPS * _ROWS * _gemv_cols(itemsize)) \
        + 4 * (2 * _ROWS + 1)


def _stream_stage(rows: int, in_mode: int, in_f32: bool) -> int:
    """Bytes of one stream-kernel ring stage (``StreamLayout`` in
    csrc/gemv.cuh): the weight tile; the raw inputs, a box of 8 rows (16
    above 8 rows) x 64 columns of the input's elements, a second box for
    the SwiGLU modes, the norm's w and b [2, 64] bf16, rounded up to 128
    bytes; the inputs split into bf16 terms (three, or one for a bf16
    input without a transform), [rows, 72] each."""
    r = _STREAM_ROWS if rows > 8 else 8
    es = 4 if in_f32 else 2
    halves = 2 if in_mode in (2, 3) else 1
    splits = 3 if in_f32 or in_mode else 1
    raw = -(-(halves * r * _TILE * es + 2 * _TILE * 2) // 128) * 128
    return _STAGE_BYTES + raw + splits * r * (_TILE + 8) * 2


def _stream_smem(stages: int, stage: int) -> int:
    """Shared memory of one stream-kernel block: 1024 bytes of alignment
    slack, the ring's stages and the barriers."""
    return 1024 + stages * stage + _STREAM_SHARED


# the stream kernel's costs on an H100 (csrc/gemv.cuh), fitted to its
# times at the serving shapes under forced plans: the card streams ~2.9
# TB/s and one block a unit in ~0.8 us; a K split costs ~12 us (the
# partials' round trips, at the end), each strip after a block's first
# ~8 us (its flush stalls the block's ring)
_CARD_BYTES_PER_US = 2.9e6
_UNIT_US = 0.8
_SPLIT_US = 12.0
_STRIP_US = 8.0


def plan_gemv(k: int, widths, rows: int, *, in_mode: int = 0,
              in_f32: bool = False, sms: int = _H100_SMS,
              smem_budget: int = SMEM_BUDGET):
    """The bf16 stream kernel's plan for ``[rows, k] x [k, sum(widths)]``
    (``widths``: the output columns of each weight segment).  Returns
    ``(plan, None)`` or ``(None, reason)``, the reason starting with
    ``"smem:"``.

    Each segment is cut into strips of 128 columns (the last one ragged),
    K into ``kT = ceil(k / 64)`` tiles of 64 rows (a unit: one ring
    stage).  The blocks form ``grid`` column groups x ``ksplit`` K splits,
    at most one block per SM for each group ``y`` of 16 batch rows: block
    ``(c, q)`` takes strips ``c, c + grid, ...``, each over the K tiles
    ``[q kT / ksplit, (q + 1) kT / ksplit)``, so the blocks of one split
    read the same weight rows at the same time, side by side.  The two
    minimise the modelled time: the larger of the weight bytes over the
    card's rate and the busiest block's units over one block's rate, plus
    the cost of a K split and of each strip after a block's first (at
    most 8 splits).  With ``ksplit``
    1 every strip is finished by one block; otherwise each split writes
    its partial into workspace slot ``(y ksplit + q) strips + strip``
    (2048 floats) and the last split of a strip adds them in split
    order.  The ring takes as many stages as fit (at most 12), each sized
    to the input (``in_mode``, ``in_f32``: :func:`_stream_stage`)."""
    widths = tuple(int(w) for w in widths)
    groups = -(-rows // _STREAM_ROWS)
    strips = sum(-(-w // _STRIP) for w in widths)
    kt = -(-k // _TILE)
    blocks = max(1, sms // groups)
    best = None
    for gk in range(1, min(kt, blocks, _MAX_SPLIT_K) + 1):
        per_s = -(-strips // min(strips, blocks // gk))
        per_k = -(-kt // gk)
        gk, gc = -(-kt // per_k), -(-strips // per_s)
        us = max(strips * kt * _STAGE_BYTES / _CARD_BYTES_PER_US,
                 per_s * per_k * _UNIT_US)
        us += (_SPLIT_US if gk > 1 else 0.0) + (per_s - 1) * _STRIP_US
        if best is None or (us, gk) < best[:2]:
            best = (us, gk, gc, per_s * per_k)
    _, ksplit, grid, units = best
    stage = _stream_stage(rows, in_mode, in_f32)
    stages = min(_MAX_STAGES, (smem_budget - _stream_smem(0, stage))
                 // stage)
    if stages < 2:
        return None, (f"smem: the GEMV's ring needs "
                      f"{_stream_smem(2, stage)} bytes of shared memory at "
                      f"2 stages (budget {smem_budget})")
    return {"groups": groups, "strips": strips, "kT": kt,
            "grid": grid, "ksplit": ksplit, "units": units,
            "stages": stages, "smem": _stream_smem(stages, stage),
            "widths": widths, "k": k,
            "workspace": groups * ksplit * strips * _PART_SLOT,
            "counters": groups * strips}, None


def gemv_blocks(plan):
    """Each block of a row group of ``plan``, in launch order: ``(strips,
    (t0, t1))``, its strips and the K tiles it takes of each."""
    gc, gk, kt = plan["grid"], plan["ksplit"], plan["kT"]
    return [(list(range(b % gc, plan["strips"], gc)),
             (b // gc * kt // gk, (b // gc + 1) * kt // gk))
            for b in range(gc * gk)]


def _fast_attention(block_k: int, rep: int, head_dim: int) -> bool:
    """Whether the attention launch takes the register-resident path."""
    return (block_k == _FAST_BLOCK_K and head_dim in _FAST_HEAD_DIMS
            and rep in _FAST_REPS)


def _attn_smem(block_k: int, rep: int, head_dim: int) -> int:
    """Shared memory of one attention block, all f32.  Register path: q
    [rep, Dh], the fresh K/V row, the 8 warps' accumulators [8, rep, Dh]
    and softmax state.  Tile path: q and acc [rep, Dh], the K tile
    [block_k, Dh+1] and V tile [block_k, Dh], the scores [rep, block_k],
    the fresh K/V row and the softmax state."""
    if _fast_attention(block_k, rep, head_dim):
        return 4 * (rep * head_dim + 2 * head_dim
                    + _WARPS * rep * head_dim + 2 * _WARPS * rep)
    return 4 * (2 * rep * head_dim + block_k * (head_dim + 1)
                + block_k * head_dim + rep * block_k + 2 * head_dim
                + 3 * rep)


_STATS_SMEM = 4 * _WARPS


@functools.lru_cache(maxsize=4096)
def _stream_plan(k: int, widths: tuple, rows: int, in_mode: int,
                 in_f32: bool, sms: int) -> dict:
    """:func:`plan_gemv` at the launch's budget (the card's 227 KB), kept
    per shape: the projections' wrapper asks it on every call."""
    plan, why = plan_gemv(k, widths, rows, in_mode=in_mode, in_f32=in_f32,
                          sms=sms)
    if plan is None:
        raise ValueError(why)
    return plan


def _proj_smem(k: int, widths, rows: int, itemsize: int, cap: int,
               in_mode: int = 0, in_f32: bool = False) -> int:
    """Shared memory one projection launch takes: in bf16 the stream
    kernel's (its ring fills the card's budget, its stages sized to the
    input), in f32 the split-K kernel's at its K slice of at most ``cap``
    rows."""
    if itemsize == 2:
        return _stream_plan(k, tuple(widths), rows, in_mode, in_f32,
                            _H100_SMS)["smem"]
    return _gemv_smem(_k_slice(k, sum(widths), rows, itemsize, cap)[0],
                      itemsize)


def _pick_block_k(max_seq: int, rep: int, head_dim: int,
                  smem_budget: int) -> int:
    """K/V rows per attention pass: 64, halved while the tile exceeds the
    cache or the budget, down to 8."""
    bk = _MAX_BLOCK_K
    while bk > 8 and bk > max_seq:
        bk //= 2
    while bk > 8 and _attn_smem(bk, rep, head_dim) > smem_budget:
        bk //= 2
    return bk


def _pick_block_f(itemsize: int, smem_budget: int) -> int:
    """The most input rows one projection block takes (its K slice):
    2048, halved while the budget is exceeded, down to 64."""
    bf = _MAX_BLOCK_F
    while bf > _ROW_STEP and _gemv_smem(bf, itemsize) > smem_budget:
        bf //= 2
    return bf


def plan_decode_block(*, max_seq: int, hidden: int, heads: int,
                      kv_heads: int, head_dim: int, ffn: int, batch: int,
                      itemsize: int, gated: bool = False, tp: int = 1,
                      smem_budget: int = SMEM_BUDGET):
    """Pick ``(block_k, block_f)`` under the per-block shared-memory
    budget, or explain why no tiling fits.  Returns ``(plan, None)`` or
    ``(None, reason)``; ``plan`` holds ``block_k``, ``block_f`` and the
    bytes the kernels allocate at those tiles for this shape
    (``smem_attn``: the most any launch of ``decode_block_attn`` takes,
    ``smem_mlp`` the same for ``decode_block_mlp``).

    ``block_k`` (K/V rows per attention pass) starts at 64 and halves to
    8; ``block_f`` (the most weight rows one f32 projection block takes)
    starts at 2048 and halves to 64.  A bf16 projection is one launch of
    the stream kernel, whose ring takes the card's whole budget
    (:func:`plan_gemv`), whatever ``block_f``.  When even the smallest
    tiles and the projection's buffers do not fit, the reason starts with
    ``"smem:"``.  Weights stream, so their sizes never refuse.  ``gated``
    adds the SwiGLU gate's columns to the up-projection.

    ``tp > 1`` plans the sharded variant instead
    (``decode_block_tp.plan_decode_block_tp``): the per-shard attention
    tile and the K slice of each ring seam's hop kernel."""
    if tp > 1:
        from .decode_block_tp import plan_decode_block_tp
        return plan_decode_block_tp(
            max_seq=max_seq, hidden=hidden, heads=heads, kv_heads=kv_heads,
            head_dim=head_dim, ffn=ffn, batch=batch, itemsize=itemsize,
            tp=tp, gated=gated, smem_budget=smem_budget)
    rep = heads // kv_heads
    bk = _pick_block_k(max_seq, rep, head_dim, smem_budget)
    bf = _pick_block_f(itemsize, smem_budget)
    qkv = (heads * head_dim, kv_heads * head_dim, kv_heads * head_dim)
    smem_attn = max(_proj_smem(hidden, qkv, batch, itemsize, bf, 1),
                    _attn_smem(bk, rep, head_dim), _STATS_SMEM)
    if smem_attn > smem_budget:
        return None, (f"smem: attention block needs {smem_attn} bytes of "
                      f"shared memory even at block_k={bk} (budget "
                      f"{smem_budget})")
    # (K, widths, input transform, f32 input) of the three launches
    mlp = [(heads * head_dim, (hidden,), 0, False),
           (hidden, (ffn,) * (2 if gated else 1), 1, True),
           (ffn, (hidden,), 2 if gated else 0, True)]
    smem_mlp = max([_proj_smem(k, w, batch, itemsize, bf, m, f)
                    for k, w, m, f in mlp] + [_STATS_SMEM])
    if smem_mlp > smem_budget:
        return None, (f"smem: proj+MLP block needs {smem_mlp} bytes of "
                      f"shared memory even at block_f={bf} (budget "
                      f"{smem_budget})")
    return {"block_k": bk, "block_f": bf, "smem_attn": smem_attn,
            "smem_mlp": smem_mlp}, None


def _dtype_of(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    return getattr(torch, name) if isinstance(getattr(torch, name, None),
                                              torch.dtype) else None


def fusion_legal(*, max_seq: int, hidden: int, heads: int, kv_heads: int,
                 head_dim: int, ffn: int, batch: int, dtype,
                 gated: bool = False, tp: int = 1,
                 smem_budget: int = SMEM_BUDGET):
    """Static legality of the fused decode block for this shape/dtype.
    Returns ``(ok, reason)``; ``reason`` names the first failing check, in
    the reference's words where the reference has the check.

    ``tp > 1`` checks the sharded variant (``decode_block_tp``): the
    kv-head axis must tile the mesh (the slabs shard on it), the batch
    must slot-shard (the residual stream rides ``[B/tp, D]`` between the
    ring collectives), the ffn must column-shard, and the per-shard plan
    must fit."""
    dt = _dtype_of(dtype)
    if dt not in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "") if dt is None \
            else str(dt).replace("torch.", "")
        return False, f"dtype {name} not in (float32, bfloat16)"
    if heads * head_dim != hidden:
        return False, (f"hidden {hidden} != heads*head_dim "
                       f"{heads}*{head_dim}")
    if kv_heads < 1 or heads % kv_heads:
        return False, f"heads {heads} not a multiple of kv_heads {kv_heads}"
    if head_dim % 2:
        return False, f"head_dim {head_dim} must be even (rotary halves)"
    if head_dim % 8 or head_dim > 256:
        return False, (f"head_dim {head_dim} must be a multiple of 8 up to "
                       f"256 (16-byte K/V row loads)")
    if ffn % 8:
        return False, (f"ffn {ffn} must be a multiple of 8 (16-byte weight "
                       f"row loads)")
    if tp > 1:
        if kv_heads % tp:
            return False, (f"kv_heads {kv_heads} not divisible by "
                           f"tensor_parallel {tp} (the slab shards on "
                           f"the kv-head axis)")
        if batch % tp:
            return False, (f"batch {batch} not divisible by "
                           f"tensor_parallel {tp} (the residual stream "
                           f"slot-shards between the ring collectives)")
        if ffn % tp:
            return False, (f"ffn {ffn} not divisible by "
                           f"tensor_parallel {tp} (MLP column shards)")
    plan, why = plan_decode_block(
        max_seq=max_seq, hidden=hidden, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, ffn=ffn, batch=batch, itemsize=dt.itemsize,
        gated=gated, tp=tp, smem_budget=smem_budget)
    if plan is None:
        return False, why
    return True, None


def resolve_fused_decode(model, *, batch: int, kv_len: int, tp: int = 1):
    """The fused-vs-unfused chain for a model at ``(batch, kv_len)``: model
    support (``fused_decode_step`` + ``fused_decode_supported``), then at
    ``tp > 1`` the model's tensor-parallel bundle (``tp_decode_weights``,
    the layout the sharded block consumes) and its
    ``tp_decode_supported`` divisibility, then the model's own legality
    (dropout, :func:`fusion_legal` at ``tp``).  Returns ``(ok, reason)``;
    ``reason`` is None when the fused path may engage."""
    supported = getattr(model, "fused_decode_supported", None)
    if supported is None or not hasattr(model, "fused_decode_step"):
        return False, "model has no fused_decode_step"
    if tp > 1:
        if not hasattr(model, "tp_decode_weights") \
                or not hasattr(model, "tp_decode_supported"):
            return False, ("model has no tp_decode_weights (the sharded "
                           "decode block consumes the TP bundle layout)")
        ok, reason = model.tp_decode_supported(tp)
        if not ok:
            return False, reason
    return supported(batch=batch, kv_len=kv_len, tp=tp)


# ============================================================ shape checks
def _positions(seq_pos, b: int, device: torch.device) -> torch.Tensor:
    """``seq_pos`` as an int32 tensor on ``device``: ``[b]``, or ``[1]``
    for a scalar (broadcast to every row)."""
    if not isinstance(seq_pos, torch.Tensor):
        return torch.full((1,), int(seq_pos), dtype=torch.int32,
                          device=device)
    if seq_pos.device != device:
        raise ValueError(f"seq_pos is on {seq_pos.device}, x on {device}")
    if seq_pos.is_floating_point():
        raise ValueError("seq_pos must be an integer tensor")
    if seq_pos.dim() == 0:
        return seq_pos.reshape(1).to(torch.int32)
    if tuple(seq_pos.shape) != (b,):
        raise ValueError(f"seq_pos must be [{b}] or 0-d, got "
                         f"{tuple(seq_pos.shape)}")
    return seq_pos.to(torch.int32).contiguous()


def _attn_shapes(x, k_slab, v_slab, wq, wk, wv, kv_heads, head_dim):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, 1, D], got {tuple(x.shape)}")
    b, sq, d = x.shape
    if sq != 1:
        raise ValueError(f"decode_block_attn is a decode kernel (sq=1), "
                         f"got sq={sq}")
    if k_slab.dim() != 4 or tuple(k_slab.shape) != tuple(v_slab.shape):
        raise ValueError(f"k/v slabs must be one [B, S, KH, Dh] shape, got "
                         f"{tuple(k_slab.shape)} and {tuple(v_slab.shape)}")
    sb, s_max, kh, dh = k_slab.shape
    if sb != b or kh != kv_heads or dh != head_dim:
        raise ValueError(f"slabs {tuple(k_slab.shape)} do not match batch "
                         f"{b}, kv_heads {kv_heads}, head_dim {head_dim}")
    if wq.dim() != 2 or wq.shape[0] != d or wq.shape[1] % head_dim:
        raise ValueError(f"wq must be [{d}, heads*{head_dim}], got "
                         f"{tuple(wq.shape)}")
    heads = wq.shape[1] // head_dim
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not a multiple of kv_heads "
                         f"{kv_heads}")
    for name, w in (("wk", wk), ("wv", wv)):
        if tuple(w.shape) != (d, kv_heads * head_dim):
            raise ValueError(f"{name} must be [{d}, {kv_heads * head_dim}], "
                             f"got {tuple(w.shape)}")
    return b, s_max, heads, d


def _mlp_shapes(x, attn, wo, w1, w2, w_gate):
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"x must be [B, 1, D], got {tuple(x.shape)}")
    b, _, d = x.shape
    if attn.dim() != 3 or attn.shape[:2] != (b, 1):
        raise ValueError(f"attn must be [{b}, 1, H*Dh], got "
                         f"{tuple(attn.shape)}")
    hd = attn.shape[2]
    if tuple(wo.shape) != (hd, d):
        raise ValueError(f"wo must be [{hd}, {d}], got {tuple(wo.shape)}")
    if w1.dim() != 2 or w1.shape[0] != d:
        raise ValueError(f"w1 must be [{d}, ffn], got {tuple(w1.shape)}")
    ffn = w1.shape[1]
    if tuple(w2.shape) != (ffn, d):
        raise ValueError(f"w2 must be [{ffn}, {d}], got {tuple(w2.shape)}")
    if w_gate is not None and tuple(w_gate.shape) != (d, ffn):
        raise ValueError(f"w_gate must be [{d}, {ffn}], got "
                         f"{tuple(w_gate.shape)}")
    return b, d, hd, ffn


def _check_norm(norm: str):
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")


# ---------------------------------------------------------- kernel checks
def _kernel_device(x: torch.Tensor, what: str) -> int:
    """dtype code for a tensor headed to the kernels; raises for a tensor
    that is neither on the card nor on the CPU, or of another dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors (CPU tensors take the "
                         f"plain version); got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}; the {what} kernels "
                         f"take float32 and bfloat16")
    return _DTYPE_CODES[x.dtype]


def _same(name: str, t: torch.Tensor, like: torch.Tensor, dtype=None):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    want = like.dtype if dtype is None else dtype
    if t.dtype != want:
        raise ValueError(f"{name} has dtype {t.dtype}, want {want}")


def _matrix(name: str, w: torch.Tensor, like: torch.Tensor) -> int:
    """Check a weight for 16-byte row loads; returns its row stride."""
    _same(name, w, like)
    es = w.element_size()
    if w.stride(1) != 1 or w.data_ptr() % 16 or w.stride(0) * es % 16:
        raise ValueError(f"{name} must be contiguous in its last dim with "
                         f"rows on 16-byte boundaries (data pointer and "
                         f"row stride)")
    return w.stride(0)


def _vector(name: str, v: Optional[torch.Tensor], n: int,
            like: torch.Tensor) -> Optional[int]:
    if v is None:
        return None
    _same(name, v, like)
    if tuple(v.shape) != (n,) or (n > 1 and v.stride(0) != 1):
        raise ValueError(f"{name} must be a contiguous [{n}] vector, got "
                         f"{tuple(v.shape)}")
    return v.data_ptr()


def _rows(name: str, t: torch.Tensor, like: torch.Tensor) -> int:
    """Row stride of a [B, 1, n] activation read element by element."""
    _same(name, t, like)
    if t.stride(2) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")
    return t.stride(0)


def _check_rc(rc: int, what: str) -> None:
    if rc >= _TMA_REFUSED:
        raise ValueError(f"{what}: the driver refuses a TMA tensor map of a "
                         f"weight (cuTensorMapEncodeTiled returned CUresult "
                         f"{rc - _TMA_REFUSED})")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{rc}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# per (device, stream): the projection kernels' tile counters, zero
# between launches (each launch's last blocks reset their own), and their
# f32 partials.  Neither is ever freed or replaced while a CUDA graph
# could still point at it: the partials only grow, and a grown buffer
# keeps the one it replaces alive (_RETIRED).
_COUNTERS = {}
_MAX_TILES = 1 << 16
_PARTIALS = {}
_RETIRED = []
_SM_COUNTS = {}


def _counters(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = torch.zeros((_MAX_TILES,), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _sm_count(dev: torch.device) -> int:
    n = _SM_COUNTS.get(dev.index)
    if n is None:
        n = _SM_COUNTS[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _partials(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` f32 partials for ``stream``: allocated once at 8
    slots of 2048 floats per SM (8.6 MB on an H100; the serving shapes'
    plans take at most 4.2 MB), grown (never shrunk) for a larger
    split."""
    key = (dev.index, stream)
    buf = _PARTIALS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, _sm_count(dev) * 8 * _PART_SLOT)
        if buf is not None:
            _RETIRED.append(buf)
            size = max(size, 2 * buf.numel())
        buf = _PARTIALS[key] = torch.empty((size,), dtype=torch.float32,
                                           device=dev)
    return buf


def _gemv(entry, stream, *, dtype, inp, ld_in, K, rows, weights, biases,
          out, ld_out, out_f32, cap, itemsize, device, in_mode=0, in_f32=0,
          stats=None, nw=None, nb=None, res=None, ld_res=0, res_f32=0,
          act=0, what="decode_block projection") -> None:
    """One launch of the projection kernel (csrc/gemv.cuh) through
    ``entry``, a library's C entry point taking a ``GemvArgs`` pointer.
    ``weights`` is a list of ``(tensor, row_stride)`` segments whose
    columns concatenate to the output columns, ``biases`` their optional
    bias pointers.  bf16 weights take the stream kernel at its
    :func:`plan_gemv`; f32 weights the split-K kernel with K split into
    slices of at most ``cap`` rows.  ``in_mode`` is the input transform
    (``GemvArgs.in_mode``), ``act`` the epilogue's activation."""
    widths = tuple(w.shape[1] for w, _ in weights)
    n = sum(widths)
    a = _GemvArgs()
    if dtype == 2:
        # the inputs ride the weight ring: TMA boxes of the input, bulk
        # copies (16-byte units) of the norm's w and b
        es_in = 4 if in_f32 else 2
        if inp % 16 or ld_in * es_in % 16 or (in_mode == 1 and K % 8):
            raise ValueError(f"{what}: the bf16 kernel copies its input by "
                             f"TMA: the input's data pointer and row stride "
                             f"must be 16-byte aligned (and K, {K}, a "
                             f"multiple of 8 under a norm)")
        plan = _stream_plan(K, widths, rows, in_mode, bool(in_f32),
                            _sm_count(device))
        tiles, need = plan["counters"], plan["workspace"]
        a.kc, a.ksplit = _TILE, plan["ksplit"]
        a.stages, a.grid = plan["stages"], plan["grid"]
    else:
        kc, ksplit = _k_slice(K, n, rows, itemsize, cap)
        tiles = -(-n // _gemv_cols(itemsize)) * -(-rows // _ROWS)
        need = ksplit * rows * n
        a.kc, a.ksplit = kc, ksplit
    if tiles > _MAX_TILES:
        raise ValueError(f"projection of {n} columns x {rows} rows needs "
                         f"{tiles} tile counters (at most {_MAX_TILES})")
    a.inp, a.ld_in, a.K, a.rows, a.N = inp, ld_in, K, rows, n
    a.stats = stats
    a.nw, a.nb = nw, nb
    end = 0
    for i, (w, ld) in enumerate(weights):
        a.w[i], a.ld_w[i], a.bias[i] = w.data_ptr(), ld, biases[i]
        end += w.shape[1]
        a.seg_end[i] = end
    for i in range(len(weights), 3):
        a.w[i], a.ld_w[i], a.bias[i] = a.w[0], a.ld_w[0], None
        a.seg_end[i] = end
    a.res, a.ld_res, a.res_f32 = res, ld_res, res_f32
    a.out, a.ld_out, a.out_f32 = out, ld_out, out_f32
    a.part = _partials(device, stream, need).data_ptr()
    a.counters = _counters(device, stream).data_ptr()
    a.in_mode, a.in_f32, a.act, a.dtype = in_mode, in_f32, act, dtype
    _check_rc(entry(ctypes.addressof(a), stream), what)


# ================================================================ one GEMV
def _gemv_input(x, k, in_mode, stats, norm_w, norm_b):
    """The kernel's input transform, in f32: ``in'`` [rows, k]."""
    xf = x.float()
    if in_mode == 1:
        v = (xf[:, :k] - stats[:, :1]) * stats[:, 1:] * norm_w.float()
        return v + norm_b.float() if norm_b is not None else v
    if in_mode == 2:                                   # [up | gate]
        return F.silu(xf[:, k:2 * k]) * xf[:, :k]
    if in_mode == 3:                                   # [gate | up]
        return F.silu(xf[:, :k]) * xf[:, k:2 * k]
    if in_mode in (4, 5):
        return F.gelu(xf[:, :k], approximate="tanh" if in_mode == 4
                      else "none")
    return xf[:, :k]


def _stream_sums(xt, weights, plan, drop=None, late=None):
    """``xt @ [w_0 | w_1 | ...]`` summed as the stream kernel sums it: per
    strip, each K split's tiles as one partial, the partials added in
    split order.  ``drop`` leaves unit ``drop`` (strip ``drop // kT``, K
    tile ``drop % kT``) out, ``late`` reads unit ``late``'s weight rows
    one row late: the planted faults that the card's checks must see."""
    k, kt, gk = plan["k"], plan["kT"], plan["ksplit"]
    out, strip = [], 0
    for w in weights:
        wx = torch.cat([w.float(), w.new_zeros((1, w.shape[1]),
                                               dtype=torch.float32)])
        for c0 in range(0, w.shape[1], _STRIP):
            cols = slice(c0, min(c0 + _STRIP, w.shape[1]))
            total = None
            for q in range(gk):
                t0, t1 = q * kt // gk, (q + 1) * kt // gk
                idx = torch.arange(t0 * _TILE, min(t1 * _TILE, k),
                                   device=xt.device)
                src = idx.clone()
                for u, shift in ((late, 1), (drop, None)):
                    if u is None or u // kt != strip \
                            or not t0 <= u % kt < t1:
                        continue
                    hit = idx // _TILE == u % kt
                    if shift is None:
                        idx, src = idx[~hit], src[~hit]
                    else:
                        src = torch.where(hit, (src + 1).clamp(max=k), src)
                part = xt[:, idx] @ wx[src][:, cols]
                total = part if total is None else total + part
            out.append(total)
            strip += 1
    return torch.cat(out, dim=1)


def gemv_reference(x, weights, biases=None, *, in_mode: int = 0,
                   stats=None, norm_w=None, norm_b=None, res=None,
                   act: int = 0, out_f32: bool = False, plan=None,
                   drop=None, late=None):
    """The plain version of :func:`gemv`, on any device: the input
    transform in f32, f32 sums, then the residual, the biases and the
    activation, one cast.  With ``plan`` (:func:`plan_gemv`) the sums
    follow the stream kernel's order (:func:`_stream_sums`, with its
    ``drop`` / ``late`` faults)."""
    k = weights[0].shape[0]
    xt = _gemv_input(x, k, in_mode, stats, norm_w, norm_b)
    if plan is None:
        sums = xt @ torch.cat([w.float() for w in weights], dim=1)
    else:
        sums = _stream_sums(xt, weights, plan, drop, late)
    v = sums if res is None else res.float() + sums
    if biases is not None and any(b is not None for b in biases):
        v = v + torch.cat([b.float() if b is not None else
                           torch.zeros(w.shape[1], device=v.device)
                           for w, b in zip(weights, biases)])
    if act:
        v = F.gelu(v, approximate="tanh" if act == 1 else "none")
    return v if out_f32 else v.to(weights[0].dtype)


def gemv(x, weights, biases=None, *, in_mode: int = 0, stats=None,
         norm_w=None, norm_b=None, res=None, act: int = 0,
         out_f32: bool = False):
    """One projection of the decode block as one kernel launch:
    ``act(res + in'(x) @ [w_0 | w_1 | w_2] + [b_0 | b_1 | b_2])``.

    ``weights``: up to three ``[K, n_s]`` segments (views with a row
    stride are fine), float32 or bfloat16; ``biases`` their optional
    ``[n_s]`` vectors.  ``x`` ``[rows, K]`` (``[rows, 2K]`` for the SwiGLU
    modes) in the weights' dtype or f32; ``in_mode`` the input transform
    (0 none, 1 ``(x - mean) * rstd * norm_w + norm_b`` with ``stats``
    ``[rows, 2]`` f32, 2 ``silu(x[:, K:]) * x[:, :K]``, 3 ``silu(x[:, :K])
    * x[:, K:]``, 4 / 5 GeLU tanh / erf); ``res`` ``[rows, N]`` in the
    weights' dtype or f32; ``act`` the output activation (0 none, 1 / 2
    GeLU tanh / erf); the output is f32 with ``out_f32``, else in the
    weights' dtype.  CUDA tensors launch the kernel, CPU tensors run
    :func:`gemv_reference`."""
    biases = list(biases) if biases is not None else [None] * len(weights)
    if not 1 <= len(weights) <= 3 or len(biases) != len(weights):
        raise ValueError("gemv takes 1 to 3 weight segments, each with an "
                         "optional bias")
    if x.device.type == "cpu":
        return gemv_reference(x, weights, biases, in_mode=in_mode,
                              stats=stats, norm_w=norm_w, norm_b=norm_b,
                              res=res, act=act, out_f32=out_f32)
    w0 = weights[0]
    code = _kernel_device(w0, "gemv")
    k, rows = w0.shape[0], x.shape[0]
    segs = [(w, _matrix(f"weights[{i}]", w, w0))
            for i, w in enumerate(weights)]
    if any(w.shape[0] != k for w in weights):
        raise ValueError("gemv: the weight segments must share K")
    n = sum(w.shape[1] for w in weights)
    for name, t in (("x", x), ("res", res)):
        if t is not None and (t.device != w0.device or t.dtype not in
                              (w0.dtype, torch.float32) or t.stride(1) != 1):
            raise ValueError(f"gemv: {name} must be on {w0.device}, in "
                             f"{w0.dtype} or float32, contiguous in its "
                             f"last dim")
    out = torch.empty((rows, n), dtype=torch.float32 if out_f32
                      else w0.dtype, device=w0.device)
    ptrs = [_vector(f"biases[{i}]", b, w.shape[1], w0)
            for i, (w, b) in enumerate(zip(weights, biases))]
    from ._build import load
    lib = load("decode_block")
    es = w0.element_size()
    with torch.cuda.device(w0.device):
        _gemv(lib.decode_block_gemv, _stream(w0.device), dtype=code,
              inp=x.data_ptr(), ld_in=x.stride(0), K=k, rows=rows,
              weights=segs, biases=ptrs, out=out.data_ptr(), ld_out=n,
              out_f32=int(out_f32), cap=_pick_block_f(es, SMEM_BUDGET),
              itemsize=es, device=w0.device, in_mode=in_mode,
              in_f32=int(x.dtype == torch.float32),
              stats=None if stats is None else stats.data_ptr(),
              nw=_vector("norm_w", norm_w, k, w0),
              nb=_vector("norm_b", norm_b, k, w0),
              res=None if res is None else res.data_ptr(),
              ld_res=0 if res is None else res.stride(0),
              res_f32=int(res is not None and res.dtype == torch.float32),
              act=act, what="gemv")
    gemv.launches += 1
    return out


# launches of the GEMV kernel through gemv() since the count was last set
# to 0 (the decode-block wrappers launch it directly)
gemv.launches = 0


def _row_stats(lib, stream, inp, ld, rows, K, dtype, norm, eps, stats):
    _check_rc(lib.decode_block_row_stats(inp, stats.data_ptr(), ld, rows, K,
                                         dtype, int(norm == "rms"),
                                         float(eps), stream),
              "decode_block norm statistics")


# ============================================================ attention block
def decode_block_attn_reference(x, k_slab, v_slab, seq_pos, norm_w, norm_b,
                                wq, wk, wv, bq=None, bkv=None, bv=None, *,
                                kv_heads, head_dim, norm="layer", eps=1e-5,
                                scale=None, rope_cos=None, rope_sin=None):
    """The plain PyTorch version of :func:`decode_block_attn`, on any
    device, with the kernel's semantics (the slabs are updated in place
    here too)."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    b, s_max, heads, _ = _attn_shapes(x, k_slab, v_slab, wq, wk, wv,
                                      kv_heads, head_dim)
    dt = torch.float32
    xn = _norm_f32(x[:, 0].to(dt), norm_w.to(dt),
                   norm_b.to(dt) if norm == "layer" and norm_b is not None
                   else None, norm, eps)
    q = xn @ wq.to(dt)
    kx = xn @ wk.to(dt)
    vx = xn @ wv.to(dt)
    if bq is not None:
        q = q + bq.to(dt)
    if bkv is not None:
        kx = kx + bkv.to(dt)
    if bv is not None:
        vx = vx + bv.to(dt)
    q = q.reshape(b, heads, head_dim)
    kx = kx.reshape(b, kv_heads, head_dim)
    vx = vx.reshape(b, kv_heads, head_dim)
    if rope_cos is not None:
        c = rope_cos.to(dt)[:, None, :]
        s = rope_sin.to(dt)[:, None, :]
        half = head_dim // 2

        def rot(t):                       # rotate_half: concat(-x2, x1)
            return torch.cat([-t[..., half:], t[..., :half]], dim=-1)
        q = q * c + rot(q) * s
        kx = kx * c + rot(kx) * s
    q = q * scale
    pos = torch.as_tensor(seq_pos, device=x.device).long()
    if pos.dim() == 0:
        pos = pos.expand(b)
    posw = pos.clamp(0, s_max - 1)
    rows = torch.arange(b, device=x.device)
    k_slab[rows, posw] = kx.to(k_slab.dtype)
    v_slab[rows, posw] = vx.to(v_slab.dtype)
    # rows kpos <= posw of the updated slab: the live rows, then the fresh
    # one as stored
    out = decode_attention_reference(q[:, None], k_slab, v_slab,
                                     (posw + 1).to(torch.int32), scale=1.0)
    return out.reshape(b, 1, heads * head_dim).to(x.dtype), k_slab, v_slab


def decode_block_attn(x, k_slab, v_slab, seq_pos, norm_w, norm_b,
                      wq, wk, wv, bq=None, bkv=None, bv=None, *,
                      kv_heads: int, head_dim: int, norm: str = "layer",
                      eps: float = 1e-5, scale: Optional[float] = None,
                      rope_cos=None, rope_sin=None,
                      block_k: Optional[int] = None):
    """Fused norm -> QKV -> KV append -> streaming decode attention.

    x [B, 1, D]; k_slab/v_slab [B, S, KH, Dh] (updated IN PLACE at each
    slot's ``min(pos, S-1)``); seq_pos [B] int cache lengths before this
    token, or a scalar for every row; wq [D, H*Dh], wk/wv [D, KH*Dh] (views
    with a row stride are fine); each bias optional; rope_cos/rope_sin
    [B, Dh] full-width tables or None.  Returns ``(attn [B, 1, H*Dh],
    k_slab, v_slab)``.  CUDA tensors launch the kernels (three launches:
    norm statistics, the q/k/v projection, attention), CPU tensors run the
    plain version."""
    _check_norm(norm)
    b, s_max, heads, d = _attn_shapes(x, k_slab, v_slab, wq, wk, wv,
                                      kv_heads, head_dim)
    scale = 1.0 / math.sqrt(head_dim) if scale is None else float(scale)
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if x.device.type == "cpu":
        return decode_block_attn_reference(
            x, k_slab, v_slab, seq_pos, norm_w, norm_b, wq, wk, wv, bq, bkv,
            bv, kv_heads=kv_heads, head_dim=head_dim, norm=norm, eps=eps,
            scale=scale, rope_cos=rope_cos, rope_sin=rope_sin)
    code = _kernel_device(x, "decode_block_attn")
    if head_dim % 8 or head_dim > 256:
        raise ValueError(f"head_dim {head_dim} unsupported: the kernel takes "
                         f"multiples of 8 up to 256")
    rep = heads // kv_heads
    if block_k is None:
        block_k = _pick_block_k(s_max, rep, head_dim, SMEM_BUDGET)
    block_k = max(1, int(block_k))
    need = _attn_smem(block_k, rep, head_dim)
    cap = _pick_block_f(x.element_size(), SMEM_BUDGET)
    if need > SMEM_BUDGET:
        raise ValueError(f"block_k={block_k} needs {need} bytes of shared "
                         f"memory (budget {SMEM_BUDGET})")
    ld_x = _rows("x", x, x)
    for name, t in (("k_slab", k_slab), ("v_slab", v_slab)):
        _same(name, t, x)
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must be contiguous and start on "
                             f"16-byte boundaries")
    weights = [(wq, _matrix("wq", wq, x)), (wk, _matrix("wk", wk, x)),
               (wv, _matrix("wv", wv, x))]
    biases = [_vector("bq", bq, heads * head_dim, x),
              _vector("bkv", bkv, kv_heads * head_dim, x),
              _vector("bv", bv, kv_heads * head_dim, x)]
    nw = _vector("norm_w", norm_w, d, x)
    nb = _vector("norm_b", norm_b, d, x) if norm == "layer" else None
    if nw is None:
        raise ValueError("norm_w is required")
    pos = _positions(seq_pos, b, x.device)
    cos = sin = None
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if t.device != x.device or tuple(t.shape) != (b, head_dim):
                raise ValueError(f"{name} must be [{b}, {head_dim}] on "
                                 f"{x.device}")
        cos = rope_cos.to(torch.float32).contiguous()
        sin = rope_sin.to(torch.float32).contiguous()

    from ._build import load
    lib = load("decode_block")
    gemv = lib.decode_block_gemv
    n_qkv = (heads + 2 * kv_heads) * head_dim
    stats = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, n_qkv), dtype=torch.float32, device=x.device)
    attn = torch.empty((b, 1, heads * head_dim), dtype=x.dtype,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        _row_stats(lib, stream, x.data_ptr(), ld_x, b, d, code, norm, eps,
                   stats)
        _gemv(gemv, stream, dtype=code, inp=x.data_ptr(), ld_in=ld_x, K=d,
              rows=b, weights=weights, biases=biases, out=qkv.data_ptr(),
              ld_out=n_qkv, out_f32=1, cap=cap, itemsize=x.element_size(),
              device=x.device, in_mode=1,
              stats=stats.data_ptr(), nw=nw, nb=nb)
        a = _AttnArgs()
        a.qkv, a.ld_qkv = qkv.data_ptr(), n_qkv
        a.cos = cos.data_ptr() if cos is not None else None
        a.sin = sin.data_ptr() if sin is not None else None
        a.k_slab, a.v_slab = k_slab.data_ptr(), v_slab.data_ptr()
        a.k_sb, a.k_ss, a.k_sh = k_slab.stride()[:3]
        a.v_sb, a.v_ss, a.v_sh = v_slab.stride()[:3]
        a.pos, a.pos_stride = pos.data_ptr(), int(pos.numel() > 1)
        a.out = attn.data_ptr()
        a.B, a.H, a.KH, a.Dh, a.S = b, heads, kv_heads, head_dim, s_max
        a.block_k, a.dtype, a.scale = block_k, code, scale
        _check_rc(lib.decode_block_attention(ctypes.addressof(a), stream),
                  "decode_block attention")
    decode_block_attn.launches += 1
    return attn, k_slab, v_slab


# launches of the attention-block kernels since the count was last set to 0
decode_block_attn.launches = 0


# ============================================================= proj+MLP block
def decode_block_mlp_reference(x, attn, wo, bo, norm_w, norm_b, w1, b1, w2,
                               b2, w_gate=None, *, norm="layer", eps=1e-5,
                               act="gelu_tanh"):
    """The plain PyTorch version of :func:`decode_block_mlp`, on any
    device, with the kernel's semantics."""
    _mlp_shapes(x, attn, wo, w1, w2, w_gate)
    dt = torch.float32
    xm = x[:, 0].to(dt) + attn[:, 0].to(dt) @ wo.to(dt)
    if bo is not None:
        xm = xm + bo.to(dt)
    h = _norm_f32(xm, norm_w.to(dt),
                  norm_b.to(dt) if norm == "layer" and norm_b is not None
                  else None, norm, eps)
    t = h @ w1.to(dt)
    if b1 is not None:
        t = t + b1.to(dt)
    if w_gate is not None:
        a = F.silu(h @ w_gate.to(dt)) * t
    else:
        a = F.gelu(t, approximate="tanh" if act == "gelu_tanh" else "none")
    y = xm + a @ w2.to(dt)
    if b2 is not None:
        y = y + b2.to(dt)
    return y[:, None].to(x.dtype)


def decode_block_mlp(x, attn, wo, bo, norm_w, norm_b, w1, b1, w2, b2,
                     w_gate=None, *, norm: str = "layer",
                     eps: float = 1e-5, act: str = "gelu_tanh",
                     block_f: Optional[int] = None):
    """Fused out-projection (+residual) -> norm2 -> MLP (+residual).

    x [B, 1, D] is the layer input (the residual stream); attn is
    :func:`decode_block_attn`'s output.  ``w_gate`` switches the MLP to
    SwiGLU (``w2 (silu(h wg) * (h w1 + b1))``).  Every bias is optional on
    its own.  CUDA tensors launch the kernels (four launches: the
    out-projection, norm2 statistics, the up-projection, the
    down-projection), CPU tensors run the plain version.  Returns
    ``y [B, 1, D]`` in x's dtype."""
    _check_norm(norm)
    if w_gate is None and act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    b, d, hd, ffn = _mlp_shapes(x, attn, wo, w1, w2, w_gate)
    if x.device.type == "cpu":
        return decode_block_mlp_reference(x, attn, wo, bo, norm_w, norm_b,
                                          w1, b1, w2, b2, w_gate, norm=norm,
                                          eps=eps, act=act)
    code = _kernel_device(x, "decode_block_mlp")
    if block_f is None:
        block_f = _pick_block_f(x.element_size(), SMEM_BUDGET)
    # slices are whole passes of the kernel's 8 warps x 8 rows
    block_f = max(_ROW_STEP, int(block_f) // _ROW_STEP * _ROW_STEP)
    need = _gemv_smem(block_f, x.element_size())
    if need > SMEM_BUDGET:
        raise ValueError(f"block_f={block_f} needs {need} bytes of shared "
                         f"memory (budget {SMEM_BUDGET})")
    ld_x = _rows("x", x, x)
    ld_a = _rows("attn", attn, x)
    wo_seg = [(wo, _matrix("wo", wo, x))]
    up = [(w1, _matrix("w1", w1, x))]
    if w_gate is not None:
        up.append((w_gate, _matrix("w_gate", w_gate, x)))
    down = [(w2, _matrix("w2", w2, x))]
    bo_p = _vector("bo", bo, d, x)
    b1_p = _vector("b1", b1, ffn, x)
    b2_p = _vector("b2", b2, d, x)
    nw = _vector("norm_w", norm_w, d, x)
    nb = _vector("norm_b", norm_b, d, x) if norm == "layer" else None
    if nw is None:
        raise ValueError("norm_w is required")

    from ._build import load
    lib = load("decode_block")
    gemv = lib.decode_block_gemv
    dev = x.device
    n_up = ffn * len(up)
    xm = torch.empty((b, d), dtype=torch.float32, device=dev)
    stats = torch.empty((b, 2), dtype=torch.float32, device=dev)
    u = torch.empty((b, n_up), dtype=torch.float32, device=dev)
    y = torch.empty((b, 1, d), dtype=x.dtype, device=dev)
    tiles = dict(cap=block_f, itemsize=x.element_size(), device=dev)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        # xm = x + attn wo + bo (f32)
        _gemv(gemv, stream, dtype=code, inp=attn.data_ptr(), ld_in=ld_a,
              K=hd, rows=b, weights=wo_seg, biases=[bo_p],
              out=xm.data_ptr(), ld_out=d, out_f32=1, **tiles,
              res=x.data_ptr(), ld_res=ld_x)
        _row_stats(lib, stream, xm.data_ptr(), d, b, d, 0, norm, eps, stats)
        # u = act(norm2(xm) w1 + b1), or [t | g] for SwiGLU (f32)
        _gemv(gemv, stream, dtype=code, inp=xm.data_ptr(), ld_in=d, K=d,
              rows=b, weights=up, biases=[b1_p, None], out=u.data_ptr(),
              ld_out=n_up, out_f32=1, **tiles, in_mode=1, in_f32=1,
              stats=stats.data_ptr(), nw=nw, nb=nb,
              act=0 if w_gate is not None else _ACTS[act])
        # y = xm + act w2 + b2, cast once
        _gemv(gemv, stream, dtype=code, inp=u.data_ptr(), ld_in=n_up, K=ffn,
              rows=b, weights=down, biases=[b2_p], out=y.data_ptr(),
              ld_out=d, out_f32=0, **tiles,
              in_mode=2 if w_gate is not None else 0, in_f32=1,
              res=xm.data_ptr(), ld_res=d, res_f32=1)
    decode_block_mlp.launches += 1
    return y


# launches of the proj+MLP kernels since the count was last set to 0
decode_block_mlp.launches = 0


# ============================================================== layer wrapper
def decode_block_layer(x, k_slab, v_slab, seq_pos, *, kv_heads, head_dim,
                       norm, eps1, eps2, norm1_w, norm1_b, wq, wk, wv,
                       bq, bkv, bv, wo, bo, norm2_w, norm2_b,
                       w1, b1, w2, b2, w_gate=None, act="gelu_tanh",
                       rope_cos=None, rope_sin=None,
                       block_k=None, block_f=None):
    """One transformer layer's decode step through the kernel pair.
    Returns ``(y [B, 1, D], k_slab, v_slab)`` with the slabs updated in
    place at each slot's ``min(pos, S-1)``.

    Tiles not given come from :func:`plan_decode_block` at this call's
    shapes, so every caller launches exactly what the legality check
    approved.  Raises if no tiling fits: callers gate on
    :func:`fusion_legal` / ``fused_decode_supported`` first."""
    if block_k is None or block_f is None:
        heads = wq.shape[1] // head_dim
        plan, why = plan_decode_block(
            max_seq=k_slab.shape[1], hidden=x.shape[-1], heads=heads,
            kv_heads=kv_heads, head_dim=head_dim, ffn=w1.shape[1],
            batch=x.shape[0], itemsize=x.element_size(),
            gated=w_gate is not None)
        if plan is None:
            raise ValueError(
                f"decode_block_layer: no shared-memory tiling fits this "
                f"shape ({why}); gate on fusion_legal/fused_decode_supported "
                f"before calling the fused path")
        block_k = block_k if block_k is not None else plan["block_k"]
        block_f = block_f if block_f is not None else plan["block_f"]
    attn, k2, v2 = decode_block_attn(
        x, k_slab, v_slab, seq_pos, norm1_w, norm1_b, wq, wk, wv,
        bq, bkv, bv, kv_heads=kv_heads, head_dim=head_dim, norm=norm,
        eps=eps1, rope_cos=rope_cos, rope_sin=rope_sin, block_k=block_k)
    y = decode_block_mlp(
        x, attn, wo, bo, norm2_w, norm2_b, w1, b1, w2, b2, w_gate,
        norm=norm, eps=eps2, act=act, block_f=block_f)
    return y, k2, v2


def decode_block_reference(x, k_slab, v_slab, seq_pos, *, kv_heads,
                           head_dim, norm, eps1, eps2, norm1_w, norm1_b,
                           wq, wk, wv, bq, bkv, bv, wo, bo, norm2_w,
                           norm2_b, w1, b1, w2, b2, w_gate=None,
                           act="gelu_tanh", rope_cos=None, rope_sin=None,
                           scale: Optional[float] = None):
    """The plain PyTorch version of the pair on any device, with exactly
    the kernels' semantics: f32 projections, norms and activations, the
    fresh K/V row written in place at ``min(pos, S-1)`` in the slab dtype
    and attended as stored, attn cast to x's dtype between the halves, y
    cast once.  Returns ``(y, k_slab, v_slab)``."""
    _check_norm(norm)
    attn, k2, v2 = decode_block_attn_reference(
        x, k_slab, v_slab, seq_pos, norm1_w, norm1_b, wq, wk, wv, bq, bkv,
        bv, kv_heads=kv_heads, head_dim=head_dim, norm=norm, eps=eps1,
        scale=scale, rope_cos=rope_cos, rope_sin=rope_sin)
    y = decode_block_mlp_reference(x, attn, wo, bo, norm2_w, norm2_b, w1, b1,
                                   w2, b2, w_gate, norm=norm, eps=eps2,
                                   act=act)
    return y, k2, v2
