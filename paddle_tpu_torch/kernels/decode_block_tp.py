"""Sharded decode block: the fused decode step of ``kernels/decode_block.py``
re-partitioned over a 1-D tensor-parallel mesh (counterpart of
paddle_tpu/kernels/decode_block_tp.py).

  * **entry** — the residual stream arrives slot-sharded ``[B/tp, D]``;
    :func:`ring_entry_matmul` runs the all-gather ring of
    ``collective_matmul.entry_ring`` with each hop's product
    ``x [B/tp, K] @ w_l [K, N_l] + b_l`` as one launch of the hop kernel
    (:func:`ring_entry_hop`);
  * **attention** — :func:`decode_block_attn_tp`, one shard's attention
    over its own kv-head group: rotary, the fresh K/V row stored into the
    shard's slab at ``min(pos, S-1)``, online softmax over the live rows,
    the fresh row (as stored) folded in last;
  * **exit** — :func:`ring_exit_matmul` runs the reduce-scatter ring with
    each hop's partial ``act(y_chunk) @ w_l`` as one launch of the hop
    kernel (:func:`ring_exit_hop`: the MLP activation applied as the
    chunk is read, an f32 accumulator, the partial emitted in the
    output dtype); the arriving accumulator is added outside the kernel,
    in the output dtype, as in the reference;
  * :func:`tp_fused_block_layer` — one layer of the sharded decode
    program through the three.

A CUDA tensor always goes to the hand-written kernels
(``csrc/decode_block_tp.cu``, built for ``sm_90a`` at first use; a hop is
one launch of the GEMV of ``csrc/gemv.cuh`` that the unsharded block's
projections also use); a CPU tensor always goes to the plain
PyTorch version beside each wrapper (``*_reference``).  There is no
fallback: a CUDA tensor the kernels do not take raises, and so does a
failed build or launch.  Each wrapper counts its kernel launches in
``.launches``.  Values of the mesh are per-shard lists
(``distributed/mesh.py``); the ring hops are ``ppermute`` copies between
the kernels.

The wrappers pick their own tiles: the hop's GEMV plan as
``decode_block``'s projections pick theirs, the attention kernel's K/V
tile by :func:`_pick_block_k_tp`.  :func:`plan_decode_block_tp` asks the
same two questions at the model's shapes against this card's shared
memory (not the reference's 12 MiB VMEM plan), so the legality check
approves exactly what the launches take.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..distributed.mesh import Mesh
from ..nn import functional as NF
from .collective_matmul import entry_ring, exit_ring
from .decode_attention import decode_attention_reference
from .decode_block import (_MAX_TILES, SMEM_BUDGET, _check_rc, _counters,
                           _gemv, _kernel_device, _matrix, _partials,
                           _pick_block_f, _positions, _proj_smem, _same,
                           _stream, _vector)

__all__ = ["plan_decode_block_tp", "ring_entry_hop",
           "ring_entry_hop_reference", "ring_exit_hop",
           "ring_exit_hop_reference", "ring_entry_matmul",
           "ring_entry_matmul_reference", "ring_exit_matmul",
           "ring_exit_matmul_reference", "decode_block_attn_tp",
           "decode_block_attn_tp_reference", "tp_fused_block_layer",
           "arch_norm"]

# attn_tp_kernel's largest K/V tile (rows per stage)
_MAX_BLOCK_K = 64
# attn_tp_split_kernel (csrc/decode_split.cuh): cache rows a block walks
# (the grid is sized from S_max, never from the positions), rows a TMA
# tile, ring stages, consumer warps
_SPLIT_ROWS = 256
_SPLIT_TILE = 32
_SPLIT_STAGES = 3
_SPLIT_WARPS = 4
# exit-hop activations: the GEMV kernel's input transforms
# (GemvArgs.in_mode in csrc/gemv.cuh)
_EXIT_IN_MODES = {"none": 0, "swiglu": 3, "gelu_tanh": 4, "gelu": 5}

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


class _TpAttnArgs(ctypes.Structure):
    """Mirror of ``TpAttnArgs`` in csrc/decode_block_tp.cu."""
    _fields_ = [("q", _P), ("k", _P), ("v", _P), ("cos", _P), ("sin", _P),
                ("k_slab", _P), ("v_slab", _P), ("pos", _P), ("out", _P),
                ("ld_q", _LL), ("ld_k", _LL), ("ld_v", _LL),
                ("k_sb", _LL), ("k_ss", _LL), ("k_sh", _LL),
                ("v_sb", _LL), ("v_ss", _LL), ("v_sh", _LL),
                ("B", _I), ("H", _I), ("KH", _I), ("Dh", _I), ("S", _I),
                ("block_k", _I), ("pos_stride", _I), ("dtype", _I),
                ("scale", ctypes.c_float), ("part", _P), ("count", _P),
                ("split_rows", _I)]


# ======================================================== planning / legality
def _attn_tp_smem(block_k: int, rep: int, head_dim: int,
                  itemsize: int) -> int:
    """Shared memory of one ``attn_tp_kernel`` block (f32, and bf16 at a
    head_dim other than 64 / 128): q and acc ``[rep, Dh]``, the scores
    ``[rep, block_k]``, the fresh K/V row and the softmax state in f32,
    plus two stages of the K and V tiles ``[block_k, Dh]`` in the slab
    dtype."""
    return (4 * (2 * rep * head_dim + rep * block_k + 2 * head_dim
                 + 3 * rep)
            + 2 * 2 * block_k * head_dim * itemsize)


def _split_launch(itemsize: int, head_dim: int) -> bool:
    """bf16 rows of head_dim 64 or 128 take the split-KV kernel
    (``attn_tp_split_kernel``); the rest ``attn_tp_kernel``."""
    return itemsize == 2 and head_dim in (64, 128)


def _split_smem(rep: int, head_dim: int) -> int:
    """Shared memory of one ``attn_tp_split_kernel`` block, byte for byte
    as ``tp_split_smem<G, D>`` in csrc/decode_block_tp.cu lays it out: 1024
    bytes of alignment slack, the ring of ``_SPLIT_STAGES`` K and V tiles
    (``head_dim / 64`` boxes of 32 rows x 128 bytes each), ``SplitShared``
    (the ring's barriers, the consumer warps' m / l / acc partials and the
    last-block flag, 8-byte aligned) and ``TpShared`` (the fresh K/V row
    and its score per head, f32)."""
    g = 4 if rep % 4 == 0 else 1
    split_shared = 8 * 2 * _SPLIT_STAGES + 4 * (2 * _SPLIT_WARPS * g
                                                + _SPLIT_WARPS * g * head_dim
                                                + 1)
    return (1024 + 2 * _SPLIT_STAGES * (head_dim // 64) * _SPLIT_TILE * 128
            + -(-split_shared // 8) * 8 + 4 * (2 * head_dim + g))


def _attn_tp_plan(max_seq: int, rep: int, head_dim: int, itemsize: int,
                  smem_budget: int):
    """``(block_k, smem)`` of the attention launch at these shapes: the
    split kernel's 32-row TMA tile and its fixed shared memory, or
    ``attn_tp_kernel``'s tile (:func:`_pick_block_k_tp`) and bytes."""
    if _split_launch(itemsize, head_dim):
        return _SPLIT_TILE, _split_smem(rep, head_dim)
    bk = _pick_block_k_tp(max_seq, rep, head_dim, itemsize, smem_budget)
    return bk, _attn_tp_smem(bk, rep, head_dim, itemsize)


def _pick_block_k_tp(max_seq: int, rep: int, head_dim: int, itemsize: int,
                     smem_budget: int) -> int:
    """The attention kernel's K/V rows per stage: 64, halved while the
    tile exceeds the cache or the budget, down to 8."""
    bk = _MAX_BLOCK_K
    while bk > 8 and bk > max_seq:
        bk //= 2
    while bk > 8 and _attn_tp_smem(bk, rep, head_dim, itemsize) > smem_budget:
        bk //= 2
    return bk


def plan_decode_block_tp(*, max_seq: int, hidden: int, heads: int,
                         kv_heads: int, head_dim: int, ffn: int, batch: int,
                         itemsize: int, tp: int, gated: bool = False,
                         smem_budget: int = SMEM_BUDGET):
    """Per-shard shared-memory plan of the sharded decode block at degree
    ``tp``: the attention launch's K/V tile ``block_k`` and its bytes
    ``smem_attn`` (:func:`_attn_tp_plan`), and the most
    shared memory any ring hop takes (``smem_hop``) over the four seams
    (QKV and MLP-up entry hops, out-proj and MLP-down exit hops), each
    hop's launch planned as ``decode_block``'s projections plan theirs
    (bf16: the stream kernel's ring; f32: the K slice).  Divisibility
    (kv_heads / ffn / batch over tp) is checked by
    ``decode_block.fusion_legal`` before this runs.  Returns ``(plan,
    None)`` or ``(None, reason)``, the contract of
    ``decode_block.plan_decode_block``; a reason starts with
    ``"smem:"``."""
    rep = heads // kv_heads
    h_l, kh_l, f_l, b_l = heads // tp, kv_heads // tp, ffn // tp, batch // tp
    bk, smem_attn = _attn_tp_plan(max_seq, rep, head_dim, itemsize,
                                  smem_budget)
    if smem_attn > smem_budget:
        return None, (f"smem: tp attention residents {smem_attn} bytes "
                      f"exceed budget {smem_budget} even at block_k={bk}")
    cap = _pick_block_f(itemsize, smem_budget)
    smem_hop = 0
    for what, k, n, mode in (
            ("entry", hidden, (h_l + 2 * kh_l) * head_dim, 0),
            ("entry", hidden, f_l * (2 if gated else 1), 0),
            ("exit", h_l * head_dim, hidden, 0),
            ("exit", f_l, hidden, 3 if gated else 4)):
        need = _proj_smem(k, (n,), b_l, itemsize, cap, mode)
        if need > smem_budget:
            return None, (f"smem: tp {what} hop needs {need} bytes of "
                          f"shared memory even at block_f={cap} (budget "
                          f"{smem_budget})")
        smem_hop = max(smem_hop, need)
    return {"block_k": bk, "smem_attn": smem_attn, "smem_hop": smem_hop}, None


# ============================================================ ring hop kernels
def ring_entry_hop_reference(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The plain version of :func:`ring_entry_hop`: ``x @ w + bias`` in
    f32, cast once to x's dtype."""
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _hop_launch(what: str, x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor], k: int,
                in_mode: int) -> torch.Tensor:
    """One launch of the GEMV kernel: ``out [rows, N] = cast(sum_k
    in'(r, k) * w[k, n] + bias[n])``, ``in'`` the input transform
    ``in_mode``, planned as ``decode_block``'s projections plan theirs."""
    code = _kernel_device(x, what)
    if x.stride(1) != 1:
        raise ValueError(f"{what}: the input must be contiguous in its "
                         f"last dim")
    rows, n = x.shape[0], w.shape[1]
    es = x.element_size()
    if n % (16 // es):
        raise ValueError(f"{what}: {n} output columns; the kernel reads "
                         f"weight rows 16 bytes at a time, so N must be a "
                         f"multiple of {16 // es}")
    weights = [(w, _matrix("w", w, x))]
    biases = [_vector("bias", bias, n, x)]
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    from ._build import load
    lib = load("decode_block_tp")
    with torch.cuda.device(x.device):
        _gemv(lib.decode_block_tp_hop, _stream(x.device), dtype=code,
              inp=x.data_ptr(), ld_in=x.stride(0), K=k, rows=rows,
              weights=weights, biases=biases, out=out.data_ptr(), ld_out=n,
              out_f32=0, cap=_pick_block_f(es, SMEM_BUDGET), itemsize=es,
              device=x.device, in_mode=in_mode, what=what)
    return out


def ring_entry_hop(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One hop of the entry ring: ``x [B_l, K] @ w [K, N_l] + bias [N_l]``
    with an f32 contraction, the output cast once to x's dtype.  ``w`` may
    be a view with a row stride.  CUDA tensors launch the hop kernel (one
    launch; shares of the work that cut a column strip are summed in
    block order by the last of them), CPU tensors run the plain
    version."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"ring_entry_hop wants x [B, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu":
        return ring_entry_hop_reference(x, w, bias)
    out = _hop_launch("ring_entry_hop", x, w, bias, x.shape[1], 0)
    ring_entry_hop.launches += 1
    return out


# launches of the entry hop kernel since the count was last set to 0
ring_entry_hop.launches = 0


def _act_f32(t: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        k_l = t.shape[1] // 2
        return F.silu(t[:, :k_l]) * t[:, k_l:]
    if act == "gelu_tanh":
        return F.gelu(t, approximate="tanh")
    if act == "gelu":
        return F.gelu(t, approximate="none")
    return t


def _check_act(act: str) -> None:
    if act not in _EXIT_IN_MODES:
        raise ValueError(f"act must be one of {sorted(_EXIT_IN_MODES)}, got "
                         f"{act!r}")


def ring_exit_hop_reference(y: torch.Tensor, w: torch.Tensor,
                            act: str = "none") -> torch.Tensor:
    """The plain version of :func:`ring_exit_hop`: ``act(y) @ w`` in f32,
    cast once to y's dtype."""
    _check_act(act)
    return (_act_f32(y.float(), act) @ w.float()).to(y.dtype)


def ring_exit_hop(y: torch.Tensor, w: torch.Tensor,
                  act: str = "none") -> torch.Tensor:
    """One hop of the exit ring: the partial ``act(y) [B_l, K_l] @ w
    [K_l, N]``, the activation applied as the chunk is read (``act(y)``
    never lands in device memory), an f32 accumulator, the partial cast
    once to y's dtype.  For ``act="swiglu"`` ``y`` is ``[B_l, 2 K_l]``,
    the gate in its FIRST half: ``silu(gate) * up``.  CUDA tensors launch
    the hop kernel, CPU tensors run the plain version."""
    _check_act(act)
    k = y.shape[1] // (2 if act == "swiglu" else 1) if y.dim() == 2 else -1
    if y.dim() != 2 or w.dim() != 2 or w.shape[0] != k \
            or (act == "swiglu" and y.shape[1] != 2 * k):
        raise ValueError(f"ring_exit_hop wants y [B, K] ([B, 2K] for "
                         f"swiglu) and w [K, N], got {tuple(y.shape)} and "
                         f"{tuple(w.shape)}")
    if y.device.type == "cpu":
        return ring_exit_hop_reference(y, w, act)
    out = _hop_launch("ring_exit_hop", y, w, None, k, _EXIT_IN_MODES[act])
    ring_exit_hop.launches += 1
    return out


# launches of the exit hop kernel since the count was last set to 0
ring_exit_hop.launches = 0


# ================================================================ ring drivers
def ring_entry_matmul(hs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                      biases: Sequence[Optional[torch.Tensor]],
                      mesh: Mesh) -> List[torch.Tensor]:
    """Per shard ``concat_over_shards(h) @ w_l + b_l``: ``hs[d] [B_l, K]``
    shard ``d``'s slot shard of the (normed) activation, ``ws[d] [K,
    N_l]`` / ``biases[d] [N_l]`` its column block.  Returns per shard
    ``[B_l * tp, N_l]`` in h's dtype, each hop one :func:`ring_entry_hop`
    per shard."""
    return entry_ring(hs, mesh, lambda idx, buf: ring_entry_hop(
        buf, ws[idx], biases[idx]))


def ring_entry_matmul_reference(hs, ws, biases, mesh: Mesh):
    """:func:`ring_entry_matmul` with the plain hop on any device."""
    return entry_ring(hs, mesh, lambda idx, buf: ring_entry_hop_reference(
        buf, ws[idx], biases[idx]))


def ring_exit_matmul(ys: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                     mesh: Mesh, *,
                     act: str = "none") -> List[torch.Tensor]:
    """Per shard ``d``: row chunk ``d`` of ``sum_over_shards(act(y) @
    w_l)``.  ``ys[d] [B, K_l]`` (``[B, 2 K_l]`` with the ``[gate | up]``
    halves for swiglu), ``ws[d] [K_l, N]``.  Returns per shard ``[B //
    tp, N]`` in y's dtype, each hop one :func:`ring_exit_hop` per shard,
    the arriving accumulator added in y's dtype."""
    return exit_ring(ys, mesh, lambda idx, chunk: ring_exit_hop(
        chunk, ws[idx], act))


def ring_exit_matmul_reference(ys, ws, mesh: Mesh, *, act: str = "none"):
    """:func:`ring_exit_matmul` with the plain hop on any device."""
    return exit_ring(ys, mesh, lambda idx, chunk: ring_exit_hop_reference(
        chunk, ws[idx], act))


# ======================================================= per-shard attention
def _attn_shapes(q, k, v, k_slab, v_slab, kv_heads, head_dim):
    if k_slab.dim() != 4 or tuple(k_slab.shape) != tuple(v_slab.shape):
        raise ValueError(f"k/v slabs must be one [B, S, KH, Dh] shape, got "
                         f"{tuple(k_slab.shape)} and {tuple(v_slab.shape)}")
    b, s_max, kh, dh = k_slab.shape
    if kh != kv_heads or dh != head_dim:
        raise ValueError(f"slabs {tuple(k_slab.shape)} do not match kv_heads "
                         f"{kv_heads}, head_dim {head_dim}")
    if q.dim() != 2 or q.shape[0] != b or q.shape[1] % (kv_heads * dh):
        raise ValueError(f"q must be [{b}, heads*{dh}] with heads a multiple "
                         f"of kv_heads {kv_heads}, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, kv_heads * dh):
            raise ValueError(f"{name} must be [{b}, {kv_heads * dh}], got "
                             f"{tuple(t.shape)}")
    return b, s_max, q.shape[1] // dh


def decode_block_attn_tp_reference(q, k, v, k_slab, v_slab, seq_pos, *,
                                   kv_heads: int, head_dim: int,
                                   scale: Optional[float] = None,
                                   rope_cos=None, rope_sin=None):
    """The plain version of :func:`decode_block_attn_tp`, on any device,
    with the kernel's semantics (the slabs are updated in place)."""
    b, s_max, heads = _attn_shapes(q, k, v, k_slab, v_slab, kv_heads,
                                   head_dim)
    scale = 1.0 / math.sqrt(head_dim) if scale is None else float(scale)
    qf = q.float().reshape(b, heads, head_dim)
    kf = k.float().reshape(b, kv_heads, head_dim)
    vf = v.float().reshape(b, kv_heads, head_dim)
    if rope_cos is not None:
        c = rope_cos.float()[:, None, :]
        s = rope_sin.float()[:, None, :]
        half = head_dim // 2

        def rot(t):                           # rotate_half: concat(-x2, x1)
            return torch.cat([-t[..., half:], t[..., :half]], dim=-1)
        qf = qf * c + rot(qf) * s
        kf = kf * c + rot(kf) * s
    qf = qf * scale
    pos = torch.as_tensor(seq_pos, device=q.device).long()
    if pos.dim() == 0:
        pos = pos.expand(b)
    posw = pos.clamp(0, s_max - 1)
    rows = torch.arange(b, device=q.device)
    k_slab[rows, posw] = kf.to(k_slab.dtype)
    v_slab[rows, posw] = vf.to(v_slab.dtype)
    out = decode_attention_reference(qf[:, None], k_slab, v_slab,
                                     (posw + 1).to(torch.int32), scale=1.0)
    return out.reshape(b, heads * head_dim).to(q.dtype), k_slab, v_slab


def decode_block_attn_tp(q, k, v, k_slab, v_slab, seq_pos, *,
                         kv_heads: int, head_dim: int,
                         scale: Optional[float] = None,
                         rope_cos=None, rope_sin=None):
    """One shard's attention block: rotary -> the fresh K/V row stored in
    the shard's slabs -> streaming decode attention over its kv-head group.

    ``q [B, H_l*Dh]`` / ``k``, ``v [B, KH_l*Dh]`` are this shard's fresh
    projections in the model dtype (the entry ring's output; views with a
    row stride are fine); ``k_slab``/``v_slab [B, S, KH_l, Dh]`` the
    shard's slabs, updated IN PLACE at each slot's ``min(pos, S-1)``;
    ``seq_pos [B]`` the cache lengths before this token (or a scalar);
    ``rope_cos``/``rope_sin`` f32 ``[B, Dh]`` full-width tables or None.
    ``kv_heads`` is the LOCAL count.  Returns ``(attn [B, H_l*Dh],
    k_slab, v_slab)``.  CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    b, s_max, heads = _attn_shapes(q, k, v, k_slab, v_slab, kv_heads,
                                   head_dim)
    scale = 1.0 / math.sqrt(head_dim) if scale is None else float(scale)
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if q.device.type == "cpu":
        return decode_block_attn_tp_reference(
            q, k, v, k_slab, v_slab, seq_pos, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale, rope_cos=rope_cos,
            rope_sin=rope_sin)
    code = _kernel_device(q, "decode_block_attn_tp")
    if head_dim % 8 or head_dim > 256:
        raise ValueError(f"head_dim {head_dim} unsupported: the kernel takes "
                         f"multiples of 8 up to 256")
    rep = heads // kv_heads
    es = q.element_size()
    block_k, need = _attn_tp_plan(s_max, rep, head_dim, es, SMEM_BUDGET)
    if need > SMEM_BUDGET:
        raise ValueError(f"block_k={block_k} needs {need} bytes of shared "
                         f"memory (budget {SMEM_BUDGET})")
    lds = {}
    for name, t in (("q", q), ("k", k), ("v", v)):
        _same(name, t, q)
        if t.stride(1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        lds[name] = t.stride(0)
    for name, t in (("k_slab", k_slab), ("v_slab", v_slab)):
        _same(name, t, q)
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows must be contiguous and start on "
                             f"16-byte boundaries")
    pos = _positions(seq_pos, b, q.device)
    cos = sin = None
    if rope_cos is not None:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if t.device != q.device or tuple(t.shape) != (b, head_dim):
                raise ValueError(f"{name} must be [{b}, {head_dim}] on "
                                 f"{q.device}")
        cos = rope_cos.to(torch.float32).contiguous()
        sin = rope_sin.to(torch.float32).contiguous()
    from ._build import load
    lib = load("decode_block_tp")
    out = torch.empty((b, heads * head_dim), dtype=q.dtype, device=q.device)
    a = _TpAttnArgs()
    a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    a.ld_q, a.ld_k, a.ld_v = lds["q"], lds["k"], lds["v"]
    a.cos = cos.data_ptr() if cos is not None else None
    a.sin = sin.data_ptr() if sin is not None else None
    a.k_slab, a.v_slab = k_slab.data_ptr(), v_slab.data_ptr()
    a.k_sb, a.k_ss, a.k_sh = k_slab.stride()[:3]
    a.v_sb, a.v_ss, a.v_sh = v_slab.stride()[:3]
    a.pos, a.pos_stride = pos.data_ptr(), int(pos.numel() > 1)
    a.out = out.data_ptr()
    a.B, a.H, a.KH, a.Dh, a.S = b, heads, kv_heads, head_dim, s_max
    a.block_k, a.dtype, a.scale = block_k, code, scale
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        if _split_launch(es, head_dim):
            # the stream's partials and counters from decode_block (never
            # freed; the counters are 0 between launches)
            rows, _, n_part = _split_grid(b, kv_heads, rep, head_dim, s_max)
            if rows > _MAX_TILES:
                raise ValueError(f"decode_block_attn_tp: {rows} (slot, kv "
                                 f"head, head group) rows exceed the "
                                 f"{_MAX_TILES} split counters")
            a.part = _partials(q.device, stream, n_part).data_ptr()
            a.count = _counters(q.device, stream).data_ptr()
            a.split_rows = _SPLIT_ROWS
        _check_rc(lib.decode_block_tp_attention(ctypes.addressof(a), stream),
                  "decode_block_attn_tp")
    decode_block_attn_tp.launches += 1
    return out, k_slab, v_slab


# launches of the per-shard attention kernel since the count was last set
# to 0
decode_block_attn_tp.launches = 0


def _split_grid(b: int, kv_heads: int, rep: int, head_dim: int,
                s_max: int):
    """``(rows, splits, part)`` of a split launch, from the shapes and
    S_max alone (never the positions, so a CUDA graph can capture it): a
    block row (and a counter) per (slot, kv head, group of 4 query heads,
    or each head where the group is not a multiple of 4), a split per
    ``_SPLIT_ROWS`` slab rows, and ``part`` f32 partials ``(m, l,
    acc[head_dim])`` per query head and split."""
    rows = b * kv_heads * (rep // 4 if rep % 4 == 0 else rep)
    splits = -(-s_max // _SPLIT_ROWS)
    return rows, splits, b * kv_heads * rep * splits * (2 + head_dim)


# ============================================================== layer wrapper
def arch_norm(x, w, b, arch):
    """The bundle's norm (``arch["norm"]``: ``"rms"`` or ``"layer"``) over
    the last dim, through the fused-norm kernels: f32 statistics and
    affine, one cast."""
    if arch["norm"] == "rms":
        return NF.rms_norm(x, w, arch["eps"])
    return NF.layer_norm(x, (x.shape[-1],), w, b, arch["eps"])


def tp_fused_block_layer(xs, pks, pvs, poss, blks, arch, ropes, mesh: Mesh):
    """One transformer layer of the sharded fused decode program, over
    per-shard lists: the norm (the fused-norm kernel) local on each slot
    shard, the QKV entry
    ring, the per-shard attention (fresh K/V stored in place), the
    out-proj exit ring, the norm, the MLP-up entry ring, the MLP-down exit
    ring with the activation applied as the chunk is read.

    ``xs[d] [B/tp, D]`` shard ``d``'s slot shard of the residual;
    ``pks``/``pvs`` its slab shards ``[B, S, KH/tp, Dh]``; ``poss[d]
    [B]`` the cache lengths on its device; ``blks[d]`` its entry of the
    ``tp_decode_weights`` bundle; ``arch`` the bundle's architecture;
    ``ropes`` per shard ``(cos, sin)`` f32 ``[B, Dh]`` full-width tables,
    or None.  Each kernel picks its own tiles, as
    :func:`plan_decode_block_tp` (the legality check callers gate on)
    does.  Returns ``(xs', pks, pvs)``."""
    tp = mesh.size
    dh = arch["head_dim"]
    h_l, kh_l = arch["heads"] // tp, arch["kv_heads"] // tp
    h1 = [arch_norm(x, blk["n1w"], blk["n1b"], arch)
          for x, blk in zip(xs, blks)]
    qkv = ring_entry_matmul(h1, [blk["wqkv"] for blk in blks],
                            [blk["bqkv"] for blk in blks], mesh)
    attn = []
    for d in range(tp):
        t = qkv[d]
        cos, sin = ropes[d] if ropes is not None else (None, None)
        a, _, _ = decode_block_attn_tp(
            t[:, :h_l * dh], t[:, h_l * dh:(h_l + kh_l) * dh],
            t[:, (h_l + kh_l) * dh:], pks[d], pvs[d], poss[d],
            kv_heads=kh_l, head_dim=dh, rope_cos=cos, rope_sin=sin)
        attn.append(a)
    o = ring_exit_matmul(attn, [blk["wo"] for blk in blks], mesh)
    xs = [x + (oo if blk["bo"] is None else oo + blk["bo"])
          for x, oo, blk in zip(xs, o, blks)]
    h2 = [arch_norm(x, blk["n2w"], blk["n2b"], arch)
          for x, blk in zip(xs, blks)]
    up = ring_entry_matmul(h2, [blk["wup"] for blk in blks],
                           [blk["bup"] for blk in blks], mesh)
    dn = ring_exit_matmul(up, [blk["wdown"] for blk in blks], mesh,
                          act=arch["act"])
    xs = [x + (dd if blk["bdown"] is None else dd + blk["bdown"])
          for x, dd, blk in zip(xs, dn, blks)]
    return xs, pks, pvs
