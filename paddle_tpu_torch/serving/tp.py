"""Tensor-parallel serving: the mesh, the sharded layouts, the decode
programs (counterpart of paddle_tpu/serving/tp.py).

The serving engine becomes tensor-parallel by sharding its WHOLE device
plane over a 1-D mesh (``distributed/mesh.py``: one process drives every
shard, as the reference's single-controller ``shard_map`` does):

  * **KV slot slabs** and the radix **block slabs** (``kv_pool``) split on
    the kv-head axis: every shard holds every slot, but only its own head
    group, as a contiguous ``[rows, len, kv_heads/tp, head_dim]`` tensor
    on its device (the reference's ``KV_SLAB_SPEC``);
  * **weights** split Megatron-style from the model's
    ``tp_decode_weights`` bundle (:func:`shard_model_params`): QKV /
    MLP-up column-wise (head-aligned ``[q_d | k_d | v_d]`` and
    ``[gate_d | up_d]`` blocks), out-proj / MLP-down row-wise, the
    embedding and head on the vocab axis, norms and the remaining biases
    replicated;
  * the decode step runs one of three programs (the engine's rungs):
    ``tp_fused_block`` — the sharded decode-block kernels
    (kernels/decode_block_tp.py: entry / exit rings around the hop
    kernels, per-shard attention with the fresh K/V stored in place);
    ``tp_fused`` — the composed ring (kernels/collective_matmul.py) with
    ``decode_attention`` on the local slab shards (:func:`_tp_layer`); and
    ``unfused`` — :func:`build_tp_forward`, the per-shard Megatron body
    that also serves every prefill chunk.

The reference runs its prefill chunks and its ``unfused`` rung as GSPMD
programs over the sharded model.  The port's counterpart is one
per-shard body with a replicated residual: column-parallel QKV / MLP-up,
attention on the local head group against the local slab shard,
row-parallel out / down partials summed with :func:`psum` (the arithmetic
GSPMD inserts).  It takes any row count, so it serves prefill chunks and
an ``unfused`` decode at any ``num_slots``.

Per-shard decode dataflow of the fused rungs (one layer; B slots)::

    x [B/tp, D] --norm--> entry ring --> qkv [B, (H+2KH)/tp * dh]
      --rotary/append (local slab shard)--> attention (local heads)
      --> exit ring (out-proj) --> [B/tp, D] +residual
      --norm--> entry ring (MLP up) --> act --> exit ring (MLP down)
      --> [B/tp, D] +residual

Logits are computed against each shard's vocab columns and gathered onto
the first shard's device (the controller), where sampling runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..distributed.mesh import Mesh, psum
from ..kernels.collective_matmul import allgather_matmul, matmul_reduce_scatter
from ..kernels.decode_attention import decode_attention_auto
from ..models.kv_cache import append_kv, cache_lens
from ..kernels.decode_block_tp import arch_norm
from ..models.llama import _positions, _rope_tables, apply_rotary_pos_emb
from ..nn import functional as F

__all__ = ["build_serving_mesh", "serving_param_specs", "shard_model_params",
           "sharded_zeros", "tp_decode_supported", "build_tp_decode_program",
           "build_tp_verify_program", "build_tp_forward", "init_staging"]

# the axis each leaf of the tp_decode_weights bundle splits on over the
# mesh (None: replicated).  tp_decode_weights arranges the globals so that
# an equal contiguous split IS the per-shard block (the reference's
# _BUNDLE_SPECS)
_BUNDLE_SPECS = {
    "wte": 0,         # vocab rows (masked lookup + psum)
    "wpe": None,      # learned positions: replicated
    "head": 1,        # vocab columns (None when tied)
    "nfw": None, "nfb": None,
    "n1w": None, "n1b": None, "n2w": None, "n2b": None,
    "wqkv": 1, "bqkv": 0,
    "wo": 0, "bo": None,
    "wup": 1, "bup": 0,
    "wdown": 0, "bdown": None,
}


def build_serving_mesh(tp: int, devices=None) -> Mesh:
    """A 1-D tensor-parallel mesh over ``tp`` devices: the first ``tp`` of
    ``devices``, or by default of the visible CUDA devices.  Raises when
    fewer are available: nothing places shards on its own initiative.
    Several shards may share one card (``devices=["cuda:0"] * tp``); CPU
    callers pass ``devices=["cpu"] * tp``."""
    if tp < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(n)]
        where = "CUDA devices are"
    else:
        devices = list(devices)
        where = "devices were given"
    if len(devices) < tp:
        raise ValueError(
            f"tensor_parallel={tp} needs {tp} devices but only "
            f"{len(devices)} {where} visible — pass devices= to place the "
            f"shards (several may share one card: devices=['cuda:0'] * "
            f"{tp}; on the CPU devices=['cpu'] * {tp})")
    return Mesh(devices[:tp])


# --------------------------------------------------------------- layouts
def serving_param_specs(model) -> Dict[str, Optional[int]]:
    """Leaf name of ``model.tp_decode_weights`` -> the axis its
    tensor-parallel layout splits (None: replicated), the layout every
    program of the port's tensor-parallel plane uses (the reference's
    GSPMD specs have no counterpart: there is no GSPMD here)."""
    if not hasattr(model, "tp_decode_weights"):
        raise ValueError("the model has no tp_decode_weights bundle")
    return dict(_BUNDLE_SPECS)


def sharded_zeros(mesh: Mesh, shape, dtype) -> List[torch.Tensor]:
    """A kv-head-sharded slab (``[rows, len, kv_heads, head_dim]``) born
    sharded: per shard a zero ``[rows, len, kv_heads/tp, head_dim]`` on
    its device; the whole slab never exists on one device."""
    rows, length, kv_heads, dh = shape
    if kv_heads % mesh.size:
        raise ValueError(
            f"kv_heads {kv_heads} must divide evenly over the "
            f"{mesh.size}-device tensor-parallel mesh (the slot slabs "
            f"partition on the kv-head axis)")
    local = (rows, length, kv_heads // mesh.size, dh)
    return [torch.zeros(local, dtype=dtype, device=d) for d in mesh.devices]


def _split(t: Optional[torch.Tensor], axis: Optional[int], mesh: Mesh
           ) -> List[Optional[torch.Tensor]]:
    """Shard ``d``'s block of ``t`` on its device: a contiguous chunk of
    ``axis`` (a view where it already is one on that device), or ``t``
    itself for a replicated leaf (shared by shards on one device)."""
    if t is None:
        return [None] * mesh.size
    if axis is None:
        return mesh.replicate(t)
    chunks = torch.chunk(t, mesh.size, dim=axis)
    return [c.to(d).contiguous() for c, d in zip(chunks, mesh.devices)]


def shard_model_params(model, mesh: Mesh) -> dict:
    """Lay the model's weights out over ``mesh`` in place and return the
    per-shard bundle ``{"mesh", "arch", "shards"}`` (also kept as
    ``model.tp_weights``): ``shards[d]`` holds shard ``d``'s block of
    every leaf of ``model.tp_decode_weights(tp)`` (``_BUNDLE_SPECS``).
    The model's own parameters are then released, so the weights are
    held once (on one card the row-split and replicated leaves stay
    views of the old storage; the column-split ones are the only copies).
    The model serves only through a tensor-parallel engine on ``mesh``
    afterwards: its own entry points and a tp=1 engine raise, naming the
    cause (``models.gpt.check_weights_held``).  A model already sharded
    over the same mesh returns its bundle; over another mesh it raises."""
    held = getattr(model, "tp_weights", None)
    if held is not None:
        if held["mesh"] != mesh:
            raise ValueError(f"the model is already sharded over "
                             f"{held['mesh']}; build a fresh model to shard "
                             f"it over {mesh}")
        return held
    tp = mesh.size
    specs = serving_param_specs(model)
    arch, weights = model.tp_decode_weights(tp)
    shards = [{"blocks": []} for _ in range(tp)]
    for key, t in weights.items():
        if key != "blocks":
            for d, part in enumerate(_split(t, specs[key], mesh)):
                shards[d][key] = part
    blocks = weights.pop("blocks")
    while blocks:
        blk = blocks.pop(0)               # each global block dies here
        per = [{} for _ in range(tp)]
        for key, t in blk.items():
            for d, part in enumerate(_split(t, specs[key], mesh)):
                per[d][key] = part
        for d in range(tp):
            shards[d]["blocks"].append(per[d])
    del weights
    with torch.no_grad():
        for p in model.parameters():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
    model.tp_weights = {"mesh": mesh, "arch": arch, "shards": shards}
    return model.tp_weights


# ------------------------------------------------------- shared legs
def tp_decode_supported(model, tp: int,
                        num_slots: int) -> Tuple[bool, Optional[str]]:
    """Static legality of the fused ring decode program (``tp_fused``)
    for ``model`` at this engine shape.  Returns ``(ok, reason)``."""
    if tp == 1:
        return False, "tensor_parallel is 1 (single chip needs no " \
                      "collectives)"
    if not hasattr(model, "tp_decode_weights") \
            or not hasattr(model, "tp_decode_supported"):
        return False, "model has no tp_decode_weights"
    if num_slots % tp:
        return False, (f"num_slots {num_slots} not divisible by "
                       f"tensor_parallel {tp} (the residual stream "
                       f"slot-shards between the fused collectives)")
    return model.tp_decode_supported(tp)


def _on(pos, device):
    return pos.to(device) if isinstance(pos, torch.Tensor) else pos


def _embed(shards, ids: torch.Tensor, position, mesh: Mesh):
    """Replicated ``[b, s, D]`` embeddings: each shard looks up the ids
    that fall in its vocab rows (zeros elsewhere), the rows are summed
    over shards, learned positions added."""
    parts = []
    for d, (sh, dev) in enumerate(zip(shards, mesh.devices)):
        wte = sh["wte"]
        v_l = wte.shape[0]
        loc = ids.to(dev).long() - d * v_l
        ok = (loc >= 0) & (loc < v_l)
        rows = wte[loc.clamp(0, v_l - 1)]
        parts.append(torch.where(ok[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=dev)))
    xs = psum(parts, mesh)
    if shards[0]["wpe"] is not None:
        xs = [x + F.embedding(_positions(position, ids.shape[1], x.device),
                              sh["wpe"]) for x, sh in zip(xs, shards)]
    return xs


def _gather_logits(parts: Sequence[torch.Tensor], mesh: Mesh):
    """Per-shard vocab blocks concatenated on the controller device."""
    ctrl = mesh.devices[0]
    return torch.cat([p.to(ctrl) for p in parts], dim=-1)


def _head(sh) -> torch.Tensor:
    return sh["head"] if sh["head"] is not None else sh["wte"].t()


def _act(up: torch.Tensor, arch) -> torch.Tensor:
    if arch["act"] == "swiglu":
        f_l = up.shape[-1] // 2
        return F.silu(up[..., :f_l]) * up[..., f_l:]
    return F.gelu(up, approximate=True)


def _bias(t, b):
    return t if b is None else t + b


def _local_attention(qkv, pk, pv, pos, rope, arch, tp: int):
    """One shard's attention over its head group: ``qkv [b, s, (H_l +
    2 KH_l) Dh]`` split into q / k / v, rotary, the fresh K/V appended into
    the shard's slabs at ``pos``, ``decode_attention`` over the slabs.
    Returns ``[b, s, H_l Dh]``."""
    dh = arch["head_dim"]
    h_l, kh_l = arch["heads"] // tp, arch["kv_heads"] // tp
    b, s = qkv.shape[:2]
    q = qkv[..., :h_l * dh].reshape(b, s, h_l, dh)
    k = qkv[..., h_l * dh:(h_l + kh_l) * dh].reshape(b, s, kh_l, dh)
    v = qkv[..., (h_l + kh_l) * dh:].reshape(b, s, kh_l, dh)
    if rope is not None:
        q = apply_rotary_pos_emb(q, *rope)
        k = apply_rotary_pos_emb(k, *rope)
    append_kv(pk, pv, k, v, pos)
    a = decode_attention_auto(q, pk, pv,
                              cache_lens(pos, s, b, device=qkv.device))
    return a.reshape(b, s, h_l * dh)


# ------------------------------------------- the per-shard Megatron body
def _megatron_layer(xs, pks, pvs, poss, blks, arch, ropes, mesh: Mesh):
    """One layer with a replicated residual ``xs[d] [b, s, D]``: the
    column-parallel QKV, the shard's attention (K/V appended at
    ``poss[d]``), the row-parallel out-projection's partials summed over
    shards; the MLP likewise."""
    parts = []
    for d, (x, blk) in enumerate(zip(xs, blks)):
        qkv = _bias(arch_norm(x, blk["n1w"], blk["n1b"], arch) @ blk["wqkv"],
                    blk["bqkv"])
        a = _local_attention(qkv, pks[d], pvs[d], poss[d],
                             None if ropes is None else ropes[d], arch,
                             mesh.size)
        parts.append(a @ blk["wo"])
    xs = [x + _bias(o, blk["bo"])
          for x, o, blk in zip(xs, psum(parts, mesh), blks)]
    parts = [_act(_bias(arch_norm(x, blk["n2w"], blk["n2b"], arch)
                        @ blk["wup"], blk["bup"]), arch) @ blk["wdown"]
             for x, blk in zip(xs, blks)]
    return [x + _bias(m, blk["bdown"])
            for x, m, blk in zip(xs, psum(parts, mesh), blks)]


def build_tp_forward(bundle):
    """The per-shard Megatron forward over a :func:`shard_model_params`
    bundle: ``forward(ids [b, s], caches, position) -> (logits [b, s, V],
    new_caches)`` with the signature of the models' ``decode_step``, where
    each layer's cache is ``(k_shards, v_shards, pos)`` and the shards'
    slabs are appended in place.  ``position`` is an int or a ``[b]``
    tensor.  Logits land on the controller device.  Serves the engine's
    prefill chunks and its ``unfused`` tensor-parallel decode."""
    mesh, arch, shards = bundle["mesh"], bundle["arch"], bundle["shards"]

    @torch.no_grad()
    def forward(ids: torch.Tensor, caches, position):
        s = ids.shape[1]
        xs = _embed(shards, ids, position, mesh)
        ropes = None
        if arch["rope"]:
            ropes = [_rope_tables(_positions(position, s, x.device),
                                  arch["head_dim"], arch["rope_theta"],
                                  x.dtype) for x in xs]
        new_caches = []
        for li, (pks, pvs, pos) in enumerate(caches):
            poss = [_on(pos, dev) for dev in mesh.devices]
            xs = _megatron_layer(xs, pks, pvs, poss,
                                 [sh["blocks"][li] for sh in shards], arch,
                                 ropes, mesh)
            new_caches.append((pks, pvs, pos + s))
        logits = [arch_norm(x, sh["nfw"], sh["nfb"], arch) @ _head(sh)
                  for x, sh in zip(xs, shards)]
        return _gather_logits(logits, mesh), new_caches

    return forward


# ------------------------------------------------- fused decode programs
def _tp_layer(xs, pks, pvs, poss, blks, arch, ropes, mesh: Mesh,
              s: int = 1):
    """One layer of the composed ring decode (``tp_fused``): the entry
    all-gather ring fused with the QKV / MLP-up products, the exit
    reduce-scatter ring with the out-proj / MLP-down products, the
    shard's attention through ``decode_attention``.  ``s`` is the
    per-slot token width: 1 for the decode program, the ``spec_k+1``
    window for the verify program.  ``xs[d] [B*s/tp, D]`` is the
    slot-sharded residual, its rows slot-major; they fold back to ``[B,
    s, ...]`` only around attention, where query t of a slot's window
    sees keys up to ``pos + t``."""
    h1 = [arch_norm(x, blk["n1w"], blk["n1b"], arch)
          for x, blk in zip(xs, blks)]
    qkv = allgather_matmul(h1, [blk["wqkv"] for blk in blks], mesh)
    attn = []
    for d, (t, blk) in enumerate(zip(qkv, blks)):
        t = _bias(t, blk["bqkv"])
        a = _local_attention(t.reshape(-1, s, t.shape[-1]), pks[d], pvs[d],
                             poss[d], None if ropes is None else ropes[d],
                             arch, mesh.size)
        attn.append(a.reshape(-1, a.shape[-1]))
    o = matmul_reduce_scatter(attn, [blk["wo"] for blk in blks], mesh)
    xs = [x + _bias(oo, blk["bo"]) for x, oo, blk in zip(xs, o, blks)]
    h2 = [arch_norm(x, blk["n2w"], blk["n2b"], arch)
          for x, blk in zip(xs, blks)]
    up = allgather_matmul(h2, [blk["wup"] for blk in blks], mesh)
    act = [_act(_bias(u, blk["bup"]), arch) for u, blk in zip(up, blks)]
    dn = matmul_reduce_scatter(act, [blk["wdown"] for blk in blks], mesh)
    return [x + _bias(m, blk["bdown"]) for x, m, blk in zip(xs, dn, blks)]


def _ring_forward(bundle, ks, vs, seq_pos: torch.Tensor, ids: torch.Tensor,
                  pallas_block: bool = False) -> torch.Tensor:
    """The ring programs' forward over ``ids [B, s]`` at per-row
    positions ``seq_pos [B]``: embedding (masked vocab-shard lookup +
    psum), the residual slot-sharded ``[B*s/tp, D]`` (slot-major) through
    the layers, the final norm, logits against each shard's vocab columns
    gathered onto the controller as ``[B, s, V]``.  The slabs are
    appended in place; ``seq_pos`` is left as it is.  ``pallas_block``
    (``s`` = 1 only) runs the layers on the sharded decode-block
    kernels."""
    from ..kernels.decode_block_tp import tp_fused_block_layer
    mesh, arch, shards = bundle["mesh"], bundle["arch"], bundle["shards"]
    tp = mesh.size
    b, s = ids.shape
    b_l = b // tp
    x = _embed(shards, ids, seq_pos, mesh)
    poss = [seq_pos.to(dev) for dev in mesh.devices]
    ropes = None
    if arch["rope"]:
        if pallas_block:
            # full-width f32 tables (halves duplicated) at each slot's
            # position: the kernel applies rotary in f32
            ropes = []
            for p in poss:
                cos, sin = _rope_tables(p, arch["head_dim"],
                                        arch["rope_theta"], torch.float32)
                ropes.append((torch.cat([cos, cos], dim=-1),
                              torch.cat([sin, sin], dim=-1)))
        else:
            ropes = [_rope_tables(_positions(p, s, p.device),
                                  arch["head_dim"], arch["rope_theta"],
                                  xx.dtype) for p, xx in zip(poss, x)]
    # slot-shard the residual stream: shard d's slot-major row chunk
    xs = [xx[d * b_l:(d + 1) * b_l].reshape(b_l * s, -1)
          for d, xx in enumerate(x)]
    for li in range(len(shards[0]["blocks"])):
        blks = [sh["blocks"][li] for sh in shards]
        if pallas_block:
            xs, _, _ = tp_fused_block_layer(xs, ks[li], vs[li], poss, blks,
                                            arch, ropes, mesh)
        else:
            xs = _tp_layer(xs, ks[li], vs[li], poss, blks, arch, ropes, mesh,
                           s=s)
    xf = [arch_norm(x, sh["nfw"], sh["nfb"], arch)
          for x, sh in zip(xs, shards)]
    logits = allgather_matmul(xf, [_head(sh) for sh in shards], mesh)
    return _gather_logits(logits, mesh).view(b, s, -1)


def build_tp_decode_program(bundle, *, pallas_block: bool = False,
                            batch: Optional[int] = None,
                            max_seq: Optional[int] = None):
    """The engine's ring decode program over a :func:`shard_model_params`
    bundle: ``program(ks, vs, seq_pos, last_tok) -> (logits [B, 1, V],
    ks, vs, seq_pos)`` with ``ks[layer]`` the layer's per-shard slabs
    (updated in place) and ``seq_pos`` the tensor it was given, advanced
    by one in place (the engine's CUDA graph replays it on fixed
    buffers).  Embedding (masked vocab-shard lookup + psum),
    the residual slot-sharded ``[B/tp, D]`` through the layers, the final
    norm, logits against each shard's vocab columns gathered onto the
    controller.

    ``pallas_block=True`` builds the ``tp_fused_block`` variant: the layer
    bodies run the sharded decode-block kernels (kernels/decode_block_tp.py).
    It raises if ``plan_decode_block(tp=...)`` finds no tiling that fits
    at ``batch`` / ``max_seq`` — callers gate on
    ``decode_block.resolve_fused_decode(tp=...)`` first."""
    from ..kernels.decode_block import plan_decode_block
    mesh, arch, shards = bundle["mesh"], bundle["arch"], bundle["shards"]
    tp = mesh.size
    if pallas_block:
        gated = arch["act"] == "swiglu"
        blk0 = shards[0]["blocks"][0]
        plan, why = plan_decode_block(
            max_seq=max_seq, hidden=arch["hidden"], heads=arch["heads"],
            kv_heads=arch["kv_heads"], head_dim=arch["head_dim"],
            ffn=blk0["wup"].shape[1] * tp // (2 if gated else 1),
            batch=batch, itemsize=blk0["wqkv"].element_size(), gated=gated,
            tp=tp)
        if plan is None:
            raise ValueError(
                f"build_tp_decode_program(pallas_block=True): no shared-"
                f"memory tiling fits ({why}) — gate on resolve_fused_decode "
                f"before requesting the sharded decode block")

    @torch.no_grad()
    def program(ks, vs, seq_pos: torch.Tensor, last_tok: torch.Tensor):
        logits = _ring_forward(bundle, ks, vs, seq_pos, last_tok[:, None],
                               pallas_block=pallas_block)
        seq_pos.add_(1)
        return logits, ks, vs, seq_pos

    return program


def build_tp_verify_program(bundle, *, width: int):
    """The engine's ring verify program over a :func:`shard_model_params`
    bundle (speculative decoding): ``program(ks, vs, seq_pos, ids) ->
    logits [B, width, V]`` with ``ids [B, width]`` each slot's last
    committed token followed by its draft window, at each slot's own
    ``seq_pos``.  The window's K/V rows are appended into the slabs in
    place; ``seq_pos`` is NOT advanced (the engine advances it by each
    slot's accepted length + 1).  The layers are the composed ring's
    :func:`_tp_layer` at width ``width``; a ``tp_fused_block`` engine
    verifies through this program too (its block kernels take one token
    a slot) and keeps the kernels for its decode steps."""
    if width < 2:
        raise ValueError(f"verify width must be >= 2 (spec_k >= 1), "
                         f"got {width}")

    @torch.no_grad()
    def program(ks, vs, seq_pos: torch.Tensor, ids: torch.Tensor):
        if ids.shape[1] != width:
            raise ValueError(f"verify program built for width {width}, "
                             f"got ids {tuple(ids.shape)}")
        return _ring_forward(bundle, ks, vs, seq_pos, ids)

    return program


def init_staging(bundle, max_seq: int) -> Tuple[list, list]:
    """The engine's zero staging lane: per layer the per-shard ``[1,
    max_seq, kv_heads/tp, head_dim]`` k and v."""
    mesh, arch, shards = bundle["mesh"], bundle["arch"], bundle["shards"]
    shape = (1, max_seq, arch["kv_heads"], arch["head_dim"])
    dtype = shards[0]["blocks"][0]["wqkv"].dtype
    n = len(shards[0]["blocks"])
    return ([sharded_zeros(mesh, shape, dtype) for _ in range(n)],
            [sharded_zeros(mesh, shape, dtype) for _ in range(n)])
