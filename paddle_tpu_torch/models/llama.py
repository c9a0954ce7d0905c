"""Llama family (counterpart of paddle_tpu/models/llama.py).

PaddleNLP's ``LlamaForCausalLM`` surface: RMSNorm, rotary position
embeddings (the neox pairing of halves), grouped-query attention, a
SwiGLU MLP, no biases, an untied ``lm_head``.  Parameter names and
layouts are the reference's (``llama.layers.0.self_attn.q_proj.weight``,
``[in, out]`` Linear weights), so a JAX ``state_dict`` loads key for key
(``models/convert.py``).

Every RMSNorm goes through the fused-norm kernels
(``nn.functional.rms_norm``).  The uncached (training) forward's
attention is ``nn.functional.scaled_dot_product_attention`` (the flash
kernels' ``autograd.Function``); the cached decode/prefill path's is
``kernels.decode_attention_auto``; ``fused_decode_step`` runs each layer
through the decode-block kernel pair.  All three read kv head
``h // (H // KVH)`` themselves, so the KV tensors are passed with their
own heads: the reference's ``jnp.repeat`` of the cache (a broadcast under
XLA) would be a copy of ``[B, S_max, H, D]`` per layer per step here.

``cfg.remat`` recomputes each layer in the uncached training forward
(``distributed/recompute.py``; off by default, as in the reference).

``llama_shard_fn(mesh)`` is the reference's semi-auto tensor-parallel
plan for ``dist.shard_layer``; under it the auto-parallel Engine runs
each decoder layer through :meth:`LlamaDecoderLayer.forward_ranks`, each
mp rank's heads and ffn columns (:meth:`LlamaDecoderLayer.partial`) with
the row-parallel partials summed over the mp group.  Not ported yet
(ROADMAP): ``chunked_loss``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..distributed.mesh import Mesh, all_gather, psum
from ..distributed.recompute import remat_wrap
from ..kernels.decode_attention import decode_attention_auto
from ..kernels.decode_block import decode_block_layer, fusion_legal
from ..nn.functional import scaled_dot_product_attention, silu
from ..nn.layers import Dropout, Embedding, LayerList, Linear, RMSNorm
from .gpt import check_weights_held
from .kv_cache import append_kv, cache_lens

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "apply_rotary_pos_emb",
           "llama_shard_fn", "llama_tiny", "llama_7b"]

Cache = Tuple[torch.Tensor, torch.Tensor, Union[int, torch.Tensor]]
Pos = Union[int, torch.Tensor]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None      # None -> MHA; < num_heads -> GQA
    max_seq_len: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dropout: float = 0.0
    dtype: str = "float32"
    # recompute per layer in the training forward: False | True | a
    # policy name (distributed/recompute.py; llama.py:52-53)
    remat: Union[bool, str] = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        kvh = self.kv_heads * self.head_dim
        attn = h * h + 2 * h * kvh + h * h          # q, k, v, o
        mlp = 3 * h * self.intermediate_size        # gate, up, down
        norms = 2 * h
        return 2 * v * h + l * (attn + mlp + norms) + h


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[*, head_dim/2]`` for ``positions``, computed in
    f32 and cast to ``dtype`` (llama.py:72-78)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device)
                           / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def fused_rope_tables(pos: torch.Tensor, cfg: "LlamaConfig"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused decode path's rotary tables: f32 ``[B, head_dim]`` at
    each row's position ``pos [B]``, the halves duplicated
    (llama.py:297-303)."""
    cos, sin = _rope_tables(pos, cfg.head_dim, cfg.rope_theta, torch.float32)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _positions(offset: Pos, s: int, device: torch.device) -> torch.Tensor:
    """``offset + arange(s)``: ``[s]`` for an int offset, ``[b, s]`` for a
    ``[b]`` tensor of per-row offsets (ragged continuous batching)."""
    ar = torch.arange(s, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() >= 1:
        return offset.to(device).long()[:, None] + ar
    return ar + int(offset)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor) -> torch.Tensor:
    """x ``[b, s, heads, d]``; cos/sin ``[s, d/2]`` (shared positions) or
    ``[b, s, d/2]`` (per-row positions).  Llama pairing: ``(x1, x2)`` are
    the halves of the head (llama.py:81-92)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        kw = dict(bias_attr=False, device=device, dtype=dtype,
                  generator=generator)
        self.q_proj = Linear(h, cfg.num_heads * d, **kw)
        self.k_proj = Linear(h, cfg.kv_heads * d, **kw)
        self.v_proj = Linear(h, cfg.kv_heads * d, **kw)
        self.o_proj = Linear(cfg.num_heads * d, h, **kw)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[Cache] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(b, s, cfg.kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(b, s, cfg.kv_heads, cfg.head_dim)
        q = apply_rotary_pos_emb(q, cos, sin)
        k = apply_rotary_pos_emb(k, cos, sin)
        if cache is None:
            out = scaled_dot_product_attention(q, k, v, is_causal=True)
            new_cache = None
        else:
            pk, pv, pos = cache
            # pos: int (dense batch) or [b] per-row offsets; seq_lens =
            # pos + s with the causal tail is the chunked-prefill mask
            k, v = append_kv(pk, pv, k, v, pos)
            out = decode_attention_auto(
                q, k, v, cache_lens(pos, s, b, device=x.device))
            new_cache = (k, v, pos + s)
        out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
        return self.o_proj(out), new_cache


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias_attr=False, device=device, dtype=dtype,
                  generator=generator)
        self.gate_proj = Linear(h, m, **kw)
        self.up_proj = Linear(h, m, **kw)
        self.down_proj = Linear(m, h, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, generator=generator, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                epsilon=cfg.rms_norm_eps,
                                                **kw)
        self.mlp = LlamaMLP(cfg, generator=generator, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: Optional[Cache] = None):
        a, new_cache = self.self_attn(self.input_layernorm(x), cos, sin,
                                      cache)
        x = x + self.drop(a)
        x = x + self.drop(self.mlp(self.post_attention_layernorm(x)))
        if cache is not None:
            return x, new_cache
        return x

    # the per-rank body's layout (the Engine reads it): these sublayers'
    # weights split on their columns (Shard(1)) and on their rows
    # (Shard(0)) over one mesh dim, everything else replicated
    RANK_COLUMNS = ("self_attn.q_proj", "self_attn.k_proj",
                    "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj")
    RANK_ROWS = ("self_attn.o_proj", "mlp.down_proj")
    # calls of partial() since the process started
    partial_calls = 0

    def check_ranks(self, mp: int) -> None:
        """Raise unless the heads and the ffn columns split over ``mp``
        ranks (the kv heads need not: forward_ranks gathers them)."""
        cfg = self.cfg
        for what, n in (("num_heads", cfg.num_heads),
                        ("intermediate_size", cfg.intermediate_size)):
            if n % mp:
                raise ValueError(
                    f"LlamaConfig.{what} {n} does not split over the {mp} "
                    f"tensor-parallel ranks: each rank runs whole heads and "
                    f"an equal share of the ffn columns")

    def partial(self, x: torch.Tensor, half: str, w: dict,
                cos: Optional[torch.Tensor] = None,
                sin: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """One mp rank's share of half the layer, before the row-parallel
        sum, on ``x`` already through the half's RMSNorm (after
        ``GPTBlock.partial``): ``"attn"`` is the rank's q (and k / v)
        columns -> rotary -> causal attention over its heads -> ``@``
        its ``o_proj`` rows; ``"mlp"`` is its gate / up columns -> SwiGLU
        -> ``@`` its ``down_proj`` rows.  ``w`` holds the rank's pieces
        (``q k v o gate up down``); ``kv`` the rank's K / V heads when the
        caller gathered them (kv heads that do not split over the ranks)."""
        LlamaDecoderLayer.partial_calls += 1
        if half == "mlp":
            return torch.matmul(silu(torch.matmul(x, w["gate"]))
                                * torch.matmul(x, w["up"]), w["down"])
        b, s, _ = x.shape
        d = self.cfg.head_dim
        q = torch.matmul(x, w["q"]).view(b, s, -1, d)
        if kv is None:
            kv = (torch.matmul(x, w["k"]).view(b, s, -1, d),
                  torch.matmul(x, w["v"]).view(b, s, -1, d))
        k, v = kv
        q = apply_rotary_pos_emb(q, cos, sin)
        k = apply_rotary_pos_emb(k, cos, sin)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.matmul(out.reshape(b, s, -1), w["o"])

    def _gathered_kv(self, hs, ws, mesh: Mesh) -> list:
        """Each rank's K / V heads when the kv heads do not split over the
        ranks: the ranks' K / V columns gathered over the group, then for
        each rank the kv head of each of its q heads (``h // (H / KVH)``),
        so the rank's attention is exact."""
        cfg = self.cfg
        b, s, _ = hs[0].shape
        d, mp = cfg.head_dim, mesh.size
        ks = all_gather([torch.matmul(h, w["k"]) for h, w in zip(hs, ws)],
                        mesh, dim=-1)
        vs = all_gather([torch.matmul(h, w["v"]) for h, w in zip(hs, ws)],
                        mesh, dim=-1)
        per, group = cfg.num_heads // mp, cfg.num_heads // cfg.kv_heads
        out = []
        for r in range(mp):
            idx = [hd // group for hd in range(r * per, (r + 1) * per)]
            out.append((ks[r].view(b, s, cfg.kv_heads, d)[:, :, idx],
                        vs[r].view(b, s, cfg.kv_heads, d)[:, :, idx]))
        return out

    def forward_ranks(self, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, groups) -> torch.Tensor:
        """The layer under ``llama_shard_fn``'s placements: both RMSNorms
        once over all rows (replicated weights, held once); for each data
        group ``(rows, ws, mesh)`` each mp rank of ``mesh`` runs its rows
        through its half-layer partials (``ws``: the ranks' pieces), summed
        over the group with ``psum``; then the residual adds."""
        mp = groups[0][2].size
        self.check_ranks(mp)
        gather_kv = self.cfg.kv_heads % mp != 0
        for half, norm in (("attn", self.input_layernorm),
                           ("mlp", self.post_attention_layernorm)):
            h = norm(x)
            parts = []
            for rows, ws, mesh in groups:
                hs = mesh.replicate(h[rows])
                kvs = self._gathered_kv(hs, ws, mesh) \
                    if half == "attn" and gather_kv else [None] * mp
                outs = [self.partial(hr, half, w, cos.to(hr.device),
                                     sin.to(hr.device), kv)
                        for hr, w, kv in zip(hs, ws, kvs)]
                parts.append(psum(outs, mesh)[0].to(x.device))
            x = x + self.drop(torch.cat(parts) if len(parts) > 1
                              else parts[0])
        return x

    def decode_block_weights(self) -> dict:
        """This layer as ``decode_block_layer``'s keywords (without the
        rotary tables): RMSNorm, no biases, GQA, SwiGLU."""
        cfg = self.cfg
        at, mlp = self.self_attn, self.mlp
        return dict(
            kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
            norm="rms", eps1=cfg.rms_norm_eps, eps2=cfg.rms_norm_eps,
            norm1_w=self.input_layernorm.weight, norm1_b=None,
            wq=at.q_proj.weight, wk=at.k_proj.weight, wv=at.v_proj.weight,
            bq=None, bkv=None, bv=None, wo=at.o_proj.weight, bo=None,
            norm2_w=self.post_attention_layernorm.weight, norm2_b=None,
            w1=mlp.up_proj.weight, b1=None, w2=mlp.down_proj.weight, b2=None,
            w_gate=mlp.gate_proj.weight)

    def fused_decode_step(self, x: torch.Tensor, cos_full: torch.Tensor,
                          sin_full: torch.Tensor, cache: Cache):
        """One decode token through the decode-block kernel pair
        (kernels/decode_block.py): RMSNorm -> QKV (+rotary) -> KV append
        -> GQA streaming attention -> o_proj -> SwiGLU MLP.
        ``cos_full``/``sin_full`` are f32 ``[B, head_dim]`` rotary tables
        (halves duplicated) at each row's position; the slabs in
        ``cache`` are updated in place."""
        pk, pv, pos = cache
        y, k2, v2 = decode_block_layer(
            x, pk, pv, pos, **self.decode_block_weights(),
            rope_cos=cos_full, rope_sin=sin_full)
        return y, (k2, v2, pos + 1)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size,
                                      generator=generator, **kw)
        self.layers = LayerList([LlamaDecoderLayer(cfg, generator=generator,
                                                   **kw)
                                 for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor,
                caches: Optional[List[Cache]] = None,
                position_offset: Pos = 0):
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        pos = _positions(position_offset, input_ids.shape[1], x.device)
        cos, sin = _rope_tables(pos, cfg.head_dim, cfg.rope_theta, x.dtype)
        new_caches = []
        remat = cfg.remat if torch.is_grad_enabled() else False
        for i, layer in enumerate(self.layers):
            if caches is None:
                x = remat_wrap(layer, remat)(x, cos, sin)
            else:
                x, c = layer(x, cos, sin, caches[i])
                new_caches.append(c)
        x = self.norm(x)
        return x if caches is None else (x, new_caches)


class LlamaForCausalLM(nn.Module):
    """Llama with an untied ``lm_head``.

    Built on ``device`` (default: the current CUDA device; with no CUDA
    device it raises and asks for ``device="cpu"``), in ``dtype``
    (default: ``cfg.dtype``), with weights drawn from ``generator``
    (default: a generator on ``device`` seeded with 0).  Parameters are
    created on ``device`` directly."""

    def __init__(self, cfg: LlamaConfig,
                 device: Union[None, str, torch.device] = None,
                 dtype: Union[None, str, torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, cfg.dtype)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        self.llama = LlamaModel(cfg, device=device, dtype=dtype,
                                generator=generator)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                              bias_attr=False, device=device, dtype=dtype,
                              generator=generator)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        check_weights_held(self, "LlamaForCausalLM.forward")
        return self.lm_head(self.llama(input_ids))

    def loss(self, input_ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Causal LM loss: the mean over tokens of the f32 log-softmax's
        negative label entry (llama.py:236-240)."""
        logp = torch.log_softmax(self(input_ids).float(), dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None]).mean()

    # ---- incremental decode -------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: Union[None, str, torch.dtype] = None
                   ) -> List[Cache]:
        cfg = self.cfg
        dt = resolve_dtype(dtype) if dtype is not None else self.dtype
        shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device), 0)
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def decode_step(self, input_ids: torch.Tensor, caches: List[Cache],
                    position: Pos):
        """One incremental chunk at ``position`` (an int or a ``[b]``
        tensor): appends its K/V into ``caches`` in place and returns
        ``(logits [b, s, vocab], new_caches)``."""
        check_weights_held(self, "LlamaForCausalLM.decode_step")
        hidden, new_caches = self.llama(input_ids, caches,
                                        position_offset=position)
        return self.lm_head(hidden), new_caches

    def fused_decode_supported(self, batch: int = 1,
                               kv_len: Optional[int] = None, tp: int = 1):
        """Static legality of the fused decode-block path (GQA aware).
        Returns ``(ok, reason)``."""
        cfg = self.cfg
        if cfg.dropout and self.training:
            return False, "dropout active (training mode)"
        return fusion_legal(
            max_seq=kv_len or cfg.max_seq_len, hidden=cfg.hidden_size,
            heads=cfg.num_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, ffn=cfg.intermediate_size, batch=batch,
            dtype=self.dtype, gated=True, tp=tp)

    @torch.no_grad()
    def fused_decode_step(self, input_ids: torch.Tensor, caches: List[Cache],
                          position: Pos):
        """``decode_step`` for one token per row through the decode-block
        kernels: the embedding, final norm and head are shared with
        ``decode_step``; the rotary tables are f32 at each row's position,
        full width with the halves duplicated (llama.py:285-310)."""
        check_weights_held(self, "LlamaForCausalLM.fused_decode_step")
        cfg = self.cfg
        x = self.llama.embed_tokens(input_ids)
        b = x.shape[0]
        if isinstance(position, torch.Tensor) and position.dim() >= 1:
            pos = position.to(x.device)
        else:
            pos = torch.full((b,), int(position), dtype=torch.int32,
                             device=x.device)
        cos_full, sin_full = fused_rope_tables(pos, cfg)
        new_caches = []
        for layer, cache in zip(self.llama.layers, caches):
            x, c = layer.fused_decode_step(x, cos_full, sin_full, cache)
            new_caches.append(c)
        x = self.llama.norm(x)
        return self.lm_head(x), new_caches

    def generate(self, input_ids, max_new_tokens: int, **kw):
        """Autoregressive decoding (models/generation.py)."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens, **kw)

    # ---- tensor-parallel serving (serving/tp.py) ----------------------
    def tp_decode_supported(self, tp: int):
        """Static legality of the tensor-parallel decode program at degree
        ``tp`` (GQA aware: the kv-head axis must tile the mesh too, since
        the KV slabs shard on it).  Returns ``(ok, reason)``."""
        cfg = self.cfg
        for what, n in (("num_heads", cfg.num_heads),
                        ("kv_heads", cfg.kv_heads),
                        ("intermediate_size", cfg.intermediate_size),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                return False, (f"{what} {n} not divisible by "
                               f"tensor_parallel {tp}")
        return True, None

    @torch.no_grad()
    def tp_decode_weights(self, tp: int):
        """``(arch, weights)`` for the tensor-parallel decode program
        (serving/tp.py), in the reference's global layout: q/k/v column
        blocks re-arranged per shard as ``[q_d | k_d | v_d]`` head groups
        (one fused entry product), gate/up as ``[gate_d | up_d]`` (one
        fused MLP-up product), both new tensors; o/down stay row-parallel,
        embedding and lm_head vocab-parallel, as the model's own
        parameters."""
        check_weights_held(self, "LlamaForCausalLM.tp_decode_weights")
        cfg = self.cfg
        dh = cfg.head_dim
        arch = {"norm": "rms", "eps": cfg.rms_norm_eps, "act": "swiglu",
                "rope": True, "rope_theta": cfg.rope_theta,
                "heads": cfg.num_heads, "kv_heads": cfg.kv_heads,
                "head_dim": dh, "hidden": cfg.hidden_size,
                "vocab": cfg.vocab_size}
        qs, kvs, fs = ((cfg.num_heads // tp) * dh,
                       (cfg.kv_heads // tp) * dh,
                       cfg.intermediate_size // tp)
        blocks = []
        for layer in self.llama.layers:
            at, mlp = layer.self_attn, layer.mlp
            wq, wk, wv = (at.q_proj.weight.detach(), at.k_proj.weight.detach(),
                          at.v_proj.weight.detach())
            wg, wu = mlp.gate_proj.weight.detach(), mlp.up_proj.weight.detach()
            parts, mparts = [], []
            for d in range(tp):
                parts += [wq[:, d * qs:(d + 1) * qs],
                          wk[:, d * kvs:(d + 1) * kvs],
                          wv[:, d * kvs:(d + 1) * kvs]]
                mparts += [wg[:, d * fs:(d + 1) * fs],
                           wu[:, d * fs:(d + 1) * fs]]
            blocks.append({
                "n1w": layer.input_layernorm.weight.detach(), "n1b": None,
                "wqkv": torch.cat(parts, dim=1), "bqkv": None,
                "wo": at.o_proj.weight.detach(), "bo": None,
                "n2w": layer.post_attention_layernorm.weight.detach(),
                "n2b": None,
                "wup": torch.cat(mparts, dim=1), "bup": None,
                "wdown": mlp.down_proj.weight.detach(), "bdown": None})
        return arch, {
            "wte": self.llama.embed_tokens.weight.detach(), "wpe": None,
            "head": self.lm_head.weight.detach(),
            "nfw": self.llama.norm.weight.detach(), "nfb": None,
            "blocks": blocks}


def llama_shard_fn(mesh, dp_axis: str = "dp", mp_axis: str = "mp"):
    """A ``shard_fn`` for ``dist.shard_layer`` (llama.py:379-406):
    Megatron placement over ``mp_axis`` (q / k / v / gate / up columns
    ``Shard(1)``, o / down rows ``Shard(0)``, the embedding split on its
    hidden dim, ``lm_head`` on the vocab), everything else replicated (dp
    comes from the batch).  Raises when the heads or the ffn columns do
    not split over the mp ranks."""
    from ..distributed.auto_parallel import Replicate, Shard, shard_tensor

    mp_dim = mesh.dim_names.index(mp_axis)
    mp = mesh.shape[mp_dim]

    def place(sub, pname, tensor_dim):
        p = sub._parameters.get(pname)
        if p is None:
            return
        pl = [Replicate()] * mesh.ndim
        pl[mp_dim] = Shard(tensor_dim)
        sub._parameters[pname] = shard_tensor(p, mesh, pl)

    def shard_fn(name, sub, m):
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(sub, LlamaDecoderLayer):
            sub.check_ranks(mp)
        if leaf in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            place(sub, "weight", 1)   # column parallel: [h, out/mp]
        elif leaf in ("o_proj", "down_proj"):
            place(sub, "weight", 0)   # row parallel: [in/mp, h]
        elif leaf == "embed_tokens":
            place(sub, "weight", 1)   # hidden-sharded embedding
        elif leaf == "lm_head":
            place(sub, "weight", 1)   # vocab-parallel logits

    return shard_fn


def llama_tiny(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=176,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       max_seq_len=128, **kw)


def llama_7b(**kw) -> LlamaConfig:
    # Llama-2-7B: 32 layers, 4096 hidden, 11008 ffn, 32 heads, MHA
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_layers=32, num_heads=32,
                       max_seq_len=4096, dtype="bfloat16", **kw)
