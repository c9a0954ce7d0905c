"""GPT decoder LM (counterpart of paddle_tpu/models/gpt.py).

The serving surface of the reference model: learned positions, pre-LN
blocks with a fused ``[h, 3h]`` QKV projection and a GELU (tanh) MLP,
tied output head, and the functional KV-cache decode step the serving
engine drives.  Parameter names and layouts are the reference's, so a
JAX ``state_dict`` loads key for key (``models/convert.py``).

The cached decode/prefill path's attention goes through
``kernels.decode_attention_auto``; the uncached (training) forward goes
through ``nn.functional.scaled_dot_product_attention``, the flash kernels'
``autograd.Function``, so gradients reach every projection.  Each is the
CUDA kernel on the card and its plain PyTorch version on the CPU.
``GPTForCausalLM.loss`` is the mean of ``parallel_cross_entropy``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..distributed.recompute import remat_wrap
from ..distributed.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    parallel_cross_entropy)
from ..kernels.decode_attention import decode_attention_auto
from ..kernels.decode_block import decode_block_layer, fusion_legal
from ..nn.functional import gelu, scaled_dot_product_attention
from ..nn.layers import Dropout, LayerList, LayerNorm
from .kv_cache import append_kv, cache_lens

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM",
           "check_weights_held", "gpt_tiny", "gpt_small", "gpt3_6_7b"]

Cache = Tuple[torch.Tensor, torch.Tensor, Union[int, torch.Tensor]]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "float32"
    use_bias: bool = True
    # parallel / runtime knobs (gpt.py:61-67)
    sp: bool = False          # sequence-parallel activations between blocks
    # recompute per block in the training forward: False | True (full) |
    # a policy name (distributed/recompute.py)
    remat: Union[bool, str] = True
    cp: Optional[str] = None  # context parallelism: not ported

    def __post_init__(self):
        if self.cp is not None:
            raise NotImplementedError(
                f"cp={self.cp!r}: context parallelism is not ported yet "
                f"(ROADMAP queue 1 item 9); set cp=None")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.hidden_size * self.ffn_mult

    def num_params(self) -> int:
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        per_block = 4 * h * h + 2 * h * self.ffn_size + \
            (9 * h + 2 * self.ffn_size if self.use_bias else 4 * h)
        emb = v * h + self.max_seq_len * h
        head = 0 if self.tie_embeddings else v * h
        return emb + l * per_block + 2 * h + head


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, cfg: GPTConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                        has_bias=cfg.use_bias,
                                        generator=generator, **kw)
        self.out_proj = RowParallelLinear(h, h, input_is_parallel=True,
                                          has_bias=cfg.use_bias,
                                          generator=generator, **kw)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.fc_in = ColumnParallelLinear(h, cfg.ffn_size,
                                          gather_output=False,
                                          has_bias=cfg.use_bias,
                                          generator=generator, **kw)
        self.fc_out = RowParallelLinear(cfg.ffn_size, h,
                                        input_is_parallel=True,
                                        has_bias=cfg.use_bias,
                                        generator=generator, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def _attn(self, x: torch.Tensor, cache: Optional[Cache] = None):
        cfg = self.cfg
        b, s, h = x.shape
        if self.training and cfg.attn_dropout:
            raise NotImplementedError(
                "attention dropout is not supported by the port's attention "
                "kernels; set attn_dropout=0 or call .eval()")
        qkv = self.qkv(x).view(b, s, 3, cfg.num_heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            out = scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.out_proj(out.reshape(b, s, h)), None
        pk, pv, pos = cache
        # pos: int (dense batch) or [b] per-row offsets (continuous
        # batching); seq_lens = pos + s with the causal tail gives query t
        # of the chunk the keys up to pos + t
        k, v = append_kv(pk, pv, k, v, pos)
        out = decode_attention_auto(q, k, v,
                                    cache_lens(pos, s, b, device=x.device))
        return self.out_proj(out.reshape(b, s, h)), (k, v, pos + s)

    def partial(self, x: torch.Tensor, half: str) -> torch.Tensor:
        """One mp rank's share of half the block, before the row-parallel
        sum (the hybrid trainer's Megatron body), on ``x`` already through
        the half's LayerNorm: ``"attn"`` is QKV -> causal attention over
        the block's heads -> ``@ out_proj.weight``; ``"mlp"`` is fc_in ->
        GELU (tanh) -> ``@ fc_out.weight``.  With an mp shard's weights
        (QKV columns ``[q_d | k_d | v_d]`` of its head group) the heads and
        ffn columns are the shard's; the caller sums the partials over the
        group, then adds the bias and the residual."""
        if half == "mlp":
            return torch.matmul(gelu(self.fc_in(x), approximate=True),
                                self.fc_out.weight)
        b, s, _ = x.shape
        qkv = self.qkv(x).view(b, s, 3, -1, self.cfg.head_dim)
        out = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                           qkv[:, :, 2], is_causal=True)
        return torch.matmul(out.reshape(b, s, -1), self.out_proj.weight)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None):
        a, new_cache = self._attn(self.ln_1(x), cache)
        x = x + self.drop(a)
        m = self.fc_out(gelu(self.fc_in(self.ln_2(x)), approximate=True))
        x = x + self.drop(m)
        if cache is not None:
            return x, new_cache
        return x

    def decode_block_weights(self) -> dict:
        """This block as ``decode_block_layer``'s keywords: the fused
        ``[h, 3h]`` QKV weight split into q | k | v column views (and its
        bias likewise), LayerNorm, gelu_tanh, multi-head attention."""
        cfg = self.cfg
        h = cfg.hidden_size
        wqkv = self.qkv.weight                  # [h, 3h]: q | k | v columns
        bqkv = self.qkv.bias
        bq, bk, bv = ((bqkv[:h], bqkv[h:2 * h], bqkv[2 * h:])
                      if bqkv is not None else (None, None, None))
        return dict(
            kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
            norm="layer", eps1=cfg.layer_norm_eps, eps2=cfg.layer_norm_eps,
            norm1_w=self.ln_1.weight, norm1_b=self.ln_1.bias,
            wq=wqkv[:, :h], wk=wqkv[:, h:2 * h], wv=wqkv[:, 2 * h:],
            bq=bq, bkv=bk, bv=bv,
            wo=self.out_proj.weight, bo=self.out_proj.bias,
            norm2_w=self.ln_2.weight, norm2_b=self.ln_2.bias,
            w1=self.fc_in.weight, b1=self.fc_in.bias,
            w2=self.fc_out.weight, b2=self.fc_out.bias,
            act="gelu_tanh")

    def fused_decode_step(self, x: torch.Tensor, cache: Cache):
        """One decode token through the fused decode-block kernel pair
        (kernels/decode_block.py): norm -> QKV -> KV append -> streaming
        attention -> out-proj -> MLP.  ``cache`` is ``(k, v, pos)`` with an
        int or per-row ``pos``; the slabs are updated in place.  Same
        contract as ``forward(x, cache)`` at sq=1; callers gate on
        ``fused_decode_supported``."""
        pk, pv, pos = cache
        y, k2, v2 = decode_block_layer(x, pk, pv, pos,
                                       **self.decode_block_weights())
        return y, (k2, v2, pos + 1)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          generator=generator, **kw)
        self.wpe = VocabParallelEmbedding(cfg.max_seq_len, cfg.hidden_size,
                                          generator=generator, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)
        self.h = LayerList([GPTBlock(cfg, generator=generator, **kw)
                            for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              **kw)

    def embed(self, input_ids: torch.Tensor,
              position_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """Token + position embeddings; ``position_offset`` is an int or a
        ``[b]`` tensor of per-row offsets (ragged continuous batching).
        Positions past the table give NaN rows, as in JAX."""
        b, s = input_ids.shape
        ar = torch.arange(s, device=input_ids.device)
        if isinstance(position_offset, torch.Tensor) \
                and position_offset.dim() >= 1:
            pos = position_offset.to(input_ids.device).long()[:, None] + ar
        else:
            pos = (ar + int(position_offset))[None, :]
        return self.drop(self.wte(input_ids) + self.wpe(pos))

    def forward(self, input_ids: torch.Tensor,
                caches: Optional[List[Cache]] = None):
        x = self.embed(input_ids)
        new_caches = []
        # cfg.remat per block in the training forward; a no-grad or cached
        # forward never recomputes (gpt.py:211-220)
        remat = self.cfg.remat if torch.is_grad_enabled() else False
        for i, block in enumerate(self.h):
            if caches is None:
                x = remat_wrap(block, remat)(x)
            else:
                x, c = block(x, caches[i])
                new_caches.append(c)
        x = self.ln_f(x)
        return x if caches is None else (x, new_caches)


def check_weights_held(model, what: str) -> None:
    """Raise, naming the cause, when ``serving.tp.shard_model_params`` has
    taken ``model``'s weights: they live in ``model.tp_weights`` over its
    mesh then, the model's own parameters are empty, and the model serves
    only through a tensor-parallel engine on that mesh."""
    held = getattr(model, "tp_weights", None)
    if held is not None:
        mesh = held["mesh"]
        raise RuntimeError(
            f"{what}: this model's weights were handed to a tensor-parallel "
            f"engine (shard_model_params moved them into model.tp_weights "
            f"over {mesh} and released the model's own parameters); it "
            f"serves only through ServingEngine(tensor_parallel="
            f"{mesh.size}) on that mesh now — build a fresh model for "
            f"anything else")


class GPTForCausalLM(nn.Module):
    """GPT with a tied (or separate) LM head.

    Built on ``device`` (default: the current CUDA device; with no CUDA
    device it raises and asks for ``device="cpu"``), in ``dtype``
    (default: ``cfg.dtype``), with weights drawn from ``generator``
    (default: a generator on ``device`` seeded with 0).  Parameters are
    created on ``device`` directly."""

    def __init__(self, cfg: GPTConfig,
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
        self.gpt = GPTModel(cfg, device=device, dtype=dtype,
                            generator=generator)
        if not cfg.tie_embeddings:
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False,
                device=device, dtype=dtype, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(hidden, self.gpt.wte.weight.t())
        return self.lm_head(hidden)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        check_weights_held(self, "GPTForCausalLM.forward")
        return self.logits(self.gpt(input_ids))

    def loss(self, input_ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Causal LM loss, the mean over tokens of
        ``parallel_cross_entropy`` (gpt.py:249-253)."""
        return parallel_cross_entropy(self(input_ids), labels).mean()

    # ---- decode (cached path) ------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: Union[None, str, torch.dtype] = None
                   ) -> List[Cache]:
        cfg = self.cfg
        dt = resolve_dtype(dtype) if dtype is not None else self.dtype
        shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device), 0)
                for _ in range(cfg.num_layers)]

    @torch.no_grad()
    def decode_step(self, input_ids: torch.Tensor, caches: List[Cache],
                    position: Union[int, torch.Tensor]):
        """One incremental chunk: appends its K/V into ``caches`` in place
        and returns ``(logits [b, s, vocab], new_caches)``."""
        check_weights_held(self, "GPTForCausalLM.decode_step")
        x = self.gpt.embed(input_ids, position)
        new_caches = []
        for block, cache in zip(self.gpt.h, caches):
            x, c = block(x, cache)
            new_caches.append(c)
        x = self.gpt.ln_f(x)
        return self.logits(x), new_caches

    def fused_decode_supported(self, batch: int = 1,
                               kv_len: Optional[int] = None,
                               tp: int = 1):
        """Static legality of the fused decode-block path for this model
        at ``(batch, kv_len)``.  Returns ``(ok, reason)``."""
        cfg = self.cfg
        if cfg.dropout and self.training:
            return False, "dropout active (training mode)"
        return fusion_legal(
            max_seq=kv_len or cfg.max_seq_len, hidden=cfg.hidden_size,
            heads=cfg.num_heads, kv_heads=cfg.num_heads,
            head_dim=cfg.head_dim, ffn=cfg.ffn_size, batch=batch,
            dtype=self.dtype, tp=tp)

    @torch.no_grad()
    def fused_decode_step(self, input_ids: torch.Tensor, caches: List[Cache],
                          position: Union[int, torch.Tensor]):
        """``decode_step`` for one token per row through the fused
        decode-block kernels: the embedding, final norm and logits are
        shared with ``decode_step``; each layer body is the kernel pair
        with the KV slabs updated in place.  ``position`` is an int or a
        per-row ``[b]`` tensor."""
        check_weights_held(self, "GPTForCausalLM.fused_decode_step")
        x = self.gpt.embed(input_ids, position)
        new_caches = []
        for block, cache in zip(self.gpt.h, caches):
            x, c = block.fused_decode_step(x, cache)
            new_caches.append(c)
        x = self.gpt.ln_f(x)
        return self.logits(x), new_caches

    def generate(self, input_ids, max_new_tokens: int, **kw):
        """Autoregressive decoding (models/generation.py)."""
        from .generation import generate
        return generate(self, input_ids, max_new_tokens, **kw)

    # ---- tensor-parallel serving (serving/tp.py) ----------------------
    def tp_decode_supported(self, tp: int):
        """Static legality of the tensor-parallel decode program at degree
        ``tp``: every partitioned dimension must tile the mesh evenly.
        Returns ``(ok, reason)``."""
        cfg = self.cfg
        for what, n in (("num_heads", cfg.num_heads),
                        ("ffn_size", cfg.ffn_size),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                return False, (f"{what} {n} not divisible by "
                               f"tensor_parallel {tp}")
        return True, None

    @torch.no_grad()
    def tp_decode_weights(self, tp: int):
        """``(arch, weights)`` for the tensor-parallel decode program
        (serving/tp.py), in the reference's global layout.  The fused QKV
        weight is re-arranged so that shard ``d``'s contiguous column
        block is ``[q_d | k_d | v_d]`` for its own head group (a new
        tensor); every other leaf is the model's own parameter."""
        check_weights_held(self, "GPTForCausalLM.tp_decode_weights")
        cfg = self.cfg
        h, dh = cfg.hidden_size, cfg.head_dim
        arch = {"norm": "layer", "eps": cfg.layer_norm_eps,
                "act": "gelu_tanh", "rope": False, "rope_theta": None,
                "heads": cfg.num_heads, "kv_heads": cfg.num_heads,
                "head_dim": dh, "hidden": h, "vocab": cfg.vocab_size}
        step = (cfg.num_heads // tp) * dh

        def own(p):
            return None if p is None else p.detach()
        blocks = []
        for blk in self.gpt.h:
            w, bias = blk.qkv.weight.detach(), own(blk.qkv.bias)
            parts, bparts = [], []
            for d in range(tp):
                sl = slice(d * step, (d + 1) * step)
                parts += [w[:, :h][:, sl], w[:, h:2 * h][:, sl],
                          w[:, 2 * h:][:, sl]]
                if bias is not None:
                    bparts += [bias[:h][sl], bias[h:2 * h][sl],
                               bias[2 * h:][sl]]
            blocks.append({
                "n1w": own(blk.ln_1.weight), "n1b": own(blk.ln_1.bias),
                "wqkv": torch.cat(parts, dim=1),
                "bqkv": torch.cat(bparts) if bias is not None else None,
                "wo": own(blk.out_proj.weight), "bo": own(blk.out_proj.bias),
                "n2w": own(blk.ln_2.weight), "n2b": own(blk.ln_2.bias),
                "wup": own(blk.fc_in.weight), "bup": own(blk.fc_in.bias),
                "wdown": own(blk.fc_out.weight),
                "bdown": own(blk.fc_out.bias)})
        return arch, {
            "wte": own(self.gpt.wte.weight), "wpe": own(self.gpt.wpe.weight),
            "head": None if cfg.tie_embeddings else own(self.lm_head.weight),
            "nfw": own(self.gpt.ln_f.weight), "nfb": own(self.gpt.ln_f.bias),
            "blocks": blocks}


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=128, **kw)


def gpt_small(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=1024, **kw)


def gpt3_6_7b(**kw) -> GPTConfig:
    # GPT-3 6.7B: 32 layers, 4096 hidden, 32 heads, 2048 seq
    return GPTConfig(vocab_size=50304, hidden_size=4096, num_layers=32,
                     num_heads=32, max_seq_len=2048, dtype="bfloat16", **kw)
