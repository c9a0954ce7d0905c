"""GPT-MoE, the expert-parallel decoder LM (counterpart of
paddle_tpu/models/gpt_moe.py; BASELINE config #5).

Pre-LN GPT blocks whose every ``moe_every``-th FFN is a
``distributed.moe.MoELayer``; the tied head is the second use of ``wte``.
Parameter names and layouts are the reference's (``h.{i}.qkv.weight``,
``h.{i}.ffn.gate.gate_weight``, ``h.{i}.ffn.experts.stacked__w0``, ...),
so its state loads key for key (``models/convert.py``).  Attention goes
through ``nn.functional.scaled_dot_product_attention`` (the flash
kernels), every LayerNorm through the fused-norm kernels; the experts run
as batched products over experts.  ``loss`` is the token cross entropy
plus ``aux_weight`` times the gates' load-balance losses of the same
forward.  Unlike the dense GPT, the block's projections and tables carry
no mp specs: the hybrid trainer keeps attention whole over mp and splits
only the experts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..distributed.moe import ExpertFFN, MoELayer, draws_noise, gate_layers
from ..distributed.meta_parallel.mp_layers import parallel_cross_entropy
from ..distributed.recompute import _dropout_generators, remat_wrap
from ..nn.functional import gelu, scaled_dot_product_attention
from ..nn.layers import Dropout, LayerList, LayerNorm
from ..nn.layers.common import Embedding, Linear

__all__ = ["GPTMoEConfig", "GPTMoEForCausalLM", "gpt_moe_tiny",
           "attention"]


@dataclasses.dataclass
class GPTMoEConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ffn_mult: int = 4
    num_experts: int = 8
    top_k: int = 2
    moe_every: int = 2            # every k-th block uses the MoE FFN
    gate: str = "gshard"          # naive | gshard | switch
    gate_kwargs: Optional[dict] = None   # extra gate arguments
    # recompute per block in the training forward: False | True | a policy
    # name (distributed/recompute.py)
    remat: Union[bool, str] = False
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    # the expert axis (a ParallelAxis or an axis name)
    moe_group: Optional[object] = None
    # expert-internal tensor parallelism: True -> "mp", or a group / name
    mp_group: Optional[object] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.hidden_size * self.ffn_mult


def attention(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
              wo: torch.Tensor, bo: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """The block's attention half on normed ``x [b, s, h]``: the fused
    QKV projection, causal attention through the flash path, the output
    projection (gpt_moe.py:95-102)."""
    b, s, h = x.shape
    qkv = (torch.matmul(x, wqkv) + bqkv).view(b, s, 3, num_heads,
                                               h // num_heads)
    out = scaled_dot_product_attention(qkv[:, :, 0], qkv[:, :, 1],
                                       qkv[:, :, 2], is_causal=True)
    return torch.matmul(out.reshape(b, s, h), wo) + bo


class _MoEBlock(nn.Module):
    def __init__(self, cfg: GPTMoEConfig, use_moe: bool, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.use_moe = use_moe
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.qkv = Linear(h, 3 * h, generator=generator, **kw)
        self.out_proj = Linear(h, h, generator=generator, **kw)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        if use_moe:
            experts = [ExpertFFN(h, cfg.ffn_size, generator=generator, **kw)
                       for _ in range(cfg.num_experts)]
            gate = ({"type": cfg.gate, "topk": cfg.top_k}
                    if cfg.gate != "switch" else {"type": "switch"})
            gate.update(cfg.gate_kwargs or {})
            self.ffn = MoELayer(h, experts, gate=gate,
                                moe_group=cfg.moe_group,
                                mp_group=cfg.mp_group,
                                capacity_factor=cfg.capacity_factor,
                                generator=generator)
        else:
            self.fc_in = Linear(h, cfg.ffn_size, generator=generator, **kw)
            self.fc_out = Linear(cfg.ffn_size, h, generator=generator, **kw)
        self.drop = Dropout(cfg.dropout, generator=generator)

    def _attn(self, x: torch.Tensor) -> torch.Tensor:
        return attention(x, self.qkv.weight, self.qkv.bias,
                         self.out_proj.weight, self.out_proj.bias,
                         self.cfg.num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop(self._attn(self.ln_1(x)))
        h = self.ln_2(x)
        if self.use_moe:
            m = self.ffn(h)
        else:
            m = self.fc_out(gelu(self.fc_in(h), approximate=True))
        return x + self.drop(m)


def replay_generators(module: nn.Module) -> list:
    """The generators a recomputed ``module`` must replay: its dropout's
    and its gates' where they draw."""
    gens = _dropout_generators(module)
    for g in gate_layers(module):
        if draws_noise(g) and g.training and g.generator is not None \
                and all(g.generator is not x for x in gens):
            gens.append(g.generator)
    return gens


class GPTMoEForCausalLM(nn.Module):
    """GPT-MoE with the tied head, built on ``device`` (default: the
    current CUDA device; with none it raises and asks for
    ``device="cpu"``) in ``dtype`` (default ``cfg.dtype``), its weights and
    its gates' routing noise drawn from ``generator`` (default: one on
    ``device`` seeded with 0).  The tables are N(0, 0.02) (the reference's
    GPT-2 init, gpt_moe.py:118-129)."""

    def __init__(self, cfg: GPTMoEConfig,
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
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, std=0.02, **kw)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size, std=0.02,
                             **kw)
        self.h = LayerList([
            _MoEBlock(cfg, i % cfg.moe_every == cfg.moe_every - 1, **kw)
            for i in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              device=device, dtype=dtype)
        self.drop = Dropout(cfg.dropout, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        remat = self.cfg.remat if torch.is_grad_enabled() else False
        for blk in self.h:
            x = remat_wrap(blk, remat, replay_generators(blk))(x) \
                if remat else blk(x)
        x = self.ln_f(x)
        return torch.matmul(x, self.wte.weight.t())

    def loss(self, input_ids: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """The mean token cross entropy plus ``aux_weight`` times the
        gates' aux losses of this same forward (gpt_moe.py:145)."""
        logits = self(input_ids)
        lm = parallel_cross_entropy(logits, labels).mean()
        return lm + self.cfg.aux_weight * self.gate_aux_loss()

    def gate_aux_loss(self) -> torch.Tensor:
        """Sum of the gates' aux buffers from the most recent forward."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for g in gate_layers(self):
            total = total + g.aux_loss
        return total

    def moe_layers(self) -> Dict[int, MoELayer]:
        return {i: blk.ffn for i, blk in enumerate(self.h) if blk.use_moe}

    @staticmethod
    def loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                         buffers: Dict[str, torch.Tensor],
                         aux_weight: float) -> torch.Tensor:
        """The loss from ``(logits, buffers)`` (the buffers by name, e.g.
        ``dict(model.named_buffers())`` after the forward)."""
        aux = sum(v for k, v in buffers.items() if k.endswith("aux_loss"))
        return parallel_cross_entropy(logits, labels).mean() + \
            aux_weight * aux


def gpt_moe_tiny(**kw) -> GPTMoEConfig:
    return GPTMoEConfig(vocab_size=256, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=128, num_experts=4, **kw)

