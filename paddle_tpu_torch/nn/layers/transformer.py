"""Transformer layers (counterpart of paddle_tpu/nn/layers/transformer.py,
BASELINE config #2): ``MultiHeadAttention`` with ``Cache`` /
``StaticCache`` incremental decoding, ``TransformerEncoderLayer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder`` and ``Transformer``.

Parameter names and the ``[in, out]`` Linear layout are the reference's,
so weights carry across key for key (``models.convert.
layer_state_from_jax``).  Attention goes through
``F.scaled_dot_product_attention``, which picks its route by its
arguments: a mask or dropout in training takes the dense form, anything
else the flash kernels.  LayerNorms are the port's ``LayerNorm`` (the
fused-norm kernels on the card).

Each layer takes, besides the reference's parameters, keyword-only
``device`` (default: the card), ``dtype`` and ``generator``: weights are
drawn from the generator and every dropout (attention dropout included)
draws its mask from it; a stack of ``num_layers`` draws each layer after
the last from that one generator, the fresh draw per depth of the
reference's ``_clone_layer``.  With no generator the weights come from
torch's global generator, as ``Linear``'s do, and a dropout with p > 0
raises in training, as ``Dropout`` does.
"""

from __future__ import annotations

import collections
from typing import Optional, Union

import torch
from torch import nn

from ...device import resolve_device, resolve_dtype
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

Device = Union[None, str, torch.device]
DType = Union[None, str, torch.dtype]


def _placement(device: Device, dtype: DType,
               generator: Optional[torch.Generator]) -> dict:
    """The resolved ``device`` / ``dtype`` and the ``generator`` (None
    stays None) a layer builds with and hands to its sublayers and
    clones."""
    return dict(device=resolve_device(device),
                dtype=resolve_dtype(dtype, "float32"), generator=generator)


def _convert_attention_mask(attn_mask: Optional[torch.Tensor]
                            ) -> Optional[torch.Tensor]:
    """A bool mask (True keeps) as an additive f32 mask (0 or the f32
    minimum); a numeric mask as f32 (transformer.py:29-36)."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, 0.0,
                           torch.finfo(torch.float32).min).float()
    return attn_mask.float()


class MultiHeadAttention(nn.Module):
    """Inputs ``[batch, seq, embed_dim]``; the heads are split to the
    ``[B, S, H, D]`` layout of the attention core.  ``forward(query, key,
    value, attn_mask, cache)`` returns the output, and with a ``cache``
    also the new one: a ``Cache`` (self-attention) grows by the step's
    keys and values along the sequence, a ``StaticCache`` (cross
    attention) holds the memory's projected keys and values."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, *, device: Device = None,
                 dtype: DType = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _placement(device, dtype, generator)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} must be divisible by "
                             f"num_heads {num_heads}")
        self.generator = kw["generator"]
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key: torch.Tensor, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value`` projected (``type`` is
        ``StaticCache``, or a ``value`` is given), else an empty ``Cache``
        for ``key``'s batch."""
        if type is self.StaticCache or (value is not None and type is None):
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        k = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(k, torch.zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
            new_cache = cache
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                new_cache = self.Cache(k, v)
            else:
                new_cache = None
        mask = _convert_attention_mask(attn_mask)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]            # [B, 1, Sq, Sk] over the heads
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout,
            training=self.training, generator=self.generator)
        b, s = out.shape[:2]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, new_cache
        return out


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm after it (before it with ``normalize_before``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device: Device = None, dtype: DType = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _placement(device, dtype, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr,
                            layer_norm_eps=layer_norm_eps, **kw)
        gen = kw["generator"]
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=gen)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **norm_kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **norm_kw)
        self.dropout1 = Dropout(dropout, generator=gen)
        self.dropout2 = Dropout(dropout, generator=gen)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clone_layer(layer: nn.Module) -> nn.Module:
    """A fresh layer of ``layer``'s configuration, drawn after it from the
    same generator (transformer.py:161-170: no copy of the weights)."""
    return type(layer)(**layer._config)


class TransformerEncoder(nn.Module):
    """``num_layers`` encoder layers (the given one, then fresh ones of
    its configuration) and an optional final norm."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            _clone_layer(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_c = mod(output, src_mask, cache[i])
                new_caches.append(new_c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over the memory and a feed-forward
    block, each with a residual and a LayerNorm.  Its cache is the pair
    ``(incremental Cache, StaticCache)``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device: Device = None, dtype: DType = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _placement(device, dtype, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr,
                            layer_norm_eps=layer_norm_eps, **kw)
        gen = kw["generator"]
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout, generator=gen)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **norm_kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **norm_kw)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **norm_kw)
        self.dropout1 = Dropout(dropout, generator=gen)
        self.dropout2 = Dropout(dropout, generator=gen)
        self.dropout3 = Dropout(dropout, generator=gen)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache, static_cache = None, None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """``num_layers`` decoder layers (the given one, then fresh ones of
    its configuration) and an optional final norm."""

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            _clone_layer(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_c = mod(output, memory, tgt_mask, memory_mask,
                                    cache[i])
                new_caches.append(new_c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip: bool = False):
        """Each layer's ``(Cache, StaticCache)``; with ``do_zip`` the
        incremental caches and the static ones as two tuples."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """The full encoder-decoder (parity: ``paddle.nn.Transformer``);
    ``custom_encoder`` / ``custom_decoder`` replace the built stacks.
    With ``normalize_before`` each stack ends with a LayerNorm."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, custom_encoder: Optional[nn.Module] = None,
                 custom_decoder: Optional[nn.Module] = None, *,
                 device: Device = None, dtype: DType = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        kw = _placement(device, dtype, generator)
        norm_kw = dict(device=kw["device"], dtype=kw["dtype"])
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            enc_norm = LayerNorm(d_model, **norm_kw) if normalize_before \
                else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            dec_norm = LayerNorm(d_model, **norm_kw) if normalize_before \
                else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int, *,
                                        device: Device = None
                                        ) -> torch.Tensor:
        """The additive causal mask ``[length, length]`` in f32: 0 where
        ``j <= i``, the f32 minimum above the diagonal
        (transformer.py:340-344); on ``device`` (default: the card)."""
        device = resolve_device(device)
        i = torch.arange(length, device=device)[:, None]
        j = torch.arange(length, device=device)[None, :]
        return torch.where(j <= i, 0.0,
                           torch.finfo(torch.float32).min).float()
