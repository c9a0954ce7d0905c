"""Megatron-style layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py).

The port keeps the reference's parameter names, layouts and specs: a
Linear weight is ``[in, out]`` and computes ``x @ w + b``, split on its
output columns (``ColumnParallelLinear``, ``P(None, "mp")``) or its input
rows (``RowParallelLinear``, ``P("mp", None)``); the embedding table is
``[num_embeddings, dim]`` split on its rows (``P("mp", None)``).  Like the
reference's, a layer holds its full weight: the hybrid trainer
(``models/trainer.py``) splits the weights by these specs into the rank
blocks and runs each mp rank's block, with the row-parallel partials
summed over the mp group (``mesh.psum``).  Parameters are created
directly on ``device`` from an explicit ``torch.Generator``, so a
multi-billion-parameter model is never materialised on the host.

The vocab-parallel pieces work on sharded values (per-shard lists over a
1-D ``Mesh``): :func:`sharded_row_take` is the masked local lookup summed
over the row shards, :func:`parallel_cross_entropy` of a list of vocab
shards combines each shard's max and sum of exponentials in f32, so the
full ``[b, s, V]`` softmax is never formed on one rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ...device import resolve_device
from ...nn.functional.input import embedding
from ...nn.layers.common import Linear, check_no_weight_attr
from ..mesh import Mesh, psum
from ..sharding_utils import P, set_param_spec
from ..topology import get_hybrid_communicate_group

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_cross_entropy", "sharded_row_take", "split"]


def _mp_axis(mp_group) -> str:
    """The grid axis a layer splits over: ``mp_group``'s name, else
    ``"mp"`` (mp_layers.py:36)."""
    if mp_group is not None and hasattr(mp_group, "name"):
        return mp_group.name
    return "mp"


class _Linear(Linear):
    """``y = x @ weight + bias`` with ``weight [in, out]`` (the reference's
    ``F.linear`` layout), XavierNormal-initialised; the bias starts at
    zero."""

    def __init__(self, in_features: int, out_features: int, weight_attr,
                 has_bias: bool, mp_group, *, device, dtype, generator):
        check_no_weight_attr(weight_attr)
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         device=resolve_device(device), dtype=dtype,
                         generator=generator)
        self._axis = _mp_axis(mp_group)


class ColumnParallelLinear(_Linear):
    """Linear whose ``[in, out]`` weight (and bias) split on the output
    columns over mp (mp_layers.py:52), with the reference's constructor
    (``weight_attr`` only None: queue 1 item 10).  The layer holds its
    whole weight under the single controller, so ``gather_output`` (the
    reference's output layout: replicated, or mp-sharded to feed a
    ``RowParallelLinear``) and ``fuse_matmul_bias`` change no arithmetic;
    the hybrid trainer splits the weight by the spec."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group=None, name=None, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, device=device, dtype=dtype,
                         generator=generator)
        self.gather_output = gather_output
        set_param_spec(self, "weight", P(None, self._axis))
        if self.bias is not None:
            set_param_spec(self, "bias", P(self._axis))


class RowParallelLinear(_Linear):
    """Linear whose ``[in, out]`` weight splits on the input rows over mp;
    the partial products are summed over the group, then the replicated
    bias is added (mp_layers.py:84), with the reference's constructor.  The
    layer holds its whole weight under the single controller, so
    ``input_is_parallel`` (the input arrives mp-sharded on its features)
    and ``fuse_matmul_bias`` change no arithmetic."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 *, device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         mp_group, device=device, dtype=dtype,
                         generator=generator)
        self.input_is_parallel = input_is_parallel
        set_param_spec(self, "weight", P(self._axis, None))
        if self.bias is not None:
            set_param_spec(self, "bias", P())


class VocabParallelEmbedding(nn.Module):
    """Embedding lookup with ``jnp.take``'s fill semantics
    (mp_layers.py:137): a negative id wraps once (numpy-style), and an id
    that is still out of range yields a NaN row.  Nothing raises, and on
    the card no device-side assert can fire: every gathered index is
    clamped in range before the lookup and the fill is applied after.
    The reference's constructor; the table splits on its rows over mp."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *,
                 device: Union[None, str, torch.device] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_weight_attr(weight_attr)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        w = torch.empty((num_embeddings, embedding_dim),
                        device=resolve_device(device), dtype=dtype)
        w.normal_(0.0, 0.02, generator=generator)
        self.weight = nn.Parameter(w)
        set_param_spec(self, "weight", P(_mp_axis(mp_group), None))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding(ids, self.weight)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


class _TakeRowsF32Grad(torch.autograd.Function):
    """``table[ids]`` whose backward accumulates the rows' gradient in f32
    and casts once (mp_layers.py:141): an embedding row's gradient sums
    many updates."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        gt = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        gt.index_add_(0, ids.reshape(-1),
                      g.reshape(-1, ctx.shape[-1]).float())
        return gt.to(ctx.dtype), None


def _take_rows_f32grad(table: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    return _TakeRowsF32Grad.apply(table, ids.long())


def sharded_row_take(shards: Sequence[torch.Tensor], ids: torch.Tensor,
                     mesh: Mesh) -> List[torch.Tensor]:
    """``table[ids]`` for a table split on its rows into ``shards`` (in
    shard order over ``mesh``), replicated on every shard's device
    (mp_layers.py:171): each shard looks up the ids in its rows (zeros
    elsewhere, its gradient accumulated in f32), and the rows are summed
    over the shards in f32 and cast back to the table's dtype."""
    parts = []
    start = 0
    for tbl, dev in zip(shards, mesh.devices):
        n = tbl.shape[0]
        loc = ids.to(dev).long() - start
        ok = (loc >= 0) & (loc < n)
        rows = _take_rows_f32grad(tbl, loc.clamp(0, n - 1)).float()
        parts.append(rows * ok[..., None])
        start += n
    return [x.to(shards[0].dtype) for x in psum(parts, mesh)]


def parallel_cross_entropy(logits: Union[torch.Tensor,
                                         Sequence[torch.Tensor]],
                           label: torch.Tensor, ignore_index: int = -100,
                           mesh: Optional[Mesh] = None):
    """Per-token softmax cross entropy over the vocab (last) axis
    (mp_layers.py:222-242): a stable logsumexp in f32, the label's logit
    picked, and a loss of 0 where ``label == ignore_index``.

    ``logits`` is one tensor, or its vocab shards in order over ``mesh``
    (the hybrid trainer's vocab-parallel head): each shard's max and sum
    of exponentials are combined over the shards in f32 and the label's
    logit is picked where its shard holds it, so no rank forms the whole
    ``[b, s, V]`` softmax.  The loss then comes replicated on every
    shard's device."""
    if isinstance(logits, torch.Tensor):
        x = logits.float()
        # the max only stabilises the sum: its gradient terms cancel exactly
        m = x.amax(dim=-1, keepdim=True).detach()
        lse = m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))
        lbl = label.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        picked = torch.gather(x, -1, safe[..., None])
        return torch.where(valid, (lse - picked)[..., 0], 0.0)
    if mesh is None or len(logits) != mesh.size:
        raise ValueError("vocab-parallel logits need the mesh of their "
                         "shards (one shard per mesh device)")
    dev0 = mesh.devices[0]
    xs = [t.float() for t in logits]
    m = torch.stack([x.amax(dim=-1).detach().to(dev0) for x in xs]).amax(0)
    ms = mesh.replicate(m)
    sums = psum([torch.exp(x - mi[..., None]).sum(dim=-1)
                 for x, mi in zip(xs, ms)], mesh)
    picks, start = [], 0
    for x, dev in zip(xs, mesh.devices):
        n = x.shape[-1]
        loc = label.to(dev).long() - start
        ok = (loc >= 0) & (loc < n)
        got = torch.gather(x, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        picks.append(torch.where(ok, got, 0.0))
        start += n
    picked = psum(picks, mesh)
    out = []
    for mi, s, pk, dev in zip(ms, sums, picked, mesh.devices):
        valid = label.to(dev) != ignore_index
        out.append(torch.where(valid, mi + torch.log(s) - pk, 0.0))
    return out


class ParallelCrossEntropy(nn.Module):
    """:func:`parallel_cross_entropy` as a layer (mp_layers.py:245)."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label, mesh: Optional[Mesh] = None):
        return parallel_cross_entropy(input, label, self.ignore_index, mesh)


_SPLIT_CACHE: dict = {}


def split(x: torch.Tensor, size, operation: str = "linear", axis: int = 0,
          num_partitions: int = 1, gather_out: bool = True,
          weight_attr=None, bias_attr=None, name=None,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``paddle.distributed.split`` (mp_layers.py:261): build a
    column-parallel (``axis=1``) or row-parallel (``axis=0``) Linear, or a
    vocab-parallel Embedding, on ``x``'s device and dtype at its first call
    (cached under the required ``name``; one name is one layer) and apply
    it.  Like the reference's, the layer holds its full weight, so the
    product is the whole layer's at any mp degree; ``num_partitions`` must
    be 1 or the current group's mp degree."""
    if name is None:
        raise ValueError(
            "distributed.split needs an explicit name= (it caches the "
            "created parallel layer; unnamed call sites with equal shapes "
            "would silently share parameters)")
    hcg = get_hybrid_communicate_group()
    if hcg is not None and num_partitions not in (
            1, hcg.get_model_parallel_world_size()):
        raise ValueError(
            f"num_partitions={num_partitions} does not match the "
            f"initialized mp degree {hcg.get_model_parallel_world_size()}")
    cfg = (operation, tuple(size), axis)
    cached = _SPLIT_CACHE.get(name)
    if cached is not None and cached[1] != cfg:
        raise ValueError(f"distributed.split name {name!r} was first used "
                         f"with config {cached[1]}, now called with {cfg}; "
                         f"one name = one layer")
    if cached is None:
        kw = dict(device=x.device, generator=generator,
                  dtype=x.dtype if x.is_floating_point() else torch.float32)
        if operation == "linear":
            cls = ColumnParallelLinear if axis == 1 else RowParallelLinear
            layer = cls(*size, has_bias=bias_attr is not False, **kw)
        elif operation == "embedding":
            layer = VocabParallelEmbedding(*size, **kw)
        else:
            raise ValueError(f"unknown split operation {operation!r}")
        cached = _SPLIT_CACHE[name] = (layer, cfg)
    return cached[0](x)
