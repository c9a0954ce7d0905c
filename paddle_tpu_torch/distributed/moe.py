"""Mixture-of-experts and expert parallelism (counterpart of
paddle_tpu/distributed/moe.py).

* The routing utils (``number_count``, ``assign_pos``,
  ``limit_by_capacity``, ``prune_gate_by_capacity``,
  ``default_capacity``) with the reference's semantics.
  ``global_scatter`` / ``global_gather`` raise as the reference's do: the
  layer's dispatch and combine take their place.
* The gates: ``NaiveGate`` (top-k of a softmax over f32 logits),
  ``GShardGate`` (top-2, the load-balance aux loss, random routing) and
  ``SwitchGate`` (top-1, jitter, the aux loss).  A gate's ``forward`` is
  ``select(logits(x))``: ``logits`` is the per-token product the batch
  shards compute, ``select`` the softmax, the top-k and the aux loss over
  every token of the batch.  The reference draws its routing noise from a
  global key; the port draws the same laws from the ``torch.Generator``
  the gate was given (``noise=`` supplies the draw instead).
* ``ExpertFFN`` (w0 -> exact GELU -> w1), ``ExpertStack`` (the experts'
  weights stacked ``[E, ...]``, run as one batched product over experts)
  and ``MoELayer``.

``MoELayer`` keeps the reference's arithmetic: the capacity from
``default_capacity`` (the training or the eval factor), each (token,
slot)'s position within its expert in arrival order (row-major over
tokens, then the k slots), ``keep`` as the reference defines it, the kept
gate weights renormalised per token, and the ``expert_util`` /
``token_keep_rate`` readings.  Where the reference contracts ``[S, E, C]``
one-hot tensors, the port gathers by index: dispatch gathers each filled
slot's token into ``[E, C, M]`` (exact), and combine gathers each kept
(token, slot)'s expert output and sums its k weighted products in f32
(the same products as the reference's contraction, in another order).
The backward of each scatters by the same indices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers.common import xavier_normal
from .sharding_utils import P, get_param_specs, set_param_spec
from .topology import get_hybrid_communicate_group

__all__ = [
    "BaseGate", "NaiveGate", "GShardGate", "SwitchGate", "MoELayer",
    "ExpertFFN", "ExpertStack", "number_count", "limit_by_capacity",
    "prune_gate_by_capacity", "assign_pos", "global_scatter",
    "global_gather", "default_capacity", "moe_route", "dispatch", "combine",
    "experts_partial", "gate_logits"]

# the profiler ranges around the layer's forward pieces
GATE_RANGE = "moe.gate"
DISPATCH_RANGE = "moe.dispatch"
EXPERTS_RANGE = "moe.experts"
COMBINE_RANGE = "moe.combine"


# --------------------------------------------------------------------------
# Routing utils
# --------------------------------------------------------------------------

def _long(x) -> torch.Tensor:
    return torch.as_tensor(x).long()


def number_count(gate_idx, upper_range: int) -> torch.Tensor:
    """Per-expert token counts, a histogram of ``gate_idx`` over ``[0,
    upper_range)``; a pruned token (``-1``) is not counted (moe.py:51)."""
    idx = _long(gate_idx).reshape(-1)
    hit = idx[:, None] == torch.arange(upper_range, device=idx.device)
    return hit.sum(0)


def assign_pos(gate_idx, upper_range: int) -> torch.Tensor:
    """Token indices sorted by expert id, stable within an expert: the
    permutation that lays tokens out expert by expert (moe.py:62)."""
    return torch.argsort(_long(gate_idx).reshape(-1), stable=True)


def limit_by_capacity(expert_count, capacity, n_worker: int = 1
                      ) -> torch.Tensor:
    """Per-(worker, expert) counts (flat ``[n_worker * E]`` or ``[n_worker,
    E]``) limited by the per-expert ``capacity``, consumed worker by worker
    (moe.py:71)."""
    ec_in = _long(expert_count)
    cap = _long(capacity).to(ec_in.device)
    ec = ec_in.reshape(n_worker, -1)
    if cap.dim() == 0:
        cap = cap.expand(ec.shape[1])
    before = ec.cumsum(0) - ec
    out = torch.minimum(ec, (cap[None, :] - before).clamp(min=0))
    return out.reshape(-1) if ec_in.dim() == 1 else out


def prune_gate_by_capacity(gate_idx, expert_count, n_expert: int,
                           n_worker: int = 1) -> torch.Tensor:
    """``gate_idx`` with ``-1`` where a token overflows its expert's
    admitted count ``expert_count`` (length ``n_expert * n_worker``), in
    arrival order (moe.py:89)."""
    idx = _long(gate_idx).reshape(-1)
    cap = _long(expert_count).reshape(-1).to(idx.device)
    hit = (idx[:, None] == torch.arange(n_expert * n_worker,
                                        device=idx.device)).long()
    pos = (hit.cumsum(0) * hit).sum(-1) - 1
    # an index of -1 reads the last count, as the reference's take does
    keep = pos < cap[idx]
    return torch.where(keep, idx, -1)


def default_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """GShard capacity ``ceil(top_k * tokens / experts * factor)``, at
    least 4 and rounded up to a multiple of 4 (moe.py:107)."""
    cap = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(4, ((cap + 3) // 4) * 4)


def global_scatter(x, local_count, global_count, group=None):
    """The NCCL ``global_scatter`` op: MoELayer's dispatch takes its place
    (moe.py:119)."""
    raise NotImplementedError(
        "global_scatter is subsumed by MoELayer's capacity-padded dispatch; "
        "use MoELayer for the expert all-to-all")


def global_gather(x, local_count, global_count, group=None):
    """See :func:`global_scatter`."""
    raise NotImplementedError(
        "global_gather is subsumed by MoELayer's capacity-padded combine; "
        "use MoELayer for the expert all-to-all")


# --------------------------------------------------------------------------
# Gates
# --------------------------------------------------------------------------

def gate_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The router's logits, ``x @ weight`` in f32 (moe.py:191)."""
    return torch.matmul(x.float(), weight.float())


def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort)."""
    val, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                       num_expert: int) -> torch.Tensor:
    """``E * sum_e mean_prob_e * frac_tokens_e`` over the top-1
    assignment (moe.py:203)."""
    me = probs.mean(0)
    top1 = gate_idx[..., 0] if gate_idx.dim() > 1 else gate_idx
    hit = top1[:, None] == torch.arange(num_expert, device=top1.device)
    ce = hit.to(probs.dtype).mean(0)
    return (me * ce).sum() * num_expert


class BaseGate(nn.Module):
    """Gate base: the aux load-balance loss of the last forward in the
    non-persistent buffer ``aux_loss`` (moe.py:141)."""

    def __init__(self, d_model: int, num_expert: int, *,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.generator = generator
        self.register_buffer("aux_loss", torch.zeros(
            (), dtype=torch.float32, device=resolve_device(device)),
            persistent=False)

    def set_loss(self, loss: torch.Tensor) -> None:
        self.aux_loss = loss

    def get_loss(self, clear: bool = True) -> torch.Tensor:
        loss = self.aux_loss
        if clear:
            self.aux_loss = torch.zeros((), dtype=torch.float32,
                                        device=loss.device)
        return loss

    def _draw(self, shape, device) -> torch.Tensor:
        if self.generator is None:
            raise ValueError(
                f"{type(self).__name__} draws routing noise in training: "
                f"give it a torch.Generator (generator=...) or pass noise=")
        return torch.rand(shape, generator=self.generator, device=device,
                          dtype=torch.float32)


class NaiveGate(BaseGate):
    """Learned top-k softmax gate: ``(gate_probs [S, k], gate_idx [S, k])``
    (moe.py:181).  ``gate_weight [d_model, E]`` is XavierUniform."""

    def __init__(self, d_model: int, num_expert: int, topk: int = 2, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, device=device,
                         generator=generator)
        self.top_k = topk
        w = torch.empty((d_model, num_expert), dtype=dtype,
                        device=resolve_device(device))
        a = math.sqrt(6.0 / (d_model + num_expert))
        w.uniform_(-a, a, generator=generator)
        self.gate_weight = nn.Parameter(w)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return gate_logits(x, self.gate_weight)

    def select(self, logits: torch.Tensor, noise=None):
        """Top-k of the softmax of ``logits`` over every token."""
        val, idx = _topk(torch.softmax(logits, dim=-1), self.top_k)
        self.set_loss(torch.zeros((), dtype=torch.float32,
                                  device=logits.device))
        return val, idx

    def forward(self, x: torch.Tensor, noise=None):
        return self.select(self.logits(x), noise)


class GShardGate(NaiveGate):
    """Top-2 gate with the load-balance aux loss; in training with
    ``random_routing`` the second expert is kept where ``2 * p2 > u``,
    ``u ~ U(0, 1)`` a token, and set to ``-1`` elsewhere (moe.py:213).
    ``noise`` is that ``u`` ``[S]``; by default it is drawn."""

    def __init__(self, d_model: int, num_expert: int, topk: int = 2,
                 capacity=(1.2, 2.4), random_routing: bool = True,
                 group=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        if topk != 2:
            raise ValueError("GShardGate is top-2 (the reference asserts "
                             "the same)")
        super().__init__(d_model, num_expert, topk=2, device=device,
                         dtype=dtype, generator=generator)
        self.capacity = capacity
        self.random_routing = random_routing

    def select(self, logits: torch.Tensor, noise=None):
        probs = torch.softmax(logits, dim=-1)
        val, idx = _topk(probs, 2)
        self.set_loss(_load_balance_loss(probs, idx, self.num_expert))
        if self.random_routing and self.training:
            u = self._draw(val.shape[:-1], val.device) if noise is None \
                else noise.to(val.device)
            keep = 2.0 * val[..., 1] > u
            idx = torch.stack([idx[..., 0],
                               torch.where(keep, idx[..., 1], -1)], dim=-1)
        return val, idx


class SwitchGate(NaiveGate):
    """Top-1 gate (Switch Transformer): in training the logits are scaled
    by a jitter ``U(1 - eps, 1 + eps)`` an element, then the aux loss
    (moe.py:241).  ``noise`` is that jitter ``[S, E]``; by default it is
    drawn."""

    def __init__(self, d_model: int, num_expert: int, topk: int = 1,
                 switch_eps: float = 0.1, capacity=(1.2, 2.4), group=None,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(d_model, num_expert, topk=1, device=device,
                         dtype=dtype, generator=generator)
        self.switch_eps = switch_eps
        self.capacity = capacity

    def select(self, logits: torch.Tensor, noise=None):
        if self.training and self.switch_eps > 0:
            eps = self.switch_eps
            if noise is None:
                noise = self._draw(logits.shape, logits.device) \
                    * (2.0 * eps) + (1.0 - eps)
            logits = logits * noise.to(logits.device)
        probs = torch.softmax(logits, dim=-1)
        val, idx = _topk(probs, 1)
        self.set_loss(_load_balance_loss(probs, idx, self.num_expert))
        return val, idx


GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


def draws_noise(gate: BaseGate) -> bool:
    """Whether ``gate`` draws from its generator in training."""
    return (isinstance(gate, GShardGate) and gate.random_routing) or \
        (isinstance(gate, SwitchGate) and gate.switch_eps > 0)


# --------------------------------------------------------------------------
# Routing, dispatch and combine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Route:
    """Where every (token, slot) goes: ``slot [S, k]`` its row of the
    flattened ``[E * C]`` expert buffer (``E * C`` where it is dropped),
    ``gv [S, k]`` its renormalised weight (0 where dropped), ``slot_token
    [E * C]`` the token filling each row (``S``: empty), and ``n_kept``
    (a 0-dim tensor) of the pairs kept."""
    slot: torch.Tensor
    gv: torch.Tensor
    slot_token: torch.Tensor
    n_kept: torch.Tensor
    capacity: int


def moe_route(gate_val: torch.Tensor, gate_idx: torch.Tensor,
              num_expert: int, capacity: int) -> Route:
    """The reference's positions, ``keep`` and renormalised weights
    (moe.py:372-385) as gather indices.  Positions count each expert's
    (token, slot) pairs in arrival order, row-major over ``[S, k]``; a
    pair is kept when its expert index is valid and its position is below
    ``capacity``.  No host synchronisation."""
    S, k = gate_idx.shape
    E, C = num_expert, capacity
    flat = gate_idx.reshape(-1)
    # [E, S*k]: the count runs along the contiguous dim (a scan down 8
    # columns of 16k rows keeps the card all but idle)
    hit = (flat[None, :] == torch.arange(E, device=flat.device)[:, None]
           ).int()
    pos = ((hit.cumsum(1) * hit).sum(0) - 1).view(S, k)
    keep = (pos >= 0) & (pos < C) & (gate_idx >= 0)
    gv = torch.where(keep, gate_val, torch.zeros_like(gate_val))
    gv = gv / gv.sum(-1, keepdim=True).clamp(min=1e-9)
    slot = torch.where(keep, gate_idx * C + pos, E * C)
    tok = torch.arange(S, device=flat.device)[:, None].expand(S, k)
    # dropped pairs all write the spare row E*C, cut off after
    slot_token = torch.full((E * C + 1,), S, dtype=torch.long,
                            device=flat.device)
    slot_token.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    return Route(slot, gv, slot_token[:E * C], keep.sum(), C)


class _Dispatch(torch.autograd.Function):
    """``out[r] = tokens[idx[r]]``, zeros where ``idx[r] == len(tokens)``;
    the backward sums each token's rows in f32 and casts once."""

    @staticmethod
    def forward(ctx, tokens, idx):
        n = tokens.shape[0]
        filled = idx < n
        ctx.save_for_backward(idx, filled)
        ctx.shape = tokens.shape
        out = tokens.index_select(0, idx.clamp(max=n - 1))
        return out.masked_fill_(~filled[:, None], 0)

    @staticmethod
    def backward(ctx, g):
        idx, filled = ctx.saved_tensors
        n = ctx.shape[0]
        gt = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        gt.index_add_(0, idx.clamp(max=n - 1),
                      g.float().masked_fill_(~filled[:, None], 0))
        return gt.to(g.dtype), None


def dispatch(tokens: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """Each expert-buffer row's token (zeros for an empty row): the
    reference's ``einsum("sec,sm->ecm", dispatch, tokens)``, exactly."""
    return _Dispatch.apply(tokens, slot_token)


class _Combine(torch.autograd.Function):
    """``out[s] = sum_k w[s, k] * rows[slot[s, k]]`` in f32 with the
    weights cast to the rows' dtype first (the reference's combine
    tensor), cast once; a dropped pair's weight is 0."""

    @staticmethod
    def forward(ctx, rows, slot, gv):
        idx = slot.reshape(-1).clamp(max=rows.shape[0] - 1)
        w = gv.to(rows.dtype)
        ctx.save_for_backward(rows, idx, w)
        out = (_Combine.gathered(rows, idx, slot.shape).float()
               * w.float()[..., None]).sum(-2)
        return out.to(rows.dtype)

    @staticmethod
    def gathered(rows, idx, shape):
        return rows.index_select(0, idx).view(*shape, rows.shape[-1])

    @staticmethod
    def backward(ctx, g):
        rows, idx, w = ctx.saved_tensors
        gf = g.float()[..., None, :]
        g_rows = g_w = None
        if ctx.needs_input_grad[0]:
            gy = (gf * w.float()[..., None]).to(rows.dtype)
            g_rows = torch.zeros_like(rows).index_add_(
                0, idx, gy.reshape(-1, rows.shape[-1]))
        if ctx.needs_input_grad[2]:
            y = _Combine.gathered(rows, idx, w.shape)
            g_w = (gf * y.float()).sum(-1).to(w.dtype).float()
        return g_rows, None, g_w


def combine(rows: torch.Tensor, slot: torch.Tensor,
            gv: torch.Tensor) -> torch.Tensor:
    """``[S, M]``: each token's kept expert outputs (``rows [E * C, M]``
    at ``slot [S, k]``) weighted by ``gv`` and summed (the reference's
    ``einsum("sec,ecm->sm", combine, expert_out)``)."""
    return _Combine.apply(rows, slot, gv)


# --------------------------------------------------------------------------
# Experts + MoELayer
# --------------------------------------------------------------------------

def experts_partial(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    w1: torch.Tensor, activation: str = "gelu"
                    ) -> torch.Tensor:
    """``[E, C, M]`` through each expert's ``act(x @ w0 + b0) @ w1`` as
    batched products over the experts, ``b1`` not added: an mp shard's
    columns of w0 and rows of w1 give its partial of the sum."""
    h = getattr(F, activation)(torch.baddbmm(b0.unsqueeze(1), x, w0))
    return torch.bmm(h, w1)


class ExpertFFN(nn.Module):
    """One FFN expert, ``act(x @ w0 + b0) @ w1 + b1``, ``act`` a name in
    ``nn.functional`` (the exact GELU by default; moe.py:269).  With
    ``mp_group`` the weights carry the Megatron column/row specs (w0
    columns, w1 rows over mp)."""

    def __init__(self, d_model: int, d_hidden: int, activation: str = "gelu",
                 mp_group=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not hasattr(F, activation):
            raise ValueError(f"activation {activation!r} is not in "
                             f"paddle_tpu_torch.nn.functional")
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.w0 = xavier_normal((d_model, d_hidden), **kw)
        self.b0 = nn.Parameter(torch.zeros(d_hidden, device=dev, dtype=dtype))
        self.w1 = xavier_normal((d_hidden, d_model), **kw)
        self.b1 = nn.Parameter(torch.zeros(d_model, device=dev, dtype=dtype))
        self.activation = activation
        mp_axis = _moe_mp_axis(mp_group)
        if mp_axis:
            _apply_ffn_mp_specs(self, mp_axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = getattr(F, self.activation)(torch.matmul(x, self.w0) + self.b0)
        return torch.matmul(h, self.w1) + self.b1


class ExpertStack(nn.Module):
    """The experts' weights stacked ``stacked__{w0,b0,w1,b1}`` ``[E, ...]``,
    each spec'd ``P(expert axis, <the expert's own spec>)``, run as one
    batched product over experts (moe.py:408).  The experts must be
    ``ExpertFFN`` of one activation; their own tensors are released."""

    def __init__(self, experts: Sequence[ExpertFFN], moe_group=None):
        super().__init__()
        experts = list(experts)
        if not experts:
            raise ValueError("need at least one expert")
        if not all(isinstance(e, ExpertFFN) for e in experts) or \
                len({e.activation for e in experts}) != 1:
            raise NotImplementedError(
                "ExpertStack runs ExpertFFN experts of one activation as a "
                "batched product; other expert layers are not ported")
        self._n = len(experts)
        self._axis = _ep_axis(moe_group)
        self.activation = experts[0].activation
        tspecs = get_param_specs(experts[0])
        for name in ("w0", "b0", "w1", "b1"):
            leaves = [getattr(e, name) for e in experts]
            pname = f"stacked__{name}"
            with torch.no_grad():
                stacked = torch.stack([t.detach() for t in leaves])
            for t in leaves:
                t.data = torch.empty(0, dtype=t.dtype, device=t.device)
            self.register_parameter(pname, nn.Parameter(stacked))
            inner = tuple(tspecs.get(name, P()))
            inner = inner + (None,) * (leaves[0].dim() - len(inner))
            set_param_spec(self, pname, P(self._axis, *inner))

    @property
    def num_experts(self) -> int:
        return self._n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[E, C, M] -> [E, C, M]``."""
        return experts_partial(x, self.stacked__w0, self.stacked__b0,
                               self.stacked__w1, self.activation) \
            + self.stacked__b1.unsqueeze(1)


class MoELayer(nn.Module):
    """Mixture-of-experts layer (moe.py:301): ``d_model``, ``experts``
    (one ``ExpertFFN`` per global expert), ``gate`` (a ``BaseGate`` or a
    config dict with ``type`` in naive / gshard / switch, built on the
    experts' device with ``generator``), ``moe_group`` (the expert axis:
    a ``ParallelAxis`` or an axis name; default ``ep`` when the hybrid
    group's ep degree is above 1, else ``dp``), ``mp_group`` (expert-
    internal tensor parallelism), the capacity factors.  The specs are
    what the hybrid trainer splits the weights by; this module computes
    on its own device."""

    def __init__(self, d_model: int, experts: Sequence[ExpertFFN],
                 gate=None, moe_group=None, mp_group=None,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0,
                 recompute_interval: int = 0, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        experts = list(experts)
        self.d_model = d_model
        self.num_expert = len(experts)
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        dev = experts[0].w0.device
        if gate is None or isinstance(gate, dict):
            cfg = dict(gate or {})
            gcls = GATES[cfg.pop("type", "gshard")]
            gate = gcls(d_model, self.num_expert, device=dev,
                        dtype=experts[0].w0.dtype, generator=generator,
                        **cfg)
        self.gate = gate
        mp_axis = _moe_mp_axis(mp_group)
        if mp_axis:
            for e in experts:
                if not e.__dict__.get("_param_specs"):
                    _apply_ffn_mp_specs(e, mp_axis)
        self.experts = ExpertStack(experts, moe_group=moe_group)
        self._axis = self.experts._axis
        self.register_buffer("expert_util", torch.zeros((), device=dev),
                             persistent=False)
        self.register_buffer("token_keep_rate", torch.ones((), device=dev),
                             persistent=False)

    @property
    def top_k(self) -> int:
        return self.gate.top_k

    def capacity(self, num_tokens: int) -> int:
        factor = self.capacity_factor if self.training \
            else self.eval_capacity_factor
        return default_capacity(num_tokens, self.num_expert, self.top_k,
                                factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        M, E = self.d_model, self.num_expert
        tokens = x.reshape(-1, M)
        with record_function(GATE_RANGE):
            val, idx = self.gate(tokens)
        route = moe_route(val, idx, E, self.capacity(tokens.shape[0]))
        self.record(route, tokens.shape[0])
        with record_function(DISPATCH_RANGE):
            xin = dispatch(tokens, route.slot_token).view(E, -1, M)
        with record_function(EXPERTS_RANGE):
            out = self.experts(xin).reshape(-1, M)
        with record_function(COMBINE_RANGE):
            return combine(out, route.slot, route.gv).view(x.shape)

    def record(self, route: Route, num_tokens: int) -> None:
        """The routing readings (moe.py:345-353): occupancy, filled slots
        over ``E * C``; keep rate, kept pairs over ``S * k``."""
        kept = route.n_kept.detach().float()
        self.expert_util = kept / float(self.num_expert * route.capacity)
        self.token_keep_rate = kept / float(num_tokens * self.top_k)


def _apply_ffn_mp_specs(layer: nn.Module, mp_axis: str) -> None:
    """The Megatron column->row split of the FFN expert (moe.py:460): w0
    column-parallel, w1 row-parallel, the biases following their
    outputs."""
    set_param_spec(layer, "w0", P(None, mp_axis))
    set_param_spec(layer, "b0", P(mp_axis))
    set_param_spec(layer, "w1", P(mp_axis, None))
    set_param_spec(layer, "b1", P())


def _moe_mp_axis(mp_group) -> Optional[str]:
    """The axis of expert-internal tensor parallelism: a group's name,
    ``"mp"`` for True, None for None / False (moe.py:471)."""
    if mp_group is None or mp_group is False:
        return None
    if mp_group is True:
        return "mp"
    if hasattr(mp_group, "name"):
        return mp_group.name
    return mp_group if isinstance(mp_group, str) else None


def _ep_axis(moe_group) -> Optional[str]:
    """The experts' axis (moe.py:487): the group's, else ``ep`` when the
    hybrid group's ep degree is above 1, ``dp`` with a hybrid group, None
    without one."""
    if moe_group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None:
            return None
        return "ep" if hcg.get_expert_parallel_world_size() > 1 else "dp"
    if hasattr(moe_group, "name"):
        return moe_group.name
    return moe_group if isinstance(moe_group, str) else None


def gate_layers(model: nn.Module) -> List[BaseGate]:
    return [m for m in model.modules() if isinstance(m, BaseGate)]
