"""GPT trainer, serial or hybrid-parallel (counterpart of
paddle_tpu/models/trainer.py).

``GPTHybridTrainer(cfg, hcg, optimizer, microbatches, zero_stage, vpp)``
keeps the reference's constructor, ``make_batch`` draw and layout; the
step is eager: ``train_step(ids, labels) -> loss``.

* ``hcg=None`` (or a group whose every degree is 1): one
  ``GPTForCausalLM`` on ``device`` (the card by default), forward with
  attention through the flash kernels, the mean ``parallel_cross_entropy``,
  ``backward()``, one optimizer step, gradients cleared.
* a hybrid group (``fleet.init`` + ``get_hybrid_communicate_group()``):
  the reference's layout over the group's rank grid, driven from this one
  process.  The model is built once on rank 0's device and split tensor by
  tensor into rank blocks by the reference's specs: Megatron columns /
  rows over ``mp`` (QKV columns head-aligned, ``[q_d | k_d | v_d]``), the
  ``wte`` / ``wpe`` rows over ``mp`` and ``pp`` (the tied head is the
  second use of ``wte``), each stage's blocks (``L/S`` of them, or ``V``
  round-robin chunks under VPP), the batch over ``dp x sharding`` within
  each microbatch.  Every rank runs its share: its rows, its heads and
  ffn columns (``GPTBlock.partial``, the row-parallel partials summed over
  the mp group), its stage's blocks (``distributed/pipelining.py``: only
  the ``S·M`` pairs that carry data), its vocab shard of the head and
  the vocab-parallel cross entropy.  One ``backward()`` of the global mean
  gives every gradient summed over microbatches and the batch groups.
* ZeRO (``sharding_degree > 1``): the optimizer state of a tensor splits
  over ``sharding`` along the dim ``shard_opt_state_specs`` picks; stage 3
  also stores the weights split and gathers them at use.  Each rank
  updates its slice in place with the bound optimizer (one ``fused_adamw``
  launch a slice with ``FusedAdamW``).  A tensor whose ZeRO dim is not its
  first is stored with that dim moved first, and the compute reads it
  through the matching view, so every slice the kernel writes in place is
  contiguous.

* ``cfg.sp`` at mp > 1 (sequence parallelism): between blocks each mp
  rank holds its ``s/mp`` rows of the residual (the layout of the
  reference's block code, ``[b, s/mp, h]``); each rank normalises its
  rows, the rows are gathered before QKV / fc_in, the out_proj / fc_out
  partials are reduced and scattered on the sequence, and the bias and the
  residual add run on the rank's rows.  The embedding hands each stage-0
  rank its rows; the head gathers them.
* ``cfg.remat``: each block, across its mp ranks, runs under
  ``distributed.recompute.remat_wrap`` (the reference wraps
  ``_block_apply``), so the backward runs its forward again.
* the optimizer's ``grad_clip``: the reference trainer updates the
  non-block tensors and the block stack in two ``update`` calls
  (trainer.py:340-341), so a global-norm clip takes one norm for each of
  the two groups; the port does the same, over the logical gradient
  (each element once: a replica once, each ZeRO slice once).  The rate is
  ``optimizer.get_lr()``, read once a step.

A value replicated over ranks on one device is held once there: the
ranks share the tensor, and autograd sums their gradient contributions,
which is the dp / sharding gradient all-reduce.  Replicas on different
devices sum their gradients explicitly and ZeRO slices are copied between
them after the update.

``train_state()`` is every tensor a resumed step depends on (parameters,
the optimizer's slots, masters and step, the scheduler's state) by name,
in the reference's global layout, each element once (pieces of a
``ShardedTensor`` for the hybrid layout), viewing the trainer's own
storage.  ``fleet_utils.save_auto_resume`` writes it; ``load_auto_resume``
fills it in place from a checkpoint of any layout, and
``load_train_state`` then copies the replicas and sets the step and the
scheduler.

``ep_degree > 1`` on the dense GPT is the reference's layout: no
parameter carries an ``ep`` spec and the batch does not split over
``ep``, so the ep ranks hold replicas and the step computes on ep rank 0.

``GPTMoEHybridTrainer`` (below) trains ``GPTMoEForCausalLM`` over the same
grid with the experts split over ``ep`` (or ``dp`` when ep is 1) and mp.

Not ported (ROADMAP queue 1): ``sep`` / context parallelism and, in the
hybrid path, dropout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..distributed import moe
from ..distributed.mesh import Mesh, psum
from ..distributed.meta_parallel.mp_layers import (parallel_cross_entropy,
                                                   sharded_row_take)
from ..distributed.meta_parallel.sequence_parallel import (all_gather,
                                                           reduce_scatter,
                                                           scatter)
from ..distributed.pipelining import (pipeline_apply,
                                      pipeline_apply_interleaved)
from ..distributed.recompute import remat_wrap
from ..distributed.sharding_utils import (P, ShardedTensor, get_param_specs,
                                          shard_block, shard_index,
                                          spec_axes, zero_dim)
from ..nn.functional import layer_norm
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM
from .gpt_moe import (GPTMoEConfig, GPTMoEForCausalLM, attention,
                      replay_generators)

__all__ = ["GPTHybridTrainer", "GPTMoEHybridTrainer"]

# the profiler range around the clip's work in a hybrid step
CLIP_RANGE = "GPTHybridTrainer.clip"


class _BlockShard(nn.Module):
    """``functional_call`` target: ``GPTBlock.partial`` with a rank's
    weights."""

    def __init__(self, block: GPTBlock):
        super().__init__()
        self.block = block

    def forward(self, x: torch.Tensor, half: str) -> torch.Tensor:
        return self.block.partial(x, half)


@dataclasses.dataclass
class _Layout:
    """Where one parameter lives: its spec over the grid (mp, pp), the
    stage of its block (None: every stage) and its ZeRO split: ``zdim``
    (the dim of the per-rank block, stored first) or ``owner`` (the
    sharding rank holding a whole block: the reference splits the stacked
    layer dim)."""
    spec: P
    stage: Optional[int]
    zdim: Optional[int] = None
    owner: Optional[int] = None


def _bias(t: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return t if b is None else t + b


def _ptrs(x) -> List[int]:
    """Where a tensor's or a ``ShardedTensor``'s pieces' data start."""
    return [t.data_ptr() for _, t in x.pieces] \
        if isinstance(x, ShardedTensor) else [x.data_ptr()]


class GPTHybridTrainer:
    BLOCK_PREFIX = "gpt.h."
    KEY_WTE = "gpt.wte.weight"
    KEY_WPE = "gpt.wpe.weight"
    KEY_LNF_W = "gpt.ln_f.weight"
    KEY_LNF_B = "gpt.ln_f.bias"

    def __init__(self, cfg: GPTConfig, hcg=None, optimizer=None,
                 microbatches: int = 1, zero_stage: int = 1, vpp: int = 1,
                 *, device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        if optimizer is None:
            raise ValueError("GPTHybridTrainer needs an optimizer, e.g. "
                             "FusedAdamW(learning_rate=1e-4, "
                             "multi_precision=True)")
        self.cfg = cfg
        self.hcg = hcg
        self.M = microbatches
        self.zero = zero_stage
        self.V = max(vpp, 1)
        self.S = 1 if hcg is None else hcg.get_pipe_parallel_world_size()
        if hcg is not None:
            self._check_group(hcg)
        # stage-body calls of the pipelined forward (no bubble ticks)
        self.stage_calls = 0
        serial = hcg is None or all(n == 1 for n in hcg.degrees().values())
        if serial:
            if hcg is not None:
                if device is not None:
                    raise ValueError("the hybrid group places the trainer: "
                                     "pass devices= to fleet.init, not "
                                     "device=")
                device = hcg.grid.device(0)
            self.grid = None
            self.model = self._make_model(device, generator).train()
            self.opt = optimizer.bind(self.model)
            return
        if device is not None:
            raise ValueError("the hybrid group places the ranks: pass "
                             "devices= to fleet.init, not device=")
        self.model = None
        self.opt = optimizer
        self._build(generator)
        self.sp = getattr(cfg, "sp", False) and self.mp > 1
        # the hybrid path refuses dropout: it replays only what the block
        # itself draws
        self._block_run = remat_wrap(self._block_body, cfg.remat,
                                     generators=self._replay_generators())

    def _make_model(self, device, generator) -> nn.Module:
        return GPTForCausalLM(self.cfg, device=device, generator=generator)

    def _make_template(self, model: nn.Module) -> nn.Module:
        """What the per-rank block body calls with a rank's weights."""
        return _BlockShard(GPTBlock(self.cfg, device=torch.device("meta"),
                                    dtype=self._dtype, generator=None))

    def _replay_generators(self) -> list:
        return []

    def _check_group(self, hcg) -> None:
        cfg = self.cfg
        if hcg.get_sep_parallel_world_size() > 1:
            raise NotImplementedError(
                f"sep_degree={hcg.get_sep_parallel_world_size()}: context "
                f"parallelism is not ported yet (ROADMAP queue 1 item 9)")
        if self.S > 1 and cfg.num_layers % (self.S * self.V):
            raise ValueError(
                f"num_layers={cfg.num_layers} must divide evenly into "
                f"pp_degree={self.S} x vpp={self.V} chunks (reference "
                f"PipelineLayer uniform segmentation has the same "
                f"requirement)")
        if self.V > 1 and self.S > 1 and self.M % self.S:
            raise ValueError("interleaved schedule needs microbatches "
                             "divisible by pp_degree")
        if self.zero not in (0, 1, 2, 3):
            raise ValueError(f"zero_stage must be 0-3, got {self.zero}")
        if any(n > 1 for n in hcg.degrees().values()):
            if cfg.dropout or getattr(cfg, "attn_dropout", 0.0):
                raise NotImplementedError(
                    "dropout in the hybrid-parallel trainer is not ported "
                    "yet (ROADMAP queue 1 item 5); set dropout=0 and "
                    "attn_dropout=0")
            if not getattr(cfg, "tie_embeddings", True):
                raise NotImplementedError(
                    "the hybrid-parallel trainer's head is the tied wte "
                    "table, as the reference's; set tie_embeddings=True")

    # ------------------------------------------------------------ layout
    def _build(self, generator) -> None:
        cfg, hcg = self.cfg, self.hcg
        grid = self.grid = hcg.grid
        self.mp = hcg.get_model_parallel_world_size()
        self.D = hcg.get_sharding_parallel_world_size()
        self.G = hcg.get_data_parallel_world_size() * self.D
        S, V, L = self.S, self.V, cfg.num_layers
        self.interleave = S > 1 and V > 1
        self.K = L // (S * V) if self.interleave else L // S
        model = self._make_model(grid.device(0), generator)
        self._dtype = model.dtype
        specs = get_param_specs(model)
        # wte / wpe rows extend over pp: each stage holds 1/S of the table
        # and the tied head's vocab shards ride mp x pp (trainer.py:98-131)
        if S > 1:
            for k in (self.KEY_WTE, self.KEY_WPE):
                old = tuple(specs[k]) or (None,)
                specs[k] = P(spec_axes(old[0]) + ("pp",), *old[1:])
        self._vocab_axes = spec_axes((tuple(specs[self.KEY_WTE])
                                      or (None,))[0])
        self._layout: Dict[str, _Layout] = {}
        shapes = self._shapes = {n: tuple(p.shape)
                                 for n, p in model.named_parameters()}
        stacked_specs, stacked_shapes = {}, {}
        for n, shape in shapes.items():
            spec = P(*(tuple(specs[n]) + (None,) * (len(shape)
                                                     - len(specs[n]))))
            if not n.startswith(self.BLOCK_PREFIX):
                self._layout[n] = _Layout(spec, None)
                stacked_specs[n], stacked_shapes[n] = spec, shape
                continue
            suffix = self._suffix(n)
            self._layout[n] = _Layout(spec, self._stage_of(self._layer_of(n)))
            lead = (("pp", None) if self.interleave else
                    ("pp" if S > 1 else None,))
            dims = ((S * V, self.K) if self.interleave else (L,))
            stacked_specs[suffix] = P(*lead, *spec)
            stacked_shapes[suffix] = dims + shape
        if self.D > 1:
            for n, lay in self._layout.items():
                self._zero_split(n, lay, stacked_shapes, stacked_specs)
        self._template = self._make_template(model)
        self._store: Dict[tuple, torch.Tensor] = {}
        self._held: Dict[tuple, Optional[tuple]] = {}
        self._views: Dict[tuple, torch.Tensor] = {}
        self._unit_list = None
        self._opt_state = None
        self._place(dict(model.named_parameters()))
        del model

    def _suffix(self, n: str) -> str:
        """A block parameter's name within its block."""
        return n[len(self.BLOCK_PREFIX):].split(".", 1)[1]

    def _layer_of(self, n: str) -> int:
        return int(n[len(self.BLOCK_PREFIX):].split(".", 1)[0])

    def _stage_of(self, layer: int) -> int:
        if self.interleave:
            return (layer // self.K) % self.S
        return layer // self.K

    def _zero_split(self, n: str, lay: _Layout, shapes, specs) -> None:
        """Map ZeRO's dim of the stacked layout (``shard_opt_state_specs``'
        rule) onto the per-rank block: the stacked layer dim (plain, pp=1)
        or the chunk's block dim (VPP) gives whole blocks to one sharding
        rank; any other dim splits each block."""
        block = n.startswith(self.BLOCK_PREFIX)
        key = self._suffix(n) if block else n
        d = zero_dim(shapes[key], specs[key], self.D)
        if d is None:
            return
        lead = (2 if self.interleave else 1) if block else 0
        if d >= lead:
            lay.zdim = d - lead
            return
        i = self._layer_of(n)
        per = (self.K if self.interleave else self.cfg.num_layers) // self.D
        lay.owner = (i % self.K if self.interleave else i) // per

    def _arranged(self, n: str) -> bool:
        """Whether ``n`` is a QKV weight / bias split on its columns over
        mp, stored with each shard's head group contiguous."""
        return self.mp > 1 and n.endswith(("qkv.weight", "qkv.bias")) \
            and "mp" in spec_axes(self._layout[n].spec[-1])

    def _qkv_arranged(self, n: str, t: torch.Tensor) -> torch.Tensor:
        """The QKV weight / bias with each mp shard's head group
        contiguous, ``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]`` (the column
        order ``tp_decode_weights`` uses)."""
        if not self._arranged(n):
            return t
        h = self.cfg.hidden_size
        q, k, v = t.split(h, dim=-1)
        parts = zip(q.chunk(self.mp, -1), k.chunk(self.mp, -1),
                    v.chunk(self.mp, -1))
        return torch.cat([x for trio in parts for x in trio], dim=-1)

    def _qkv_restored(self, n: str, t: torch.Tensor) -> torch.Tensor:
        if not self._arranged(n):
            return t
        per = t.chunk(self.mp, -1)
        trios = [x.chunk(3, -1) for x in per]
        return torch.cat([torch.cat([tr[j] for tr in trios], -1)
                          for j in range(3)], -1)

    def _ranks_of(self, n: str) -> List[int]:
        stage = self._layout[n].stage
        return [r for r in range(self.grid.size)
                if stage is None or self.grid.coord(r)["pp"] == stage]

    def _block_index(self, n: str, r: int) -> tuple:
        lay = self._layout[n]
        return shard_index(lay.spec, len(lay.spec), self.grid, r)

    def _holds(self, n: str, r: int) -> Optional[tuple]:
        """The store key ``(name, block index, piece, device)`` of what
        rank ``r`` keeps of ``n``: piece None for the whole block, under
        stage 3 the rank's ZeRO slice or ``"own"`` (None: nothing, a block
        another sharding rank owns)."""
        if (n, r) not in self._held:
            lay, grid = self._layout[n], self.grid
            s = grid.coord(r)["sharding"]
            piece = None
            if self.zero >= 3 and lay.zdim is not None:
                piece = s
            elif self.zero >= 3 and lay.owner is not None:
                piece = "own" if s == lay.owner else False
            self._held[(n, r)] = None if piece is False else (
                n, self._block_index(n, r), piece, grid.device(r))
        return self._held[(n, r)]

    def _place(self, params: Dict[str, nn.Parameter]) -> None:
        """Split the full weights into the rank blocks, releasing each full
        tensor as soon as its blocks exist."""
        with torch.no_grad():
            for n, p in params.items():
                self._write(n, p.detach())
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        for t in self._store.values():
            t.requires_grad_(True)

    def _write(self, n: str, full: torch.Tensor) -> None:
        """Lay ``full`` (the reference's global layout) into the blocks of
        ``n``: new leaves at build, copied in place afterwards."""
        lay = self._layout[n]
        full = self._qkv_arranged(n, full)
        done = set()
        for r in self._ranks_of(n):
            key = self._holds(n, r)
            if key is None or key in done:
                continue
            done.add(key)
            blk = shard_block(full, key[1])
            if lay.zdim is not None:
                blk = blk.movedim(lay.zdim, 0)
                if isinstance(key[2], int):
                    blk = blk.chunk(self.D, 0)[key[2]]
            if key not in self._store:
                self._store[key] = torch.empty(blk.shape, dtype=blk.dtype,
                                               device=key[3])
            self._store[key].copy_(blk)

    # ------------------------------------------------------------ weights
    def _group_rank(self, r: int, **coord) -> int:
        c = self.grid.coord(r)
        c.update(coord)
        return self.grid.rank(**c)

    def _param(self, n: str, r: int) -> torch.Tensor:
        """Rank ``r``'s block of ``n`` in its logical layout, for this
        step: gathered over the sharding group under stage 3 (once per
        device and step: the gathered value is replicated)."""
        lay, grid = self._layout[n], self.grid
        key = self._holds(n, r)
        dev = grid.device(r)
        vkey = (n, self._block_index(n, r), dev)
        t = self._views.get(vkey)
        if t is not None:
            return t
        if key is not None and key[2] is None:
            t = self._store[key]
        elif lay.owner is not None:
            src = self._group_rank(r, sharding=lay.owner)
            t = self._store[self._holds(n, src)].to(dev)
        else:
            t = torch.cat([self._store[self._holds(n, q)].to(dev)
                           for q in grid.axis_ranks("sharding", r)])
        if lay.zdim is not None:
            t = t.movedim(0, lay.zdim)
        self._views[vkey] = t
        return t

    def _block_params(self, layer: int, r: int) -> Dict[str, torch.Tensor]:
        pre = f"{self.BLOCK_PREFIX}{layer}."
        return {f"block.{n[len(pre):]}": self._param(n, r)
                for n in self._layout if n.startswith(pre)}

    # ------------------------------------------------------------ forward
    def _rank(self, g: int, stage: int, d: int) -> int:
        dp, sh = divmod(g, self.D)
        return self.grid.rank(dp=dp, pp=stage, sharding=sh, mp=d)

    def _vocab_ranks(self, g: int) -> List[int]:
        """The ranks of batch group ``g`` holding the vocab shards of
        ``wte`` / ``wpe`` and of the head, in shard order (the table's row
        axes, the first major)."""
        axes = self._vocab_axes
        dims = [self.grid.shape[a] for a in axes]
        out = []
        for j in range(math.prod(dims)):
            c = {}
            for a, n in reversed(list(zip(axes, dims))):
                j, c[a] = divmod(j, n)
            out.append(self._rank(g, c.get("pp", 0), c.get("mp", 0)))
        return out

    def _mesh(self, ranks: List[int]) -> Mesh:
        return Mesh([self.grid.device(r) for r in ranks])

    def _block(self, layer: int, g: int, stage: int,
               xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """One block over the mp group of (``g``, ``stage``), recomputed in
        the backward under ``cfg.remat``."""
        ranks = [self._rank(g, stage, d) for d in range(self.mp)]
        prm = [self._block_params(layer, r) for r in ranks]
        return self._block_run(self._mesh(ranks), xs, prm)

    def _block_body(self, mesh: Mesh, xs: List[torch.Tensor],
                    prm: List[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
        """Each rank's rows through the half's LayerNorm, then each rank's
        partial of the attention summed over the group (under sp the normed
        rows gathered on the sequence first, the partials reduced and
        scattered on it), bias, residual; then the MLP likewise."""
        cfg, fc = self.cfg, torch.func.functional_call
        for half, bias in (("attn", "block.out_proj.bias"),
                           ("mlp", "block.fc_out.bias")):
            ln = "block.ln_2" if half == "mlp" else "block.ln_1"
            hs = [layer_norm(x, cfg.hidden_size, p[f"{ln}.weight"],
                             p[f"{ln}.bias"], cfg.layer_norm_eps)
                  for p, x in zip(prm, xs)]
            if self.sp:
                hs = all_gather(hs, mesh)
            outs = [fc(self._template, p, (h, half)) for p, h in zip(prm, hs)]
            outs = reduce_scatter(outs, mesh) if self.sp else psum(outs, mesh)
            xs = [x + _bias(o, p.get(bias))
                  for x, o, p in zip(xs, outs, prm)]
        return xs

    def _stage_body(self, g: int):
        def body(entry, xs):
            stage, layers = entry
            self.stage_calls += 1
            for i in layers:
                xs = self._block(i, g, stage, xs)
            return xs
        return body

    def _hop(self, g: int):
        def hop(xs, stage):
            return [x.to(self.grid.device(self._rank(g, stage, d)))
                    for d, x in enumerate(xs)]
        return hop

    def _embed(self, g: int, ids: torch.Tensor) -> List[torch.Tensor]:
        """Token + position rows of ``ids`` for batch group ``g``: masked
        lookups in each vocab shard summed over the shards, then handed to
        the stage-0 mp ranks (under sp each rank its rows)."""
        ranks = self._vocab_ranks(g)
        mesh = self._mesh(ranks)
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        tok = sharded_row_take([self._param(self.KEY_WTE, r) for r in ranks],
                               ids, mesh)
        at = sharded_row_take([self._param(self.KEY_WPE, r) for r in ranks],
                              pos, mesh)
        xs = [a + b for a, b in zip(tok, at)]
        xs = [xs[ranks.index(self._rank(g, 0, d))] for d in range(self.mp)]
        if self.sp:
            xs = scatter(xs, self._mesh([self._rank(g, 0, d)
                                         for d in range(self.mp)]))
        return self._hop(g)(xs, 0)

    def _final_loss(self, g: int, xs: List[torch.Tensor],
                    labels: torch.Tensor) -> torch.Tensor:
        """Summed token loss of one microbatch of group ``g``: ln_f and the
        tied head on each vocab shard's rank, then the vocab-parallel
        cross entropy (under sp the last stage's rows gathered first)."""
        cfg = self.cfg
        if self.sp:
            xs = all_gather(xs, self._mesh([self._rank(g, self.S - 1, d)
                                            for d in range(self.mp)]))
        ranks = self._vocab_ranks(g)
        logits = []
        for r in ranks:
            x = xs[self.grid.coord(r)["mp"]].to(self.grid.device(r))
            x = layer_norm(x, cfg.hidden_size, self._param(self.KEY_LNF_W, r),
                           self._param(self.KEY_LNF_B, r),
                           cfg.layer_norm_eps)
            logits.append(torch.matmul(x, self._param(self.KEY_WTE, r).t()))
        per_tok = parallel_cross_entropy(logits, labels,
                                         mesh=self._mesh(ranks))[0]
        return per_tok.sum()

    def _stage_entries(self) -> list:
        """Per pipeline slot, ``(stage, its layers)``: ``S`` stages of
        ``L/S`` blocks, or under VPP the ``S·V`` chunks in the reference's
        ``stack_interleaved`` order."""
        S, V, K = self.S, self.V, self.K
        if not self.interleave:
            return [(s, range(s * K, (s + 1) * K)) for s in range(S)]
        return [(s, range(c * K, (c + 1) * K))
                for s in range(S) for c in (v * S + s for v in range(V))]

    def _loss(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The global mean token loss, with every rank's share in one
        autograd graph."""
        B, s = ids.shape
        M = self.M if self.S > 1 else 1
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        if self.sp and s % self.mp:
            raise ValueError(f"sequence parallelism splits the sequence "
                             f"({s}) over mp_degree={self.mp}: it must "
                             f"divide evenly")
        mb = B // M
        per = -(-mb // self.G)        # rows a batch group takes, as XLA
        dev0 = self.grid.device(0)
        total = torch.zeros((), dtype=torch.float32, device=dev0)
        entries = self._stage_entries()
        for g in range(self.G):
            rows = [(m * mb + g * per, min(m * mb + (g + 1) * per,
                                           (m + 1) * mb)) for m in range(M)]
            rows = [(lo, hi) for lo, hi in rows if lo < hi]
            if not rows:
                continue
            xs = [self._embed(g, ids[lo:hi]) for lo, hi in rows]
            run = pipeline_apply_interleaved if self.interleave \
                else pipeline_apply
            extra = (self.V,) if self.interleave else ()
            outs = run(self._stage_body(g), entries, xs, self.S, *extra,
                       hop=self._hop(g))
            for (lo, hi), out in zip(rows, outs):
                total = total + self._final_loss(g, out,
                                                 labels[lo:hi]).to(dev0)
        return total / (B * s)

    # ------------------------------------------------------------ update
    def _units(self) -> List[tuple]:
        """Every slice a rank updates, once per device: ``(state key,
        optimizer name, store key, slice or None)``."""
        out, seen = [], set()
        for n, lay in self._layout.items():
            name = self._suffix(n) if n.startswith(self.BLOCK_PREFIX) \
                else n
            for r in self._ranks_of(n):
                key = self._holds(n, r)
                if key is None:
                    continue
                s = self.grid.coord(r)["sharding"]
                cut = None
                if key[2] is None and lay.zdim is not None:
                    cut = s
                elif key[2] is None and lay.owner is not None:
                    if s != lay.owner:
                        continue
                unit = key[:2] + (cut if cut is not None else key[2],
                                  key[3])
                if unit not in seen:
                    seen.add(unit)
                    out.append((unit, name, key, cut))
        return out

    def _operands(self, key: tuple, cut: Optional[int], grad: bool):
        t = self._store[key]
        if grad:
            t = t.grad
            if t is None:
                return None
        return t if cut is None else t.chunk(self.D, 0)[cut]

    def _sum_replica_grads(self) -> None:
        """Gradients of one block held on several devices (replicas over
        dp / sharding / mp / ep ranks there) are summed and shared; a
        replica that took no part in the step (an ep replica of the dense
        GPT, a copy of an expert block another batch group computes) gets
        the sum too."""
        groups: Dict[tuple, List[tuple]] = {}
        for key in self._store:
            groups.setdefault(key[:3], []).append(key)
        for keys in groups.values():
            ts = [self._store[k] for k in keys]
            got = [t for t in ts if t.grad is not None]
            if len(ts) > 1 and got:
                total = psum([t.grad for t in got],
                             Mesh([t.device for t in got]))[0]
                for t in ts:
                    t.grad = total.to(t.device, copy=True)

    def _share_slices(self, updated: Dict[tuple, torch.device]) -> None:
        """ZeRO 1-2 across devices: each replica takes the slices it did
        not update from a device that did (the all-gather)."""
        for key, t in self._store.items():
            lay = self._layout[key[0]]
            if key[2] is not None or (lay.zdim is None and lay.owner is None):
                continue
            cuts = range(self.D) if lay.zdim is not None else (None,)
            for c in cuts:
                src = updated.get((key[0], key[1], c if c is not None
                                   else lay.owner))
                if src is None or src == key[3]:
                    continue
                other = self._store[key[:3] + (src,)]
                if c is None:
                    t.data.copy_(other.data)
                else:
                    t.data.chunk(self.D, 0)[c].copy_(
                        other.data.chunk(self.D, 0)[c])

    def _tensor_of(self, name: str) -> Tuple[str, str]:
        """``(update group, reference tensor)`` of a parameter: the
        reference trainer's two ``update`` calls, the non-block tensors and
        the stacked blocks, whose tensor is the block suffix
        (trainer.py:340-341; clip.py's ``tensor_of``)."""
        if name.startswith(self.BLOCK_PREFIX):
            return "blocks", self._suffix(name)
        return "nonblock", name

    def _opt_state_made(self) -> dict:
        """The optimizer state, per unit of :meth:`_units`, made at first
        use."""
        if self._unit_list is None:
            self._unit_list = self._units()
        if self._opt_state is None:
            self._opt_state = {"step": 0, "slots": {}, "master": {}}
            for unit, _, key, cut in self._unit_list:
                slots, master = self.opt.init_tensor_state(
                    self._operands(key, cut, False))
                self._opt_state["slots"][unit] = slots
                self._opt_state["master"][unit] = master
        return self._opt_state

    @torch.no_grad()
    def _update(self) -> None:
        st = self._opt_state_made()
        units = self._unit_list
        spread = len({key[3] for key in self._store}) > 1
        if spread:
            self._sum_replica_grads()
        grads = {}
        for unit, _, key, cut in units:
            g = self._operands(key, cut, True)
            if g is not None:
                grads[unit] = g
        clip = self.opt.grad_clip
        if clip is not None:
            # the norms over the logical gradient: each slice once (a
            # replica's units on other devices hold the same sum)
            once = {}
            for unit, g in grads.items():
                once.setdefault(unit[:3], g)
            with record_function(CLIP_RANGE):
                scales = clip.scales(once, lambda u: self._tensor_of(u[0]))
        lr = self.opt.get_lr()
        updated = {}
        for unit, name, key, cut in units:
            g = grads.get(unit)
            if g is None:
                continue
            if clip is not None:
                with record_function(CLIP_RANGE):
                    g = clip.clip_one(g, scales[unit[:3]])
            self.opt.update_tensor(name, self._operands(key, cut, False), g,
                                   st["slots"][unit], st["master"][unit],
                                   st["step"], lr)
            updated.setdefault(key[:2] + (cut if cut is not None
                                          else self._layout[key[0]].owner,),
                               key[3])
        if spread and self.D > 1 and self.zero < 3:
            self._share_slices(updated)
        st["step"] += 1
        for t in self._store.values():
            t.grad = None

    # ------------------------------------------------------------ the API
    @property
    def device(self) -> torch.device:
        return self.model.device if self.grid is None else \
            self.grid.device(0)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype if self.grid is None else self._dtype

    def make_batch(self, batch: int, seq: Optional[int] = None,
                   seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ids, labels)`` ``[batch, seq]`` int64 on rank 0's device (the
        model's, serial): the reference's draw (trainer.py:361-373),
        ``RandomState(seed).randint(0, vocab, (batch, seq + 1))`` shifted
        by one.  The step hands each rank its rows."""
        seq = seq or self.cfg.max_seq_len
        ids = np.random.RandomState(seed).randint(
            0, self.cfg.vocab_size, (batch, seq + 1))
        t = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        return t[:, :-1].contiguous(), t[:, 1:].contiguous()

    def train_step(self, ids: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """Forward, loss, backward, one optimizer step, gradients cleared.
        Returns the step's loss (a detached 0-dim f32 tensor; reading it
        synchronises with the card)."""
        if self.grid is None:
            loss = self.model.loss(ids, labels)
            loss.backward()
            self.opt.step(tensor_of=self._tensor_of)
            self.opt.clear_grad()
            return loss.detach()
        self._views.clear()
        try:
            loss = self._loss(ids, labels)
            loss.backward()
        finally:
            self._views.clear()
        self._update()
        return loss.detach()

    # ------------------------------------------------- state in and out
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every parameter in the reference model's names and global
        layout (serial: the model's own; hybrid: the rank blocks put
        together on rank 0's device)."""
        if self.grid is None:
            return self.model.state_dict()
        out = {}
        dev0 = self.grid.device(0)
        with torch.no_grad():
            for n, lay in self._layout.items():
                blocks = {}
                for r in self._ranks_of(n):
                    idx = self._block_index(n, r)
                    if idx not in blocks:
                        blocks[idx] = self._param(n, r).detach().to(dev0)
                self._views.clear()
                out[n] = self._qkv_restored(n, _assemble(blocks))
        return out

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Lay the reference-layout parameters ``state`` (every name of the
        model) into the rank blocks in place; the optimizer state starts
        over."""
        if self.grid is None:
            self.model.load_state_dict(state)
            return
        missing = set(self._layout) - set(state)
        extra = set(state) - set(self._layout)
        if missing or extra:
            raise KeyError(f"state names: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        with torch.no_grad():
            for n in self._layout:
                self._write(n, state[n].to(self.grid.device(0),
                                           self._dtype))
        self._opt_state = None

    def _global_pieces(self, n: str, idx: tuple, cut: Optional[int],
                       t: torch.Tensor) -> List[tuple]:
        """``t``, the store's block ``idx`` of ``n`` (its ZeRO slice ``cut``
        when not None; stored ZeRO dim first), as ``(global offset,
        view)`` pieces of the reference's global tensor: QKV's arranged
        columns ``[q_d | k_d | v_d]`` are three pieces."""
        lay, shape = self._layout[n], self._shapes[n]
        if lay.zdim is not None:
            t = t.movedim(0, lay.zdim)
        off = [i * (shape[d] // c) for d, (i, c) in enumerate(idx)]
        if cut is not None:
            off[lay.zdim] += cut * t.shape[lay.zdim]
        if not self._arranged(n):
            return [(tuple(off), t)]
        h, w = self.cfg.hidden_size, t.shape[-1] // 3
        d = off[-1] // (3 * w)
        return [(tuple(off[:-1]) + (j * h + d * w,), t.narrow(-1, j * w, w))
                for j in range(3)]

    def _state_pieces(self) -> Dict[str, List[tuple]]:
        """Per train-state name, the pieces of this layout, each element
        once: the first store key (parameters) or unit (optimizer state)
        of each ``(name, block, slice)``; the others hold replicas."""
        st = self._opt_state_made()
        pieces: Dict[str, List[tuple]] = {}
        seen = set()
        for key, t in self._store.items():
            if key[:3] not in seen:
                seen.add(key[:3])
                cut = key[2] if isinstance(key[2], int) else None
                pieces.setdefault(key[0], []).extend(
                    self._global_pieces(key[0], key[1], cut, t.detach()))
        seen = set()
        for unit, *_ in self._unit_list:
            if unit[:3] in seen:
                continue
            seen.add(unit[:3])
            n, cut = unit[0], unit[2] if isinstance(unit[2], int) else None
            per = dict(st["slots"][unit])
            if st["master"][unit] is not None:
                per["master"] = st["master"][unit]
            for k, v in per.items():
                pieces.setdefault(f"opt.{k}.{n}", []).extend(
                    self._global_pieces(n, unit[1], cut, v))
        return pieces

    def train_state(self) -> Dict[str, object]:
        """Every tensor a resumed step depends on, by name, in the
        reference's global layout: the parameters (the model's names),
        ``opt.{slot}.{name}`` and ``opt.master.{name}`` (the optimizer's
        slots and f32 masters, made now if no step ran yet), ``opt.step``
        and ``lr.{key}`` (the scheduler's state).  Serial: the tensors
        themselves; hybrid: ``ShardedTensor``s whose pieces view the rank
        blocks, each element once."""
        out: Dict[str, object] = {}
        if self.grid is None:
            st = self.opt.state
            for n, p in self.model.named_parameters():
                out[n] = p.detach()
                for k, v in st["slots"][n].items():
                    out[f"opt.{k}.{n}"] = v
                if st["master"][n] is not None:
                    out[f"opt.master.{n}"] = st["master"][n]
        else:
            st = self._opt_state_made()
            for name, ps in self._state_pieces().items():
                base = name.split(".", 2)[2] if name.startswith("opt.") \
                    else name
                out[name] = ShardedTensor(self._shapes[base], ps[0][1].dtype,
                                          ps)
        out["opt.step"] = torch.tensor(st["step"], dtype=torch.int64)
        for k, v in self.opt.state_dict()["lr"].items():
            out[f"lr.{k}"] = torch.tensor(
                float("nan") if v is None else v,
                dtype=torch.float64 if v is None or isinstance(v, float)
                else torch.int64)
        return out

    @torch.no_grad()
    def load_train_state(self, sd: Dict[str, object]) -> None:
        """Finish a resume: ``sd`` is this trainer's ``train_state()``
        filled in place (``checkpoint.load_state_dict`` / ``fleet_utils.
        load_auto_resume``, from a checkpoint of any layout); copy the
        blocks onto their replicas and set the optimizer's step and the
        scheduler's state, so the next step continues the run that saved
        it."""
        target = self.train_state()
        missing = sorted(set(target) - set(sd))
        if missing:
            raise KeyError(f"train state lacks {missing}")
        for name, dst in target.items():
            if name == "opt.step" or name.startswith("lr."):
                continue
            if _ptrs(sd[name]) != _ptrs(dst):
                raise ValueError(
                    f"{name}: not this trainer's state; fill "
                    f"trainer.train_state() through checkpoint."
                    f"load_state_dict(state, path)")
        if self.grid is not None:
            self._copy_replicas()
        st = self.opt.state if self.grid is None else self._opt_state
        st["step"] = int(sd["opt.step"])
        lr = {}
        for k, v in sd.items():
            if k.startswith("lr."):
                x = v.item()
                lr[k[3:]] = None if isinstance(x, float) and x != x else x
        self.opt.set_state_dict({"lr": lr})

    def _copy_replicas(self) -> None:
        """Copy each block, slice and optimizer state the train state
        listed once onto the replicas of it on other devices."""
        first: Dict[tuple, torch.Tensor] = {}
        for key, t in self._store.items():
            src = first.setdefault(key[:3], t)
            if src is not t:
                t.data.copy_(src.data)
        st, firsts = self._opt_state, {}
        for unit, *_ in self._unit_list:
            src = firsts.setdefault(unit[:3], unit)
            if src == unit:
                continue
            for k, v in st["slots"][unit].items():
                v.copy_(st["slots"][src][k])
            if st["master"][unit] is not None:
                st["master"][unit].copy_(st["master"][src])

    def rank_state(self, rank: int) -> Dict[str, torch.Tensor]:
        """What rank ``rank`` stores of each parameter it holds (its block,
        or its ZeRO-3 slice of it; under stage 3 nothing of a block another
        sharding rank owns)."""
        out = {}
        for n in self._layout:
            if rank in self._ranks_of(n):
                key = self._holds(n, rank)
                if key is not None:
                    out[n] = self._store[key]
        return out


def _assemble(blocks: Dict[tuple, torch.Tensor]) -> torch.Tensor:
    """Put the blocks keyed by ``shard_index`` back into one tensor."""
    if len(blocks) == 1:
        return next(iter(blocks.values())).clone()
    any_idx = next(iter(blocks))
    ndim = len(any_idx)
    # fold the last split dim first, then the earlier ones
    for d in reversed(range(ndim)):
        if any_idx[d][1] == 1:
            continue
        merged = {}
        for idx in sorted(blocks, key=lambda k: k[d][0]):
            rest = idx[:d] + ((0, 1),) + idx[d + 1:]
            merged.setdefault(rest, []).append(blocks[idx])
        blocks = {k: torch.cat(v, dim=d) for k, v in merged.items()}
        any_idx = next(iter(blocks))
    return next(iter(blocks.values()))


class GPTMoEHybridTrainer(GPTHybridTrainer):
    """GPT-MoE over the hybrid grid (counterpart of trainer.py:383-474):
    ``GPTMoEForCausalLM`` with dp x pp x ZeRO x ep x mp.

    The constructor, ``make_batch``, ``train_step`` and the state API are
    ``GPTHybridTrainer``'s.  The blocks must be uniform
    (``cfg.moe_every == 1``, the pipeline's requirement).  With an mp
    degree above 1 the experts take the Megatron split over ``mp``
    (``cfg.mp_group = "mp"``, on the trainer's copy of ``cfg``), and they
    split over ``ep`` (``dp`` when ep is 1: ``_ep_axis``'s rule).  The
    attention weights, the norms, the gate and the tables carry no mp
    spec; with pp > 1 ``wte`` / ``wpe`` split their rows over ``pp`` and
    the head's cross entropy runs over those vocab shards.

    A step, for each microbatch, runs the pipeline with the hidden state
    of every batch group (dp x sharding) and the gates' aux loss as the
    carry (the reference's ``{"h", "aux"}``): each batch group's rows
    through attention and the norms on its own ranks; then, per MoE layer,
    the router's logits of each group's rows, gathered in row order so
    the softmax, the top-k, the aux loss, the capacity and the arrival
    order run over the whole microbatch (the reference's single program
    sees every token of it); dispatch gathers each expert block's rows
    onto the block's ranks (``expert axis = j``), the mp ranks of the
    block each run their columns and their w1 partials are summed over
    mp; combine gathers the blocks' outputs in expert order onto each
    group.  The batch aux is the mean over microbatches with pp > 1
    (trainer.py:455-461) and the exact sum without pp (trainer.py:463-
    475; microbatches then do not split the batch).  With microbatches >
    1 the capacity is per microbatch, as the reference's.

    Per layer, ``expert_util`` and ``token_keep_rate`` hold the last
    step's readings (their mean over its microbatches), as 0-dim tensors;
    ``routing()`` reads them."""

    BLOCK_PREFIX = "h."
    KEY_WTE = "wte.weight"
    KEY_WPE = "wpe.weight"
    KEY_LNF_W = "ln_f.weight"
    KEY_LNF_B = "ln_f.bias"

    def __init__(self, cfg: GPTMoEConfig, hcg=None, optimizer=None,
                 microbatches: int = 1, zero_stage: int = 1, vpp: int = 1,
                 *, device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        if cfg.moe_every != 1:
            raise ValueError(
                "GPTMoEHybridTrainer needs uniform blocks: set "
                "cfg.moe_every = 1 (every block MoE), the pipeline's "
                "structurally identical stages, like the reference "
                "PipelineLayer's uniform segmentation")
        if hcg is not None:
            ep = hcg.get_expert_parallel_world_size()
            mp = hcg.get_model_parallel_world_size()
            cfg = dataclasses.replace(
                cfg, moe_group=cfg.moe_group if cfg.moe_group is not None
                else ("ep" if ep > 1 else "dp"),
                mp_group="mp" if cfg.mp_group is None and mp > 1
                else cfg.mp_group)
        self.expert_util: List[Optional[torch.Tensor]] = \
            [None] * cfg.num_layers
        self.token_keep_rate: List[Optional[torch.Tensor]] = \
            [None] * cfg.num_layers
        super().__init__(cfg, hcg, optimizer, microbatches, zero_stage, vpp,
                         device=device, generator=generator)

    def _check_group(self, hcg) -> None:
        super()._check_group(hcg)
        axis = moe._ep_axis(self.cfg.moe_group)
        if axis not in ("ep", "dp", "sharding"):
            raise ValueError(f"moe_group {axis!r}: the experts split over "
                             f"ep, dp or sharding")
        n = hcg.grid.shape[axis]
        if self.cfg.num_experts % n:
            raise ValueError(f"num_experts={self.cfg.num_experts} must "
                             f"divide evenly over the {axis} axis of {n}")

    def _make_model(self, device, generator) -> nn.Module:
        return GPTMoEForCausalLM(self.cfg, device=device,
                                 generator=generator)

    def _make_template(self, model: nn.Module) -> nn.Module:
        """Block 0's ``MoELayer``: its gate's ``select`` (which uses no
        weight), capacity factors, activation and expert axis."""
        return model.h[0].ffn

    def _replay_generators(self) -> list:
        return replay_generators(self._template)

    # ------------------------------------------------------------ forward
    def _embed(self, g: int, ids: torch.Tensor) -> torch.Tensor:
        """Token + position rows of ``ids`` for batch group ``g`` on its
        stage-0 rank (masked lookups summed over the tables' row shards
        when pp splits them)."""
        ranks = self._vocab_ranks(g)
        mesh = self._mesh(ranks)
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        tok = sharded_row_take([self._param(self.KEY_WTE, r) for r in ranks],
                               ids, mesh)[0]
        at = sharded_row_take([self._param(self.KEY_WPE, r) for r in ranks],
                              pos, mesh)[0]
        return (tok + at).to(self.grid.device(self._rank(g, 0, 0)))

    def _carry_hop(self, carry, stage: int):
        xs, aux = carry
        return ({g: x.to(self.grid.device(self._rank(g, stage, 0)))
                 for g, x in xs.items()}, aux)

    def _expert_rank(self, stage: int, j: int, d: int) -> int:
        """The rank computing expert block ``j``'s mp shard ``d``: expert
        axis at ``j``, the other batch axes at 0."""
        return self.grid.rank(pp=stage, mp=d, **{self._template._axis: j})

    def _block_body(self, i: int, stage: int, xs: Dict[int, torch.Tensor]):
        """Layer ``i`` on every batch group's rows: ``({group: hidden},
        the gate's aux loss)``."""
        cfg, h = self.cfg, self.cfg.hidden_size
        pre = f"{self.BLOCK_PREFIX}{i}."
        out, hs = {}, {}
        for g, x in xs.items():
            r = self._rank(g, stage, 0)

            def p(name):
                return self._param(pre + name, r)
            a = layer_norm(x, h, p("ln_1.weight"), p("ln_1.bias"),
                           cfg.layer_norm_eps)
            x = x + attention(a, p("qkv.weight"), p("qkv.bias"),
                              p("out_proj.weight"), p("out_proj.bias"),
                              cfg.num_heads)
            out[g] = x
            hs[g] = layer_norm(x, h, p("ln_2.weight"), p("ln_2.bias"),
                               cfg.layer_norm_eps)
        ms, aux = self._moe(i, stage, hs)
        return {g: out[g] + ms[g] for g in out}, aux

    def _moe(self, i: int, stage: int, hs: Dict[int, torch.Tensor]):
        """Layer ``i``'s MoE over every group's rows of one microbatch."""
        tpl, grid = self._template, self.grid
        E, k, h = tpl.num_expert, tpl.top_k, self.cfg.hidden_size
        pre = f"{self.BLOCK_PREFIX}{i}.ffn."
        groups = list(hs)
        toks = {g: hs[g].reshape(-1, h) for g in groups}
        dev_r = toks[groups[0]].device
        with record_function(moe.GATE_RANGE):
            logits = _cat([moe.gate_logits(toks[g], self._param(
                pre + "gate.gate_weight", self._rank(g, stage, 0))).to(dev_r)
                for g in groups])
            val, idx = tpl.gate.select(logits)
        S = logits.shape[0]
        route = moe.moe_route(val, idx, E, tpl.capacity(S))
        C = route.capacity
        kept = route.n_kept.detach().float()
        self._readings[i].append((kept / (E * C), kept / (S * k)))
        n_blk = grid.shape[tpl._axis]
        rows = (E // n_blk) * C
        tok_at: Dict[torch.device, torch.Tensor] = {}
        outs = []
        for j in range(n_blk):
            ranks = [self._expert_rank(stage, j, d) for d in range(self.mp)]
            dev = grid.device(ranks[0])
            if dev not in tok_at:
                tok_at[dev] = _cat([toks[g].to(dev) for g in groups])
            with record_function(moe.DISPATCH_RANGE):
                xin = moe.dispatch(tok_at[dev], route.slot_token[
                    j * rows:(j + 1) * rows].to(dev)).view(-1, C, h)
            with record_function(moe.EXPERTS_RANGE):
                parts = []
                for r in ranks:
                    def p(name):
                        return self._param(pre + "experts.stacked__" + name,
                                           r)
                    parts.append(moe.experts_partial(
                        xin.to(grid.device(r)), p("w0"), p("b0"), p("w1"),
                        tpl.experts.activation))
                y = psum(parts, self._mesh(ranks))[0] + \
                    self._param(pre + "experts.stacked__b1",
                                ranks[0]).unsqueeze(1)
            outs.append(y.reshape(rows, h))
        res, full_at, off = {}, {}, 0
        for g in groups:
            n, dev = toks[g].shape[0], toks[g].device
            if dev not in full_at:
                full_at[dev] = _cat([o.to(dev) for o in outs])
            with record_function(moe.COMBINE_RANGE):
                res[g] = moe.combine(full_at[dev],
                                     route.slot[off:off + n].to(dev),
                                     route.gv[off:off + n].to(dev)
                                     ).view_as(hs[g])
            off += n
        return res, tpl.gate.aux_loss

    def _loss(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The mean token loss plus ``aux_weight`` times the batch aux, with
        every rank's share in one autograd graph."""
        B, s = ids.shape
        M = self.M if self.S > 1 else 1
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        mb = B // M
        per = -(-mb // self.G)        # rows a batch group takes, as XLA
        dev0 = self.grid.device(0)
        self._readings = [[] for _ in range(self.cfg.num_layers)]
        carries, spans = [], []
        for m in range(M):
            rows = {g: (m * mb + g * per, min(m * mb + (g + 1) * per,
                                              (m + 1) * mb))
                    for g in range(self.G)}
            rows = {g: r for g, r in rows.items() if r[0] < r[1]}
            spans.append(rows)
            carries.append(({g: self._embed(g, ids[lo:hi])
                             for g, (lo, hi) in rows.items()},
                            torch.zeros((), dtype=torch.float32,
                                        device=dev0)))

        def body(entry, carry):
            stage, layers = entry
            self.stage_calls += 1
            xs, aux = carry
            for i in layers:
                xs, a = self._block_run(i, stage, xs)
                aux = aux + a.to(aux.device)
            return xs, aux
        run = pipeline_apply_interleaved if self.interleave \
            else pipeline_apply
        extra = (self.V,) if self.interleave else ()
        outs = run(body, self._stage_entries(), carries, self.S, *extra,
                   hop=self._carry_hop)
        for i, got in enumerate(self._readings):
            if got:
                self.expert_util[i] = torch.stack([u for u, _ in got]).mean()
                self.token_keep_rate[i] = torch.stack(
                    [t for _, t in got]).mean()
        total = torch.zeros((), dtype=torch.float32, device=dev0)
        aux = torch.zeros((), dtype=torch.float32, device=dev0)
        for rows, (xs, a) in zip(spans, outs):
            for g, (lo, hi) in rows.items():
                total = total + self._final_loss(g, [xs[g]],
                                                 labels[lo:hi]).to(dev0)
            aux = aux + a
        return total / (B * s) + self.cfg.aux_weight * (aux / M)

    def train_step(self, ids: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        loss = super().train_step(ids, labels)
        if self.grid is None:
            for i, layer in self.model.moe_layers().items():
                self.expert_util[i] = layer.expert_util
                self.token_keep_rate[i] = layer.token_keep_rate
        return loss

    def routing(self) -> Dict[str, List[Optional[float]]]:
        """The last step's ``expert_util`` and ``token_keep_rate`` per
        layer, as floats (reading them synchronises with the card)."""
        return {name: [None if t is None else float(t) for t in vals]
                for name, vals in (("expert_util", self.expert_util),
                                   ("token_keep_rate",
                                    self.token_keep_rate))}


def _cat(ts: List[torch.Tensor]) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(ts)
