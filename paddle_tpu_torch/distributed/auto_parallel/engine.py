"""Auto-parallel Engine: distributed train / eval / predict over a
ProcessMesh (counterpart of paddle_tpu/distributed/auto_parallel/
engine.py).

Reference: python/paddle/distributed/auto_parallel/static/engine.py —
Engine.fit / evaluate / predict / prepare, and api.py — to_static ->
DistModel.  The reference's step is one GSPMD program: parameters carry
their shardings, the batch splits over the mesh's first axis, and XLA
partitions the program.

Single-controller design.  The port's step is eager, driven by this one
process over the mesh's :class:`Grid`:

* the model runs once on the whole batch; work on replicated weights (the
  norms, the rotary tables, the residual adds, any unsharded layer) runs
  once over all rows on the mesh's first device, held once;
* each sharded layer splits the rows over the mesh's first (data) axis,
  as the reference's ``_data_sharding`` does (a batch whose rows do not
  divide it is run as one group, replicated), and each (data, mp) rank
  runs its group's rows on its own piece of the weights:

  - a ``Linear`` split on its columns (``Shard(1)``): each rank's product
    with its columns (and its bias columns), gathered over the group;
  - a ``Linear`` split on its rows (``Shard(0)``): the input's last dim
    split to match, each rank's partial product, summed with ``psum``,
    then the bias;
  - an ``Embedding`` split on its hidden dim: each rank looks up its
    columns, gathered; split on its rows (vocab): masked lookups summed;
  - a module with a per-rank body whose layout matches
    (``RANK_COLUMNS`` / ``RANK_ROWS`` and ``forward_ranks``: the Llama
    decoder layer under ``llama_shard_fn``) runs that body;

  so vocab-split logits are gathered before the user's ``loss``, which
  takes the whole output;
* a ``Shard`` placement the port cannot run per rank (on another kind of
  module, on the data axis, over two mesh dims, a ``Partial``) raises,
  naming the module and the placement; nothing is quietly replicated;
* one ``backward()`` of the loss gives every gradient (pieces shared by
  the data groups sum their contributions: the data-parallel all-reduce),
  and the given optimizer, bound to the model, updates it in place.

The Strategy knobs: ``amp`` casts the f32 parameters (and f32 inputs) to
``amp.dtype`` for the forward, ``recompute`` recomputes the forward in
the backward (``distributed/recompute.remat_wrap``), ``gradient_merge``
accumulates ``k_steps`` gradients and updates once (their mean with
``avg``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ...nn.functional import embedding
from ...nn.layers import Embedding, Linear
from ...profiler import RecordEvent
from ..mesh import Mesh, all_gather, psum
from ..meta_parallel.mp_layers import sharded_row_take
from ..recompute import _dropout_generators, remat_wrap
from .api import _piece_index, local_pieces
from .placement import ProcessMesh, Replicate, Shard, placements_to_spec
from .strategy import Strategy

__all__ = ["Engine", "to_static", "DistModel"]


def _shard_axes(p) -> List[tuple]:
    """``[(mesh dim, Shard)]`` of a parameter's placements."""
    return [(i, pl) for i, pl in enumerate(getattr(p, "placements", None)
                                           or []) if isinstance(pl, Shard)]


class _Rule:
    """How one module runs per rank: ``kind`` (``column`` / ``row`` /
    ``embed_hidden`` / ``embed_vocab`` / ``ranks``), the mesh dim name,
    and its sharded parameters by the name the rule reads."""

    def __init__(self, kind: str, axis: str, params: Dict[str, str]):
        self.kind = kind
        self.axis = axis
        self.params = params
        # the placements a parameter's pieces are cut by, where they are
        # not its own
        self.cuts: Dict[str, list] = {}


class Engine:
    """Semi-auto training engine over one ProcessMesh.

    As in the reference: no separate partition phase (the first ``fit`` /
    ``evaluate`` call prepares); the mesh is ``process_mesh`` or the one
    the sharded parameters carry.  ``fit`` returns the step losses."""

    def __init__(self, model: nn.Module, loss: Optional[Callable] = None,
                 optimizer=None, metrics=None,
                 strategy: Optional[Strategy] = None,
                 process_mesh: Optional[ProcessMesh] = None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics is not None else [])
        self.strategy = strategy or Strategy()
        if process_mesh is None:
            process_mesh = next((p.process_mesh for p in model.parameters()
                                 if getattr(p, "process_mesh", None)
                                 is not None), None)
        self.process_mesh = process_mesh
        self._rules: Optional[Dict[nn.Module, _Rule]] = None
        self._bound = False
        self._merge_count = 0
        self._groups = 1
        self._pieces: Dict[str, list] = {}

    # ------------------------------------------------------------- layout
    @property
    def device(self) -> torch.device:
        if self.process_mesh is not None:
            return self.process_mesh.get_mesh().device(0)
        p = next(self.model.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _plan(self) -> Dict[nn.Module, _Rule]:
        """The per-rank rule of every module with a sharded parameter
        (made once); raises for a placement no rule runs."""
        if self._rules is not None:
            return self._rules
        rules: Dict[nn.Module, _Rule] = {}
        covered = set()
        mesh = self.process_mesh
        for mname, mod in self.model.named_modules():
            pre = f"{mname}." if mname else ""
            if mesh is None:
                break
            if id(mod) in covered:
                continue
            rule = self._rank_body_rule(mod, pre)
            if rule is None:
                rule = self._leaf_rule(mod, pre)
            if rule is not None:
                rules[mod] = rule
                covered.update(id(m) for m in mod.modules())
        seen = {n for r in rules.values() for n in r.params.values()}
        for name, p in self.model.named_parameters():
            pls = getattr(p, "placements", None) or []
            if any(pl.is_partial() for pl in pls):
                raise ValueError(f"parameter {name} has placements {pls}: a "
                                 f"Partial parameter has no per-rank rule")
            if _shard_axes(p) and name not in seen:
                raise ValueError(
                    f"parameter {name} has placements {pls}, and its module "
                    f"has no per-rank rule for them (the port runs a Linear "
                    f"split on its columns or rows, an Embedding split on "
                    f"either dim, and a module with forward_ranks under its "
                    f"RANK_COLUMNS / RANK_ROWS layout)")
        self._rules = rules
        return rules

    def _axis_of(self, name: str, p, want_dim: Optional[int] = None
                 ) -> Optional[str]:
        """The one non-data mesh dim a parameter is split on (None when it
        is not split); raises for a split the rules cannot run."""
        axes = _shard_axes(p)
        if not axes:
            return None
        mesh = self.process_mesh
        if len(axes) > 1 or axes[0][0] == 0:
            raise ValueError(
                f"parameter {name} has placements {p.placements}: the port "
                f"runs a parameter split over one mesh dim other than the "
                f"data dim {mesh.dim_names[0]!r}")
        i, pl = axes[0]
        if want_dim is not None and pl.dim % p.dim() != want_dim:
            return None
        return mesh.dim_names[i]

    def _rank_body_rule(self, mod: nn.Module, pre: str) -> Optional[_Rule]:
        cols = getattr(mod, "RANK_COLUMNS", None)
        rows = getattr(mod, "RANK_ROWS", None)
        if cols is None or rows is None or not hasattr(mod, "forward_ranks"):
            return None
        params = dict(mod.named_parameters())
        if not any(_shard_axes(p) for p in params.values()):
            return None
        axes = set()
        for names, dim in ((cols, 1), (rows, 0)):
            for n in names:
                p = params.get(f"{n}.weight")
                axis = None if p is None else \
                    self._axis_of(pre + n + ".weight", p, dim)
                axes.add(axis)
        layout = {f"{n}.weight" for n in cols + rows}
        extra = [n for n, p in params.items()
                 if n not in layout and _shard_axes(p)]
        if len(axes) != 1 or None in axes or extra:
            return None     # another layout: its leaves take their rules
        # the body's keys: q k v o gate up down (the sublayer names less
        # their "_proj")
        return _Rule("ranks", axes.pop(),
                     {n.split(".")[-2].replace("_proj", ""): pre + n
                      for n in sorted(layout)})

    def _leaf_rule(self, mod: nn.Module, pre: str) -> Optional[_Rule]:
        w = mod._parameters.get("weight")
        if not isinstance(mod, (Linear, Embedding)) or w is None \
                or not _shard_axes(w):
            return None
        axis = self._axis_of(pre + "weight", w)
        dim = _shard_axes(w)[0][1].dim % 2
        params = {"weight": pre + "weight"}
        if isinstance(mod, Embedding):
            return _Rule("embed_hidden" if dim == 1 else "embed_vocab", axis,
                         params)
        b = mod._parameters.get("bias")
        if b is not None and _shard_axes(b):
            b_axis = self._axis_of(pre + "bias", b)
            if dim == 0 or b_axis != axis:
                raise ValueError(
                    f"{pre}bias has placements {b.placements} beside the "
                    f"weight's {w.placements}: the port runs a bias split "
                    f"with its column-parallel weight's columns only")
        rule = _Rule("column" if dim == 1 else "row", axis, params)
        if b is not None and dim == 1:
            # the bias columns go with the weight's, placed or not
            params["bias"] = pre + "bias"
            pl = [Replicate()] * self.process_mesh.ndim
            pl[self.process_mesh.dim_names.index(axis)] = Shard(0)
            rule.cuts[pre + "bias"] = pl
        return rule

    # --------------------------------------------------------- per step
    def _rank_groups(self, axis: str) -> List[tuple]:
        """Per data group, ``(rows, ranks of its group along axis)``."""
        grid = self.process_mesh.get_mesh()
        data = self.process_mesh.dim_names[0]
        out = []
        for g in range(self._groups):
            rows = slice(None) if self._groups == 1 else \
                slice(g * self._rows, (g + 1) * self._rows)
            out.append((rows, grid.axis_ranks(axis, grid.rank(**{data: g}))))
        return out

    def _mesh(self, ranks) -> Mesh:
        grid = self.process_mesh.get_mesh()
        return Mesh([grid.device(r) for r in ranks])

    def _cut(self, eff: Dict[str, torch.Tensor]) -> None:
        """Each sharded parameter's per-rank pieces for this step, cut once
        from the tensor the forward uses (views where the ranks share its
        device): every data group reads the same pieces."""
        self._pieces.clear()
        for rule in self._rules.values():
            for n in rule.params.values():
                pl = rule.cuts.get(n) or self._param_by_name[n].placements
                self._pieces[n] = local_pieces(eff[n], self.process_mesh, pl)

    def _forward_of(self, mod: nn.Module, rule: _Rule) -> Callable:
        pieces, grid = self._pieces, self.process_mesh.get_mesh()
        w = rule.params

        def column(x):
            parts = []
            for rows, ranks in self._rank_groups(rule.axis):
                mesh = self._mesh(ranks)
                xs = mesh.replicate(x[rows])
                outs = []
                for xr, r in zip(xs, ranks):
                    y = torch.matmul(xr, pieces[w["weight"]][r])
                    if "bias" in w:
                        y = y + pieces[w["bias"]][r]
                    outs.append(y)
                parts.append(all_gather(outs, mesh, dim=-1)[0].to(x.device))
            return torch.cat(parts) if len(parts) > 1 else parts[0]

        def row(x):
            p = self._param_by_name[w["weight"]]
            spec = placements_to_spec(p.placements, 2,
                                      self.process_mesh.dim_names)
            parts = []
            for rows, ranks in self._rank_groups(rule.axis):
                mesh = self._mesh(ranks)
                outs = []
                for r, dev in zip(ranks, mesh.devices):
                    lo, hi = _piece_index(p.shape, spec, grid, r)[0]
                    outs.append(torch.matmul(x[rows][..., lo:hi].to(dev),
                                             pieces[w["weight"]][r]))
                parts.append(psum(outs, mesh)[0].to(x.device))
            y = torch.cat(parts) if len(parts) > 1 else parts[0]
            b = mod.bias
            return y if b is None else y + b

        def embed_hidden(ids):
            parts = []
            for rows, ranks in self._rank_groups(rule.axis):
                mesh = self._mesh(ranks)
                outs = [embedding(i, pieces[w["weight"]][r]) for i, r in
                        zip(mesh.replicate(ids[rows]), ranks)]
                parts.append(all_gather(outs, mesh, dim=-1)[0])
            return torch.cat([t.to(parts[0].device) for t in parts]) \
                if len(parts) > 1 else parts[0]

        def embed_vocab(ids):
            parts = []
            for rows, ranks in self._rank_groups(rule.axis):
                mesh = self._mesh(ranks)
                shards = [pieces[w["weight"]][r] for r in ranks]
                parts.append(sharded_row_take(shards, ids[rows], mesh)[0])
            return torch.cat([t.to(parts[0].device) for t in parts]) \
                if len(parts) > 1 else parts[0]

        def ranks_body(x, cos, sin, cache=None):
            if cache is not None:
                raise ValueError(f"{type(mod).__name__}.forward_ranks runs "
                                 f"the uncached training forward only")
            groups = []
            for rows, ranks in self._rank_groups(rule.axis):
                ws = [{k: pieces[n][r] for k, n in w.items()}
                      for r in ranks]
                groups.append((rows, ws, self._mesh(ranks)))
            return mod.forward_ranks(x, cos, sin, groups)

        return {"column": column, "row": row, "embed_hidden": embed_hidden,
                "embed_vocab": embed_vocab, "ranks": ranks_body}[rule.kind]

    def _install(self) -> None:
        for mod, rule in self._rules.items():
            mod.forward = self._forward_of(mod, rule)

    def _uninstall(self) -> None:
        for mod in self._rules:
            mod.__dict__.pop("forward", None)

    def _to_device(self, batch) -> tuple:
        dev = self.device
        amp = self.strategy.amp
        out = []
        for v in batch:
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            if amp.enable and t.dtype == torch.float32:
                from ...device import resolve_dtype
                t = t.to(resolve_dtype(amp.dtype))
            out.append(t.to(dev))
        return tuple(out)

    def _effective(self) -> Dict[str, torch.Tensor]:
        """The tensors the forward uses by name: the parameters, cast to
        ``amp.dtype`` where they are f32 under amp."""
        amp = self.strategy.amp
        eff = dict(self._param_by_name)
        if amp.enable:
            from ...device import resolve_dtype
            dt = resolve_dtype(amp.dtype)
            eff = {n: p.to(dt) if p.dtype == torch.float32 else p
                   for n, p in eff.items()}
        return eff

    def _forward(self, inputs: tuple, training: bool):
        """The model on ``inputs`` (the sharded layers per rank)."""
        mesh = self.process_mesh
        n = mesh.get_mesh().shape[mesh.dim_names[0]] if mesh else 1
        b = inputs[0].shape[0] if inputs and inputs[0].dim() else 0
        self._groups = n if n > 1 and b and b % n == 0 else 1
        self._rows = b // self._groups if self._groups else b
        eff = self._effective()
        if self._rules:
            self._cut(eff)
        fc = torch.func.functional_call

        def run(*a):
            return fc(self.model, eff, a)
        rc = self.strategy.recompute
        if training and rc.enable:
            run = remat_wrap(run, True if rc.policy == "full" else rc.policy,
                             generators=_dropout_generators(self.model))
        return run(*inputs)

    @staticmethod
    def _split_batch(batch):
        """(inputs, labels) from loader batches: (x, y), dict, or x."""
        if isinstance(batch, dict):
            labels = tuple(v for k, v in batch.items()
                           if k in ("label", "labels", "y"))
            inputs = tuple(v for k, v in batch.items()
                           if k not in ("label", "labels", "y"))
            return inputs, labels
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return tuple(batch[:-1]), (batch[-1],)
            return tuple(batch), ()
        return (batch,), ()

    # --------------------------------------------------------- public API
    def prepare(self, *args, **kwargs):
        """Plan the per-rank rules and bind the optimizer to the model's
        parameters (the reference compiles here; the port plans)."""
        self._param_by_name = dict(self.model.named_parameters())
        self._plan()
        if self.optimizer is not None and not self._bound:
            self.optimizer.bind(self.model)
            self._bound = True

    def _train_step(self, batch) -> torch.Tensor:
        inputs, labels = self._split_batch(batch)
        inputs, labels = self._to_device(inputs), self._to_device(labels)
        self.model.train()
        self._install()
        try:
            with RecordEvent("Engine.forward"):
                out = self._forward(inputs, True)
                loss = self.loss(out, *labels)
            with RecordEvent("Engine.backward"):
                loss.backward()
        finally:
            self._uninstall()
            self._pieces.clear()
        gm = self.strategy.gradient_merge
        k = int(gm.k_steps) if gm.enable else 1
        self._merge_count += 1
        if self._merge_count >= k:
            with RecordEvent("Engine.optimizer"):
                if k > 1 and gm.avg:
                    for p in self._param_by_name.values():
                        if p.grad is not None:
                            p.grad.div_(k)
                self.optimizer.step()
                self.optimizer.clear_grad()
            self._merge_count = 0
        return loss.detach().float()

    def fit(self, train_data, epochs: int = 1,
            batch_size: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, log_freq: int = 10,
            verbose: int = 0) -> List[float]:
        self.prepare()
        history = []     # device scalars, read once after the loop
        for epoch in range(epochs):
            for it, batch in enumerate(train_data):
                if steps_per_epoch is not None and it >= steps_per_epoch:
                    break
                history.append(self._train_step(batch))
                if verbose and it % log_freq == 0:
                    print(f"epoch {epoch} step {it}: loss "
                          f"{float(history[-1]):.4f}")
        return [float(v) for v in history]

    @torch.no_grad()
    def _eval_step(self, inputs: tuple, labels: tuple):
        inputs, labels = self._to_device(inputs), self._to_device(labels)
        self.model.eval()
        self._install()
        try:
            out = self._forward(inputs, False)
        finally:
            self._uninstall()
            self._pieces.clear()
        loss = self.loss(out, *labels) if self.loss and labels else None
        return loss, out, labels

    def evaluate(self, eval_data, steps: Optional[int] = None) -> dict:
        self.prepare()
        losses = []
        for m in self.metrics:
            m.reset()
        for it, batch in enumerate(eval_data):
            if steps is not None and it >= steps:
                break
            loss, out, labels = self._eval_step(*self._split_batch(batch))
            if loss is not None:
                losses.append(float(loss))
            if labels:
                for m in self.metrics:
                    m.update(m.compute(out, labels[0]))
        result = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self.metrics:
            n = m.name() if callable(getattr(m, "name", None)) else str(m)
            if isinstance(n, (list, tuple)):
                n = n[0]
            result[n] = m.accumulate()
        return result

    def predict(self, data, steps: Optional[int] = None) -> list:
        self.prepare()
        outs = []
        for it, batch in enumerate(data):
            if steps is not None and it >= steps:
                break
            inputs, _ = self._split_batch(batch)
            outs.append(self._eval_step(inputs, ())[1])
        return outs

    # state access (reference: Engine.save / load)
    def state_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.state_dict())

    def save(self, path: str) -> None:
        from ...framework.io import save
        save({"model": self.state_dict(),
              "opt": None if self.optimizer is None
              else self.optimizer.state_dict()}, path)

    @torch.no_grad()
    def load(self, path: str) -> None:
        from ...framework.io import load
        blob = load(path, device=self.device)
        for k, t in self.model.state_dict().items():
            if k in blob["model"]:
                t.copy_(blob["model"][k].to(t.dtype))
        if blob.get("opt") is not None and self.optimizer is not None:
            self.prepare()
            self.optimizer.set_state_dict(blob["opt"])


class DistModel:
    """Callable one-step wrapper (reference: api.py — DistModel returned by
    dist.to_static; ``__call__`` runs one train or eval step)."""

    def __init__(self, engine: Engine):
        self._engine = engine
        self._mode = "train"

    def train(self):
        self._mode = "train"

    def eval(self):
        self._mode = "eval"

    def state_dict(self):
        return self._engine.state_dict()

    def __call__(self, *batch):
        e = self._engine
        e.prepare()
        if self._mode == "train":
            return e._train_step(tuple(batch))
        loss, _, _ = e._eval_step(*e._split_batch(tuple(batch)))
        return loss


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              process_mesh=None) -> DistModel:
    """Reference: dist.to_static(layer, loader, loss, optimizer)."""
    return DistModel(Engine(layer, loss=loss, optimizer=optimizer,
                            strategy=strategy, process_mesh=process_mesh))
