"""Semi-auto parallel eager API (counterpart of
paddle_tpu/distributed/auto_parallel/api.py).

Reference: python/paddle/distributed/auto_parallel/api.py — shard_tensor,
dtensor_from_fn, reshard, shard_layer, shard_optimizer, unshard_dtensor.

Single-controller design.  One process drives every rank of the mesh, so
a dist tensor is a torch tensor holding the GLOBAL value once, on the
mesh's first device, with its ``process_mesh`` and ``placements`` as
attributes; :func:`local_pieces` gives rank ``r``'s piece (views of the
one tensor where ranks share its device, copies on another device).
Where ranks share a device nothing is stored twice (the hybrid trainer's
rule).  ``Partial`` is the exception: each rank holds the partial value
(``x / n`` for sum / avg, ``x`` for max / min, held once), and a reshard
reduces the ranks' pieces with ``mesh.psum`` (or the max / min) over the
partial mesh dims.

LIMITATION, as in the reference (api.py:34-45): partial-ness rides on the
handle only.  A tensor derived from a partial one (``y = d * 2``) carries
no placements, and reshard(y) does not reduce it again.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..mesh import Mesh, psum
from ..sharding_utils import spec_axes
from .placement import (Partial, Placement, ProcessMesh, Replicate, Shard,
                        compute_placements_spec, placements_to_spec)

__all__ = ["shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "shard_optimizer", "unshard_dtensor", "get_placements",
           "shard_dataloader", "set_mesh", "get_mesh", "local_pieces",
           "is_dist_tensor"]


def is_dist_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and \
        getattr(x, "process_mesh", None) is not None


def _annotate(t: torch.Tensor, mesh: ProcessMesh,
              placements: List[Placement]) -> torch.Tensor:
    t.process_mesh = mesh
    t.placements = list(placements)
    return t


def _as_tensor(data, dtype) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        x = data
    else:
        x = torch.as_tensor(np.asarray(data))
    if dtype is not None:
        from ...device import resolve_dtype
        x = x.to(resolve_dtype(dtype))
    return x


def _place(x: torch.Tensor, data, mesh: ProcessMesh,
           placements: List[Placement],
           stop_gradient: Optional[bool]) -> torch.Tensor:
    """``x`` on the mesh's first device as a new tensor object: a
    Parameter stays a Parameter (sharing its storage where it already
    lies there), anything else keeps its autograd history."""
    out = x.to(mesh.get_mesh().device(0))
    if isinstance(data, nn.Parameter):
        out = nn.Parameter(out.detach(), requires_grad=data.requires_grad
                           if stop_gradient is None else not stop_gradient)
    elif out is data:
        out = out.view_as(out)
    if not isinstance(out, nn.Parameter) and stop_gradient is not None:
        out = out.detach().requires_grad_(not stop_gradient)
    return _annotate(out, mesh, placements)


def _partial_share(x: torch.Tensor, mesh: ProcessMesh,
                   placements: List[Placement]) -> torch.Tensor:
    """Each rank's partial value: ``x / n`` for sum / avg over the ``n``
    ranks of the partial dims, ``x`` for max / min."""
    dims = [i for i, p in enumerate(placements) if p.is_partial()]
    n = int(np.prod([mesh.shape[i] for i in dims]))
    rt = placements[dims[0]].reduce_type
    if rt not in ("sum", "avg", "max", "min"):
        raise ValueError(f"unknown reduce_type {rt!r}")
    return x / n if rt in ("sum", "avg") else x


def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, stop_gradient: Optional[bool] = None
                 ) -> torch.Tensor:
    """Place ``data`` on ``mesh`` with ``placements`` (reference:
    auto_parallel/api.py — shard_tensor).  Partial placements split the
    value so the ranks reduce back to it (sum / avg) or replicate it
    (max / min)."""
    x = _as_tensor(data, dtype)
    _, placements = compute_placements_spec(x.dim(), mesh, placements)
    if any(p.is_partial() for p in placements):
        x = _partial_share(x, mesh, placements)
    return _place(x, data, mesh, placements, stop_gradient)


def get_placements(x) -> List[Placement]:
    """The placements of a dist tensor (reference: Tensor.placements)."""
    if not is_dist_tensor(x):
        raise ValueError("not a dist tensor (no process_mesh / placements)")
    return list(x.placements)


def _block(n: int, i: int, k: int) -> tuple:
    """``[lo, hi)`` of block ``i`` of ``k`` over ``n`` elements: blocks of
    ``ceil(n / k)``, the last ones shorter or empty (GSPMD's padding)."""
    size = -(-n // k)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


def _piece_index(shape, spec, grid, rank) -> tuple:
    """Per tensor dim, ``[lo, hi)`` of rank ``rank``'s piece."""
    coord, dims = grid.coord(rank), grid.shape
    out = []
    for d, n in enumerate(shape):
        idx, count = 0, 1
        for a in spec_axes(spec[d]):
            idx, count = idx * dims[a] + coord[a], count * dims[a]
        out.append(_block(n, idx, count))
    return tuple(out)


def local_pieces(x: torch.Tensor, mesh: Optional[ProcessMesh] = None,
                 placements: Optional[Sequence[Placement]] = None
                 ) -> List[torch.Tensor]:
    """Each grid rank's piece of ``x`` (its placements by default), in
    grid rank order: views of ``x`` on its own device, one copy per
    (piece, device) elsewhere.  A Partial dim gives every rank the handle's
    value (its partial share)."""
    mesh = mesh if mesh is not None else x.process_mesh
    placements = list(placements if placements is not None
                      else x.placements)
    grid = mesh.get_mesh()
    spec = placements_to_spec(placements, x.dim(), mesh.dim_names)
    index = [_piece_index(x.shape, spec, grid, r) for r in range(grid.size)]
    split = [d for d in range(x.dim())
             if any(ix[d] != (0, x.shape[d]) for ix in index)]
    if len(split) == 1:
        # one split dim: one split op, whose backward is one concatenation
        # of the pieces' gradients
        d = split[0]
        bounds = sorted({ix[d] for ix in index})
        parts = dict(zip(bounds, torch.split(
            x, [hi - lo for lo, hi in bounds], dim=d)))
    made = {}
    out = []
    for r in range(grid.size):
        key = (index[r], grid.device(r))
        if key not in made:
            if len(split) == 1:
                t = parts[index[r][split[0]]]
            else:
                t = x
                for d, (lo, hi) in enumerate(index[r]):
                    if (lo, hi) != (0, x.shape[d]):
                        t = t.narrow(d, lo, hi - lo)
            made[key] = t.to(key[1])
        out.append(made[key])
    return out


def _assemble(pieces: List[torch.Tensor], mesh: ProcessMesh,
              placements: List[Placement], shape) -> torch.Tensor:
    """The global tensor of ``shape`` from the ranks' pieces (replicas
    write the same values), on the mesh's first device."""
    grid = mesh.get_mesh()
    spec = placements_to_spec(placements, len(shape), mesh.dim_names)
    home = grid.device(0)
    out = torch.empty(shape, dtype=pieces[0].dtype, device=home)
    for r, p in enumerate(pieces):
        idx = _piece_index(shape, spec, grid, r)
        out[tuple(slice(lo, hi) for lo, hi in idx)] = p.to(home)
    return out


def _reduce_partial(x: torch.Tensor) -> tuple:
    """``(global value, placements)`` of a partial handle with its pending
    reduction done: the ranks' pieces reduced over each partial mesh dim in
    turn (``mesh.psum`` for sum / avg, the max / min otherwise), the
    partial dims then Replicate (the reference's PToR reshard)."""
    mesh, placements = x.process_mesh, list(x.placements)
    grid = mesh.get_mesh()
    pieces = local_pieces(x)
    for i, p in enumerate(placements):
        if not p.is_partial():
            continue
        axis = mesh.dim_names[i]
        reduced = []
        for r in range(grid.size):
            ranks = grid.axis_ranks(axis, r)
            group = [pieces[s] for s in ranks]
            if p.reduce_type in ("sum", "avg"):
                val = psum(group, Mesh([grid.device(s) for s in ranks]))
                reduced.append(val[ranks.index(r)])
            else:
                fn = torch.maximum if p.reduce_type == "max" \
                    else torch.minimum
                acc = group[0]
                for t in group[1:]:
                    acc = fn(acc, t.to(acc.device))
                reduced.append(acc.to(grid.device(r)))
        pieces = reduced
        placements[i] = Replicate()
    return _assemble(pieces, mesh, placements, x.shape), placements


def reshard(x, mesh: ProcessMesh, placements: Sequence[Placement]):
    """Change a dist tensor's placements (reference: dist.reshard).  A
    pending Partial is reduced first; a Partial target splits the value
    again (divides for sum / avg).  Shard / Replicate changes only the
    pieces the ranks read: the global value is held once."""
    if is_dist_tensor(x) and any(p.is_partial() for p in x.placements):
        x, _ = _reduce_partial(x)
    x = _as_tensor(x, None)
    _, placements = compute_placements_spec(x.dim(), mesh, placements)
    if any(p.is_partial() for p in placements):
        x = _partial_share(x, mesh, placements)
    out = x.to(mesh.get_mesh().device(0))
    if out is x:
        out = out.view_as(out)
    return _annotate(out, mesh, placements)


def unshard_dtensor(x):
    """The global value, replicated (reference: unshard_dtensor)."""
    if not is_dist_tensor(x):
        return x
    mesh = x.process_mesh
    if any(p.is_partial() for p in x.placements):
        val, _ = _reduce_partial(x)
    else:
        val = x.view_as(x)
    return _annotate(val, mesh, [Replicate()] * mesh.ndim)


def dtensor_from_fn(fn: Callable, mesh: ProcessMesh,
                    placements: Sequence[Placement], *args, **kwargs):
    """A dist tensor from a creation function (reference:
    dtensor_from_fn): ``fn(*args, **kwargs)`` made once (the global value
    is held once) and placed."""
    if any(p.is_partial() for p in placements):
        raise ValueError("dtensor_from_fn does not accept Partial placements")
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def shard_layer(layer: nn.Module, process_mesh: ProcessMesh,
                shard_fn: Optional[Callable] = None,
                input_fn: Optional[Callable] = None,
                output_fn: Optional[Callable] = None) -> nn.Module:
    """Shard a module's parameters in place (reference: dist.shard_layer).

    ``shard_fn(sublayer_name, sublayer, process_mesh)`` replaces the
    sublayer's parameters by ``shard_tensor`` results; by default every
    parameter is replicated.  ``input_fn(inputs, mesh)`` and
    ``output_fn(outputs, mesh)`` become forward pre / post hooks."""
    def default_shard_fn(name, sub, mesh):
        for pname, p in list(sub._parameters.items()):
            if p is not None and not is_dist_tensor(p):
                sub._parameters[pname] = shard_tensor(
                    p, mesh, [Replicate()] * mesh.ndim)

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_modules():
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


def shard_optimizer(optimizer, shard_fn: Optional[Callable] = None):
    """Let ``shard_fn(slot_name, param, slot)`` place each optimizer slot
    (``moment1``, ``moment2``, ``master``) as it is made (reference:
    dist.shard_optimizer).  The slots already live beside their parameter;
    without ``shard_fn`` the optimizer is returned as it is."""
    if shard_fn is None:
        return optimizer
    orig = optimizer._init_state

    def init_state(params):
        st = orig(params)
        for name, p in params:
            st["slots"][name] = {k: shard_fn(k, p, v)
                                 for k, v in st["slots"][name].items()}
            m = st["master"][name]
            if m is not None:
                st["master"][name] = shard_fn("master", p, m)
        return st

    optimizer._init_state = init_state
    return optimizer


def shard_dataloader(dataloader, meshes, shard_dims=None, input_keys=None):
    """Wrap a loader so each batch tensor is placed on the mesh split on
    its first dim over ``shard_dims`` (reference: dist.shard_dataloader);
    a batch whose rows do not divide the dim stays replicated."""
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes
    dim = shard_dims if isinstance(shard_dims, str) else (
        shard_dims[0] if shard_dims else mesh.dim_names[0])

    class _ShardedLoader:
        def __init__(self, dl):
            self._dl = dl

        def __len__(self):
            return len(self._dl)

        def __iter__(self):
            axis = mesh.dim_names.index(dim)
            n = mesh.shape[axis]
            for batch in self._dl:
                def place(x):
                    x = _as_tensor(x, None)
                    pl = [Replicate()] * mesh.ndim
                    if x.dim() and x.shape[0] % n == 0:
                        pl[axis] = Shard(0)
                    return shard_tensor(x, mesh, pl)
                if isinstance(batch, dict):
                    yield {k: place(v) for k, v in batch.items()}
                elif isinstance(batch, (list, tuple)):
                    yield type(batch)(place(v) for v in batch)
                else:
                    yield place(batch)

    return _ShardedLoader(dataloader)


# the process-global default mesh (reference: paddle.distributed.set_mesh /
# get_mesh)
_GLOBAL_MESH = [None]


def set_mesh(mesh):
    _GLOBAL_MESH[0] = mesh
    return mesh


def get_mesh():
    return _GLOBAL_MESH[0]
