"""Parameter sharding specs and layouts over the rank grid (counterpart of
paddle_tpu/distributed/sharding_utils.py).

A spec is the reference's ``PartitionSpec``: one entry per dim, ``None``
(whole), an axis name, or a tuple of axis names whose degrees multiply
(the first axis major, as in JAX).  A sharded value is the per-rank list
of tensors, rank ``r``'s block on ``grid.device(r)``; ranks that hold the
same block on one device share one tensor (a value is held once per
device, ``Mesh.replicate``'s rule).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import Grid

__all__ = ["P", "ShardedTensor", "set_param_spec", "get_param_specs",
           "spec_axes", "shard_index", "shard_block", "shard_state",
           "shard_opt_state_specs", "zero_dim"]


class P(tuple):
    """``P(None, "mp")``: the reference's ``PartitionSpec`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass
class ShardedTensor:
    """A global tensor of ``shape`` held in ``pieces``, each ``(global
    offset, local tensor)``, every element in exactly one piece: a value
    whose replicas are listed once (what the shard-aware checkpoint writes,
    and the layout it loads into)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    pieces: List[Tuple[Tuple[int, ...], torch.Tensor]]


def set_param_spec(layer, name: str, spec: P) -> None:
    """Record the spec of ``layer``'s parameter ``name``."""
    layer.__dict__.setdefault("_param_specs", {})[name] = spec


def get_param_specs(layer, prefix: str = "") -> Dict[str, P]:
    """Dotted parameter name -> spec for every parameter (default
    ``P()``, replicated)."""
    out = {}
    for lname, sub in layer.named_modules(prefix=prefix):
        specs = sub.__dict__.get("_param_specs", {})
        for pname, p in sub._parameters.items():
            if p is not None:
                out[f"{lname}.{pname}" if lname else pname] = \
                    specs.get(pname, P())
    return out


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry names (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(spec: Sequence, ndim: int, grid: Grid,
                rank: int) -> Tuple[Tuple[int, int], ...]:
    """Per dim, ``(block index, block count)`` of ``rank``'s block."""
    coord, shape = grid.coord(rank), grid.shape
    out = []
    for d in range(ndim):
        idx, count = 0, 1
        for a in spec_axes(spec[d] if d < len(spec) else None):
            idx, count = idx * shape[a] + coord[a], count * shape[a]
        out.append((idx, count))
    return tuple(out)


def shard_block(t: torch.Tensor, index: Tuple[Tuple[int, int], ...]
                ) -> torch.Tensor:
    """The block ``index`` (from :func:`shard_index`) of ``t`` as a view;
    every split must be even."""
    for d, (i, n) in enumerate(index):
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of size {t.shape[d]} does not split "
                             f"evenly into {n} blocks")
        step = t.shape[d] // n
        t = t.narrow(d, i * step, step)
    return t


def shard_state(grid: Grid, tree, specs):
    """Lay out each tensor of ``tree`` (a tensor, or nested dicts / lists
    of them) with its spec from ``specs`` (the same structure, or one spec
    for all): each leaf becomes the per-rank list of its blocks, one
    contiguous tensor per distinct (device, block)."""
    if isinstance(tree, dict):
        return {k: shard_state(grid, v, specs[k] if isinstance(specs, dict)
                               else specs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        ss = specs if isinstance(specs, (list, tuple)) \
            and not isinstance(specs, P) else [specs] * len(tree)
        return type(tree)(shard_state(grid, v, s) for v, s in zip(tree, ss))
    if tree is None:
        return None
    spec = specs if isinstance(specs, P) else P()
    held: Dict[tuple, torch.Tensor] = {}
    out: List[torch.Tensor] = []
    for r in range(grid.size):
        idx = shard_index(spec, tree.dim(), grid, r)
        key = (grid.device(r), idx)
        if key not in held:
            held[key] = shard_block(tree, idx).to(grid.device(r)).contiguous()
        out.append(held[key])
    return out


def shard_opt_state_specs(param_specs: Dict[str, P],
                          param_shapes: Dict[str, tuple], axis: str,
                          degree: int) -> Dict[str, P]:
    """ZeRO's slot specs (sharding_utils.py:102): each slot split over
    ``axis`` along the first dim divisible by ``degree`` that no other
    axis splits; a tensor with no such dim keeps its spec."""
    out = {}
    for name, spec in param_specs.items():
        shape = param_shapes[name]
        spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        dim = zero_dim(shape, spec_t, degree)
        if dim is None:
            out[name] = P(*spec_t)
            continue
        new = list(spec_t)
        new[dim] = axis
        out[name] = P(*new)
    return out


def zero_dim(shape: Sequence[int], spec: Sequence,
             degree: int) -> Optional[int]:
    """The dim :func:`shard_opt_state_specs` splits, or None."""
    for i, s in enumerate(shape):
        if (spec[i] if i < len(spec) else None) is None \
                and s % degree == 0 and s >= degree:
            return i
    return None
