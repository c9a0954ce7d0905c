"""Pipeline-parallel schedules over microbatches (counterpart of
paddle_tpu/distributed/pipelining.py).

The reference runs the whole schedule as one SPMD program: a scan over
``M + S - 1`` ticks (``M·V + S - 1`` under VPP) in which every stage runs
its body on every tick, bubbles included, and throws the bubble results
away.  The port drives every stage from one controller, so it runs only
the ``S·M`` (stage, microbatch) pairs that carry data (``S·V·M`` chunk
calls under VPP): microbatch ``m`` enters stage 0, each stage applies its
blocks and hands the activation to the next stage (``hop``, the
reference's ``ppermute``: the tensor itself when both stages share a
device, a copy onto the next stage's device otherwise).  The results are
the reference's: a stage's output depends only on its input and its
weights, and autograd through the calls and hops gives the backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

__all__ = ["pipeline_apply", "pipeline_apply_interleaved",
           "stack_stage_params", "stack_interleaved_stage_params"]

Params = Union[Dict[str, torch.Tensor], Sequence[Any]]


def stack_stage_params(per_stage_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """``[{name: t}, ...]`` per stage -> ``{name: t[S, ...]}`` stacked."""
    return {name: torch.stack([p[name] for p in per_stage_params])
            for name in per_stage_params[0]}


def stack_interleaved_stage_params(per_chunk_params, n_stages: int,
                                   n_chunks: int) -> Dict[str, torch.Tensor]:
    """``[{name: t}, ...]`` for the ``S·V`` chunks in global order ->
    ``{name: t[S·V, ...]}`` with stage ``s``'s round-robin chunks ``{s,
    s+S, ..., s+(V-1)S}`` at the contiguous rows ``[s·V, (s+1)·V)`` (the
    reference's VPP placement)."""
    S, V = n_stages, n_chunks
    order = [v * S + s for s in range(S) for v in range(V)]
    return {name: torch.stack([per_chunk_params[c][name] for c in order])
            for name in per_chunk_params[0]}


def _slots(params: Params, n: int, rows: bool = False) -> List[Any]:
    """``n`` equal slices of a stacked dict's leading dim (its ``n`` rows
    with ``rows``), or the ``n`` entries of a sequence."""
    if isinstance(params, dict):
        out = []
        for i in range(n):
            part = {}
            for k, v in params.items():
                step = v.shape[0] // n
                part[k] = v[i] if rows else v[i * step:(i + 1) * step]
            out.append(part)
        return out
    if len(params) != n:
        raise ValueError(f"{len(params)} parameter entries for {n} slots")
    return list(params)


def _microbatches(xs) -> List[Any]:
    return list(xs.unbind(0)) if isinstance(xs, torch.Tensor) else list(xs)


def pipeline_apply(stage_fn: Callable, stacked_params: Params,
                   x_microbatches, n_stages: int,
                   hop: Optional[Callable] = None) -> List[Any]:
    """Run ``stage_fn(params_of_stage, x) -> y`` as an ``n_stages``-stage
    pipeline.  ``stacked_params`` is a dict of ``[L, ...]`` tensors (stage
    ``s`` gets rows ``[s·L/S, (s+1)·L/S)``) or one entry per stage;
    ``x_microbatches`` is ``[M, mb, ...]`` or a sequence of ``M`` values.
    ``hop(x, s)`` places an activation for stage ``s`` (default: as it
    is).  Returns the last stage's ``M`` outputs; ``stage_fn`` runs
    ``S·M`` times."""
    stages = _slots(stacked_params, n_stages)
    out = []
    for x in _microbatches(x_microbatches):
        for s, params in enumerate(stages):
            if hop is not None:
                x = hop(x, s)
            x = stage_fn(params, x)
        out.append(x)
    return out


def pipeline_apply_interleaved(stage_fn: Callable, stacked_params: Params,
                               x_microbatches, n_stages: int, n_chunks: int,
                               hop: Optional[Callable] = None) -> List[Any]:
    """The interleaved (VPP) schedule: ``S`` stages with ``V`` chunks each,
    chunk ``c`` on stage ``c % S``.  ``stacked_params`` holds the ``S·V``
    chunks in :func:`stack_interleaved_stage_params` order (a dict of
    ``[S·V, K, ...]`` tensors, a chunk a row, or ``S·V`` entries);
    ``stage_fn(chunk_params, x)`` runs one chunk.  Microbatch ``m`` passes
    chunks ``0 .. S·V-1`` in turn.  Needs ``M % S == 0``, as the reference.  Returns the last
    chunk's ``M`` outputs; ``stage_fn`` runs ``S·V·M`` times."""
    S, V = n_stages, n_chunks
    xs = _microbatches(x_microbatches)
    if len(xs) % S:
        raise ValueError(f"interleaved schedule needs microbatches "
                         f"({len(xs)}) divisible by pp degree ({S})")
    slots = _slots(stacked_params, S * V, rows=True)
    out = []
    for x in xs:
        for c in range(S * V):
            s, v = c % S, c // S
            if hop is not None:
                x = hop(x, s)
            x = stage_fn(slots[s * V + v], x)
        out.append(x)
    return out
