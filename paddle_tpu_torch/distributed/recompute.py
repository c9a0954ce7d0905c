"""Recompute (activation checkpointing) (counterpart of
paddle_tpu/distributed/recompute.py).

The reference wraps a block in ``jax.checkpoint``; the port wraps it in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps only the block's inputs, and the backward runs the block's forward
again to rebuild what its gradient needs.  The kernels' ``autograd.
Function``s (flash attention, the fused norms) run again on the same
inputs, so each block launches its flash forward and its norm forwards
twice a step.

A policy name maps onto ``torch.utils.checkpoint.
create_selective_checkpoint_contexts``, which decides per ATen op what
the forward keeps:

  ``nothing_saveable``                   nothing: full recompute (``True``)
  ``everything_saveable``                every op's output: no recompute
  ``dots_saveable`` / ``checkpoint_dots`` the outputs of ``mm``, ``addmm``,
                                         ``bmm`` and ``baddbmm``
  ``dots_with_no_batch_dims_saveable`` /
  ``checkpoint_dots_with_no_batch_dims`` those of ``mm`` and ``addmm``

JAX's dot policies keep the ``dot_general`` outputs, with or without batch
dims; the port's projections reach ATen as ``mm`` / ``addmm`` on the
flattened rows, batched products as ``bmm``.  A hand-written kernel is
no ATen op, so, as a Pallas call under JAX's policies, it runs again.

Random state: JAX's keys are values, so a replayed block draws the same
dropout mask by construction.  The port draws dropout from explicit
generators, which have moved on by the time the backward replays a block;
:func:`remat_wrap` records the state of the generators of the block's
``Dropout`` modules (or of ``generators=``) at the forward and sets it
back around the replay, then restores it.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["recompute", "recompute_sequential", "remat_wrap",
           "resolve_remat_policy", "remat_from_env"]

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_DOTS_NO_BATCH = ("mm", "addmm")
_POLICY_OPS = {
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
    "nothing_saveable": (),
    "everything_saveable": None,        # every op
}
_POLICY_NAMES = tuple(_POLICY_OPS)


def resolve_remat_policy(name: str) -> Callable:
    """The selective-checkpoint policy ``(ctx, op, *args, **kwargs) ->
    CheckpointPolicy`` for ``name``.  An unknown name raises with the known
    ones (recompute.py:30: a silent fallback would change what a
    measurement measures)."""
    if name not in _POLICY_OPS:
        raise ValueError(
            f"unknown remat policy {name!r}; known: {', '.join(_POLICY_NAMES)}"
            " (or True for full checkpoint, False for none)")
    names = _POLICY_OPS[name]
    ops = None if names is None else {
        getattr(torch.ops.aten, n).default for n in names}

    def policy(ctx, op, *args, **kwargs):
        if ops is None or op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def remat_from_env(var: str = "BENCH_REMAT", default: str = "0"):
    """``'0'`` -> False, ``'1'`` -> True (full checkpoint), anything else
    -> a policy name (recompute.py:47)."""
    import os
    v = os.environ.get(var, default)
    return True if v == "1" else (False if v == "0" else v)


def _dropout_generators(*fns) -> List[torch.Generator]:
    """The generators the ``Dropout`` modules of ``fns`` (those that are
    modules) draw from, where they draw at all (p > 0, training)."""
    out = []
    for fn in fns:
        if not isinstance(fn, torch.nn.Module):
            continue
        for m in fn.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and m.training \
                    and getattr(m, "p", 0.0) > 0.0 \
                    and all(g is not h for h in out):
                out.append(g)
    return out


def _checkpointed(fn: Callable, args, kwargs, policy: Optional[str],
                  generators: Sequence[torch.Generator]):
    """``fn(*args, **kwargs)`` under the non-reentrant checkpoint, the
    replay drawing from ``generators`` as the forward did."""
    states = [g.get_state() for g in generators]
    replay = False

    def body(*a, **kw):
        nonlocal replay
        if not replay or not generators:
            replay = True
            return fn(*a, **kw)
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, states):
            g.set_state(s)
        try:
            return fn(*a, **kw)
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)
    extra = {}
    if policy is not None and policy != "nothing_saveable":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            resolve_remat_policy(policy))
    return checkpoint(body, *args, use_reentrant=False, **extra, **kwargs)


def remat_wrap(fn: Callable, remat,
               generators: Optional[Sequence[torch.Generator]] = None
               ) -> Callable:
    """Apply the remat knob (recompute.py:54): False -> ``fn``; True ->
    full recompute; a string names a policy (module docstring).  The
    wrapper recomputes only while autograd records (``torch.
    is_grad_enabled()``): a no-grad forward (serving, the cached decode
    path) calls ``fn`` itself."""
    if not remat:
        return fn
    policy = remat if isinstance(remat, str) else None
    if policy is not None:
        resolve_remat_policy(policy)          # an unknown name raises now
    gens = list(generators) if generators is not None \
        else _dropout_generators(fn)

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return _checkpointed(fn, args, kwargs, policy, gens)
    return wrapped


def recompute(function: Callable, *args, **kwargs):
    """``fleet.utils.recompute(fn, *args)``: run ``fn`` now, recompute its
    activations in the backward (recompute.py:64).  ``use_reentrant`` is
    accepted and the non-reentrant form always used; ``preserve_rng_state``
    is accepted (the global generators are preserved, and ``function``'s
    dropout generators replayed, as :func:`remat_wrap` does);
    ``checkpoint_policy`` is a policy name or None (full recompute)."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    policy = kwargs.pop("checkpoint_policy", None)
    return remat_wrap(function, policy or True)(*args, **kwargs)


def recompute_sequential(ctx: dict, functions: Sequence[Callable], *args):
    """``recompute_sequential({'segments': k}, layers, *args)``: the layers
    in ``k`` segments, each recomputed (recompute.py:79)."""
    segments = int(ctx.get("segments", 1)) if ctx else 1
    funcs = list(functions)
    n = len(funcs)
    per = max(n // max(segments, 1), 1)

    def seg_fn(fs):
        def run(*xs):
            out = xs
            for f in fs:
                out = f(*out) if isinstance(out, tuple) else f(out)
                out = out if isinstance(out, tuple) else (out,)
            return out[0] if len(out) == 1 else out
        return run

    out = args
    for i in range(0, n, per):
        out = out if isinstance(out, tuple) else (out,)
        fs = funcs[i:i + per]
        out = (remat_wrap(seg_fn(fs), True, _dropout_generators(*fs))(*out),)
    return out[0]
