"""Gradient clipping (counterpart of paddle_tpu/optimizer/clip.py):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` over
a dict of gradients.

The reference's rounding: a norm is summed in f32, and a scaled gradient
is ``g`` in f32 times the scale, cast back to ``g``'s dtype (clip.py:55-57,
:66-69).  The scale stays a device tensor: no clipper reads anything back
to the host.

A clipper works in two steps, so that a caller can clip one tensor at a
time after one pass over all of them: :meth:`GradClipBase.scales` takes
the norms (``None`` where a clipper has none), :meth:`GradClipBase.clip_one`
clips one gradient with its scale; ``clipper(grads)`` does both.  Where a
caller holds a tensor in pieces (the hybrid trainer's rank blocks),
``tensor_of(name) -> (group, tensor)`` names, for each entry, the
reference's ``update`` call it belongs to (each call takes its own global
norm) and the reference tensor it is a piece of (the pieces of one tensor
share a per-tensor norm); every element must be in exactly one entry.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

__all__ = ["GradClipBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grads"]

TensorOf = Callable[[str], Tuple[Hashable, Hashable]]


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``g``, accumulated in f32."""
    return torch.linalg.vector_norm(g, dtype=torch.float32).square()


def _norm_scales(grads: Dict[str, torch.Tensor], key: Callable[[str], Hashable],
                 clip_norm: float) -> Dict[str, torch.Tensor]:
    """Per entry, ``min(1, clip_norm / max(norm, 1e-12))`` in f32 of the
    group ``key(name)`` it falls in, on the device of its first entry."""
    sums: Dict[Hashable, torch.Tensor] = {}
    for name, g in grads.items():
        k = key(name)
        s = _sum_sq(g)
        sums[k] = s if k not in sums else sums[k] + s.to(sums[k].device)
    scales = {k: torch.clamp(clip_norm / torch.clamp(s.sqrt(), min=1e-12),
                             max=1.0) for k, s in sums.items()}
    return {name: scales[key(name)] for name in grads}


class GradClipBase:
    """A clipper of a dict of gradients."""

    def scales(self, grads: Dict[str, torch.Tensor],
               tensor_of: Optional[TensorOf] = None
               ) -> Dict[str, Optional[torch.Tensor]]:
        """Per entry, what :meth:`clip_one` needs besides the gradient."""
        return {name: None for name in grads}

    def clip_one(self, g: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, grads: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        s = self.scales(grads)
        return {name: self.clip_one(g, s[name]) for name, g in grads.items()}


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale.to(g.device)).to(g.dtype)


class ClipGradByValue(GradClipBase):
    """Each element clamped into ``[min, max]`` (``min`` defaults to
    ``-max``), in the gradient's dtype."""

    def __init__(self, max: float, min: Optional[float] = None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_one(self, g, scale):
        return g.clamp(self.min, self.max)


class ClipGradByNorm(GradClipBase):
    """Each tensor scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def scales(self, grads, tensor_of=None):
        key = (lambda n: n) if tensor_of is None else tensor_of
        return _norm_scales(grads, key, self.clip_norm)

    def clip_one(self, g, scale):
        return _scaled(g, scale)


class ClipGradByGlobalNorm(GradClipBase):
    """Every gradient scaled by ``min(1, clip_norm / global norm)``: one
    norm over all of them, or one per group of ``tensor_of`` (the clip of
    the reference's GPT configs)."""

    def __init__(self, clip_norm: float = 1.0,
                 group_name: str = "default_group",
                 auto_skip_clip: bool = False):
        self.clip_norm = float(clip_norm)

    def scales(self, grads, tensor_of=None):
        key = (lambda n: None) if tensor_of is None else \
            (lambda n: tensor_of(n)[0])
        return _norm_scales(grads, key, self.clip_norm)

    def clip_one(self, g, scale):
        return _scaled(g, scale)


def clip_grads(grads: Dict[str, torch.Tensor],
               clip: Optional[GradClipBase]) -> Dict[str, torch.Tensor]:
    return grads if clip is None else clip(grads)
