"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

The reference's optimizers are pure ``update(grads, state, params)``
rules over pytrees, with a stateful ``step()`` for eager scripts.  The
port keeps the eager form only: an optimizer is bound to a module
(``bind(layer)`` or ``parameters=``), its state lives in the optimizer,
and ``step()`` updates the parameters in place from their ``.grad`` (or
from a ``grads`` dict keyed like ``named_parameters()``).

State names are the reference's: ``state["step"]`` (updates done),
``state["slots"][name]`` (``moment1`` / ``moment2`` for Adam),
``state["master"][name]`` (an f32 copy of a bf16/f16 parameter under
``multi_precision``, else None).  The update order is the reference's
(:105-125): the gradients are clipped (``grad_clip``, a clipper of
``optimizer/clip.py``), the update runs on the master when there is one,
with the gradient cast to f32, and the parameter is then cast back to its
dtype.  ``learning_rate`` is a float or a scheduler of
``optimizer/lr.py``; each step reads ``get_lr()`` (:170-178), and the
script steps the scheduler.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .clip import GradClipBase, TensorOf
from .lr import make_scheduler

__all__ = ["Optimizer"]


class Optimizer:
    """Base class.  Subclasses implement ``_init_slot(p)`` and
    ``_update_param(g, p, slots, lr, step) -> new_p`` (f32 math, slots
    updated in place), or override ``_apply`` for an in-place kernel."""

    # L2 handling: classic optimizers add weight_decay * p to the
    # gradient; AdamW decays decoupled from the update
    _l2_mode = "l2"

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False):
        if grad_clip is not None and not isinstance(grad_clip, GradClipBase):
            raise TypeError(f"grad_clip must be a clipper of optimizer.clip "
                            f"(ClipGradByGlobalNorm, ...), got "
                            f"{type(grad_clip).__name__}")
        self._lr_sched = make_scheduler(learning_rate)
        self.grad_clip = grad_clip
        self.weight_decay = (float(weight_decay)
                             if isinstance(weight_decay, (int, float))
                             else weight_decay)
        self.multi_precision = multi_precision
        self._params: Optional[List[Tuple[str, nn.Parameter]]] = None
        self._state: Optional[dict] = None
        if parameters is not None:
            self.bind(parameters)

    # ------------------------------------------------------------ binding
    def bind(self, layer: nn.Module) -> "Optimizer":
        """Bind to a module's parameters (names from ``named_parameters``).
        Drops any state of an earlier binding."""
        self._params = list(layer.named_parameters())
        self._state = None
        return self

    def _bound(self) -> List[Tuple[str, nn.Parameter]]:
        if self._params is None:
            raise ValueError("Optimizer.step() needs bind(layer) or "
                             "parameters= first")
        return self._params

    @property
    def state(self) -> dict:
        """``{"step": int, "slots": {name: {...}}, "master": {name:
        Tensor or None}}``, created at the first ``step()``."""
        if self._state is None:
            self._state = self._init_state(self._bound())
        return self._state

    def _init_state(self, params) -> dict:
        return {"step": 0,
                "slots": {n: self._init_slot(p) for n, p in params},
                "master": {n: self._master_of(p) for n, p in params}}

    def _master_of(self, p) -> Optional[torch.Tensor]:
        if self.multi_precision and p.dtype in (torch.float16,
                                                torch.bfloat16):
            return p.detach().float().clone()
        return None

    # ------------------------------------------------- per-tensor state
    # The hybrid trainer keeps its own state per rank block (a ZeRO slice
    # of a parameter, or the whole one) and updates each block in place.
    def init_tensor_state(self, p: torch.Tensor
                          ) -> Tuple[dict, Optional[torch.Tensor]]:
        """``(slots, master)`` for one tensor, as ``step()`` keeps them per
        bound parameter."""
        return self._init_slot(p), self._master_of(p)

    @torch.no_grad()
    def update_tensor(self, name: str, p: torch.Tensor, g: torch.Tensor,
                      slots: dict, master: Optional[torch.Tensor],
                      step: int, lr: float) -> None:
        """One update of ``p`` (a view included) from ``g`` in place, with
        the state of :meth:`init_tensor_state`; ``step`` counts the updates
        done before.  The caller has clipped ``g`` and read ``lr`` for this
        step (the hybrid trainer: ``get_lr()`` once a step)."""
        self._apply(name, p, g, slots, master, lr, step)

    # ------------------------------------------------------------ decay
    def _decay_coef(self) -> float:
        """The decay coefficient: a float, or an L2Decay-style object's
        ``coeff``."""
        wd = self.weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, float):
            return wd
        return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))

    def _should_decay(self, name: str) -> bool:
        return True

    # ------------------------------------------------------------ update
    @torch.no_grad()
    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None,
             tensor_of: Optional[TensorOf] = None) -> None:
        """One update of every bound parameter that has a gradient, in
        place: ``grads[name]`` when a dict is given, else ``p.grad``.  The
        gradients are clipped first, all of them under one global norm
        (``tensor_of``: the groups of ``clip.py``; the trainer passes the
        reference trainer's two), one at a time before its update; then
        the update at ``get_lr()``."""
        state = self.state
        t = state["step"]
        have = {}
        for name, p in self._bound():
            g = p.grad if grads is None else grads.get(name)
            if g is not None:
                have[name] = (p, g)
        clip = self.grad_clip
        scales = clip.scales({n: g for n, (_, g) in have.items()},
                             tensor_of) if clip is not None else None
        lr = self.get_lr()
        for name, (p, g) in have.items():
            if clip is not None:
                g = clip.clip_one(g, scales[name])
            self._apply(name, p, g, state["slots"][name],
                        state["master"][name], lr, t)
        state["step"] = t + 1

    def _apply(self, name, p, g, slots, master, lr, step) -> None:
        compute_p = master if master is not None else p
        g32 = g.float() if master is not None else g
        l2 = self._decay_coef()
        if l2 and self._l2_mode == "l2":
            g32 = g32 + l2 * compute_p
        new_p = self._update_param(g32, compute_p, slots, lr, step)
        if l2 and self._l2_mode == "decoupled" and self._should_decay(name):
            new_p = new_p.float() - lr * l2 * compute_p.float()
        if master is not None:
            master.copy_(new_p)
        p.copy_(new_p)

    def _init_slot(self, p) -> dict:
        return {}

    def _update_param(self, g, p, slots, lr, step):
        raise NotImplementedError

    def clear_grad(self) -> None:
        """Drop the bound parameters' gradients."""
        for _, p in self._bound():
            p.grad = None

    # ------------------------------------------------------------ rate
    def get_lr(self) -> float:
        return self._lr_sched.get_lr()

    def set_lr(self, value: float) -> None:
        """A constant rate from now on (replaces a scheduler)."""
        self._lr_sched = make_scheduler(float(value))

    def state_dict(self) -> dict:
        """``{"state": the state (None before the first step), "lr": the
        scheduler's state}`` (optimizer.py:211-216)."""
        return {"state": self._state, "lr": self._lr_sched.state_dict()}

    def set_state_dict(self, sd: dict) -> None:
        if "state" in sd:
            self._state = sd["state"]
        if "lr" in sd:
            self._lr_sched.set_state_dict(sd["lr"])
