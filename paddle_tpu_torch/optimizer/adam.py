"""Adam family (counterpart of paddle_tpu/optimizer/adam.py): ``Adam``,
``AdamW`` with the reference's decoupled decay (plain PyTorch, as the
reference's default is XLA), and ``FusedAdamW``, whose per-tensor update is
one launch of the fused AdamW kernel (``kernels/fused_adamw.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..kernels.fused_adamw import fused_adamw
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "FusedAdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slot(self, p):
        return {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device),
                "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)}

    def _update_param(self, g, p, slots, lr, step):
        """adam.py:34-43 in f32; the moments are updated in place."""
        f = np.float32
        g32 = g.float()
        t = f(step) + f(1.0)
        m, v = slots["moment1"], slots["moment2"]
        m.copy_(self.beta1 * m + (1 - self.beta1) * g32)
        v.copy_(self.beta2 * v + (1 - self.beta2) * g32.square())
        m_hat = m / float(f(1.0) - f(self.beta1) ** t)
        v_hat = v / float(f(1.0) - f(self.beta2) ** t)
        upd = lr * m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return (p.float() - upd).to(p.dtype)


class AdamW(Adam):
    """Decoupled weight decay (paddle semantics: ``p -= lr * coeff * p``
    after the Adam step), filtered by ``apply_decay_param_fun(name)``."""

    _l2_mode = "decoupled"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _should_decay(self, name: str) -> bool:
        fn = self.apply_decay_param_fun
        return True if fn is None else bool(fn(name))


class FusedAdamW(AdamW):
    """AdamW whose update of each parameter tensor is ONE launch of the
    fused AdamW kernel, in place: the master (or the parameter), both
    moments, and the low-precision parameter of a master are written in
    the same pass.  The decay is folded into the kernel (``wd = 0`` for a
    name ``apply_decay_param_fun`` excludes); the gradient is read in its
    own dtype and cast inside.  ``grad_clip`` runs before the launch, as
    for every optimizer: the clipped gradient is ``g`` times the scale in
    f32, cast back to ``g``'s dtype (the reference's rounding), so the
    scale is not folded into the kernel."""

    def _apply(self, name, p, g, slots, master, lr, step) -> None:
        target = master if master is not None else p
        wd = self._decay_coef() if self._should_decay(name) else 0.0
        fused_adamw(target, g, slots["moment1"], slots["moment2"], lr=lr,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    weight_decay=wd, step=step + 1,
                    low=p if master is not None else None)
