"""Plain SGD (counterpart of paddle_tpu/optimizer/optimizer.py::SGD):
``p - lr * g`` in the parameter's (or its master's) dtype, with the base
class's L2 decay added to the gradient."""

from __future__ import annotations

from .optimizer import Optimizer

__all__ = ["SGD"]


class SGD(Optimizer):
    def _update_param(self, g, p, slots, lr, step):
        return p - lr * g
