"""Learning-rate schedulers (counterpart of paddle_tpu/optimizer/lr.py), in
plain Python: ``lr_at(step)`` is the rate at an integer step, a float.

The reference's surface: ``LRScheduler(learning_rate, last_epoch=-1)``
steps once at construction (``last_epoch`` 0); ``get_lr()`` is
``lr_at(max(last_epoch, 0))``; ``step()`` / ``step(epoch)`` advance it;
``state_dict()`` / ``set_state_dict()`` carry ``last_epoch`` (and
``ReduceOnPlateau``'s plateau state, which the reference leaves out).
``make_scheduler`` turns a float into a constant schedule.  The
optimizers read ``get_lr()`` at each step and never step a scheduler
themselves: a training script calls ``scheduler.step()``, as with the
reference.  The reference evaluates in f32; these in f64.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Union

__all__ = ["LRScheduler", "NoamDecay", "StepDecay", "MultiStepDecay",
           "ConstantLR", "LinearLR", "CyclicLR",
           "ExponentialDecay", "NaturalExpDecay", "InverseTimeDecay",
           "PolynomialDecay", "LinearWarmup", "CosineAnnealingDecay",
           "LambdaDecay", "PiecewiseDecay", "OneCycleLR", "ReduceOnPlateau",
           "CosineAnnealingWarmRestarts", "MultiplicativeDecay",
           "make_scheduler"]


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()  # to epoch 0, as the reference's constructor

    def lr_at(self, step: int) -> float:
        raise NotImplementedError

    def __call__(self, step: int) -> float:
        return self.lr_at(step)

    def get_lr(self) -> float:
        return float(self.lr_at(max(self.last_epoch, 0)))

    def step(self, epoch: Optional[int] = None) -> None:
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, state: dict) -> None:
        self.last_epoch = state["last_epoch"]


class _ConstLR(LRScheduler):
    def lr_at(self, step):
        return self.base_lr


def make_scheduler(learning_rate: Union[float, LRScheduler]) -> LRScheduler:
    """``learning_rate`` itself if it is a scheduler, else a constant
    schedule; anything else raises."""
    if isinstance(learning_rate, LRScheduler):
        return learning_rate
    if isinstance(learning_rate, bool) or \
            not isinstance(learning_rate, (int, float)):
        raise TypeError(f"learning_rate must be a float or an LRScheduler, "
                        f"got {type(learning_rate).__name__}")
    return _ConstLR(float(learning_rate))


class NoamDecay(LRScheduler):
    """``base · d_model^-0.5 · min(s^-0.5, s · warmup^-1.5)``, s >= 1."""

    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1,
                 verbose: bool = False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        s = max(float(step), 1.0)
        return self.base_lr * self.d_model ** -0.5 * min(
            s ** -0.5, s * self.warmup_steps ** -1.5)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** (int(step) // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: List[int],
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        k = sum(1 for m in self.milestones if step >= m)
        return self.base_lr * self.gamma ** k


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** float(step)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * math.exp(-self.gamma * float(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr / (1 + self.gamma * float(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False, last_epoch: int = -1,
                 verbose: bool = False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        s = float(step)
        if self.cycle:
            div = math.ceil(max(s, 1.0) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1.0)
        else:
            decay_steps = self.decay_steps
            s = min(s, float(self.decay_steps))
        frac = (1.0 - s / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """``start_lr`` to ``end_lr`` linearly over ``warmup_steps``, then
    ``learning_rate`` (a float or a scheduler, which then runs from its
    step 0; stepping the warmup steps it too)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1, verbose: bool = False):
        self.inner = make_scheduler(learning_rate)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(self.inner.base_lr, last_epoch, verbose)

    def lr_at(self, step):
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * min(
                step / max(self.warmup_steps, 1), 1.0)
        return self.inner.lr_at(max(int(step) - self.warmup_steps, 0))

    def step(self, epoch: Optional[int] = None) -> None:
        super().step(epoch)
        if hasattr(self, "inner"):
            self.inner.step(epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0,
                 last_epoch: int = -1, verbose: bool = False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        cos = math.cos(math.pi * min(float(step), self.T_max) / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0, last_epoch: int = -1,
                 verbose: bool = False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        s = float(step)
        if self.T_mult == 1:
            t_cur, t_i = math.fmod(s, self.T_0), self.T_0
        else:
            # the geometric restart schedule in closed form
            n = math.floor(math.log1p((self.T_mult - 1) * s / self.T_0) /
                           math.log(self.T_mult))
            start = self.T_0 * (float(self.T_mult) ** n - 1) / \
                (self.T_mult - 1)
            t_cur, t_i = s - start, self.T_0 * float(self.T_mult) ** n
        cos = math.cos(math.pi * t_cur / t_i)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda: Callable,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * float(self.lr_lambda(step))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float],
                 last_epoch: int = -1, verbose: bool = False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def lr_at(self, step):
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return float(v)
        return float(self.values[-1])


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int,
                 divide_factor: float = 25.0,
                 end_learning_rate: float = 0.0001, phase_pct: float = 0.3,
                 anneal_strategy: str = "cos", three_phase: bool = False,
                 last_epoch: int = -1, verbose: bool = False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def lr_at(self, step):
        s = float(step)
        up_steps = self.phase_pct * self.total_steps
        down_steps = self.total_steps - up_steps
        if s < up_steps:
            return self._interp(self.initial_lr, self.max_lr,
                                min(max(s / max(up_steps, 1), 0.0), 1.0))
        return self._interp(self.max_lr, self.end_lr, min(max(
            (s - up_steps) / max(down_steps, 1), 0.0), 1.0))


class ReduceOnPlateau(LRScheduler):
    """Metric-driven: ``step(metrics)`` lowers the rate by ``factor`` after
    more than ``patience`` steps without an improvement beyond
    ``threshold``; ``lr_at`` is the rate set now."""

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0, epsilon: float = 1e-8,
                 verbose: bool = False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.current_lr = float(learning_rate)
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def lr_at(self, step):
        return self.current_lr

    def step(self, metrics=None, epoch=None) -> None:
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics)
        better = (self.best is None or
                  (self.mode == "min" and m < self.best - self.threshold) or
                  (self.mode == "max" and m > self.best + self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0

    _PLATEAU = ("current_lr", "best", "num_bad", "cooldown_counter")

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch,
                **{k: getattr(self, k) for k in self._PLATEAU}}

    def set_state_dict(self, state: dict) -> None:
        self.last_epoch = state["last_epoch"]
        for k in self._PLATEAU:
            if k in state:
                setattr(self, k, state[k])


class ConstantLR(LRScheduler):
    """``lr · factor`` for the first ``total_steps``, then ``lr``."""

    def __init__(self, learning_rate: float, factor: float = 1.0 / 3,
                 total_steps: int = 5, last_epoch: int = -1,
                 verbose: bool = False):
        self.factor = factor
        self.total_steps = total_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.factor if step < self.total_steps \
            else self.base_lr


class LinearLR(LRScheduler):
    """``lr · start_factor`` to ``lr · end_factor`` linearly over
    ``total_steps``."""

    def __init__(self, learning_rate: float, total_steps: int,
                 start_factor: float = 1.0 / 3, end_factor: float = 1.0,
                 last_epoch: int = -1, verbose: bool = False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        frac = min(max(float(step), 0.0), self.total_steps) / \
            self.total_steps
        return self.base_lr * (self.start_factor +
                               (self.end_factor - self.start_factor) * frac)


class CyclicLR(LRScheduler):
    """Cycles between ``base_learning_rate`` and ``max_learning_rate``
    (``triangular``, ``triangular2``, ``exp_range``, or ``scale_fn``)."""

    def __init__(self, base_learning_rate: float, max_learning_rate: float,
                 step_size_up: int, step_size_down: Optional[int] = None,
                 mode: str = "triangular", exp_gamma: float = 1.0,
                 scale_fn: Optional[Callable] = None,
                 scale_mode: str = "cycle", last_epoch: int = -1,
                 verbose: bool = False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down if step_size_down is not None \
            else step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        self.scale_fn = scale_fn
        self.scale_mode = scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        s = float(step)
        total = self.up + self.down
        cycle = math.floor(s / total)
        pos = s - cycle * total
        frac = pos / self.up if pos < self.up else \
            1.0 - (pos - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.scale_fn is not None:
            amp *= float(self.scale_fn(cycle + 1 if self.scale_mode == "cycle"
                                       else s))
        elif self.mode == "triangular2":
            amp /= 2.0 ** cycle
        elif self.mode == "exp_range":
            amp *= self.exp_gamma ** s
        return self.base_lr + amp * frac


class MultiplicativeDecay(LRScheduler):
    """``lr_t = lr_{t-1} · lr_lambda(t)``: the product of ``lr_lambda(1..
    t)`` times the base rate."""

    def __init__(self, learning_rate: float, lr_lambda: Callable,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        lr = self.base_lr
        for t in range(1, int(step) + 1):
            lr *= float(self.lr_lambda(t))
        return lr
