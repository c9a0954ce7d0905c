"""GPT trainer on one card (counterpart of paddle_tpu/models/trainer.py).

The reference's ``GPTHybridTrainer`` compiles one program covering dp,
tp, sp, ZeRO and pp over a mesh.  This port runs the tp=1, single-card
case eagerly: forward (attention through the flash kernels), the mean
``parallel_cross_entropy`` loss, ``backward()``, one optimizer step (one
``fused_adamw`` launch per parameter tensor with ``FusedAdamW``) and
clearing the gradients.  It keeps the reference's name, constructor order
and ``make_batch`` draw.  Not ported yet (ROADMAP queue 1): any parallel
degree > 1, the stacked-block scan, and ``remat``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .gpt import GPTConfig, GPTForCausalLM

__all__ = ["GPTHybridTrainer"]

_DEGREES = ("get_data_parallel_world_size",
            "get_model_parallel_world_size",
            "get_pipe_parallel_world_size",
            "get_sharding_parallel_world_size",
            "get_sep_parallel_world_size")


class GPTHybridTrainer:
    """``GPTHybridTrainer(cfg, hcg=None, optimizer=None, *, device=None,
    generator=None)``: builds ``GPTForCausalLM(cfg)`` on ``device`` (the
    card by default) in ``cfg.dtype`` and binds ``optimizer`` to it.
    ``hcg`` may be None or a group whose every parallel degree is 1."""

    def __init__(self, cfg: GPTConfig, hcg=None, optimizer=None, *,
                 device: Union[None, str, torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        if hcg is not None:
            for getter in _DEGREES:
                fn = getattr(hcg, getter, None)
                if fn is not None and fn() > 1:
                    raise NotImplementedError(
                        f"{getter}() = {fn()}: parallel training is not "
                        f"ported yet (ROADMAP queue 1); the trainer runs "
                        f"on one card")
        if optimizer is None:
            raise ValueError("GPTHybridTrainer needs an optimizer, e.g. "
                             "FusedAdamW(learning_rate=1e-4, "
                             "multi_precision=True)")
        self.cfg = cfg
        self.model = GPTForCausalLM(cfg, device=device,
                                    generator=generator).train()
        self.opt = optimizer.bind(self.model)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def make_batch(self, batch: int, seq: Optional[int] = None,
                   seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ids, labels)`` ``[batch, seq]`` int64 on the model's device:
        the reference's draw (trainer.py:361-373), ``RandomState(seed)
        .randint(0, vocab, (batch, seq + 1))`` shifted by one."""
        seq = seq or self.cfg.max_seq_len
        ids = np.random.RandomState(seed).randint(
            0, self.cfg.vocab_size, (batch, seq + 1))
        t = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        return t[:, :-1].contiguous(), t[:, 1:].contiguous()

    def train_step(self, ids: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """Forward, loss, backward, one optimizer step, gradients cleared.
        Returns the step's loss (a detached 0-dim f32 tensor; reading it
        synchronises with the card)."""
        loss = self.model.loss(ids, labels)
        loss.backward()
        self.opt.step()
        self.opt.clear_grad()
        return loss.detach()
