"""Hybrid-parallel GPT training, the fleet workflow end to end (counterpart
of examples/train_gpt_hybrid.py): ``fleet.init`` from a strategy, the
hybrid group's mesh, ``gpt_tiny(sp=mp > 1, remat=True)``, ``AdamW`` with
``ClipGradByGlobalNorm(1.0)``, ``GPTHybridTrainer`` and auto-resume from
``--ckpt`` (a shard-aware checkpoint every 10 steps).

    python -m paddle_tpu_torch.examples.train_gpt_hybrid --mp 2 --pp 2
    python -m paddle_tpu_torch.examples.train_gpt_hybrid --device cpu \\
        --mp 2 --pp 2 --steps 12 --ckpt /tmp/ckpt

Every rank runs in this process (the port's single controller).  On the
card (the default) rank ``r`` sits on ``cuda:(r % cards)``, so ranks share
a card when there are fewer cards than ranks; ``--device cpu`` puts every
rank on the host.  ``--config gpt3_6_7b --layers N`` trains the GPT-3
6.7B widths at ``N`` layers in bf16 with f32 masters
(``FusedAdamW(multi_precision=True)``, the same clip).  The weights come
from a generator seeded with 0 (the reference calls the global
``paddle_tpu.seed(0)``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import torch


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--mp", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--sharding", type=int, default=1)
    ap.add_argument("--zero", type=int, default=1, choices=[1, 2, 3])
    ap.add_argument("--vpp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--config", choices=["gpt_tiny", "gpt3_6_7b"],
                    default="gpt_tiny")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Tuple[int, float]]:
    """Run the script; returns ``(step, loss)`` of every step it ran."""
    args = _args(argv)
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.distributed.fleet_utils import (get_logger,
                                                          load_auto_resume,
                                                          save_auto_resume)
    from paddle_tpu_torch.models import (GPTHybridTrainer, gpt3_6_7b,
                                         gpt_tiny)

    log = get_logger("train_gpt")
    s = dist.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": args.dp, "mp_degree": args.mp,
                        "pp_degree": args.pp,
                        "sharding_degree": args.sharding}
    world = args.dp * args.mp * args.pp * args.sharding
    if args.device == "cpu":
        devices = ["cpu"] * world
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the host")
    else:
        devices = [f"cuda:{r % torch.cuda.device_count()}"
                   for r in range(world)]
    dist.fleet.init(is_collective=True, strategy=s, devices=devices)
    hcg = dist.get_hybrid_communicate_group()
    log.info("mesh axes: %s", dict(hcg.get_mesh().shape))

    gen = torch.Generator(device=devices[0])
    gen.manual_seed(0)
    make = gpt_tiny if args.config == "gpt_tiny" else gpt3_6_7b
    cfg = make(sp=args.mp > 1, remat=True)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    clip = opt.ClipGradByGlobalNorm(1.0)
    optimizer = opt.AdamW(learning_rate=1e-3, grad_clip=clip) \
        if cfg.dtype == "float32" else \
        opt.FusedAdamW(learning_rate=1e-3, grad_clip=clip,
                       multi_precision=True)
    trainer = GPTHybridTrainer(cfg, hcg, optimizer,
                               microbatches=max(2 * args.pp, 2),
                               zero_stage=args.zero, vpp=args.vpp,
                               generator=gen)
    start = 0
    if args.ckpt:
        state, step = load_auto_resume(trainer.train_state(), args.ckpt)
        if step is not None:
            trainer.load_train_state(state)
            start = step
            log.info("resumed from step %d", start)

    x, y = trainer.make_batch(batch=args.batch, seq=args.seq)
    losses = []
    for it in range(start, args.steps):
        loss = trainer.train_step(x, y)
        losses.append((it, loss))
        if it % 5 == 0 or it == args.steps - 1:
            log.info("step %d loss %.4f", it, float(loss))
        if args.ckpt and (it + 1) % 10 == 0:
            save_auto_resume(trainer.train_state(), args.ckpt, step=it + 1)
    log.info("done")
    return [(it, float(loss)) for it, loss in losses]


if __name__ == "__main__":
    main()
