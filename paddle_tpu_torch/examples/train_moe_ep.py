"""Expert-parallel GPT-MoE training, the fleet EP workflow end to end
(counterpart of examples/train_moe_ep.py): ``fleet.init`` with an
``ep`` degree, ``gpt_moe_tiny`` with the GShard gate (random routing
off), ``GPTMoEHybridTrainer`` over ep x pp x sharding (ZeRO-1) with
``AdamW(3e-3)``, a fixed batch, and the reference's learning assert
(the last loss below the first).

    python -m paddle_tpu_torch.examples.train_moe_ep --ep 2 --pp 2 \\
        --sharding 2
    python -m paddle_tpu_torch.examples.train_moe_ep --device cpu

Every rank runs in this process (the port's single controller).  On the
card (the default) rank ``r`` sits on ``cuda:(r % cards)``; ``--device
cpu`` puts every rank on the host.  The weights come from a generator
seeded with 0 (the reference calls the global ``paddle_tpu.seed(0)``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ep", type=int, default=2)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--sharding", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5,
                    help="train steps (>= 2: the final learning assert "
                         "compares last vs first loss)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2")
    return args


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the script; returns every step's loss."""
    args = _args(argv)
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.models import GPTMoEHybridTrainer, gpt_moe_tiny

    s = dist.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": args.dp, "pp_degree": args.pp,
                        "sharding_degree": args.sharding,
                        "ep_degree": args.ep}
    world = args.dp * args.pp * args.sharding * args.ep
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
    print(f"topology: {hcg}")

    gen = torch.Generator(device=devices[0])
    gen.manual_seed(0)
    cfg = gpt_moe_tiny(gate="gshard", moe_every=1,
                       gate_kwargs={"random_routing": False})
    trainer = GPTMoEHybridTrainer(cfg, hcg, opt.AdamW(learning_rate=3e-3),
                                  microbatches=args.pp, zero_stage=1,
                                  generator=gen)
    # fixed batch: the learning assertion below needs same-data steps
    x, y = trainer.make_batch(batch=args.batch, seq=args.seq, seed=0)
    losses = []
    for step in range(args.steps):
        losses.append(float(trainer.train_step(x, y)))
        print(f"step {step}: loss={losses[-1]:.4f}")
    assert losses[-1] < losses[0], "MoE training did not learn"
    print(f"OK: expert-parallel MoE trained (loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f})")
    return losses


if __name__ == "__main__":
    main()
