"""Semi-auto-parallel Llama training, the auto-parallel workflow end to end
(counterpart of examples/train_llama_semi_auto.py): a ``ProcessMesh``
over ``dp x mp``, ``dist.shard_layer`` with ``llama_shard_fn`` (the
Megatron placements), and ``Engine.fit`` with ``AdamW(1e-3)``.

    python -m paddle_tpu_torch.examples.train_llama_semi_auto --dp 2 --mp 4
    python -m paddle_tpu_torch.examples.train_llama_semi_auto --device cpu

Every rank runs in this process (the port's single controller).  On the
card (the default) process ``p`` sits on ``cuda:(p % cards)``, so ranks
share a card when there are fewer cards than ranks; ``--device cpu``
puts every rank on the host.  ``--config llama_7b --layers N`` trains the
Llama-2-7B widths at ``N`` layers in bf16.  The weights come from a
generator seeded with ``--seed`` (the reference calls the global
``paddle_tpu.seed(0)``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", choices=["llama_tiny", "llama_7b"],
                    default="llama_tiny")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The example's loss: the mean over tokens of the f32 log-softmax's
    negative label entry."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None]).mean()


def process_mesh(dp: int, mp: int, device: str):
    """``ProcessMesh([[0 .. mp-1], ...], ["dp", "mp"])`` with process ``p``
    on ``cuda:(p % cards)`` (``"cpu"`` for ``device="cpu"``)."""
    from paddle_tpu_torch.distributed import ProcessMesh
    n = dp * mp
    if device == "cpu":
        devices = ["cpu"] * n
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the host")
    else:
        devices = [f"cuda:{p % torch.cuda.device_count()}" for p in range(n)]
    return ProcessMesh(np.arange(n).reshape(dp, mp).tolist(),
                       dim_names=["dp", "mp"], devices=devices)


def build(cfg, mesh, device, seed: int, optimizer=None):
    """The model drawn from a generator seeded with ``seed`` on
    ``device``, sharded by ``llama_shard_fn`` over ``mesh`` (serial when
    ``mesh`` is None), and its ``Engine`` with ``optimizer`` (default
    ``AdamW(learning_rate=1e-3)``)."""
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.optimizer as opt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import llama_shard_fn

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = LlamaForCausalLM(cfg, device=device, generator=gen)
    if mesh is not None:
        # semi-auto: the weights are placed by the shard_fn; the Engine
        # runs each sharded layer per rank
        dist.shard_layer(model, mesh, llama_shard_fn(mesh))
    engine = dist.Engine(model, loss=loss_fn,
                         optimizer=optimizer or opt.AdamW(learning_rate=1e-3),
                         process_mesh=mesh)
    return model, engine


def batches(vocab: int, batch: int, seq: int, steps: int) -> list:
    """The example's data: one ``RandomState(0)`` draw of ``(batch, seq +
    1)`` ids, shifted by one, repeated ``steps`` times."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (batch, seq + 1))
    return [(ids[:, :-1], ids[:, 1:])] * steps


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Run the script; returns the step losses."""
    args = _args(argv)
    from paddle_tpu_torch.distributed.fleet_utils import get_logger
    from paddle_tpu_torch.models import llama_7b, llama_tiny

    log = get_logger("train_llama")
    mesh = process_mesh(args.dp, args.mp, args.device)
    log.info("mesh: dp=%d mp=%d", args.dp, args.mp)
    cfg = llama_tiny() if args.config == "llama_tiny" else llama_7b()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device = mesh.get_mesh().device(0)
    _, engine = build(cfg, mesh, device, args.seed)
    losses = engine.fit(batches(cfg.vocab_size, args.batch, args.seq,
                                args.steps), epochs=1, verbose=0)
    log.info("loss %0.4f -> %0.4f over %d steps", losses[0], losses[-1],
             len(losses))
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    log.info("done")
    return losses


if __name__ == "__main__":
    main()
