"""The hybrid-parallel trainer on the card (``-m cuda``; no JAX import).

Every rank of ``{mp 2, pp 2}`` on the one card: two steps at an f32
gpt_tiny-sized model with 64-wide heads (TF32 off) agree with the serial
trainer's at the reference oracle's bounds, through the flash kernels (one
launch of each a block, microbatch and mp rank).  With no CUDA device, the
group and the trainer raise and name the argument that places them.
"""

import dataclasses

import pytest
import torch

from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import GPTHybridTrainer, gpt_tiny
from paddle_tpu_torch.optimizer import SGD

pytestmark = pytest.mark.cuda

# remat off: one flash forward a block, microbatch and mp rank
CFG = dataclasses.replace(gpt_tiny(), hidden_size=256, num_heads=4,
                          num_layers=4, remat=False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    topology.set_hybrid_communicate_group(None)


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def test_mp2_pp2_matches_the_serial_trainer_on_the_card(card):
    serial = GPTHybridTrainer(CFG, optimizer=SGD(learning_rate=0.1),
                              device=card, generator=_gen(9))
    ids, labels = serial.make_batch(4, 96, seed=3)
    want = [float(serial.train_step(ids, labels)) for _ in range(2)]
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=s, devices=["cuda:0"] * 4)
    tr = GPTHybridTrainer(CFG, get_hybrid_communicate_group(),
                          SGD(learning_rate=0.1), microbatches=2,
                          generator=_gen(9))
    fa.flash_attention_fwd.launches = 0
    got = [float(tr.train_step(ids, labels)) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == 2 * CFG.num_layers * 2 * 2
    assert abs(got[0] - want[0]) <= 2e-4 * abs(want[0])
    assert abs(got[1] - want[1]) <= 2e-3 * abs(want[1])


def test_no_cuda_device_raises_naming_the_argument(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    with pytest.raises(ValueError, match="devices="):
        fleet.init(is_collective=True, strategy=s)
    with pytest.raises(RuntimeError, match="device="):
        GPTHybridTrainer(CFG, optimizer=SGD(learning_rate=0.1))
