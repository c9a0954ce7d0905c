"""GPT-MoE on the card (``-m cuda``; no JAX import).

Every rank of ``{ep 2, pp 2, sharding 2}`` and of ``{dp 2, ep 2, mp 2}``
on the one card: two steps of an f32 model with 64-wide heads (TF32 off)
agree with the serial trainer's at the reference oracle's bounds (rtol
2e-4 at step 1, 2e-3 at step 2), through the flash kernels (one launch
of each a block, microbatch and batch group).  The example runs on the
card at its defaults.  With no CUDA device, the model and the gate raise
and name the argument that places them on the host.
"""

import dataclasses
import math

import pytest
import torch

from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                          get_hybrid_communicate_group,
                                          moe, topology)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import (GPTMoEForCausalLM, GPTMoEHybridTrainer,
                                     gpt_moe_tiny)
from paddle_tpu_torch.optimizer import SGD

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(
    gpt_moe_tiny(gate="gshard", moe_every=1,
                 gate_kwargs={"random_routing": False}),
    hidden_size=256, num_heads=4)


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


@pytest.mark.parametrize("hybrid", [
    {"ep_degree": 2, "pp_degree": 2, "sharding_degree": 2},
    {"dp_degree": 2, "ep_degree": 2, "mp_degree": 2}],
    ids=["ep2_pp2_sharding2", "dp2_ep2_mp2"])
def test_layouts_match_the_serial_trainer_on_the_card(card, hybrid):
    serial = GPTMoEHybridTrainer(CFG, optimizer=SGD(learning_rate=0.1),
                                 device=card, generator=_gen(9))
    ids, labels = serial.make_batch(4, 128, seed=3)
    want = [float(serial.train_step(ids, labels)) for _ in range(2)]
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    fleet.init(is_collective=True, strategy=s,
               devices=["cuda:0"] * math.prod(hybrid.values()))
    tr = GPTMoEHybridTrainer(CFG, get_hybrid_communicate_group(),
                             SGD(learning_rate=0.1), generator=_gen(9))
    fa.flash_attention_fwd.launches = 0
    got = [float(tr.train_step(ids, labels)) for _ in range(2)]
    torch.cuda.synchronize()
    groups = hybrid.get("dp_degree", 1) * hybrid.get("sharding_degree", 1)
    assert fa.flash_attention_fwd.launches == 2 * CFG.num_layers * groups
    assert abs(got[0] - want[0]) <= 2e-4 * abs(want[0])
    assert abs(got[1] - want[1]) <= 2e-3 * abs(want[1])


def test_example_runs_on_the_card(card):
    from paddle_tpu_torch.examples import train_moe_ep
    losses = train_moe_ep.main([])
    assert losses[-1] < losses[0]


def test_no_cuda_device_raises_naming_the_argument(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device="):
        GPTMoEForCausalLM(CFG)
    with pytest.raises(RuntimeError, match="device="):
        moe.NaiveGate(8, 4)
    from paddle_tpu_torch.examples import train_moe_ep
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_moe_ep.main([])
