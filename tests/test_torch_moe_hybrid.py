"""The port's ``GPTMoEHybridTrainer`` against the JAX package's at the
same layout on the CPU, and the dense ``GPTHybridTrainer`` at ep 2.

gpt_moe_tiny (2 layers, 4 experts, every block MoE) in f32 with the
GShard gate without random routing, so the routing is deterministic and
the aux loss is engaged.  Each layout's JAX trainer runs as the
reference's own tests run it (``tests/test_gpt_moe.py``: the conftest's
8 virtual devices, the jitted step), two steps of ``SGD(0.1)`` on
``make_batch(4, 16, seed=5)``; its first weights are carried into the
port's rank blocks (``hybrid_state_from_jax``), every port rank on the
CPU.  Losses agree at rtol 1e-5 and every parameter after two steps at
atol 1e-5 (the two packages sum in different orders; no token's routing
flips at this size).

Layouts: serial; ``{ep 2, pp 2, sharding 2}`` (ZeRO-1) at microbatches 1
and 2 (capacity per microbatch, as the reference's); ``{dp 2, ep 2, mp
2}`` (the experts' Megatron split); ``{dp 2}`` (ep 1: the experts over
dp).  Also the ``moe_every`` refusal, the routing readings, and the
dense GPT trainer at ``{dp 2, ep 2}`` against the JAX dense trainer.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import GPTHybridTrainer as JaxDense
from paddle_tpu.models import GPTMoEHybridTrainer as JaxMoE
from paddle_tpu.models import gpt_moe_tiny as jax_gpt_moe_tiny
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.models import (GPTHybridTrainer, GPTMoEHybridTrainer,
                                     gpt_moe_tiny, gpt_tiny,
                                     hybrid_state_from_jax,
                                     jax_trainer_arrays)
from paddle_tpu_torch.optimizer import SGD

GATE = dict(gate="gshard", moe_every=1,
            gate_kwargs={"random_routing": False})
LAYOUTS = {  # label: (hybrid_configs, microbatches)
    "serial": ({}, 1),
    "ep2_pp2_sharding2_m1": ({"ep_degree": 2, "pp_degree": 2,
                              "sharding_degree": 2}, 1),
    "ep2_pp2_sharding2_m2": ({"ep_degree": 2, "pp_degree": 2,
                              "sharding_degree": 2}, 2),
    "dp2_ep2_mp2": ({"dp_degree": 2, "ep_degree": 2, "mp_degree": 2}, 1),
    "dp2": ({"dp_degree": 2}, 1),
}


def _jax_run(hybrid, microbatches, dense=False):
    """The JAX trainer's first weights, losses and final weights."""
    s = jdist.DistributedStrategy()
    s.hybrid_configs = hybrid
    jdist.fleet.init(is_collective=True, strategy=s)
    try:
        paddle_tpu.seed(11)
        if dense:
            tr = JaxDense(jax_gpt_tiny(remat=False),
                          jdist.get_hybrid_communicate_group(),
                          jopt.SGD(learning_rate=0.1))
        else:
            tr = JaxMoE(jax_gpt_moe_tiny(**GATE),
                        jdist.get_hybrid_communicate_group(),
                        jopt.SGD(learning_rate=0.1),
                        microbatches=microbatches)
        st = tr.init_state()
        first = jax_trainer_arrays(st[0], st[1], tr.S)
        x, y = tr.make_batch(batch=4, seq=16, seed=5)
        losses = []
        for _ in range(2):
            st, loss = tr.train_step(st, x, y)
            losses.append(float(loss))
        return first, losses, jax_trainer_arrays(st[0], st[1], tr.S)
    finally:
        jdist.topology.set_hybrid_communicate_group(None)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(label):
        if label not in cache:
            hybrid, m = LAYOUTS.get(label, ({"dp_degree": 2,
                                              "ep_degree": 2}, 1))
            cache[label] = _jax_run(hybrid, m, dense=label == "dense")
        return cache[label]
    return get


@pytest.fixture(autouse=True)
def _no_group():
    yield
    topology.set_hybrid_communicate_group(None)


def _group(hybrid):
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    world = math.prod(hybrid.values()) if hybrid else 1
    fleet.init(is_collective=True, strategy=s, devices=["cpu"] * world)
    return get_hybrid_communicate_group()


def _check(tr, run, cfg_h):
    first, jlosses, jfinal = run
    hybrid_state_from_jax(first, tr)
    x, y = tr.make_batch(4, 16, seed=5)
    losses = [float(tr.train_step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = tr.state_dict()
    assert set(got) == set(jfinal)
    for k, want in jfinal.items():
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_moe_trainer_matches_the_jax_trainer(jax_runs, label):
    hybrid, m = LAYOUTS[label]
    tr = GPTMoEHybridTrainer(gpt_moe_tiny(**GATE), _group(hybrid),
                             SGD(learning_rate=0.1), microbatches=m)
    _check(tr, jax_runs(label), hybrid)
    S = hybrid.get("pp_degree", 1)
    if tr.grid is not None:
        # the pipeline carries every batch group: S·M stage calls a step
        assert tr.stage_calls == 2 * S * (m if S > 1 else 1)
    util, keep = tr.routing()["expert_util"], tr.routing()["token_keep_rate"]
    assert len(util) == 2 and all(0 < u <= 1 for u in util + keep)
    if label == "dp2_ep2_mp2":
        assert tr.cfg.mp_group == "mp"
        # each rank holds its ep block of experts and its mp columns
        w0 = {k: t for k, t in tr.rank_state(1).items()
              if k.endswith("stacked__w0")}
        assert all(tuple(t.shape) == (2, 64, 128) for t in w0.values())


def test_interleaved_schedule_and_remat_match_the_plain_one():
    """The aux loss rides the interleaved (VPP) schedule as it rides the
    plain one, and remat replays each block's routing: 4 layers at ``{pp
    2, ep 2}``, 2 microbatches, VPP 2 with ``remat=True`` against the
    plain schedule without it, from the same weights (the same products
    in the same order: rtol 1e-6)."""
    import dataclasses
    runs = []
    for vpp, remat in ((1, False), (2, True)):
        gen = torch.Generator().manual_seed(4)
        cfg = dataclasses.replace(gpt_moe_tiny(**GATE), num_layers=4,
                                  remat=remat)
        tr = GPTMoEHybridTrainer(cfg, _group({"pp_degree": 2,
                                              "ep_degree": 2}),
                                 SGD(learning_rate=0.1), microbatches=2,
                                 vpp=vpp, generator=gen)
        x, y = tr.make_batch(4, 16, seed=5)
        runs.append(([float(tr.train_step(x, y)) for _ in range(2)],
                     tr.state_dict(), tr.stage_calls))
        topology.set_hybrid_communicate_group(None)
    (plain, sd_plain, calls_plain), (vpp2, sd_vpp2, calls_vpp2) = runs
    np.testing.assert_allclose(vpp2, plain, rtol=1e-6)
    for k, v in sd_plain.items():
        torch.testing.assert_close(sd_vpp2[k], v, rtol=1e-6, atol=1e-6)
    assert (calls_plain, calls_vpp2) == (2 * 2 * 2, 2 * 2 * 2 * 2)


def test_moe_trainer_refusals():
    with pytest.raises(ValueError, match="moe_every"):
        GPTMoEHybridTrainer(gpt_moe_tiny(gate="naive", moe_every=2),
                            _group({"pp_degree": 2, "ep_degree": 2}),
                            SGD(learning_rate=0.1))
    with pytest.raises(ValueError, match="num_experts"):
        cfg = gpt_moe_tiny(gate="naive", moe_every=1)
        cfg.num_experts = 3
        GPTMoEHybridTrainer(cfg,
                            _group({"ep_degree": 2}),
                            SGD(learning_rate=0.1))


def test_dense_trainer_at_ep2_is_replicated_over_ep(jax_runs):
    """The reference's dense trainer takes ep_degree > 1: no parameter
    carries an ep spec and the batch does not split over ep."""
    hybrid = {"dp_degree": 2, "ep_degree": 2}
    tr = GPTHybridTrainer(gpt_tiny(remat=False), _group(hybrid),
                          SGD(learning_rate=0.1))
    _check(tr, jax_runs("dense"), hybrid)
    assert tr.G == 2                  # batch groups: dp only
    assert tr.rank_state(1).keys() == tr.rank_state(0).keys()


def test_example_learns_on_the_cpu():
    from paddle_tpu_torch.examples import train_moe_ep
    losses = train_moe_ep.main(["--device", "cpu"])
    assert len(losses) == 5 and losses[-1] < losses[0]
