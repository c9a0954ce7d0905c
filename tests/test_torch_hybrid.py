"""The port's hybrid-parallel GPT trainer (``fleet.init`` + the hybrid
group + ``GPTHybridTrainer`` with microbatches, ZeRO and VPP) against the
JAX package's on the CPU.

gpt_tiny in f32.  The JAX trainers run as the reference's own tests run
them (``tests/test_gpt_hybrid.py``: the conftest's 8 virtual devices, the
jitted step).  Their weights are carried into the port's rank blocks by
``hybrid_state_from_jax``; the port's ranks all sit on the CPU.

* ``{dp 2, mp 2, pp 2}``, 2 microbatches, against the JAX trainer of the
  same configuration: 2 steps of ``AdamW(1e-3)`` on ``make_batch(4, 16,
  seed=5)``; losses at rtol 1e-5, parameters at atol 1e-4 but the key
  slice of each ``qkv.bias``, whose exact gradient is 0 (softmax ignores
  a shift of every key) and which Adam moves by up to 2·lr a step on
  rounding noise (``tests/test_torch_train.py``).
* five configurations against the JAX serial trainer, with the
  reference oracle's ``SGD(0.1)`` and bounds (rtol 2e-4 at step 1, 2e-3
  at step 2, ``tests/test_gpt_hybrid.py``); the VPP ones at 4 layers on
  both sides, as the reference's VPP tests.
* the ZeRO-3 memory property, vocab-parallel cross entropy, the stage
  body's call count (no bubble), the refusals and ``make_batch``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.meta_parallel.mp_layers import \
    parallel_cross_entropy as jax_parallel_cross_entropy
from paddle_tpu.models import GPTHybridTrainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import (DistributedStrategy, Mesh, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.distributed.meta_parallel import \
    parallel_cross_entropy
from paddle_tpu_torch.models import (GPTHybridTrainer, gpt_tiny,
                                     hybrid_state_from_jax,
                                     jax_trainer_arrays)
from paddle_tpu_torch.optimizer import SGD, AdamW, FusedAdamW

LR = 1e-3


def _jax_run(hybrid, layers, batch, seed, opt, microbatches=2, steps=2,
             data_seed=5):
    """The JAX trainer's first weights, losses and final weights."""
    s = jdist.DistributedStrategy()
    s.hybrid_configs = hybrid
    jdist.fleet.init(is_collective=True, strategy=s)
    try:
        paddle_tpu.seed(seed)
        cfg = jax_gpt_tiny(remat=False)
        cfg.num_layers = layers
        tr = JaxTrainer(cfg, jdist.get_hybrid_communicate_group(), opt,
                        microbatches=microbatches)
        st = tr.init_state()
        first = jax_trainer_arrays(st[0], st[1], tr.S)
        x, y = tr.make_batch(batch=batch, seq=16, seed=data_seed)
        losses = []
        for _ in range(steps):
            st, loss = tr.train_step(st, x, y)
            losses.append(float(loss))
        return first, losses, jax_trainer_arrays(st[0], st[1], tr.S)
    finally:
        jdist.topology.set_hybrid_communicate_group(None)


@pytest.fixture(scope="module")
def jax_hybrid():
    return _jax_run({"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, 2, 4,
                    11, jopt.AdamW(learning_rate=LR))


@pytest.fixture(scope="module")
def jax_serial():
    """The JAX serial trainer's runs the port's configurations are held
    to, by layer count: (first weights, losses, final weights, batch)."""
    one = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1}
    return {2: _jax_run(one, 2, 8, 31, jopt.SGD(learning_rate=0.1)) + (8,),
            4: _jax_run(one, 4, 4, 41, jopt.SGD(learning_rate=0.1)) + (4,)}


@pytest.fixture(autouse=True)
def _no_group():
    yield
    topology.set_hybrid_communicate_group(None)


def _port(hybrid, opt, layers=2, **kw):
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    world = int(np.prod(list(hybrid.values())))
    fleet.init(is_collective=True, strategy=s, devices=["cpu"] * world)
    cfg = dataclasses.replace(gpt_tiny(), num_layers=layers)
    return GPTHybridTrainer(cfg, get_hybrid_communicate_group(), opt, **kw)


def _train(tr, weights, batch, steps=2):
    hybrid_state_from_jax(weights, tr)
    x, y = tr.make_batch(batch, 16, seed=5)
    return [float(tr.train_step(x, y)) for _ in range(steps)]


@pytest.mark.parametrize("cls", [AdamW, FusedAdamW],
                         ids=["AdamW", "FusedAdamW"])
def test_dp2_mp2_pp2_matches_the_jax_hybrid_trainer(jax_hybrid, cls):
    first, jlosses, jfinal = jax_hybrid
    tr = _port({"dp_degree": 2, "mp_degree": 2, "pp_degree": 2},
               cls(learning_rate=LR), microbatches=2)
    losses = _train(tr, first, 4)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = tr.state_dict()
    h = gpt_tiny().hidden_size
    worst = 0.0
    for k, want in jfinal.items():
        diff = np.abs(got[k].numpy() - want)
        if k.endswith("qkv.bias"):
            assert diff[h:2 * h].max() <= 2 * LR * 2, k
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        worst = max(worst, float(diff.max()))
    assert worst <= 1e-4, f"largest parameter difference {worst:.3g}"
    # 2 stages x 2 microbatches x 2 batch groups, a step
    assert tr.stage_calls == 2 * 2 * 2 * 2


CONFIGS = [  # (hybrid, layers, microbatches, zero, vpp)
    ({"pp_degree": 2}, 2, 4, 1, 1),
    ({"sharding_degree": 4}, 2, 1, 2, 1),
    ({"sharding_degree": 4}, 2, 1, 3, 1),
    ({"mp_degree": 2, "pp_degree": 2}, 4, 2, 1, 2),
    ({"pp_degree": 2, "sharding_degree": 2}, 4, 2, 3, 2),
]


@pytest.mark.parametrize("hybrid,layers,m,zero,vpp", CONFIGS,
                         ids=["pp2_m4", "sharding4_zero2", "sharding4_zero3",
                              "mp2_pp2_vpp2", "pp2_sharding2_zero3_vpp2"])
def test_hybrid_matches_the_jax_serial_trainer(jax_serial, hybrid, layers,
                                               m, zero, vpp):
    first, jlosses, jfinal, batch = jax_serial[layers]
    tr = _port(hybrid, SGD(learning_rate=0.1), layers=layers,
               microbatches=m, zero_stage=zero, vpp=vpp)
    losses = _train(tr, first, batch)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=2e-4)
    np.testing.assert_allclose(losses[1], jlosses[1], rtol=2e-3)
    got = tr.state_dict()
    for k, want in jfinal.items():
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-4,
                                   err_msg=k)
    # no bubble: the stage body runs once for each (stage, chunk,
    # microbatch, batch group) that carries data
    S = hybrid.get("pp_degree", 1)
    groups = hybrid.get("dp_degree", 1) * hybrid.get("sharding_degree", 1)
    assert tr.stage_calls == 2 * S * (vpp if S > 1 else 1) * \
        (m if S > 1 else 1) * groups


@pytest.mark.parametrize("hybrid,zero", [
    ({"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, 1),
    ({"sharding_degree": 2, "mp_degree": 2}, 1),
    ({"sharding_degree": 2, "dp_degree": 2}, 3),
    ({"dp_degree": 2, "ep_degree": 2}, 1)],
    ids=["dp2_mp2_pp2", "sharding2_mp2_zero1", "sharding2_dp2_zero3",
         "dp2_ep2"])
def test_replicas_on_distinct_devices_sum_and_share(hybrid, zero):
    """Ranks on two devices (``cpu`` and ``cpu:0`` are distinct device
    keys on one host) hold a replicated block twice: their gradients are
    summed and ZeRO-1's updated slices copied across, so three steps equal
    the serial trainer's.  At ep 2 the ep replicas (on the second device)
    take no part in the step and are given the sum."""
    cfg = gpt_tiny()
    gen = torch.Generator()
    gen.manual_seed(3)
    serial = GPTHybridTrainer(cfg, optimizer=FusedAdamW(learning_rate=LR),
                              device="cpu", generator=gen)
    x, y = serial.make_batch(8, 16, seed=5)
    want = [float(serial.train_step(x, y)) for _ in range(3)]
    s = DistributedStrategy()
    s.hybrid_configs = hybrid
    world = int(np.prod(list(hybrid.values())))
    fleet.init(is_collective=True, strategy=s,
               devices=["cpu", "cpu:0"] * (world // 2))
    gen.manual_seed(3)
    tr = GPTHybridTrainer(cfg, get_hybrid_communicate_group(),
                          FusedAdamW(learning_rate=LR), microbatches=2,
                          zero_stage=zero, generator=gen)
    assert len({key[3] for key in tr._store}) == 2
    got = [float(tr.train_step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref = serial.state_dict()
    for k, v in tr.state_dict().items():
        torch.testing.assert_close(v, ref[k], atol=2 * LR * 3, rtol=0)


def test_zero3_keeps_one_degree_th_per_rank_and_zero1_all():
    """A shardable tensor (every layer's qkv weight) is held 1/degree a
    rank under stage 3 and whole under stage 1; training matches."""
    deg, cfg = 4, gpt_tiny()
    whole = cfg.num_layers * cfg.hidden_size * 3 * cfg.hidden_size
    for zero, want in ((3, whole // deg), (1, whole)):
        tr = _port({"sharding_degree": deg}, FusedAdamW(learning_rate=LR),
                   zero_stage=zero)
        for r in range(deg):
            held = tr.rank_state(r)
            assert sum(t.numel() for k, t in held.items()
                       if k.endswith("qkv.weight")) == want, (zero, r)
        x, y = tr.make_batch(8, 16, seed=1)
        assert np.isfinite(float(tr.train_step(x, y)))
        topology.set_hybrid_communicate_group(None)


def test_vocab_parallel_cross_entropy_equals_the_plain_one():
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 5, 12).astype(np.float32) * 3
    labels = rs.randint(0, 12, (2, 5))
    labels[0, 1] = labels[1, 4] = -100
    want = np.asarray(jax_parallel_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels)))
    t = torch.tensor(logits, requires_grad=True)
    shards = list(t.chunk(2, dim=-1))
    got = parallel_cross_entropy(shards, torch.as_tensor(labels),
                                 mesh=Mesh(["cpu", "cpu"]))
    np.testing.assert_allclose(got[0].detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert got[0][0, 1] == 0.0 and got[0][1, 4] == 0.0
    got[0].sum().backward()
    ref = torch.tensor(logits, requires_grad=True)
    parallel_cross_entropy(ref, torch.as_tensor(labels)).sum().backward()
    torch.testing.assert_close(t.grad, ref.grad)


def test_refusals_and_value_errors():
    def group(**kw):
        s = DistributedStrategy()
        s.hybrid_configs = kw
        world = int(np.prod(list(kw.values())))
        fleet.init(is_collective=True, strategy=s, devices=["cpu"] * world)
        return get_hybrid_communicate_group()
    opt = SGD(learning_rate=0.1)
    with pytest.raises(NotImplementedError, match="item 9"):
        GPTHybridTrainer(gpt_tiny(), group(sep_degree=2), opt)
    with pytest.raises(ValueError, match="num_layers"):
        GPTHybridTrainer(gpt_tiny(), group(pp_degree=2), opt, vpp=2)
    with pytest.raises(ValueError, match="microbatches"):
        GPTHybridTrainer(dataclasses.replace(gpt_tiny(), num_layers=4),
                         group(pp_degree=2), opt, microbatches=3, vpp=2)
    with pytest.raises(ValueError, match="optimizer"):
        GPTHybridTrainer(gpt_tiny(), group(mp_degree=2))
    with pytest.raises(ValueError, match="devices="):
        fleet.init(is_collective=True, strategy=DistributedStrategy(),
                   devices=[])
    if not torch.cuda.is_available():
        # the default placement is the card: without one, each names the
        # argument that places it elsewhere
        s = DistributedStrategy()
        s.hybrid_configs = {"mp_degree": 2}
        with pytest.raises(ValueError, match="devices="):
            fleet.init(is_collective=True, strategy=s)
        with pytest.raises(RuntimeError, match="device="):
            GPTHybridTrainer(gpt_tiny(), optimizer=opt)


def test_make_batch_draws_the_reference_ids(jax_hybrid):
    tr = _port({"mp_degree": 2}, SGD(learning_rate=0.1))
    x, y = tr.make_batch(4, 16, seed=5)
    ids = np.random.RandomState(5).randint(0, 256, (4, 17))
    np.testing.assert_array_equal(x.numpy(), ids[:, :-1])
    np.testing.assert_array_equal(y.numpy(), ids[:, 1:])
    hcg = get_hybrid_communicate_group()
    assert hcg.get_model_parallel_world_size() == 2
    assert [hcg.get_model_parallel_rank(r) for r in range(2)] == [0, 1]
    assert hcg.get_model_parallel_group().ranks(1) == [0, 1]


@pytest.mark.parametrize("S,V,M", [(2, 1, 3), (2, 2, 4), (3, 2, 3)])
def test_pipelines_apply_every_block_in_order_without_bubbles(S, V, M):
    """The plain schedule over stacked ``[L, ...]`` weights and the
    interleaved one over ``stack_interleaved_stage_params``' rows apply
    every block of every microbatch in layer order, with ``S·M``
    (``S·V·M``) stage calls."""
    from paddle_tpu_torch.distributed.pipelining import (
        pipeline_apply, pipeline_apply_interleaved,
        stack_interleaved_stage_params)
    L = S * V * 2
    w = torch.randn(L, 5, 5, generator=torch.Generator().manual_seed(1))
    xs = torch.randn(M, 2, 5, generator=torch.Generator().manual_seed(2))
    want = []
    for x in xs:
        for i in range(L):
            x = torch.tanh(x @ w[i])
        want.append(x)
    calls, hops = [], []

    def body(p, x):
        calls.append(1)
        for wi in p["w"]:
            x = torch.tanh(x @ wi)
        return x

    def hop(x, s):
        hops.append(s)
        return x
    if V == 1:
        got = pipeline_apply(body, {"w": w}, xs, S, hop=hop)
    else:
        chunks = [{"w": w[c * 2:(c + 1) * 2]} for c in range(S * V)]
        got = pipeline_apply_interleaved(
            body, stack_interleaved_stage_params(chunks, S, V), xs, S, V,
            hop=hop)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x)
    assert len(calls) == S * V * M
    assert hops[:S * V] == [c % S for c in range(S * V)]


def test_shard_state_and_zero_specs_follow_the_reference():
    """Blocks of ``shard_state`` tile the tensor in the reference's order
    (multi-axis entries major to minor), ranks sharing a device and a
    block share one tensor, and ZeRO's slot specs are the reference's."""
    from paddle_tpu.distributed.sharding_utils import \
        shard_opt_state_specs as jax_zero_specs
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu_torch.distributed.mesh import Grid
    from paddle_tpu_torch.distributed.sharding_utils import (
        P, shard_opt_state_specs, shard_state)
    grid = Grid(["cpu"] * 8, ("dp", "pp", "mp"), (2, 2, 2))
    t = torch.arange(8 * 3).reshape(8, 3)
    blocks = shard_state(grid, {"w": t}, {"w": P(("mp", "pp"), None)})["w"]
    for r, b in enumerate(blocks):
        c = grid.coord(r)
        j = c["mp"] * 2 + c["pp"]
        torch.testing.assert_close(b, t[2 * j:2 * j + 2])
    assert blocks[0] is blocks[grid.rank(dp=1)]
    specs = {"a": (None, "mp"), "b": ("pp", None, None), "c": (("mp", "pp"),
                                                            None),
             "d": (None,)}
    shapes = {"a": (6, 4), "b": (2, 4, 8), "c": (16, 8), "d": (3,)}
    want = jax_zero_specs({k: JP(*v) for k, v in specs.items()}, shapes,
                          "sharding", 2)
    got = shard_opt_state_specs({k: P(*v) for k, v in specs.items()},
                                shapes, "sharding", 2)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
