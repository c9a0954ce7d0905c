"""The port's MoE stack (``paddle_tpu_torch/distributed/moe.py``,
``models/gpt_moe.py``) against the JAX package's on the CPU, in f32, on
inputs made from numpy seeds and weights carried key for key.

* the routing utils on the cases of ``tests/test_moe.py`` and on random
  ones: equal values;
* the naive gate, GShard with ``random_routing=False`` and Switch with
  ``switch_eps=0`` in training: the gate values at rtol 1e-6, the expert
  indices exactly, the aux loss at rtol 1e-6;
* the random laws on the port's own generator: GShard keeps the second
  expert iff ``2 * p2 > u`` for a supplied ``u``, Switch scales the
  logits by the supplied jitter, and the drawn jitter lies in ``[1 - eps,
  1 + eps]``;
* ``MoELayer`` forward and the input and parameter gradients of a
  weighted sum of its output, at atol 1e-5, one case dropping tokens at
  capacity, with ``expert_util`` and ``token_keep_rate`` at rtol 1e-6;
* ``GPTMoEForCausalLM.loss`` and every parameter's gradient, at rtol
  1e-5 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models import GPTMoEForCausalLM as JaxGPTMoE
from paddle_tpu.models import gpt_moe_tiny as jax_gpt_moe_tiny
from paddle_tpu.nn.functional_call import bind_state, functional_call, state
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.models import (GPTMoEForCausalLM, gpt_moe_tiny,
                                     state_dict_from_jax)

ATOL = 1e-5


def _np(x):
    return np.array(x)


ROUTING_CASES = [
    ("number_count", ([0, 2, 2, 1, 0, 2], 4)),
    ("number_count", ([0, -1, 3, 3, 1, -1], 4)),
    ("assign_pos", ([1, 0, 1, 0, 2], 3)),
    ("limit_by_capacity", ([5, 1, 3], 2)),
    ("limit_by_capacity", ([[3, 1, 4], [2, 5, 1]], [4, 4, 4], 2)),
    ("limit_by_capacity", ([3, 1, 4, 2, 5, 1], [4, 4, 4], 2)),
    ("prune_gate_by_capacity", ([0, 0, 0, 1, 1], [2, 2], 2)),
    ("prune_gate_by_capacity", ([0, 2, 2, 1, 0], [1, 1, 1, 0], 2, 2)),
]


@pytest.mark.parametrize("name,args", ROUTING_CASES,
                         ids=[f"{n}_{i}" for i, (n, _) in
                              enumerate(ROUTING_CASES)])
def test_routing_utils_match_the_reference(name, args):
    got = getattr(moe, name)(*[np.asarray(a) if isinstance(a, list) else a
                               for a in args])
    want = getattr(jmoe, name)(*[np.asarray(a) if isinstance(a, list)
                                 else a for a in args])
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_routing_utils_on_random_cases():
    rs = np.random.RandomState(0)
    idx = rs.randint(-1, 6, 200)
    np.testing.assert_array_equal(moe.number_count(idx, 6).numpy(),
                                  _np(jmoe.number_count(idx, 6)))
    np.testing.assert_array_equal(moe.assign_pos(idx, 6).numpy(),
                                  _np(jmoe.assign_pos(idx, 6)))
    counts = rs.randint(0, 9, (3, 6))
    cap = rs.randint(0, 12, 6)
    np.testing.assert_array_equal(
        moe.limit_by_capacity(counts, cap, 3).numpy(),
        _np(jmoe.limit_by_capacity(counts, cap, 3)))
    np.testing.assert_array_equal(
        moe.prune_gate_by_capacity(idx, cap, 3, 2).numpy(),
        _np(jmoe.prune_gate_by_capacity(idx, cap, 3, 2)))
    for args in ((64, 4, 2, 1.0), (4, 64, 1, 1.0), (4096, 8, 2, 1.25),
                 (33, 3, 2, 0.01)):
        assert moe.default_capacity(*args) == jmoe.default_capacity(*args)
    for fn in (moe.global_scatter, moe.global_gather):
        with pytest.raises(NotImplementedError, match="MoELayer"):
            fn(None, None, None)


def _gate_pair(kind, seed, d=16, e=6, **kw):
    paddle_tpu.seed(seed)
    jcls = {"naive": jmoe.NaiveGate, "gshard": jmoe.GShardGate,
            "switch": jmoe.SwitchGate}[kind]
    jg = jcls(d, e, **kw)
    tg = moe.GATES[kind](d, e, device="cpu", **kw)
    tg.gate_weight.data.copy_(torch.tensor(np.array(jg.gate_weight)))
    return jg, tg


@pytest.mark.parametrize("kind,kw", [
    ("naive", {"topk": 2}), ("naive", {"topk": 3}),
    ("gshard", {"random_routing": False}), ("switch", {"switch_eps": 0.0})],
    ids=["naive_top2", "naive_top3", "gshard", "switch"])
def test_gates_match_the_reference(kind, kw):
    jg, tg = _gate_pair(kind, 1, **kw)
    x = np.random.RandomState(2).randn(40, 16).astype(np.float32)
    jval, jidx = jg(jnp.asarray(x))
    val, idx = tg(torch.as_tensor(x))
    np.testing.assert_allclose(val.detach().numpy(), _np(jval), rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_allclose(float(tg.get_loss().detach()),
                               float(jg.get_loss()),
                               rtol=1e-6, atol=1e-7)
    assert float(tg.aux_loss) == 0.0           # get_loss cleared it


def test_topk_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    val, idx = moe._topk(probs, 2)
    jval, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))


def test_random_routing_laws_with_a_supplied_draw():
    _, tg = _gate_pair("gshard", 3, random_routing=True)
    x = torch.as_tensor(np.random.RandomState(4).randn(64, 16)
                        .astype(np.float32))
    u = torch.as_tensor(np.random.RandomState(5).rand(64)
                        .astype(np.float32))
    val, idx = tg(x, noise=u)
    keep = 2.0 * val[:, 1] > u
    _, full = moe._topk(torch.softmax(tg.logits(x), -1), 2)
    assert torch.equal(idx[:, 0], full[:, 0])
    assert torch.equal(idx[:, 1], torch.where(keep, full[:, 1], -1))
    assert 0 < int(keep.sum()) < 64
    # eval: no random routing
    tg.eval()
    assert torch.equal(tg(x)[1], full)
    # drawn from the gate's generator: reproducible from its seed
    tg.train()
    tg.generator = torch.Generator().manual_seed(9)
    a = tg(x)[1]
    tg.generator.manual_seed(9)
    assert torch.equal(tg(x)[1], a)
    _, sw = _gate_pair("switch", 3, switch_eps=0.1)
    jit = 1.0 + 0.1 * (2 * torch.as_tensor(
        np.random.RandomState(6).rand(64, 6).astype(np.float32)) - 1)
    v, i = sw(x, noise=jit)
    want = moe._topk(torch.softmax(sw.logits(x) * jit, -1), 1)
    assert torch.equal(i, want[1]) and torch.equal(v, want[0])
    sw.generator = torch.Generator().manual_seed(1)
    drawn = sw._draw((4096, 6), "cpu") * 0.2 + 0.9
    assert 0.9 <= float(drawn.min()) and float(drawn.max()) <= 1.1
    sw.generator = None
    with pytest.raises(ValueError, match="generator"):
        sw(x)


def _moe_pair(seed, d, hidden, e, topk, factor):
    paddle_tpu.seed(seed)
    jm = jmoe.MoELayer(d, [jmoe.ExpertFFN(d, hidden) for _ in range(e)],
                       gate=jmoe.NaiveGate(d, e, topk=topk),
                       capacity_factor=factor)
    jm.train()
    tm = moe.MoELayer(d, [moe.ExpertFFN(d, hidden, device="cpu")
                          for _ in range(e)],
                      gate=moe.NaiveGate(d, e, topk=topk, device="cpu"),
                      capacity_factor=factor).train()
    params, buffers = state(jm)
    tm.load_state_dict({k: torch.as_tensor(_np(v))
                        for k, v in params.items()})
    return jm, tm, params, buffers


@pytest.mark.parametrize("factor", [4.0, 0.5], ids=["no_drop", "drops"])
def test_moe_layer_forward_and_gradients(factor):
    d, e = 16, 4
    jm, tm, params, buffers = _moe_pair(0, d, 32, e, 2, factor)
    rs = np.random.RandomState(1)
    x = rs.randn(3, 12, d).astype(np.float32)
    cot = rs.randn(3, 12, d).astype(np.float32)

    def loss(p, xx):
        out, nb = functional_call(jm, p, buffers, (xx,), train=True)
        return jnp.sum(out * cot), (out, nb)
    (_, (jout, jbuf)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = tm(tx)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), atol=ATOL)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jgp[k]), atol=ATOL,
                                   err_msg=k)
    for k in ("expert_util", "token_keep_rate"):
        np.testing.assert_allclose(float(getattr(tm, k)), float(jbuf[k]),
                                   rtol=1e-6)
    if factor < 1:
        assert float(tm.token_keep_rate) < 1.0       # tokens were dropped


@pytest.fixture(scope="module")
def gpt_moe_pair():
    paddle_tpu.seed(2)
    cfg = jax_gpt_moe_tiny(gate="gshard",
                           gate_kwargs={"random_routing": False})
    jm = JaxGPTMoE(cfg)
    jm.train()
    arrays = {k: _np(v) for k, v in jm.state_dict().items()}
    tm = GPTMoEForCausalLM(gpt_moe_tiny(
        gate="gshard", gate_kwargs={"random_routing": False}), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.train(), arrays


def test_gpt_moe_loss_and_gradients_match_the_reference(gpt_moe_pair):
    jm, tm, arrays = gpt_moe_pair
    assert list(tm.state_dict()) == list(arrays)
    ids = np.random.RandomState(3).randint(0, 256, (2, 17))
    x, y = ids[:, :-1], ids[:, 1:]
    params, buffers = state(jm)

    def loss(p):
        with bind_state(jm, p, buffers):
            return jm.loss(jnp.asarray(x), jnp.asarray(y))
    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    tl = tm.loss(torch.as_tensor(x), torch.as_tensor(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tm.gate_aux_loss().item() > 0.0        # gshard's aux engaged
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jg[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)
    # the (logits, buffers) form gives the same loss
    with torch.no_grad():
        logits = tm(torch.as_tensor(x))
        again = GPTMoEForCausalLM.loss_from_logits(
            logits, torch.as_tensor(y), dict(tm.named_buffers()),
            tm.cfg.aux_weight)
    np.testing.assert_allclose(float(again), tl.item(), rtol=1e-6)
