"""The parallel layers' reference call forms, recompute (remat) and
sequence parallelism of the port on the CPU.

* ``ColumnParallelLinear`` / ``RowParallelLinear`` /
  ``VocabParallelEmbedding`` built from the reference's call forms (a
  positional ``weight_attr`` included) give the JAX layers' outputs on the
  same weights (rtol 1e-6).
* remat off against remat on (full, and each policy name), with dropout
  drawing from the model's generator: the same loss, gradients within
  1e-6; Llama likewise; a no-grad forward never recomputes.
* the port against JAX with ``remat=True`` and ``"dots_saveable"``
  (``jax.value_and_grad`` of the mean loss under ``jax.jit``): loss at
  rtol 1e-5, gradients at atol 2e-5.
* the sequence-parallel collectives and Linear layers on per-rank lists
  against the whole-sequence products, and the hybrid trainer at mp 2 with
  ``sp`` on against off.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu
import paddle_tpu.distributed.meta_parallel.mp_layers as jmp
from paddle_tpu.distributed.meta_parallel.mp_layers import \
    parallel_cross_entropy as jax_parallel_cross_entropy
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional_call, state
from paddle_tpu_torch.distributed import (DistributedStrategy, Mesh, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.distributed.meta_parallel import (
    ColumnParallelLinear, ColumnSequenceParallelLinear, RowParallelLinear,
    RowSequenceParallelLinear, VocabParallelEmbedding,
    mark_as_sequence_parallel_parameter)
from paddle_tpu_torch.distributed.meta_parallel import \
    sequence_parallel as sp
from paddle_tpu_torch.distributed.recompute import (recompute,
                                                    recompute_sequential,
                                                    remat_wrap,
                                                    resolve_remat_policy)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTHybridTrainer, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.optimizer import SGD


@pytest.fixture(autouse=True)
def _no_group():
    yield
    topology.set_hybrid_communicate_group(None)


def _np(t):
    return t.detach().numpy()


def test_parallel_layers_take_the_reference_call_forms():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 8).astype(np.float32)
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 2)
    group = get_hybrid_communicate_group().get_model_parallel_group()
    col = ColumnParallelLinear(8, 24, None, True, gather_output=False,
                               mp_group=group, name="c", device="cpu")
    row = RowParallelLinear(24, 8, None, False, input_is_parallel=True,
                            fuse_matmul_bias=True, mp_group=None,
                            name="r", device="cpu")
    emb = VocabParallelEmbedding(16, 8, None, group, "e", device="cpu")
    assert col.bias is not None and row.bias is None
    assert (col.gather_output, row.input_is_parallel) == (False, True)
    assert col._param_specs == {"weight": (None, "mp"), "bias": ("mp",)}
    assert row._param_specs == {"weight": ("mp", None)}
    assert emb._param_specs == {"weight": ("mp", None)}
    ids = rs.randint(0, 16, (2, 3))
    jcol = jmp.ColumnParallelLinear(8, 24, None, True, gather_output=False)
    jrow = jmp.RowParallelLinear(24, 8, None, False, input_is_parallel=True)
    jemb = jmp.VocabParallelEmbedding(16, 8, None, None, "e")
    for layer, jlayer, inp in ((col, jcol, x),
                               (row, jrow, rs.randn(2, 3, 24).astype(
                                   np.float32)),
                               (emb, jemb, ids)):
        params = {k: jnp.asarray(_np(v)) for k, v in layer.named_parameters()}
        want, _ = functional_call(jlayer, params, {}, (jnp.asarray(inp),))
        np.testing.assert_allclose(_np(layer(torch.as_tensor(inp))),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 10"):
        ColumnParallelLinear(8, 24, object(), device="cpu")


def _gpt(cfg, seed=3):
    g = torch.Generator()
    g.manual_seed(seed)
    return GPTForCausalLM(cfg, device="cpu", generator=g).train()


def _loss_grads(model, ids):
    loss = model.loss(ids[:, :-1], ids[:, 1:])
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


REMATS = [True, "nothing_saveable", "everything_saveable", "dots_saveable",
          "checkpoint_dots", "dots_with_no_batch_dims_saveable",
          "checkpoint_dots_with_no_batch_dims"]


@pytest.mark.parametrize("remat", REMATS)
def test_remat_gives_the_same_loss_and_gradients(remat):
    """Dropout on, drawing from the model's generator: the replayed
    blocks draw the masks the forward drew."""
    cfg = gpt_tiny(dropout=0.1, remat=False)
    ids = torch.as_tensor(np.random.RandomState(1).randint(0, 256, (2, 17)))
    want, wg = _loss_grads(_gpt(cfg), ids)
    got, gg = _loss_grads(_gpt(dataclasses.replace(cfg, remat=remat)), ids)
    assert got == want
    for n in wg:
        torch.testing.assert_close(gg[n], wg[n], atol=1e-6, rtol=0)


def test_remat_paths_and_names():
    with pytest.raises(ValueError, match="dots_saveable"):
        resolve_remat_policy("save_anything_but_dots")
    with pytest.raises(ValueError, match="known"):
        GPTForCausalLM(gpt_tiny(remat="bogus"), device="cpu")(
            torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="item 9"):
        GPTConfig(cp="ring")
    calls = []

    def fn(x):
        calls.append(1)
        return torch.tanh(x) * 2
    x = torch.randn(3, 4, requires_grad=True)
    with torch.no_grad():
        remat_wrap(fn, True)(x)
    assert len(calls) == 1                   # no checkpoint without grad
    y = remat_wrap(fn, True)(x)
    y.sum().backward()
    assert len(calls) == 3                   # the forward, then the replay
    g = x.grad.clone()
    x.grad = None
    recompute(fn, x, use_reentrant=True).sum().backward()
    torch.testing.assert_close(x.grad, g)
    layers = [torch.nn.Linear(4, 4) for _ in range(4)]
    want = x
    for lyr in layers:
        want = lyr(want)
    got = recompute_sequential({"segments": 2}, layers, x)
    torch.testing.assert_close(got, want)
    # Llama's layers recompute likewise
    cfgs = [dataclasses.replace(llama_tiny(), remat=r) for r in (False, True)]
    out = []
    for cfg in cfgs:
        g = torch.Generator()
        g.manual_seed(5)
        m = LlamaForCausalLM(cfg, device="cpu", generator=g).train()
        ids = torch.as_tensor(np.random.RandomState(2).randint(0, 256, (2, 9)))
        out.append(_loss_grads(m, ids))
    assert out[0][0] == out[1][0]
    for n in out[0][1]:
        torch.testing.assert_close(out[1][1][n], out[0][1][n], atol=1e-6,
                                   rtol=0)


@pytest.fixture(scope="module")
def jax_remat():
    """JAX GPT's weights, batch and (loss, grads) under each remat."""
    ids = np.random.RandomState(4).randint(0, 256, (2, 33))
    out = {}
    for remat in (True, "dots_saveable"):
        paddle_tpu.seed(0)
        model = JaxGPT(jax_gpt_tiny(remat=remat))
        params, buffers = state(model)

        @jax.jit
        def grad(p, x, y):
            def loss_fn(p):
                o, _ = functional_call(model, p, buffers, (x,), train=True)
                return jnp.mean(jax_parallel_cross_entropy(o, y))
            return jax.value_and_grad(loss_fn)(p)
        loss, g = grad(params, jnp.asarray(ids[:, :-1]),
                       jnp.asarray(ids[:, 1:]))
        out[remat] = ({k: np.asarray(v) for k, v in
                       model.state_dict().items()}, float(loss),
                      {k: np.asarray(v) for k, v in g.items()})
    return ids, out


@pytest.mark.parametrize("remat", [True, "dots_saveable"],
                         ids=["full", "dots_saveable"])
def test_remat_matches_jax(jax_remat, remat):
    ids, out = jax_remat
    arrays, jloss, jgrads = out[remat]
    m = GPTForCausalLM(gpt_tiny(remat=remat), device="cpu").train()
    m.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    loss, grads = _loss_grads(m, torch.as_tensor(ids))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for k, want in jgrads.items():
        np.testing.assert_allclose(_np(grads[k]), want, atol=2e-5, err_msg=k)


def test_sequence_parallel_collectives_and_layers():
    mesh = Mesh(["cpu", "cpu:0"])
    rs = np.random.RandomState(6)
    x = torch.tensor(rs.randn(2, 6, 8).astype(np.float32),
                     requires_grad=True)
    shards = sp.scatter([x, x], mesh)
    assert [tuple(t.shape) for t in shards] == [(2, 3, 8)] * 2
    full = sp.all_gather(shards, mesh)
    torch.testing.assert_close(full[1], x)
    parts = [torch.tensor(rs.randn(2, 6, 8).astype(np.float32))
             for _ in range(2)]
    rsc = sp.ReduceScatterOp.apply(parts, mesh)
    torch.testing.assert_close(torch.cat(rsc, 1), parts[0] + parts[1])
    (full[0].sum() + 2 * full[1].sum()).backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 3.0))
    with pytest.raises(ValueError, match="sequence length"):
        sp.scatter([x[:, :5]] * 2, mesh)
    col = ColumnSequenceParallelLinear(8, 12, gather_output=False,
                                       device="cpu")
    row = RowSequenceParallelLinear(12, 8, input_is_parallel=True,
                                    device="cpu")
    h = col(shards, mesh)              # each rank: whole sequence, its cols
    y = row(h, mesh)                   # each rank: its rows of the sum
    torch.testing.assert_close(torch.cat(y, 1), row(col(x)), atol=1e-5,
                               rtol=1e-5)
    assert mark_as_sequence_parallel_parameter(col.weight).sequence_parallel


def _mp2(sp_on, layers=2, remat=False):
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=s, devices=["cpu"] * 2)
    g = torch.Generator()
    g.manual_seed(8)
    cfg = dataclasses.replace(gpt_tiny(), num_layers=layers, sp=sp_on,
                              remat=remat)
    return GPTHybridTrainer(cfg, get_hybrid_communicate_group(),
                            SGD(learning_rate=0.1), generator=g)


def test_sp_on_matches_sp_off_at_mp2():
    off = _mp2(False)
    x, y = off.make_batch(4, 16, seed=2)
    want = [float(off.train_step(x, y)) for _ in range(2)]
    on = _mp2(True, remat=True)
    assert on.sp and not off.sp
    got = [float(on.train_step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ref = off.state_dict()
    for k, v in on.state_dict().items():
        torch.testing.assert_close(v, ref[k], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        on.train_step(x[:, :15], y[:, :15])
