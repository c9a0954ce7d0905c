"""The GPT train step of the PyTorch port (``GPTHybridTrainer`` with
``AdamW`` / ``FusedAdamW``, ``GPTForCausalLM.loss``, flash attention's
autograd path) against the JAX package on the CPU.

gpt_tiny in f32, weights carried key for key from the JAX model.  The
JAX side is the jitted step of ``bench.py``: ``functional_call`` ->
``parallel_cross_entropy`` -> ``jax.value_and_grad`` -> ``AdamW.update``
(its ``FusedAdamW`` inside ``jax.jit`` would put one interpreted Pallas
call per tensor into the compile; the two are equal without
``apply_decay_param_fun``, and tests/test_torch_fused_adamw.py holds the
port's ``FusedAdamW`` to the JAX one).  Losses agree at rtol 1e-5;
parameters at atol 1e-4.  Adam's first steps move each element by about
±lr = 1e-3 whatever the gradient's size, so a near-zero gradient whose
sign differs between the two frameworks shows as up to 2·lr per step.
The key slice of each ``qkv.bias`` is such a case: softmax is invariant
to a shift of every key, so its exact gradient is 0 and both frameworks
see rounding noise (~1e-10); it is held to its bound, 2·lr per step.
The largest difference elsewhere is reported.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.meta_parallel.mp_layers import \
    parallel_cross_entropy as jax_parallel_cross_entropy
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional_call, state
from paddle_tpu_torch.distributed.meta_parallel import parallel_cross_entropy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTHybridTrainer,
                                     gpt_tiny, state_dict_from_jax)
from paddle_tpu_torch.optimizer import AdamW, FusedAdamW

LR = 1e-3
BATCH, SEQ, STEPS = 2, 32, 2


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's weights, its batch, and the losses / parameters
    after STEPS jitted train steps."""
    paddle_tpu.seed(0)
    model = JaxGPT(jax_gpt_tiny())
    params, buffers = state(model)
    arrays = {k: np.asarray(v) for k, v in model.state_dict().items()}
    o = jopt.AdamW(learning_rate=LR)
    ostate = o.init(params)
    ids = np.random.RandomState(0).randint(0, 256, (BATCH, SEQ + 1))
    x, y = jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, 1:])

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(p, os_, x, y):
        def loss_fn(p):
            out, _ = functional_call(model, p, buffers, (x,), train=True)
            return jnp.mean(jax_parallel_cross_entropy(out, y))
        loss, g = jax.value_and_grad(loss_fn)(p)
        newp, nos = o.update(g, os_, p)
        return newp, nos, loss

    losses = []
    for _ in range(STEPS):
        params, ostate, loss = step(params, ostate, x, y)
        losses.append(float(loss))
    return arrays, ids, losses, {k: np.asarray(v) for k, v in params.items()}


def _trainer(cls, arrays):
    tr = GPTHybridTrainer(gpt_tiny(), optimizer=cls(learning_rate=LR),
                          device="cpu")
    tr.model.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return tr


def test_make_batch_draws_the_reference_ids(jax_run):
    arrays, ids, _, _ = jax_run
    tr = _trainer(AdamW, arrays)
    x, y = tr.make_batch(BATCH, SEQ, seed=0)
    assert x.dtype == torch.long and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), ids[:, :-1])
    np.testing.assert_array_equal(y.numpy(), ids[:, 1:])


@pytest.mark.parametrize("cls", [AdamW, FusedAdamW],
                         ids=["AdamW", "FusedAdamW"])
def test_train_steps_match_jitted_jax_step(jax_run, cls):
    arrays, _, jlosses, jparams = jax_run
    tr = _trainer(cls, arrays)
    x, y = tr.make_batch(BATCH, SEQ, seed=0)
    losses = [float(tr.train_step(x, y)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    h = gpt_tiny().hidden_size
    worst = 0.0
    for k, want in jparams.items():
        diff = np.abs(got[k] - want)
        if k.endswith("qkv.bias"):
            assert diff[h:2 * h].max() <= 2 * LR * STEPS, k
            diff = np.concatenate([diff[:h], diff[2 * h:]])
        worst = max(worst, float(diff.max()))
    assert worst <= 1e-4, f"largest parameter difference {worst:.3g}"
    assert tr.opt.state["step"] == STEPS
    assert all(p.grad is None for p in tr.model.parameters())


def test_loss_is_mean_parallel_cross_entropy_with_ignore_index(jax_run):
    arrays, ids, _, _ = jax_run
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 5, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, (2, 5))
    labels[0, 1] = labels[1, 4] = -100
    want = np.asarray(jax_parallel_cross_entropy(jnp.asarray(logits),
                                                 jnp.asarray(labels)))
    got = parallel_cross_entropy(torch.as_tensor(logits),
                                 torch.as_tensor(labels)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0, 1] == 0.0 and got[1, 4] == 0.0
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    x, y = (torch.as_tensor(ids[:, :-1]), torch.as_tensor(ids[:, 1:]))
    with torch.no_grad():
        want = parallel_cross_entropy(m(x), y).mean()
        np.testing.assert_allclose(m.loss(x, y).item(), want.item(),
                                   rtol=1e-6)


def test_trainer_refuses_parallel_degrees_and_needs_an_optimizer():
    """The degree the port's trainer does not take yet raises, naming its
    ROADMAP item (dp / mp / pp / sharding are taken:
    tests/test_torch_hybrid.py; ep, replicated as the reference's:
    tests/test_torch_moe_hybrid.py); every trainer needs an
    optimizer."""
    from paddle_tpu_torch.distributed import HybridCommunicateGroup
    hcg = HybridCommunicateGroup(devices=["cpu"] * 2, sep_degree=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        GPTHybridTrainer(gpt_tiny(), hcg, AdamW())
    hcg = HybridCommunicateGroup(devices=["cpu"] * 2, ep_degree=2)
    tr = GPTHybridTrainer(gpt_tiny(), hcg, AdamW())
    assert tr.rank_state(1) == tr.rank_state(0)     # ep ranks: replicas
    with pytest.raises(ValueError, match="optimizer"):
        GPTHybridTrainer(gpt_tiny(), device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        GPTHybridTrainer(gpt_tiny(), HybridCommunicateGroup(
            dp_degree=2, devices=["cpu"] * 2))


def test_decode_attention_refuses_inputs_that_require_grad():
    """The CUDA wrapper has no backward: it raises before it looks at the
    device, so no kernel can drop a gradient silently."""
    from paddle_tpu_torch.kernels.decode_attention import decode_attention
    q = torch.zeros(1, 2, 2, 64, requires_grad=True)
    kv = torch.zeros(1, 8, 2, 64)
    lens = torch.tensor([2])
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, kv, kv, lens)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, kv, kv, lens)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_uncached_backward_reaches_every_qkv_weight_on_the_card(card):
    """On a card, the backward of a loss of the uncached ``model(ids)``
    goes through the flash kernels' autograd path: every layer's qkv weight gets a nonzero
    gradient, and the gradients equal the CPU's (plain versions) at
    atol 1e-4 (f32, TF32 off)."""
    from dataclasses import replace
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
    # head_dim 64; remat off: one flash forward a layer
    cfg = replace(gpt_tiny(), hidden_size=256, num_heads=4, remat=False)
    cpu = GPTForCausalLM(cfg, device="cpu")
    gpu = GPTForCausalLM(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (2, 96)))
    for k in (flash_attention_fwd, flash_attention_bwd_dq,
              flash_attention_bwd_dkv):
        k.launches = 0
    for m, x in ((cpu, ids), (gpu, ids.to(card))):
        m(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == cfg.num_layers
    assert flash_attention_bwd_dq.launches == cfg.num_layers
    assert flash_attention_bwd_dkv.launches == cfg.num_layers
    for (name, pc), (_, pg) in zip(cpu.named_parameters(),
                                   gpu.named_parameters()):
        assert pg.grad is not None, name
        if name.endswith("qkv.weight"):
            assert bool((pg.grad != 0).any()), name
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, atol=1e-4,
                                   rtol=1e-4)
