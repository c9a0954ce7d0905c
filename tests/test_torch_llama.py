"""Llama in the PyTorch port (paddle_tpu_torch/models/llama.py) against
the JAX reference on the CPU, on weights carried key for key.

llama_tiny (4 heads over 2 kv heads: GQA) in float32 throughout: logits,
the loss and every parameter's gradient agree at atol 1e-4 (the two
frameworks sum in different orders), greedy tokens exactly.  Every
RMSNorm runs through the fused-norm ``autograd.Function`` (its plain
version on the CPU), so the gradients cover kernels 7 and 8's
decomposition.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.llama import _rope_tables as jax_rope_tables
from paddle_tpu.models.llama import \
    apply_rotary_pos_emb as jax_apply_rotary
from paddle_tpu.nn import state
from paddle_tpu.nn.functional_call import bind_state
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_7b, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.models.llama import _rope_tables, apply_rotary_pos_emb

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.eval(), arrays


def _ids(shape, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_state_dict_names_shapes_and_params(models):
    _, tm, arrays = models
    sd = tm.state_dict()
    assert list(sd) == list(arrays)
    assert tuple(sd["llama.layers.0.self_attn.k_proj.weight"].shape) == \
        (64, 32)
    assert sum(p.numel() for p in tm.parameters()) == \
        llama_tiny().num_params()
    assert llama_7b().num_params() == 6_738_415_616


def test_convert_errors_name_the_key(models):
    _, _, arrays = models
    bad = dict(arrays)
    del bad["llama.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError,
                       match=r"llama\.layers\.1\.mlp\.up_proj\.weight"):
        state_dict_from_jax(bad, "cpu", "float32")
    bad = dict(arrays, **{"llama.layers.0.extra": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match=r"llama\.layers\.0\.extra"):
        state_dict_from_jax(bad, "cpu", "float32")
    bad = dict(arrays)
    bad["llama.layers.0.self_attn.v_proj.weight"] = np.zeros((64, 16),
                                                             np.float32)
    with pytest.raises(ValueError,
                       match=r"llama\.layers\.0\.self_attn\.v_proj\.weight"):
        state_dict_from_jax(bad, "cpu", "float32")
    with pytest.raises(ValueError, match=r"llama\.embed_tokens\.weight"):
        state_dict_from_jax(arrays, "cpu", "float32",
                            cfg=dataclasses.replace(llama_tiny(),
                                                    vocab_size=300))
    sd = state_dict_from_jax(arrays, "cpu", "bfloat16", cfg=llama_tiny())
    assert sd["llama.norm.weight"].dtype == torch.bfloat16


def test_rotary_tables_and_rotation_match_jax():
    pos = np.array([[0, 1, 2], [7, 8, 9]], np.int32)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        for p in (pos[0], pos):
            cos, sin = _rope_tables(torch.as_tensor(p), 16, 10000.0, dtype)
            jcos, jsin = jax_rope_tables(jnp.asarray(p), 16, 10000.0, jdt)
            assert cos.dtype == dtype and tuple(cos.shape) == jcos.shape
            tol = 1e-6 if dtype == torch.float32 else 8e-3
            np.testing.assert_allclose(cos.float().numpy(),
                                       np.asarray(jcos, np.float32), atol=tol)
            np.testing.assert_allclose(sin.float().numpy(),
                                       np.asarray(jsin, np.float32), atol=tol)
    x = np.random.RandomState(1).randn(2, 3, 4, 16).astype(np.float32)
    for p in (pos[0], pos):
        cos, sin = _rope_tables(torch.as_tensor(p), 16, 10000.0,
                                torch.float32)
        jcos, jsin = jax_rope_tables(jnp.asarray(p), 16, 10000.0,
                                     jnp.float32)
        got = apply_rotary_pos_emb(torch.as_tensor(x), cos, sin)
        want = jax_apply_rotary(jnp.asarray(x), jcos, jsin)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_uncached_logits_match_jax(models):
    jm, tm, _ = models
    ids = _ids((2, 13))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    want = jax.jit(lambda i: jm(i))(jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_loss_and_every_gradient_match_jax(models):
    jm, _, arrays = models
    ids = _ids((2, 17), seed=5)
    x, y = ids[:, :-1], ids[:, 1:]
    params, buffers = state(jm)

    def loss_fn(p):
        with bind_state(jm, p, buffers):
            return jm.loss(jnp.asarray(x), jnp.asarray(y))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu").train()
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    loss = tm.loss(torch.as_tensor(x), torch.as_tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=ATOL, err_msg=name)
        assert bool((p.grad != 0).any()), name


def test_decode_step_scalar_and_per_row_positions(models):
    jm, tm, _ = models
    ids = _ids((3, 9), seed=1)
    jc = jm.init_cache(3, 24)
    tc = tm.init_cache(3, 24)
    assert tuple(tc[0][0].shape) == (3, 24, 2, 16)      # kv heads, no repeat
    # the reference side under jit, as it serves (eager dispatch of every
    # op costs seconds here)
    step = jax.jit(jm.decode_step)
    jl, jc = jax.jit(lambda i, c: jm.decode_step(i, c, 0))(jnp.asarray(ids),
                                                           jc)
    tl, tc = tm.decode_step(torch.as_tensor(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # one more token per row at ragged per-row positions
    pos = np.array([9, 5, 7], np.int32)
    nxt = _ids((3, 1), seed=2)
    jc = [(c[0], c[1], jnp.asarray(pos)) for c in jc]
    tc = [(c[0], c[1], torch.as_tensor(pos)) for c in tc]
    jl, jc = step(jnp.asarray(nxt), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(torch.as_tensor(nxt), tc, torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for (jk, jv, jp), (tk, tv, tp) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_greedy_generate_matches_jax(models):
    jm, tm, _ = models
    ids = _ids((2, 7), seed=4)
    want = np.asarray(jax.jit(lambda i: jm.generate(i, max_new_tokens=8))(
        jnp.asarray(ids)))
    got = tm.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    lens = np.array([4, 7], np.int32)
    want = np.asarray(jax.jit(lambda i, n: jm.generate(
        i, max_new_tokens=6, prompt_lens=n))(jnp.asarray(ids),
                                             jnp.asarray(lens)))
    got = tm.generate(ids, max_new_tokens=6, prompt_lens=lens).numpy()
    np.testing.assert_array_equal(got, want)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LlamaForCausalLM(llama_tiny())
