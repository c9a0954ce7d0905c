"""GPT in the PyTorch port (paddle_tpu_torch/models) against the JAX
reference on the CPU, on weights carried key for key.

Float32 throughout; logits agree at atol 1e-4 (the two frameworks sum in
different orders), greedy tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.eval(), arrays


def _ids(shape, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_state_dict_round_trip(models):
    _, tm, arrays = models
    sd = tm.state_dict()
    assert list(sd) == list(arrays)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])
    assert tuple(sd["gpt.h.0.qkv.weight"].shape) == (64, 192)


def test_state_dict_errors_name_the_key(models):
    _, _, arrays = models
    bad = dict(arrays)
    del bad["gpt.h.1.fc_in.bias"]
    with pytest.raises(KeyError, match=r"gpt\.h\.1\.fc_in\.bias"):
        state_dict_from_jax(bad, "cpu", "float32")
    bad = dict(arrays, **{"gpt.h.0.extra": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match=r"gpt\.h\.0\.extra"):
        state_dict_from_jax(bad, "cpu", "float32")
    bad = dict(arrays)
    bad["gpt.h.0.out_proj.weight"] = np.zeros((64, 63), np.float32)
    with pytest.raises(ValueError, match=r"gpt\.h\.0\.out_proj\.weight"):
        state_dict_from_jax(bad, "cpu", "float32")


def test_uncached_logits_match_jax(models):
    jm, tm, _ = models
    ids = _ids((2, 13))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    want = jax.jit(lambda i: jm(i))(jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_decode_step_scalar_and_per_row_positions(models):
    jm, tm, _ = models
    ids = _ids((3, 9), seed=1)
    jc = jm.init_cache(3, 24)
    tc = tm.init_cache(3, 24)
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


def test_positions_past_the_table_give_nan_rows(models):
    """jnp.take's fill semantics: a position >= max_seq_len embeds to a
    NaN row (no raise, no device assert); earlier rows stay finite."""
    jm, tm, _ = models
    ids = _ids((2, 4), seed=3)
    off = np.array([10, 126], np.int32)        # row 1 runs past 128
    want = np.asarray(jm.gpt.embed(jnp.asarray(ids), jnp.asarray(off)))
    got = tm.gpt.embed(torch.as_tensor(ids), torch.as_tensor(off))
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 2:]).all() and np.isfinite(got[1, :2]).all()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], atol=ATOL)


def test_greedy_generate_matches_jax(models):
    jm, tm, _ = models
    ids = _ids((2, 7), seed=4)
    want = np.asarray(jax.jit(lambda i: jm.generate(i, max_new_tokens=8))(
        jnp.asarray(ids)))
    got = tm.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    # ragged right-padded prompts, and eos with pad fill
    lens = np.array([4, 7], np.int32)
    eos = int(want[0, 9])
    kw = dict(max_new_tokens=6, eos_token_id=eos, pad_token_id=1)
    want = np.asarray(jax.jit(lambda i, n: jm.generate(i, prompt_lens=n,
                                                       **kw))(
        jnp.asarray(ids), jnp.asarray(lens)))
    got = tm.generate(ids, prompt_lens=lens, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPTForCausalLM(gpt_tiny())
