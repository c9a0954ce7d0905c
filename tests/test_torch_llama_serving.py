"""Llama served by the PyTorch port's ``ServingEngine``, unfused and with
``fused_decode=True``, against the JAX package on the same carried
weights, on the CPU.

llama_tiny in float32 (GQA 4/2, RMSNorm, rotary, SwiGLU: the Llama
wiring of the decode-block kernel pair).  The JAX side runs its engine
and, for one fused decode step, its Pallas kernel pair in interpret mode;
the port's CPU tensors take its kernels' plain versions.  Logits differ
by ~1e-6, far below any argmax gap here, so greedy tokens must be
IDENTICAL.  Seeded tokens are held inside the port (fused == unfused).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

ENGINE_KW = dict(num_slots=3, max_seq=64, min_bucket=8, block_len=16)


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.eval()


def _serve(eng, sampled=False, n_new=8):
    """Three requests, two of them sharing a 16-token prefix; the third
    arrives once the first holds its first token (a prefix-cache hit)."""
    rs = np.random.RandomState(3)
    prefix = rs.randint(0, 256, (16,))
    prompts = [np.concatenate([prefix, rs.randint(0, 256, (5,))]),
               rs.randint(0, 256, (11,)),
               np.concatenate([prefix, rs.randint(0, 256, (9,))])]
    rids = []
    for i, p in enumerate(prompts):
        sp = SamplingParams(do_sample=True, temperature=0.9, top_k=40,
                            seed=7 + i) if sampled else None
        kw = {} if sp is None else dict(sampling=sp)
        rids.append(eng.submit(p, max_new_tokens=n_new, **kw))
        if i == 0:
            while not eng.result(rids[0]).tokens:
                eng.step()
    eng.run_until_complete(300)
    return [eng.result(r).tokens for r in rids]


def test_fused_decode_step_matches_jax(models):
    """One fused decode step at ragged per-row positions: logits and the
    updated caches against the JAX fused_decode_step, and the port's
    unfused decode_step on the same caches."""
    jm, tm = models
    rs = np.random.RandomState(1)
    b, s = 3, 64
    pos = np.array([0, 23, 63], np.int32)
    ids = rs.randint(0, 256, (b, 1))
    caches = [(rs.randn(b, s, 2, 16).astype(np.float32) * 0.5,
               rs.randn(b, s, 2, 16).astype(np.float32) * 0.5)
              for _ in range(2)]

    def torch_caches():
        return [(torch.as_tensor(k).clone(), torch.as_tensor(v).clone(),
                 torch.as_tensor(pos)) for k, v in caches]
    jl, jc = jax.jit(jm.fused_decode_step)(
        jnp.asarray(ids), [(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
                           for k, v in caches], jnp.asarray(pos))
    tl, tc = tm.fused_decode_step(torch.as_tensor(ids), torch_caches(),
                                  torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for (jk, jv, jp), (tk, tv, tp) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ul, _ = tm.decode_step(torch.as_tensor(ids), torch_caches(),
                           torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), ul.numpy(), atol=1e-4, rtol=0)


def test_engines_greedy_tokens_equal_jax(models):
    jm, tm = models
    fused = ServingEngine(tm, fused_decode=True, **ENGINE_KW)
    unfused = ServingEngine(tm, **ENGINE_KW)
    assert (fused.decode_path, fused.decode_fallback_reason) == \
        ("fused", None)
    assert (unfused.decode_path, unfused.decode_fallback_reason) == \
        ("unfused", None)
    want = _serve(JaxEngine(jm, **ENGINE_KW))
    assert all(len(t) == 8 for t in want)
    assert _serve(unfused) == want
    assert unfused.metrics_dict()["prefix_hit_tokens"] > 0
    assert _serve(fused) == want


def test_seeded_tokens_fused_equal_unfused(models):
    _, tm = models
    a = _serve(ServingEngine(tm, fused_decode=True, **ENGINE_KW),
               sampled=True)
    b = _serve(ServingEngine(tm, **ENGINE_KW), sampled=True)
    assert a == b
