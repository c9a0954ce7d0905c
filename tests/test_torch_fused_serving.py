"""The fused decode-block path of the PyTorch port's serving
(``ServingEngine(fused_decode=True)``) against the JAX package on the
same carried weights, on the CPU.

The JAX side runs its Pallas kernel pair in interpret mode; the port's
CPU tensors take the plain version of its kernels.  At gpt_tiny in
float32 the two frameworks' logits differ by ~1e-6, far below any argmax
gap here, so greedy tokens must be IDENTICAL.  Seeded tokens are held
inside the port (fused == unfused): a ``torch.Generator`` does not
reproduce ``jax.random`` streams.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

ENGINE_KW = dict(num_slots=3, max_seq=64, min_bucket=8, block_len=16)


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.eval()


def _serve(eng, lengths=(5, 11, 3, 20), n_new=8, sampled=False):
    rs = np.random.RandomState(3)
    rids = []
    for i, n in enumerate(lengths):
        sp = SamplingParams(do_sample=True, temperature=0.9, top_k=40,
                            seed=7 + i) if sampled else None
        kw = {} if sp is None else dict(sampling=sp)
        rids.append(eng.submit(rs.randint(0, 256, (n,)), max_new_tokens=n_new,
                               **kw))
    eng.run_until_complete(300)
    return [eng.result(r).tokens for r in rids]


def test_fused_decode_step_matches_jax(models):
    """One fused decode step per row position on carried weights: logits
    and the updated caches against JAX fused_decode_step."""
    jm, tm = models
    rs = np.random.RandomState(1)
    b, s = 3, 64
    pos = np.array([0, 23, 63], np.int32)
    ids = rs.randint(0, 256, (b, 1))
    caches = [(rs.randn(b, s, 4, 16).astype(np.float32) * 0.5,
               rs.randn(b, s, 4, 16).astype(np.float32) * 0.5)
              for _ in range(2)]
    jl, jc = jax.jit(jm.fused_decode_step)(
        jnp.asarray(ids), [(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
                           for k, v in caches], jnp.asarray(pos))
    tl, tc = tm.fused_decode_step(
        torch.as_tensor(ids), [(torch.as_tensor(k), torch.as_tensor(v),
                                torch.as_tensor(pos)) for k, v in caches],
        torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    for (jk, jv, jp), (tk, tv, tp) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # the unfused decode_step computes the same function
    ul, _ = tm.decode_step(
        torch.as_tensor(ids), [(torch.as_tensor(k), torch.as_tensor(v),
                                torch.as_tensor(pos)) for k, v in caches],
        torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), ul.numpy(), atol=1e-4, rtol=0)


def test_engines_resolve_and_greedy_tokens_identical(models):
    jm, tm = models
    jeng = JaxEngine(jm, fused_decode=True, **ENGINE_KW)
    fused = ServingEngine(tm, fused_decode=True, **ENGINE_KW)
    unfused = ServingEngine(tm, **ENGINE_KW)
    assert jeng.decode_path == "fused" and jeng.decode_fallback_reason is None
    assert fused.decode_path == "fused"
    assert fused.decode_fallback_reason is None
    assert unfused.decode_path == "unfused"
    assert unfused.decode_fallback_reason is None
    want = _serve(jeng)
    assert _serve(fused) == want
    assert _serve(unfused) == want
    assert all(len(t) == 8 for t in want)


def test_seeded_tokens_fused_equal_unfused(models):
    _, tm = models
    a = _serve(ServingEngine(tm, fused_decode=True, **ENGINE_KW),
               sampled=True)
    b = _serve(ServingEngine(tm, **ENGINE_KW), sampled=True)
    assert a == b


def test_float16_model_falls_back_and_keeps_serving():
    """float16 is refused by the kernels' legality check: the engine
    resolves "unfused", names the reason, and serves the flag-off tokens."""
    gen = torch.Generator().manual_seed(2)
    m16 = GPTForCausalLM(gpt_tiny(), device="cpu", dtype="float16",
                         generator=gen).eval()
    eng = ServingEngine(m16, fused_decode=True, **ENGINE_KW)
    assert eng.decode_path == "unfused"
    assert "float16" in eng.decode_fallback_reason
    off = ServingEngine(m16, **ENGINE_KW)
    assert _serve(eng, lengths=(5, 9), n_new=6) == \
        _serve(off, lengths=(5, 9), n_new=6)


def test_decode_block_event_and_histogram_only_on_fused(models):
    _, tm = models
    for fused in (True, False):
        eng = ServingEngine(tm, fused_decode=fused, **ENGINE_KW)
        _serve(eng, lengths=(4, 6), n_new=4)
        evs = eng.tracer.events("decode_block")
        assert len(evs) == 1
        attrs = evs[0][3]
        assert attrs["active"] is fused and attrs["reason"] == ""
        assert attrs["tp"] == 1
        snap = eng.registry.snapshot()
        decodes = snap["serving.phase.decode_dispatch_s"]["count"]
        assert decodes > 0
        assert snap["kernel.decode_block_s"]["count"] == \
            (decodes if fused else 0)
