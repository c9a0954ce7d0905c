"""Serving in the PyTorch port (paddle_tpu_torch/serving) against the
JAX ``ServingEngine`` on the same carried weights, on the CPU.

Greedy tokens must be IDENTICAL per request: the engine is a scheduler
around the same decode arithmetic, and at gpt_tiny in float32 the two
frameworks' logits differ by ~1e-6, far below any argmax gap here.
Seeded sampling is held inside the port (engine == the port's
``generate`` with the same seed): a ``torch.Generator`` does not
reproduce ``jax.random`` streams.  Across packages the sampling filter
masks are compared instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.generation import _filter_top_k as jax_top_k
from paddle_tpu.models.generation import _filter_top_p as jax_top_p
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.engine import _filter_top_k_rows as jax_top_k_rows
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.models.generation import _filter_top_k, _filter_top_p
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving.engine import _filter_top_k_rows

ENGINE_KW = dict(num_slots=3, min_bucket=8, block_len=16)


def _carry(jax_cfg, cfg, seed=0):
    paddle_tpu.seed(seed)
    jm = JaxGPT(jax_cfg)
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models():
    return _carry(jax_gpt_tiny(), gpt_tiny())


@pytest.fixture(scope="module")
def engines(models):
    jm, tm = models
    return JaxEngine(jm, **ENGINE_KW), ServingEngine(tm, **ENGINE_KW)


def _prompts(seed, lengths, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lengths]


def _serve_both(jeng, teng, prompts, max_new_tokens, **kw):
    jout = [jeng.submit(p, max_new_tokens=max_new_tokens, **kw)
            for p in prompts]
    tout = [teng.submit(p, max_new_tokens=max_new_tokens, **kw)
            for p in prompts]
    jeng.run_until_complete(400)
    teng.run_until_complete(400)
    return ([jeng.purge(r) for r in jout], [teng.purge(r) for r in tout])


def test_prefix_wave_greedy_identical(engines):
    jeng, teng = engines
    prefix = _prompts(10, (32,))[0]
    own = _prompts(11, (5, 3, 9, 6))
    wave1 = [np.concatenate([prefix, own[0]])]
    wave2 = [np.concatenate([prefix, own[1]]),
             np.concatenate([prefix, own[2]]), own[3]]
    hits0 = (jeng.metrics_dict()["prefix_hit_tokens"],
             teng.metrics_dict()["prefix_hit_tokens"])
    for wave in (wave1, wave2):
        jo, to = _serve_both(jeng, teng, wave, 6)
        for a, b in zip(jo, to):
            assert b.finished and b.status == "finished"
            assert b.tokens == a.tokens
            assert b.prefix_hit_tokens == a.prefix_hit_tokens
    hits = (jeng.metrics_dict()["prefix_hit_tokens"] - hits0[0],
            teng.metrics_dict()["prefix_hit_tokens"] - hits0[1])
    assert hits[0] > 0 and hits[1] == hits[0]


def test_chunked_prefill_greedy_identical(models):
    jm, tm = models
    jeng = JaxEngine(jm, prefill_chunk=16, **ENGINE_KW)
    teng = ServingEngine(tm, prefill_chunk=16, **ENGINE_KW)
    prompts = _prompts(12, (40, 21, 7))
    jo, to = _serve_both(jeng, teng, prompts, 5)
    for a, b in zip(jo, to):
        assert b.tokens == a.tokens and len(b.tokens) == 5
    assert teng.metrics_dict()["prefill_chunks"] >= 3 + 2 + 1


def test_idle_slot_runs_past_max_seq():
    """Free slots ride along in every decode step and their position
    grows past max_seq: the port's writes must clamp at the row end and
    its positions past the table must embed to NaN without raising —
    the live request's tokens stay identical to the JAX engine's."""
    fields = dict(vocab_size=256, hidden_size=64, num_layers=2,
                  num_heads=4, max_seq_len=32)
    jm, tm = _carry(JaxConfig(**fields), GPTConfig(**fields), seed=1)
    jeng, teng = JaxEngine(jm, **ENGINE_KW), ServingEngine(tm, **ENGINE_KW)
    for seed in (13, 14):             # one request at a time: slot 0 busy
        jo, to = _serve_both(jeng, teng, _prompts(seed, (4,)), 27)
        assert to[0].tokens == jo[0].tokens and len(to[0].tokens) == 27
    idle = teng.core.pool.seq_pos.numpy()[1:]
    assert (idle > 32).all()          # idle rows went past max_seq
    np.testing.assert_array_equal(
        idle, np.asarray(jeng.core.pool.seq_pos)[1:])


def test_engine_matches_port_generate_greedy_and_seeded(models):
    _, tm = models
    teng = ServingEngine(tm, **ENGINE_KW)
    prompts = _prompts(15, (6, 11, 9))
    params = [SamplingParams(),
              SamplingParams(do_sample=True, temperature=1.3, top_k=20,
                             top_p=0.9, seed=5),
              SamplingParams(do_sample=True, temperature=0.7, seed=9)]
    rids = [teng.submit(p, max_new_tokens=7, sampling=s)
            for p, s in zip(prompts, params)]
    teng.run_until_complete(100)
    for rid, p, s in zip(rids, prompts, params):
        kw = {} if not s.do_sample else dict(
            do_sample=True, temperature=s.temperature, top_k=s.top_k,
            top_p=s.top_p, seed=s.seed)
        want = tm.generate(p[None], max_new_tokens=7, **kw)[0, len(p):]
        assert teng.result(rid).tokens == want.tolist()


def test_allowed_tokens_obeyed(engines):
    jeng, teng = engines
    allowed = [3, 17, 42, 99, 200]
    prompts = _prompts(16, (9, 4))
    jo, to = _serve_both(jeng, teng, prompts, 6, allowed_tokens=allowed)
    for a, b in zip(jo, to):
        assert set(b.tokens) <= set(allowed)
        assert b.tokens == a.tokens


def test_engine_lifecycle_eos_cancel_deadline_queue(models):
    """Port-only contracts of the request surface: eos stops a request
    early with generate()'s tokens, cancel/purge free every resource
    from any state, a blown deadline ends a request terminally, and
    max_queue rejects with a RequestRejected carrying its output."""
    from paddle_tpu_torch.serving import RequestRejected
    _, tm = models
    teng = ServingEngine(tm, max_queue=2, **ENGINE_KW)
    p = _prompts(18, (7,))[0]
    free = tm.generate(p[None], max_new_tokens=6)[0, len(p):].tolist()
    rid = teng.submit(p, max_new_tokens=6, eos_token_id=free[2])
    teng.run_until_complete(50)
    out = teng.purge(rid)
    stop = free.index(free[2])
    assert out.finish_reason == "eos" and out.tokens == free[:stop + 1]
    # cancel while queued, mid-prefill-free decode, and after finishing
    a = teng.submit(p, max_new_tokens=20)
    b = teng.submit(p, max_new_tokens=20)
    with pytest.raises(RequestRejected) as exc:
        teng.submit(p, max_new_tokens=4)          # queue holds 2
    assert exc.value.reason == "queue_full"
    assert exc.value.output.status == "rejected"
    assert teng.cancel(a).status == "cancelled"   # still queued
    teng.step()                                   # b admitted, decoding
    assert teng.cancel(b).status == "cancelled"
    assert teng.cancel(b).status == "cancelled"   # idempotent
    c = teng.submit(p, max_new_tokens=20, deadline_s=0.0)
    teng.run_until_complete(50)
    assert teng.result(c).status == "deadline_exceeded"
    core = teng.core
    assert core.pool.free_slots == ENGINE_KW["num_slots"]
    assert not core._slots and not core._prefills
    m = teng.metrics_dict()
    assert m["requests_cancelled"] == 2 and m["requests_rejected"] == 1
    assert m["requests_deadline_exceeded"] == 1
    teng.close()
    with pytest.raises(RuntimeError, match="closed"):
        teng.submit(p, max_new_tokens=2)


def test_filter_masks_match_jax():
    rs = np.random.RandomState(17)
    logits = rs.randn(6, 256).astype(np.float32)
    logits[2, 10:20] = logits[2, 5]            # ties resolve by vocab order
    tl = torch.as_tensor(logits)
    top_k = np.array([0, 1, 5, 40, 256, 3], np.int32)
    np.testing.assert_array_equal(
        np.isinf(_filter_top_k_rows(tl, top_k).numpy()),
        np.isinf(np.asarray(jax_top_k_rows(jnp.asarray(logits),
                                           jnp.asarray(top_k)))))
    p = np.array([0.1, 0.5, 0.9, 0.99, 1.0, 0.3], np.float32)[:, None]
    np.testing.assert_array_equal(
        np.isinf(_filter_top_p(tl, torch.as_tensor(p)).numpy()),
        np.isinf(np.asarray(jax_top_p(jnp.asarray(logits),
                                      jnp.asarray(p)))))
    for k in (1, 7):
        np.testing.assert_array_equal(
            np.isinf(_filter_top_k(tl, k).numpy()),
            np.isinf(np.asarray(jax_top_k(jnp.asarray(logits), k))))


def test_tensor_parallel_properties_match_jax(models):
    """``ServingEngine.tensor_parallel`` / ``tp_fusion_reason`` equal the
    reference's: tp=1, and tp=2 with the ring programs turned off (the
    port's shards on two CPU devices; each tp engine re-lays its own
    model)."""
    for kw in (dict(), dict(tensor_parallel=2, collective_fusion=False)):
        jm, tm = _carry(jax_gpt_tiny(), gpt_tiny())
        jeng = JaxEngine(jm, num_slots=4, **kw)
        teng = ServingEngine(tm, num_slots=4, devices=["cpu"] * 2, **kw) \
            if kw else ServingEngine(tm, num_slots=4)
        assert (teng.tensor_parallel, teng.tp_fusion_reason) == (
            jeng.tensor_parallel, jeng.tp_fusion_reason), kw
        assert teng.tensor_parallel == kw.get("tensor_parallel", 1)


def test_generate_output_scores_match_jax(models):
    """Greedy ``generate(..., output_scores=True)`` returns ``(seq,
    scores)``: the tokens equal the reference's, the pre-sampling f32
    logits [batch, new, vocab] agree at atol 1e-4 (summation order)."""
    jm, tm = models
    ids = np.random.RandomState(8).randint(0, 256, (2, 6))
    want_seq, want_scores = jax.jit(lambda i: jm.generate(
        i, max_new_tokens=5, output_scores=True))(jnp.asarray(ids))
    seq, scores = tm.generate(ids, max_new_tokens=5, output_scores=True)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    assert scores.dtype == torch.float32
    assert scores.shape == (2, 5, gpt_tiny().vocab_size)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=1e-4)
    assert torch.equal(tm.generate(ids, max_new_tokens=5), seq)


def test_serving_engine_parameter_order_follows_jax(models):
    """The names both ``ServingEngine``s take keep the reference's
    relative order, and a positional call past ``prefix_blocks`` (where
    the reference's ``record_events`` comes next) raises instead of
    binding to another parameter."""
    import inspect
    ref = list(inspect.signature(JaxEngine.__init__).parameters)
    port = list(inspect.signature(ServingEngine.__init__).parameters)
    shared = [n for n in port if n in ref]
    assert shared == [n for n in ref if n in port]
    assert set(port) - set(ref) == {"devices"}
    positional = port[:port.index("prefix_blocks") + 1]
    assert positional == ref[:len(positional)]
    _, tm = models
    args = (8, None, 16, None, None, None, True, 16, None)
    with pytest.raises(TypeError):
        ServingEngine(tm, *args, False)


def test_metrics_reset_and_pool_slots_match_jax():
    """ServingMetrics.reset, KVPool.used_slots and KVPool.reset do what the
    reference's do on the same call sequence: a reset zeroes the engine's
    counters, histograms and tracer but keeps the tp degree; a pool reset
    frees every slot (lowest first again) and parks every position at 0."""
    from paddle_tpu.serving.kv_pool import KVPool as JaxPool
    from paddle_tpu.serving.metrics import ServingMetrics as JaxMetrics
    from paddle_tpu_torch.serving.kv_pool import KVPool
    from paddle_tpu_torch.serving.metrics import ServingMetrics
    ms = (JaxMetrics(), ServingMetrics())
    for m in ms:
        m.set_tp_degree(2)
        m.on_submit(3)
        m.on_prefill(12)
        m.on_prefill_chunk(12, 0.01)
        m.on_first_token(0.0, now=0.25)
        m.on_output_token(0.02)
        m.on_finish()
        m.record_step(2, 4, 1, 2, 0.03, phases=[("decode", 0.0, 0.01)])
        m.tracer.event("probe", lane=m.engine_lane)
    snaps = [m.snapshot() for m in ms]
    keys = sorted(set(snaps[0]) & set(snaps[1]))
    assert [snaps[1][k] for k in keys] == [snaps[0][k] for k in keys]
    assert snaps[1]["requests_submitted"] == 3
    for m in ms:
        m.reset()
    snaps = [m.snapshot() for m in ms]
    assert [snaps[1][k] for k in keys] == [snaps[0][k] for k in keys]
    assert snaps[1]["steps"] == 0 and snaps[1]["ttft_p50_ms"] is None
    for m in ms:
        assert m.registry.snapshot()["serving.tp_degree"] == 2
        assert not m.tracer.events("probe")
        assert m.registry.snapshot()["serving.phase.decode_s"]["count"] == 0
    pools = (JaxPool(4, 8, 1, 1, 8), KVPool(4, 8, 1, 1, 8, device="cpu"))
    for p in pools:
        got = [p.alloc(), p.alloc(), p.alloc()]
        p.free(got[1])
        p.adopt(got[0], [(torch.zeros(1, 8, 1, 8),) * 2] if
                isinstance(p, KVPool) else
                [(jnp.zeros((1, 8, 1, 8)),) * 2], 5)
    assert [p.used_slots for p in pools] == [2, 2]
    assert [p.free_slots for p in pools] == [2, 2]
    for p in pools:
        p.reset()
    assert [p.used_slots for p in pools] == [0, 0]
    assert [p.free_slots for p in pools] == [4, 4]
    np.testing.assert_array_equal(pools[1].seq_pos.numpy(),
                                  np.asarray(pools[0].seq_pos))
    assert [p.alloc() for p in pools] == [0, 0]
