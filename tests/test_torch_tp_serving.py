"""Tensor-parallel serving in the PyTorch port (``serving/tp.py``,
``EngineCore(tensor_parallel=)``) against its own tp=1 engine and the JAX
package's tp=2 engine, on the CPU.

The port's shards live on ``devices=["cpu"] * tp``; the JAX engine runs
on the conftest's virtual CPU devices.  Weights are carried from the JAX
models (``state_dict_from_jax``), f32.  Every tensor-parallel engine
re-lays its model in place, so each gets its own model built from the
same arrays.  Logits differ by ~1e-6 between the rungs and packages, far
below any argmax gap here, so greedy tokens must be IDENTICAL on all
three rungs (``tp_fused_block``, ``tp_fused``, ``unfused``), for GPT
(MHA, learned positions, tied head) and a GQA Llama (rotary, SwiGLU).
Seeded tokens are held inside the port (engine == ``generate``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving.tp import (build_serving_mesh,
                                         shard_model_params)

CPU2 = ["cpu", "cpu"]
NEW = 6
FAMILIES = {"gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
            "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM,
                      llama_tiny)}


def _jax_model(family):
    jcls, jcfg, _, _ = FAMILIES[family]
    paddle_tpu.seed(0)
    m = jcls(jcfg())
    m.eval()
    return m


@pytest.fixture(scope="module")
def arrays():
    return {f: {k: np.asarray(v) for k, v in _jax_model(f).state_dict()
                .items()} for f in FAMILIES}


def _port(arrays, family):
    _, _, tcls, tcfg = FAMILIES[family]
    m = tcls(tcfg(), device="cpu")
    m.load_state_dict(state_dict_from_jax(arrays[family], "cpu", "float32"))
    return m.eval()


def _prompts(seed=0, lengths=(5, 11, 3, 17, 30)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)) for n in lengths]


def _tokens(eng, prompts=None):
    outs = eng.serve_batch(prompts or _prompts(), max_new_tokens=NEW)
    assert all(o.finished for o in outs)
    return [list(o.tokens) for o in outs]


@pytest.fixture(scope="module")
def want(arrays):
    """Per family: the port's tp=1 tokens and the JAX package's tp=2
    engine's (composed ring)."""
    out = {}
    for family in FAMILIES:
        port1 = _tokens(ServingEngine(_port(arrays, family), num_slots=4))
        jeng = JaxEngine(_jax_model(family), num_slots=4, tensor_parallel=2)
        assert jeng.decode_path == "tp_fused"
        out[family] = (port1, _tokens(jeng))
    return out


RUNGS = [
    # (engine keywords, decode_path, fallback reason, tp_fusion_reason)
    (dict(num_slots=4, fused_decode=True), "tp_fused_block", None, None),
    (dict(num_slots=4), "tp_fused", None, None),
    (dict(num_slots=4, collective_fusion=False), "unfused", None,
     "collective_fusion disabled"),
    (dict(num_slots=3, fused_decode=True), "unfused",
     "batch 3 not divisible by tensor_parallel 2 (the residual stream "
     "slot-shards between the ring collectives)",
     "num_slots 3 not divisible by tensor_parallel 2 (the residual stream "
     "slot-shards between the fused collectives)"),
]


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("rung", range(len(RUNGS)))
def test_tp2_rungs_serve_the_same_greedy_tokens(arrays, want, family, rung):
    kw, path, reason, tp_reason = RUNGS[rung]
    eng = ServingEngine(_port(arrays, family), tensor_parallel=2,
                        devices=CPU2, **kw)
    assert (eng.decode_path, eng.decode_fallback_reason,
            eng.core.tp_fusion_reason) == (path, reason, tp_reason)
    port1, jax2 = want[family]
    got = _tokens(eng)
    assert port1 == jax2
    assert got == port1


def test_tp4_gpt_fused_block_and_the_llama_refusal(arrays, want):
    """tp=4 over four CPU shards serves GPT on the sharded kernels; the
    GQA Llama's 2 kv heads do not split four ways (the reference's
    words), before its weights are touched."""
    eng = ServingEngine(_port(arrays, "gpt"), num_slots=4, fused_decode=True,
                        tensor_parallel=4, devices=["cpu"] * 4)
    assert eng.decode_path == "tp_fused_block"
    assert _tokens(eng) == want["gpt"][0]
    m = _port(arrays, "llama")
    with pytest.raises(ValueError, match="kv_heads 2 must divide evenly "
                                         "over tensor_parallel 4"):
        ServingEngine(m, tensor_parallel=4, devices=["cpu"] * 4)
    assert m.lm_head.weight.numel() > 0 and getattr(m, "tp_weights",
                                                    None) is None


def test_prefix_cache_hit_at_tp2(arrays):
    """The second wave's shared prefix comes from the kv-head-sharded
    block slabs; its tokens equal a tp=1 engine's on the same traffic."""
    rs = np.random.RandomState(3)
    prefix = rs.randint(0, 256, (32,))
    wave = [np.concatenate([prefix, rs.randint(0, 256, (n,))])
            for n in (5, 9)] + [rs.randint(0, 256, (7,))]
    toks = {}
    for tp in (1, 2):
        kw = dict(tensor_parallel=2, devices=CPU2) if tp == 2 else {}
        eng = ServingEngine(_port(arrays, "llama"), num_slots=4,
                            fused_decode=True, block_len=16, **kw)
        first = eng.submit(wave[0], max_new_tokens=NEW)
        while not eng.result(first).tokens:
            eng.step()
        rids = [first] + [eng.submit(p, max_new_tokens=NEW)
                          for p in wave[1:]]
        eng.run_until_complete(200)
        toks[tp] = [eng.result(r).tokens for r in rids]
        hits = eng.metrics_dict()["prefix_hit_tokens"]
        assert hits >= 32, hits
    assert toks[1] == toks[2]


def test_seeded_engine_equals_generate_at_tp2(arrays):
    prompts = _prompts(15, (6, 11))
    params = [SamplingParams(do_sample=True, temperature=1.3, top_k=20,
                             top_p=0.9, seed=5), SamplingParams()]
    eng = ServingEngine(_port(arrays, "gpt"), num_slots=4, fused_decode=True,
                        tensor_parallel=2, devices=CPU2)
    rids = [eng.submit(p, max_new_tokens=7, sampling=s)
            for p, s in zip(prompts, params)]
    eng.run_until_complete(100)
    ref = _port(arrays, "gpt")
    for rid, p, s in zip(rids, prompts, params):
        kw = {} if not s.do_sample else dict(
            do_sample=True, temperature=s.temperature, top_k=s.top_k,
            top_p=s.top_p, seed=s.seed)
        want = ref.generate(p[None], max_new_tokens=7, **kw)[0, len(p):]
        assert eng.result(rid).tokens == want.tolist()


def test_decode_block_event_and_metrics_carry_tp(arrays):
    eng = ServingEngine(_port(arrays, "gpt"), num_slots=4, fused_decode=True,
                        tensor_parallel=2, devices=CPU2)
    ev = eng.tracer.events("decode_block")
    assert len(ev) == 1
    attrs = ev[0][3]                     # (name, lane, t, attrs)
    assert attrs["tp"] == 2 and attrs["active"] is True
    assert attrs["reason"] == ""
    _tokens(eng)
    reg = eng.registry
    steps = reg.get("serving.phase.decode_dispatch_s").count
    assert steps > 0
    assert reg.get("kernel.decode_block_s").count == steps
    assert reg.get("serving.collective_s").count == steps
    assert reg.get("serving.tp_degree").value == 2


def test_build_serving_mesh_raises_naming_devices():
    with pytest.raises(ValueError, match="tensor_parallel must be >= 1"):
        build_serving_mesh(0)
    with pytest.raises(ValueError, match="devices="):
        build_serving_mesh(2, ["cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="pass devices="):
            build_serving_mesh(2)
    mesh = build_serving_mesh(2, ["cpu"] * 3)
    assert mesh.devices == [torch.device("cpu")] * 2


def test_weights_held_once_after_shard_model_params(arrays):
    """Sharding leaves every weight byte once: the shards' storages add up
    to the model's parameters, and the model's own tensors are
    released.  A second shard over the same mesh returns the same bundle;
    over another mesh it raises."""
    for family in FAMILIES:
        m = _port(arrays, family)
        before = sum(p.numel() * p.element_size() for p in m.parameters())
        mesh = build_serving_mesh(2, CPU2)
        bundle = shard_model_params(m, mesh)
        seen = {}

        def visit(t):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
            elif isinstance(t, dict):
                for v in t.values():
                    visit(v)
            elif isinstance(t, list):
                for v in t:
                    visit(v)
        visit(bundle["shards"])
        assert sum(seen.values()) == before, family
        assert all(p.numel() == 0 for p in m.parameters())
        assert shard_model_params(m, build_serving_mesh(2, CPU2)) is bundle
        with pytest.raises(ValueError, match="already sharded"):
            shard_model_params(m, build_serving_mesh(1, ["cpu"]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_released_model_names_the_cause(arrays, want, family):
    """After a tp engine takes the model's weights, the model's own entry
    points and a tp=1 engine fail at once with the cause named, not deep
    inside on an empty parameter; a tp engine on the same mesh still
    serves the tp=1 tokens."""
    m = _port(arrays, family)
    ServingEngine(m, num_slots=4, tensor_parallel=2, devices=CPU2)
    ids = torch.tensor([[1, 2, 3]])
    # (call, the entry point its message names): generate names the
    # decode_step it runs
    calls = [(lambda: m.generate(ids, 2), "decode_step"),
             (lambda: m.decode_step(ids, m.init_cache(1, 8), 0),
              "decode_step"),
             (lambda: m.fused_decode_step(ids[:, :1], m.init_cache(1, 8), 0),
              "fused_decode_step"),
             (lambda: m(ids), "forward"),
             (lambda: m.tp_decode_weights(2), "tp_decode_weights"),
             (lambda: ServingEngine(m, num_slots=4), "tensor_parallel=1")]
    for call, what in calls:
        with pytest.raises(RuntimeError, match="handed to a tensor-parallel "
                                               "engine") as err:
            call()
        assert what in str(err.value) and "tensor_parallel=2" in \
            str(err.value), (what, str(err.value))
    again = ServingEngine(m, num_slots=4, tensor_parallel=2, devices=CPU2)
    assert _tokens(again) == want[family][0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp_bundle_matches_the_reference_leaf_for_leaf(arrays, family):
    """The port's ``tp_decode_weights(2)`` from the carried weights equals
    the JAX model's, leaf for leaf (the head-aligned QKV and the
    ``[gate | up]`` re-arrangements included)."""
    jarch, jw = _jax_model(family).tp_decode_weights(2)
    tarch, tw = _port(arrays, family).tp_decode_weights(2)
    assert tarch == jarch

    def check(a, b, where):
        if a is None or b is None:
            assert a is None and b is None, where
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=where)
    for key in jw:
        if key == "blocks":
            assert len(jw[key]) == len(tw[key])
            for i, (jb, tb) in enumerate(zip(jw[key], tw[key])):
                assert sorted(jb) == sorted(tb)
                for leaf in jb:
                    check(jb[leaf], tb[leaf], f"blocks[{i}].{leaf}")
        else:
            check(jw[key], tw[key], key)


def test_tp_decode_supported_names_the_dimension(arrays):
    m = _port(arrays, "llama")
    assert m.tp_decode_supported(2) == (True, None)
    assert m.tp_decode_supported(4) == (
        False, "kv_heads 2 not divisible by tensor_parallel 4")
    g = _port(arrays, "gpt")
    assert g.tp_decode_supported(3) == (
        False, "num_heads 4 not divisible by tensor_parallel 3")
