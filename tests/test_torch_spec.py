"""Speculative decoding in the PyTorch port (``serving/spec.py`` and the
engine's verify step) against the JAX package's, on the CPU, in the order
of the reference's ``tests/test_zz_spec_serving.py``.

Weights are carried from the JAX gpt_tiny / llama_tiny
(``state_dict_from_jax``), f32; engines have 4 slots, ``max_seq=256`` and
``prefill_chunk=16``.  The bar is exact token equality:

  * greedy: the port's ``spec_k=4`` engine == the JAX engine's
    ``spec_k=4`` == the port's ``spec_k=0`` (the JAX engine runs once);
  * seeded: ``spec_k`` 1, 2 and 4 == ``spec_k=0`` inside the port on all
    five serving paths (unfused, fused, and at tp=2 on two CPU shards
    ``tp_fused``, ``tp_fused_block`` and the Megatron ``unfused``), with
    drafts accepted.  A ``torch.Generator`` does not reproduce
    ``jax.random``, so seeded tokens are held inside the port only.

CPU engines capture nothing (``decode_graph_reason == "cpu"``): every
verify step runs its body eagerly.  The card tests are
``tests/test_torch_spec_card.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import NGramDraftTable as JaxDraftTable
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import (NGramDraftTable, SamplingParams,
                                      ServingEngine)
from paddle_tpu_torch.serving.tp import (build_serving_mesh,
                                         build_tp_forward,
                                         build_tp_verify_program,
                                         shard_model_params)

NEW = 16
SEEDED = SamplingParams(do_sample=True, temperature=0.9, top_k=12,
                        top_p=0.85, seed=7)
ENGINE_KW = dict(num_slots=4, max_seq=256, min_bucket=8, prefill_chunk=16,
                 block_len=16)
CPU2 = ["cpu", "cpu"]
PATHS = {"unfused": {}, "fused": dict(fused_decode=True),
         "tp_fused": dict(tensor_parallel=2, devices=CPU2),
         "tp_fused_block": dict(tensor_parallel=2, devices=CPU2,
                                fused_decode=True),
         "tp_unfused": dict(tensor_parallel=2, devices=CPU2,
                            collective_fusion=False)}
FAMILIES = {"gpt": (JaxGPT, jax_gpt_tiny, GPTForCausalLM, gpt_tiny),
            "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM,
                      llama_tiny)}
ZERO = {"prefill": 0, "decode": 0, "verify": 0}


def _jax_model(family):
    jcls, jcfg, _, _ = FAMILIES[family]
    paddle_tpu.seed(0)
    m = jcls(jcfg())
    m.eval()
    return m


@pytest.fixture(scope="module")
def jax_gpt():
    return _jax_model("gpt")


@pytest.fixture(scope="module")
def arrays(jax_gpt):
    return {"gpt": {k: np.asarray(v)
                    for k, v in jax_gpt.state_dict().items()},
            "llama": {k: np.asarray(v) for k, v in
                      _jax_model("llama").state_dict().items()}}


def _port(arrays, family="gpt"):
    _, _, tcls, tcfg = FAMILIES[family]
    m = tcls(tcfg(), device="cpu")
    m.load_state_dict(state_dict_from_jax(arrays[family], "cpu", "float32"))
    return m.eval()


def _prompts(seed=7, lengths=(5, 9, 3, 11), reps=3, vocab=256):
    """Mixed-length prompts with internal repetition, so the n-gram
    tables have structure to predict."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).tolist() * reps for n in lengths]


def _serve(model, spec_k, sampling=None, **kw):
    eng = ServingEngine(model, **ENGINE_KW, spec_k=spec_k, **kw)
    outs = eng.serve_batch(_prompts(), max_new_tokens=NEW,
                           sampling=sampling, max_steps=2000)
    assert all(o.finished and len(o.tokens) == NEW for o in outs)
    return [list(o.tokens) for o in outs], eng


def _assert_spec_ran(eng):
    """Speculation ran: verify steps (eagerly, on the CPU), drafts
    proposed, nothing captured."""
    assert eng.spec_on and eng.spec_fallback_reason is None
    assert eng.decode_graph_reason == "cpu"
    assert eng.core.capture_counts == ZERO
    assert eng.core.eager_verify_steps > 0
    assert eng.metrics.snapshot()["spec_draft_tokens"] > 0


# ------------------------------------------------------------ parity

def test_greedy_parity_with_the_jax_engine(arrays, jax_gpt):
    """Greedy: the port's spec_k=4 engine == the JAX engine's spec_k=4 ==
    the port's spec_k=0, with the same drafts proposed and accepted."""
    jeng = JaxEngine(jax_gpt, **ENGINE_KW, spec_k=4)
    assert jeng.spec_on
    jouts = jeng.serve_batch(_prompts(), max_new_tokens=NEW, max_steps=2000)
    want = [list(o.tokens) for o in jouts]
    base, e0 = _serve(_port(arrays), 0)
    assert not e0.spec_on and "spec_k=0" in e0.spec_fallback_reason
    toks, eng = _serve(_port(arrays), 4)
    assert eng.decode_path == "unfused"
    _assert_spec_ran(eng)
    assert toks == want == base
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    for key in ("spec_draft_tokens", "spec_accepted_tokens",
                "spec_acceptance_rate"):
        assert snap[key] == jsnap[key], key
    assert eng.spec_acceptance_rate > 0


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("path", ["fused", "tp_fused_block"])
def test_greedy_parity_fused_paths(arrays, family, path):
    """The fused engines verify through the per-layer forward (tp=1) or
    the ring verify program (tp=2) and decode through the block kernels'
    plain versions; greedy tokens equal spec_k=0's on the same path."""
    base, _ = _serve(_port(arrays, family), 0, **PATHS[path])
    toks, eng = _serve(_port(arrays, family), 4, **PATHS[path])
    assert eng.decode_path == path
    _assert_spec_ran(eng)
    assert toks == base
    assert eng.spec_acceptance_rate > 0


@pytest.mark.parametrize("path", list(PATHS))
def test_seeded_parity_every_path(arrays, path):
    """Seeded: spec_k 1, 2 and 4 == spec_k=0 on each serving path.  A
    verify step draws every window position from each sampling row's
    generator and restores the state after draw accepted + 1, so the
    streams match sequential decode's draws exactly."""
    want_path = "unfused" if path == "tp_unfused" else path
    base, e0 = _serve(_port(arrays), 0, SEEDED, **PATHS[path])
    assert e0.decode_path == want_path
    for k in (1, 2, 4):
        toks, eng = _serve(_port(arrays), k, SEEDED, **PATHS[path])
        assert eng.decode_path == want_path
        _assert_spec_ran(eng)
        assert toks == base, f"spec_k={k} diverged on {path}"
        assert eng.spec_acceptance_rate > 0, k


def test_verify_program_matches_the_megatron_forward(arrays):
    """The ring verify program's ``[B, width, V]`` logits equal the
    per-shard Megatron forward's on copies of the same slabs at ragged
    per-row positions, it writes the same window K/V rows, and it does not
    advance ``seq_pos``."""
    model = _port(arrays)
    mesh = build_serving_mesh(2, CPU2)
    bundle = shard_model_params(model, mesh)
    cfg = model.cfg
    g = torch.Generator().manual_seed(3)
    shape = (4, 64, cfg.num_heads // 2, cfg.head_dim)
    ks = [[torch.randn(shape, generator=g) for _ in range(2)]
          for _ in range(cfg.num_layers)]
    vs = [[torch.randn(shape, generator=g) for _ in range(2)]
          for _ in range(cfg.num_layers)]
    pos = torch.tensor([3, 17, 0, 40], dtype=torch.int32)
    ids = torch.randint(0, cfg.vocab_size, (4, 5), generator=g)
    copy = lambda slabs: [[t.clone() for t in layer] for layer in slabs]
    ks2, vs2 = copy(ks), copy(vs)
    got = build_tp_verify_program(bundle, width=5)(ks, vs, pos, ids)
    assert torch.equal(pos, torch.tensor([3, 17, 0, 40], dtype=torch.int32))
    want, _ = build_tp_forward(bundle)(
        ids, [(k, v, pos) for k, v in zip(ks2, vs2)], pos)
    assert got.shape == (4, 5, cfg.vocab_size)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(ks + vs, ks2 + vs2):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="width"):
        build_tp_verify_program(bundle, width=1)


# ---------------------------------------------------------- resolution

def test_resolution_reasons_are_named(arrays):
    m = _port(arrays)
    eng = ServingEngine(m, num_slots=2, max_seq=64, min_bucket=8)
    assert eng.spec_k == 0 and not eng.spec_on
    assert "spec_k=0" in eng.spec_fallback_reason
    assert eng.core.stall_snapshot()["speculation"] is False
    # a window that cannot fit leaves speculation off, with the reason
    eng = ServingEngine(m, num_slots=2, max_seq=16, min_bucket=8,
                        spec_k=16)
    assert not eng.spec_on
    assert "max_seq 16 leaves no room" in eng.spec_fallback_reason
    eng = ServingEngine(m, num_slots=2, max_seq=64, min_bucket=8, spec_k=3)
    assert eng.spec_k == 3 and eng.spec_on
    assert eng.spec_fallback_reason is None
    assert eng.spec_acceptance_rate is None
    assert eng.core.stall_snapshot()["speculation"] is True
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(m, num_slots=2, max_seq=64, spec_k=-1)


def test_bypass_decodes_one_token_a_step(arrays):
    """``spec_bypass`` switches an armed engine to plain decode: nothing is
    drafted, each step commits one token, speculation reads off, and the
    stream is spec_k=0's; clearing it speculates again."""
    prompt = _prompts()[0]
    want = _serve(_port(arrays), 0)[0][0]
    eng = ServingEngine(_port(arrays), **ENGINE_KW, spec_k=4)
    eng.core.spec_bypass = True
    assert not eng.spec_on and eng.spec_fallback_reason is None
    assert eng.core.stall_snapshot()["speculation"] is False
    h = eng.submit(prompt, max_new_tokens=NEW)
    eng.run_until_complete(200)
    assert eng.result(h).tokens == want
    core = eng.core
    # the first token comes from prefill, every other from one decode step
    assert core.eager_decode_steps == NEW - 1
    assert core.eager_verify_steps == 0
    assert eng.metrics.snapshot()["spec_draft_tokens"] == 0
    eng.core.spec_bypass = False
    assert eng.spec_on and eng.core.stall_snapshot()["speculation"] is True
    h = eng.submit(prompt, max_new_tokens=NEW)
    eng.run_until_complete(200)
    assert eng.result(h).tokens == want
    assert core.eager_verify_steps > 0


def test_row_end_fallback_still_finishes(arrays):
    """A slot within spec_k+1 rows of its row end must not speculate (the
    window's append would clamp into valid rows): the step falls back to
    decode, and the request still finishes with spec_k=0's tokens."""
    prompt = [5, 6, 7, 5, 6, 7, 5, 6]
    out = {}
    for k in (0, 4):
        eng = ServingEngine(_port(arrays), num_slots=2, max_seq=32,
                            min_bucket=8, spec_k=k)
        r = eng.submit(prompt, max_new_tokens=24)
        eng.run_until_complete(200)
        out[k] = eng.result(r)
        assert out[k].finished and len(out[k].tokens) == 24
        if k:
            # speculated early, then the last steps decoded one token
            assert eng.core.eager_verify_steps > 0
            assert eng.core.eager_decode_steps > 0
    assert out[4].tokens == out[0].tokens


# --------------------------------------------------- constrained decode

def test_constrained_decoding_never_leaves_its_set(arrays):
    """The mask applies to every window position: a constrained request
    emits only allowed tokens, and its stream and its unconstrained
    neighbour's equal spec_k=0's."""
    allowed = list(range(0, 256, 5))
    out = {}
    for k in (0, 3):
        eng = ServingEngine(_port(arrays), **ENGINE_KW, spec_k=k)
        h1 = eng.submit([10, 20, 30, 10, 20, 30], max_new_tokens=NEW,
                        allowed_tokens=allowed)
        h2 = eng.submit(_prompts()[1], max_new_tokens=NEW)
        eng.run_until_complete(200)
        out[k] = (eng.result(h1).tokens, eng.result(h2).tokens)
        assert set(out[k][0]) <= set(allowed)
    assert out[3] == out[0]


def test_unsatisfiable_mask_stops_the_slots_drafts(arrays):
    """A slot whose table predicts only out-of-set tokens proposes
    nothing: it decodes one token a step, while the engine stays armed."""
    eng = ServingEngine(_port(arrays), num_slots=1, max_seq=64,
                        min_bucket=8, spec_k=4)
    h = eng.submit([1, 2, 3, 4], max_new_tokens=1, allowed_tokens=[250])
    eng.run_until_complete(50)
    assert eng.result(h).tokens == [250]
    assert eng.metrics.snapshot()["spec_draft_tokens"] == 0
    assert eng.core.eager_verify_steps == 0
    assert eng.spec_on


# ------------------------------------------------------- draft table

def test_ngram_table_matches_the_reference():
    """On seeded token streams the port's table and the JAX package's give
    the same proposals after every observe, with and without an allowed
    set, and the same length."""
    rs = np.random.RandomState(11)
    for trial in range(20):
        vocab = int(rs.choice([4, 8, 32]))
        stream = rs.randint(0, vocab, (int(rs.randint(0, 40)),)).tolist()
        allowed = frozenset(rs.choice(vocab, vocab // 2, replace=False)
                            .tolist())
        ours, ref = NGramDraftTable(), JaxDraftTable()
        cut = len(stream) // 2
        ours.seed(stream[:cut])
        ref.seed(stream[:cut])
        for tok in stream[cut:]:
            for k in (1, 3, 6):
                assert ours.propose(k) == ref.propose(k)
                assert ours.propose(k, allowed=allowed) == \
                    ref.propose(k, allowed=allowed)
            ours.observe(tok)
            ref.observe(tok)
        assert len(ours) == len(ref)
    t = NGramDraftTable()
    t.seed([7, 8, 7, 8, 7])
    assert t.propose(4) == [8, 7, 8, 7]
    assert t.propose(4, allowed=frozenset({8})) == [8]
    assert t.propose(4, allowed=frozenset({9999})) == []


# ----------------------------------------------------------- metrics

def test_spec_metrics_surface(arrays):
    _, eng = _serve(_port(arrays), 4)
    snap = eng.metrics_dict()
    assert snap["spec_draft_tokens"] >= snap["spec_accepted_tokens"] > 0
    assert snap["spec_acceptance_rate"] == pytest.approx(
        snap["spec_accepted_tokens"] / snap["spec_draft_tokens"], abs=1e-4)
    assert eng.spec_acceptance_rate == pytest.approx(
        eng.metrics.spec_acceptance_rate)
    reg = eng.registry.snapshot()
    assert reg["spec.draft_tokens"] == snap["spec_draft_tokens"]
    assert reg["spec.accepted_tokens"] == snap["spec_accepted_tokens"]
    # a verify step commits up to spec_k+1 tokens a slot, so the engine
    # took fewer decode-or-verify steps than tokens it emitted after the
    # first ones
    core = eng.core
    assert core.eager_verify_steps + core.eager_decode_steps < \
        snap["tokens_generated"] - len(_prompts())
    eng.metrics.on_spec_disable("test")
    assert [a["reason"] for *_, a in eng.tracer.events("spec_disable")] \
        == ["test"]
    eng.metrics.reset()
    assert eng.metrics.snapshot()["spec_draft_tokens"] == 0
    assert eng.metrics.spec_acceptance_rate is None
    eng.close()
    assert eng.core._verify_graph is None
