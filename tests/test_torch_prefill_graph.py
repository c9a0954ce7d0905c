"""The prefill chunk's compiled-program plane in the PyTorch port
(``EngineCore``: one CUDA graph per chunk width on a card, on one fixed
staging lane per engine) against the JAX package's engine, on the CPU.

A graph replays fixed device addresses, so on every decode path the
buffers the prefill body reads and writes — the ids, offset and valid
tensors, the staging lane and the last-logits buffer — must keep their
``data_ptr()`` across chunks, across requests and across a request
cancelled mid-prefill.  CPU engines run the same body eagerly every chunk
(``prefill_graph_reason == "cpu"``, no capture) and must still serve the
JAX engine's greedy tokens, with radix hits and prompts longer than one
chunk, and run the widths the JAX engine traced.  The card's side is
``tests/test_torch_prefill_graph_card.py``.
"""

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.serving import ServingEngine
from test_torch_decode_graph import _port, arrays, jax_model  # noqa: F401

# chunks of 16 over 16-token blocks, tails bucketed from 4: widths 16, 8, 4
ENGINE_KW = dict(num_slots=4, min_bucket=4, block_len=16, prefill_chunk=16)
PREFIX = 32
# (prompt length, starts with the shared prefix); the second wave arrives
# once the first has finished, so its shared prompts hit the radix cache
WAVES = (((40, True), (9, False), (23, False)),
         ((50, True), (35, True), (19, False)))
NEW = 4
PATHS = {
    "unfused": dict(),
    "fused": dict(fused_decode=True),
    "tp_fused_block": dict(fused_decode=True, tensor_parallel=2,
                           devices=["cpu", "cpu"]),
}
ZERO = {"prefill": 0, "decode": 0, "verify": 0}


def _waves(seed=31):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(0, 256, (PREFIX,))
    return [[np.concatenate([prefix, rs.randint(0, 256, (n - PREFIX,))])
             if shared else rs.randint(0, 256, (n,)) for n, shared in wave]
            for wave in WAVES]


def _addresses(core):
    """Every buffer the prefill body touches, by name -> data_ptr()."""
    out = {"ids": core._prefill_ids.data_ptr(),
           "offset": core._prefill_off.data_ptr(),
           "valid": core._prefill_valid.data_ptr(),
           "last_logits": core._prefill_logits.data_ptr()}
    for i, (k, v) in enumerate(zip(core._lane_ks, core._lane_vs)):
        out[f"k{i}"] = [t.data_ptr() for t in (k if isinstance(k, list)
                                               else [k])]
        out[f"v{i}"] = [t.data_ptr() for t in (v if isinstance(v, list)
                                               else [v])]
    return out


def _plans(core, served):
    """The chunk plans ``(offset, width, valid)`` that the ``(prompt,
    result)`` pairs of ``served`` ran."""
    return [core.scheduler.chunk_plan(res.prefix_hit_tokens, len(prompt),
                                      core.prefill_chunk)
            for prompt, res in served]


@pytest.fixture(scope="module")
def want(jax_model):  # noqa: F811
    eng = JaxEngine(jax_model, **ENGINE_KW)
    tokens = []
    for wave in _waves():
        rids = [eng.submit(p, max_new_tokens=NEW) for p in wave]
        eng.run_until_complete(200)
        tokens += [list(eng.purge(r).tokens) for r in rids]
    return tokens, eng.core.trace_counts["prefill"]


@pytest.fixture(scope="module")
def served(arrays):  # noqa: F811
    """Each path served the two waves step by step: the engine, the
    prefill buffers' addresses before the first step and after every
    step, the tokens, and the (prompt, result) pairs."""
    out = {}
    for path, kw in PATHS.items():
        eng = ServingEngine(_port(arrays), **ENGINE_KW, **kw)
        assert eng.decode_path == path
        history = [_addresses(eng.core)]
        pairs = []
        for wave in _waves():
            rids = [eng.submit(p, max_new_tokens=NEW) for p in wave]
            while eng.step():
                history.append(_addresses(eng.core))
            pairs += [(p, eng.result(r)) for p, r in zip(wave, rids)]
        out[path] = (eng, history, pairs)
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_greedy_tokens_equal_the_reference_engine(served, want, path):
    eng, _, pairs = served[path]
    assert [list(r.tokens) for _, r in pairs] == want[0]
    # the second wave's shared prompts hit the radix cache, and prompts
    # ran in several chunks
    assert [r.prefix_hit_tokens for _, r in pairs] == [0, 0, 0, 32, 32, 0]
    assert max(len(plan) for plan in _plans(eng.core, pairs)) == 3


@pytest.mark.parametrize("path", sorted(PATHS))
def test_widths_run_equal_the_reference_traces(served, want, path):
    """The distinct widths the port's plans ran (and its chunk spans
    name) are the programs the JAX engine traced, all in warm_buckets."""
    eng, _, pairs = served[path]
    core = eng.core
    widths = {w for plan in _plans(core, pairs) for _, w, _ in plan}
    assert widths == {16, 8, 4}
    assert len(widths) == want[1]
    assert {s.attrs["width"] for s in
            eng.tracer.spans(name="prefill_chunk")} == widths
    assert widths <= core._warm_buckets


@pytest.mark.parametrize("path", sorted(PATHS))
def test_prefill_buffers_keep_their_addresses(served, path):
    _, history, _ = served[path]
    for seen in history[1:]:
        assert seen == history[0]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cpu_engine_captures_nothing_and_says_why(served, path):
    eng, _, pairs = served[path]
    core = eng.core
    assert eng.prefill_graph_reason == eng.decode_graph_reason == "cpu"
    assert core.capture_counts == ZERO
    assert core._prefill_graphs == {} and core.prefill_capture_seconds == {}
    assert core.eager_prefill_chunks == \
        eng.metrics_dict()["prefill_chunks"] == \
        sum(len(plan) for plan in _plans(core, pairs))
    assert eng.registry.get("serving.compiles").value == 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_request_after_a_cancelled_prefill(arrays, path):  # noqa: F811
    """A request cancelled mid-prefill leaves stale rows in the lane; the
    next request's tokens are those of a fresh engine, and the buffers
    keep their addresses through the cancellation."""
    long, after = _waves(7)[0][0], _waves(8)[0][1]
    eng = ServingEngine(_port(arrays), **ENGINE_KW, **PATHS[path])
    before = _addresses(eng.core)
    doomed = eng.submit(long, max_new_tokens=NEW)
    rid = eng.submit(after, max_new_tokens=NEW)
    eng.step()
    eng.step()
    head = eng.core._prefills[0]
    assert head.req.request_id == doomed and head.next_chunk == 2
    assert len(head.plan) == 3
    assert eng.cancel(doomed)
    eng.run_until_complete(100)
    assert _addresses(eng.core) == before
    fresh = ServingEngine(_port(arrays), **ENGINE_KW, **PATHS[path])
    assert fresh.serve_batch([after], max_new_tokens=NEW)[0].tokens == \
        eng.result(rid).tokens


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_warm_buckets_equal_the_reference(arrays, jax_model,  # noqa: F811
                                          chunk, prefix_cache):
    kw = dict(num_slots=2, min_bucket=4, block_len=16, prefill_chunk=chunk,
              enable_prefix_cache=prefix_cache)
    ref = JaxEngine(jax_model, **kw).core
    core = ServingEngine(_port(arrays), **kw).core
    assert core.warm_buckets() == ref.warm_buckets()
    assert core._warm_buckets == ref._warm_buckets
    assert tuple(core._prefill_ids.shape) == (1, max(ref.warm_buckets()))
