"""Fault-tolerant serving in the PyTorch port (``serving/faults.py``,
``serving/health.py`` and the engine's watchdog) against the JAX
package's, on the CPU, in the scenarios of the reference's
``tests/test_zz_chaos_serving.py``.

Each scenario runs the same prompts and the same fault arming through the
JAX ``ServingEngine`` and the port's (gpt_tiny / llama_tiny, f32, weights
carried by ``state_dict_from_jax``; tensor-parallel engines on the
conftest's virtual devices and on ``devices=["cpu"] * 2``) and compares:
every request's status and the class of its reason (the text before the
first colon), the greedy tokens exactly, the injector's hits and fired
counts at the port's nine sites, the snapshot keys ``faults``,
``step_retries``, ``quarantines``, ``health_state`` and
``degradation_level``, ``health.state``, ``degraded_subsystems``,
``decode_path`` and each request's ``prefix_hit_tokens``.  Both engines
must then hold the accounting invariant: every request terminal, every
slot free, no radix pin leaked, tree nodes == used blocks.

Not compared: trace / capture counts (a CPU engine captures nothing, and
the reference's tensor-parallel trace counts are broken), and seeded
streams, which the port holds against itself (a ``torch.Generator`` does
not reproduce ``jax.random``).  The card-only tests are
``tests/test_torch_chaos_card.py``.
"""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.serving as jax_serving
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models import llama_tiny as jax_llama_tiny
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import POINTS, SamplingParams

TERMINAL = {"finished", "cancelled", "deadline_exceeded", "rejected",
            "failed"}
SNAPSHOT_KEYS = ("faults", "step_retries", "quarantines", "health_state",
                 "degradation_level")
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


def _prompts(seed, lengths, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lengths]


def assert_accounting(eng, rids):
    """Every request terminal with a reason, every slot free, no radix pin
    leaked, tree nodes == used blocks."""
    core = eng.core
    for rid in rids:
        out = eng.result(rid)
        assert out.finished and out.status in TERMINAL, (rid, out.status)
        assert out.status_reason, (rid, out.status)
    assert core.scheduler.active == 0 and core.scheduler.queue_depth == 0
    assert not core._prefills
    assert core.pool.free_slots == core.num_slots
    if core.prefix_cache is not None:
        bp = core.block_pool
        assert bp.free_blocks + bp.used_blocks == bp.num_blocks
        nodes = 0
        stack = list(core.prefix_cache.root.children.values())
        while stack:
            n = stack.pop()
            assert n.refcount == 0, "leaked radix pin"
            nodes += 1
            stack.extend(n.children.values())
        assert nodes == bp.used_blocks


# ------------------------------------------------------------ scenarios
# each takes (make, faults) — make(**engine_kw) builds the side's engine
# with its fault-tolerance config and injector — and returns the request
# ids it served, in order

def _kv_alloc(make, faults):
    eng = make()
    faults.enable("kv_alloc")
    try:
        rids = [eng.submit(p, max_new_tokens=5)
                for p in _prompts(0, (3, 7, 5, 6))]
        eng.run_until_complete(300)
    finally:
        faults.disable("kv_alloc")
    return eng, rids


def _gather(make, faults):
    eng = make(block_len=8, num_slots=2)
    prefix = _prompts(1, (32,))[0]
    rids = [eng.submit(np.concatenate([prefix, _prompts(2, (4,))[0]]),
                       max_new_tokens=3)]
    eng.run_until_complete(200)          # populate the radix tree
    faults.enable("gather", times=2)     # ladder_threshold faults
    try:
        rids += [eng.submit(np.concatenate([prefix, s]), max_new_tokens=3)
                 for s in _prompts(3, (4, 4))]
        eng.run_until_complete(200)
    finally:
        faults.disable("gather")
    # bypassed: a fresh cache-hit prompt no longer matches
    rids.append(eng.submit(np.concatenate([prefix, _prompts(4, (4,))[0]]),
                           max_new_tokens=3))
    eng.run_until_complete(200)
    return eng, rids


def _cache_faults(make, faults):
    # ladder 3: the scatter and block_alloc faults leave the cache on
    eng = make(ladder=3, block_len=8, num_slots=2)
    rids = []
    for site, times, p in zip(("scatter", "block_alloc", "block_exhausted"),
                              (1, 1, 8), _prompts(5, (17, 19, 21))):
        faults.enable(site, times=times)
        try:
            rids.append(eng.submit(p, max_new_tokens=3))
            eng.run_until_complete(200)
        finally:
            faults.disable(site)
    return eng, rids


def _step_retry(make, faults):
    eng = make()
    faults.enable("step")
    try:
        rids = [eng.submit(p, max_new_tokens=5)
                for p in _prompts(6, (3, 8, 5))]
        eng.run_until_complete(300)
    finally:
        faults.disable("step")
    return eng, rids


def _quarantine(make, faults, **kw):
    # at=2: the first plane decodes before 3 faults (2 retries + 1)
    # quarantine it
    eng = make(retries=2, num_slots=2, **kw)
    faults.enable("step", at=2, times=3)
    try:
        rids = [eng.submit(p, max_new_tokens=4)
                for p in _prompts(7, (3, 6, 5, 8, 7))]
        eng.run_until_complete(400)
    finally:
        faults.disable("step")
    return eng, rids


def _circuit(make, faults):
    eng = make(retries=1, circuit=2, num_slots=2)
    prompts = _prompts(8, (3, 5, 7, 4))
    faults.enable("step", times=50)      # never recovers
    try:
        rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_until_complete(400)
    finally:
        faults.disable("step")
    # fail fast: a submit rejects, a step does nothing
    rejected = eng.core.metrics.snapshot()["requests_rejected"]
    with pytest.raises(Exception, match="circuit_open") as ei:
        eng.submit(prompts[0], max_new_tokens=2)
    assert ei.value.reason == "circuit_open"
    assert ei.value.output.status == "rejected"
    assert eng.core.metrics.snapshot()["requests_rejected"] == rejected + 1
    assert eng.step() == 0
    return eng, rids


def _nan(make, faults):
    eng = make()
    faults.enable("nan_logits")          # poisons the lowest live slot
    try:
        rids = [eng.submit(p, max_new_tokens=5)
                for p in _prompts(9, (4, 6, 8))]
        eng.run_until_complete(300)
    finally:
        faults.disable("nan_logits")
    # the poisoned row is rewritten by the next adopt
    rids.append(eng.submit(_prompts(10, (5,))[0], max_new_tokens=5))
    eng.run_until_complete(200)
    return eng, rids


def _slow(make, faults):
    eng = make(num_slots=2)
    faults.enable("slow_step", seconds=0.01)
    try:
        rids = [eng.submit(p, max_new_tokens=3)
                for p in _prompts(11, (3, 5))]
        eng.run_until_complete(200)
    finally:
        faults.disable("slow_step")
    return eng, rids


def _spec(make, faults):
    eng = make(spec_k=3)
    # cyclic prompts: the n-gram tables draft from the first step
    prompts = [np.tile([5, 6, 7, 8], 6), np.tile([9, 10, 11], 8),
               np.tile([3, 4], 10)]
    faults.enable("spec_verify", times=2)     # == ladder threshold
    try:
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_complete(300)
    finally:
        faults.disable("spec_verify")
    assert eng.core.spec_bypass
    assert eng.spec_fallback_reason.startswith("degraded:")
    drafted = eng.metrics_dict()["spec_draft_tokens"]
    rids.append(eng.submit(np.tile([7, 8, 9], 8), max_new_tokens=6))
    eng.run_until_complete(200)
    assert eng.metrics_dict()["spec_draft_tokens"] == drafted
    return eng, rids


def _fused_rung(make, faults, **kw):
    eng = make(num_slots=2, fused_decode=True, **kw)
    # two fused-path faults at the first two decode steps, so the rung
    # lands before a fused step runs (the card tests rung a captured one)
    faults.enable("step", times=2)
    try:
        rids = [eng.submit(p, max_new_tokens=4)
                for p in _prompts(15, (3, 6, 4))]
        eng.run_until_complete(400)
    finally:
        faults.disable("step")
    assert eng.decode_fallback_reason.startswith("degraded:")
    return eng, rids


def _chunk_faults(make, faults):
    """No injection site sits in a prefill chunk: the chunk runner raises
    at its 2nd and 5th call, failing those requests only; the second
    fault disables chunked prefill."""
    eng = make(num_slots=2, prefill_chunk=8)
    run, calls = eng.core._run_chunk, []

    def run_chunk(st):
        calls.append(st.req.request_id)
        if len(calls) in (2, 5):
            raise RuntimeError("injected prefill fault")
        run(st)

    eng.core._run_chunk = run_chunk
    rids = [eng.submit(p, max_new_tokens=3)
            for p in _prompts(16, (20, 5, 17, 6, 12))]
    eng.run_until_complete(300)
    assert eng.core.prefill_chunk is None
    return eng, rids


SCENARIOS = {
    "kv_alloc": (_kv_alloc, "gpt", {}),
    "gather_ladder": (_gather, "gpt", {}),
    "scatter_block_faults": (_cache_faults, "gpt", {}),
    "step_retry": (_step_retry, "gpt", {}),
    "step_quarantine": (lambda m, f: _quarantine(
        m, f, enable_prefix_cache=False), "gpt", {}),
    "circuit_open": (_circuit, "gpt", {}),
    "nan_logits": (_nan, "llama", {}),
    "slow_step": (_slow, "gpt", {}),
    "chunked_prefill_rung": (_chunk_faults, "gpt", {}),
    "spec_verify_bypass": (_spec, "gpt", {}),
    "fused_rung": (_fused_rung, "gpt", {}),
    "fused_rung_tp2": (_fused_rung, "gpt", {"tensor_parallel": 2}),
    "tp2_quarantine": (_quarantine, "gpt", {"tensor_parallel": 2}),
}


def _run(side, scenario, arrays):
    """One scenario through one package; returns what is compared."""
    fn, family, tp_kw = SCENARIOS[scenario]
    ns = jax_serving if side == "jax" else port_serving
    model = _jax_model(family) if side == "jax" else _port(arrays, family)
    faults = ns.FaultInjector()

    def make(retries=3, ladder=2, circuit=3, **kw):
        ft = ns.FaultToleranceConfig(max_step_retries=retries,
                                     backoff_base_s=0.0,
                                     ladder_threshold=ladder,
                                     circuit_quarantine_limit=circuit)
        kw = {**tp_kw, **kw}
        if side == "port" and kw.get("tensor_parallel", 1) > 1:
            kw["devices"] = ["cpu"] * kw["tensor_parallel"]
        return ns.ServingEngine(model, num_slots=kw.pop("num_slots", 3),
                                min_bucket=8, fault_tolerance=ft,
                                faults=faults, **kw)

    eng, rids = fn(make, faults)
    assert_accounting(eng, rids)
    outs = [eng.result(r) for r in rids]
    snap = eng.metrics_dict()
    return {
        "status": [o.status for o in outs],
        "reason": [o.status_reason.split(":")[0] for o in outs],
        "tokens": [list(map(int, o.tokens)) for o in outs],
        "prefix_hit_tokens": [o.prefix_hit_tokens for o in outs],
        "hits": {p: faults.hits[p] for p in POINTS},
        "fired": {p: faults.fired[p] for p in POINTS},
        "snapshot": {k: snap[k] for k in SNAPSHOT_KEYS},
        "health": eng.health.state,
        "degraded": tuple(eng.degraded_subsystems),
        "decode_path": eng.decode_path,
    }


@pytest.fixture(scope="module")
def jax_runs(arrays):
    """The JAX side of each scenario, run once."""
    cache = {}

    def get(scenario):
        if scenario not in cache:
            cache[scenario] = _run("jax", scenario, arrays)
        return cache[scenario]
    return get


# what each scenario must show besides parity (the reference's own pins)
EXPECT = {
    "kv_alloc": dict(fired={"kv_alloc": 1}, health="healthy",
                     snapshot={"step_retries": 1, "quarantines": 0}),
    "gather_ladder": dict(fired={"gather": 2}, health="degraded",
                          degraded=("prefix_cache",),
                          snapshot={"degradation_level": 1}),
    "scatter_block_faults": dict(fired={"scatter": 1, "block_alloc": 1},
                                 degraded=(), snapshot={"faults": 2}),
    "step_retry": dict(fired={"step": 1}, health="healthy",
                       snapshot={"step_retries": 1, "quarantines": 0}),
    "step_quarantine": dict(health="healthy", snapshot={"quarantines": 1}),
    "circuit_open": dict(health="circuit_open",
                         snapshot={"quarantines": 2}),
    "nan_logits": dict(fired={"nan_logits": 1},
                       snapshot={"quarantines": 0}),
    "slow_step": dict(fired={"slow_step": 1}),
    "chunked_prefill_rung": dict(health="degraded",
                                 degraded=("chunked_prefill",),
                                 snapshot={"faults": 2, "step_retries": 0}),
    "spec_verify_bypass": dict(fired={"spec_verify": 2}, health="degraded",
                               degraded=("spec_verify",)),
    "fused_rung": dict(decode_path="unfused", degraded=("fused_decode",)),
    "fused_rung_tp2": dict(decode_path="tp_fused",
                           degraded=("fused_decode",)),
    "tp2_quarantine": dict(decode_path="tp_fused",
                           snapshot={"quarantines": 1}),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_chaos_scenario_matches_the_jax_engine(scenario, arrays, jax_runs):
    """The port's engine under the scenario's faults == the JAX engine's
    under the same faults, on every compared key; both hold the
    accounting invariant (checked inside ``_run``)."""
    want = jax_runs(scenario)
    got = _run("port", scenario, arrays)
    for key in want:
        assert got[key] == want[key], (scenario, key, got[key], want[key])
    for key, value in EXPECT[scenario].items():
        if isinstance(value, dict):
            for k, v in value.items():
                assert got[key][k] == v, (scenario, key, k, got[key][k])
        else:
            assert got[key] == value, (scenario, key, got[key])
    statuses = got["status"]
    if "quarantine" in scenario:
        # the in-flight requests fail, the queued ones re-serve
        assert statuses.count("failed") == 2
        assert statuses.count("finished") == 3
        assert all(r == "quarantine" for s, r in
                   zip(statuses, got["reason"]) if s == "failed")
    elif scenario == "nan_logits":
        assert statuses == ["failed", "finished", "finished", "finished"]
        assert got["reason"][0] == "non-finite logits in decode"
    elif scenario == "circuit_open":
        assert set(statuses) == {"failed"}
    elif scenario == "chunked_prefill_rung":
        assert statuses.count("failed") == 2
        assert all(r == "prefill fault" for s, r in
                   zip(statuses, got["reason"]) if s == "failed")
    else:
        assert set(statuses) == {"finished"}


def test_step_retry_keeps_seeded_streams(arrays):
    """A retried step leaves every request's generator where sequential
    decode left it: seeded tokens under one injected ``step`` fault equal
    the fault-free engine's (held inside the port)."""
    model = _port(arrays, "gpt")
    sp = SamplingParams(do_sample=True, temperature=1.3, top_k=7,
                        top_p=0.9, seed=5)
    prompts = _prompts(24, (3, 9, 6))
    toks = []
    for armed in (False, True):
        faults = port_serving.FaultInjector()
        eng = port_serving.ServingEngine(
            model, num_slots=3, min_bucket=8, faults=faults,
            fault_tolerance=port_serving.FaultToleranceConfig(
                backoff_base_s=0.0))
        if armed:
            faults.enable("step", at=2)
        rids = [eng.submit(p, max_new_tokens=6, sampling=sp)
                for p in prompts]
        eng.run_until_complete(200)
        assert faults.fired["step"] == int(armed)
        toks.append([eng.result(r).tokens for r in rids])
        assert_accounting(eng, rids)
    assert toks[0] == toks[1]


def test_stream_callback_fault_contained_to_request(arrays):
    """Under the watchdog a raising client stream callback fails its own
    request only; the other slots keep their tokens, nothing is retried."""
    model = _port(arrays, "gpt")
    eng = port_serving.ServingEngine(
        model, num_slots=3, min_bucket=8,
        fault_tolerance=port_serving.FaultToleranceConfig())

    def bad_stream(req, tok):
        raise RuntimeError("client sink broke")

    prompts = _prompts(26, (4, 6, 8))
    clean = port_serving.ServingEngine(model, num_slots=3, min_bucket=8)
    want = [o.tokens for o in clean.serve_batch(prompts[1:],
                                                max_new_tokens=5)]
    a = eng.submit(prompts[0], max_new_tokens=5, stream=bad_stream)
    rest = [eng.submit(p, max_new_tokens=5) for p in prompts[1:]]
    eng.run_until_complete(300)
    assert eng.result(a).status == "failed"
    assert "stream callback" in eng.result(a).status_reason
    assert [eng.result(r).tokens for r in rest] == want
    m = eng.metrics_dict()
    assert m["step_retries"] == 0 and m["quarantines"] == 0
    assert_accounting(eng, [a] + rest)


def test_quarantine_rebuild_honours_prefix_bypass(arrays):
    """Once the ladder bypassed the prefix cache, a quarantine builds no
    block slab; the engine still serves."""
    model = _port(arrays, "gpt")
    faults = port_serving.FaultInjector()
    eng = port_serving.ServingEngine(
        model, num_slots=2, min_bucket=8, block_len=8, faults=faults,
        fault_tolerance=port_serving.FaultToleranceConfig(
            backoff_base_s=0.0))
    base = _prompts(28, (12,))[0]
    eng.submit(base, max_new_tokens=2)
    eng.run_until_complete(100)
    faults.enable("gather", times=2)
    try:
        for s in _prompts(29, (4, 4)):
            eng.submit(np.concatenate([base, s]), max_new_tokens=2)
        eng.run_until_complete(200)
    finally:
        faults.disable("gather")
    assert eng.degraded_subsystems == ("prefix_cache",)
    assert eng.core.prefix_cache is not None     # the old slab stays
    eng.core._quarantine("test: rebuild under bypass")
    assert eng.core.prefix_cache is None and eng.core.block_pool is None
    p = _prompts(30, (5,))[0]
    clean = port_serving.ServingEngine(model, num_slots=2, min_bucket=8)
    want = clean.serve_batch([p], max_new_tokens=3)[0].tokens
    r = eng.submit(p, max_new_tokens=3)
    eng.run_until_complete(200)
    assert eng.result(r).status == "finished"
    assert eng.result(r).tokens == want
    assert eng.core.stall_snapshot()["degraded_subsystems"] == \
        ["prefix_cache"]


def test_failed_insert_leaves_no_unwritten_block(arrays):
    """A block claim or a scatter that raises inside ``PrefixCache.insert``
    unlinks the nodes that insert created and frees their blocks: a later
    request with the same prompt misses instead of gathering rows the
    scatter never wrote."""
    model = _port(arrays, "gpt")
    faults = port_serving.FaultInjector()
    eng = port_serving.ServingEngine(
        model, num_slots=2, min_bucket=8, block_len=8, faults=faults,
        fault_tolerance=port_serving.FaultToleranceConfig(
            backoff_base_s=0.0, ladder_threshold=3))
    p = _prompts(31, (33,))[0]
    for site in ("scatter", "block_alloc"):
        faults.enable(site, at=1 if site == "block_alloc" else 0)
        try:
            r = eng.submit(p, max_new_tokens=2)
            eng.run_until_complete(100)
        finally:
            faults.disable(site)
        assert faults.fired[site] == 1
        assert eng.core.block_pool.used_blocks == 0
        assert not eng.core.prefix_cache.root.children
        assert_accounting(eng, [r])
    r = eng.submit(p, max_new_tokens=2)
    eng.run_until_complete(100)
    assert eng.result(r).prefix_hit_tokens == 0
    assert eng.core.block_pool.used_blocks == 4
