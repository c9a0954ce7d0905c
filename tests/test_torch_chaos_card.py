"""Fault-tolerant serving on the card: what a CPU engine cannot show,
since it captures no CUDA graph and runs no hand-written kernel.

  * a quarantine drops every graph and captures it again on the new
    device plane (``capture_counts["decode"]`` + 1), and so does the
    ``fused_decode`` rung for the decode graph;
  * the rebuild frees the old plane and the graphs before it allocates
    the new one;
  * a raise inside a capture leaves no half-captured graph: the
    watchdog's retry decodes the same step again and captures anew;
  * ``nan_logits`` (NaN written in place into a slot's K row) reaches the
    sentinel through the card's attention kernels on each decode path:
    exactly the poisoned request fails.

Every engine's requests are held to a fault-free engine's on the same
card (f32 tiny models).  Skips without a card; the CPU tests are
``tests/test_torch_chaos_serving.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.serving import (FaultInjector, FaultToleranceConfig,
                                      ServingEngine)

KW = dict(num_slots=2, min_bucket=8, prefill_chunk=16, block_len=8)
NEW = 5
PATHS = {"unfused": ("gpt", {}),
         "fused": ("llama", dict(fused_decode=True)),
         "spec": ("gpt", dict(spec_k=4)),
         "tp_fused": ("gpt", dict(tensor_parallel=2)),
         "tp_fused_block": ("gpt", dict(tensor_parallel=2,
                                        fused_decode=True))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _model(family):
    torch.manual_seed(0)
    cls, cfg = (GPTForCausalLM, gpt_tiny()) if family == "gpt" \
        else (LlamaForCausalLM, llama_tiny())
    return cls(cfg, device="cuda").eval()


def _engine(model, faults=None, **kw):
    if kw.get("tensor_parallel", 1) > 1:
        kw["devices"] = ["cuda:0"] * kw["tensor_parallel"]
    return ServingEngine(model, **KW, **kw, faults=faults,
                         fault_tolerance=FaultToleranceConfig(
                             max_step_retries=2, backoff_base_s=0.0))


def _prompts(tiled=False, n=5):
    rs = np.random.RandomState(3)
    if tiled:
        return [np.tile(rs.randint(0, 256, (3,)), 6) for _ in range(n)]
    return [rs.randint(0, 256, (int(rs.randint(5, 20)),)) for _ in range(n)]


def _serve(eng, prompts, cancel=None):
    """Serve to the end; ``cancel = (i, n)`` cancels request ``i`` right
    after ``n`` steps.  Returns the outputs and, per request, the steps
    after which it was terminal."""
    rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    steps, done_at = 0, [None] * len(rids)
    while eng.core.scheduler.has_work():
        eng.step()
        steps += 1
        for i, rid in enumerate(rids):
            if done_at[i] is None and eng.result(rid).finished:
                done_at[i] = steps
        if cancel is not None and steps == cancel[1]:
            eng.cancel(rids[cancel[0]])
        assert steps < 300
    return [eng.result(r) for r in rids], done_at


def _clean(model, prompts, cancel=None, **kw):
    eng = _engine(model, **kw)
    outs, _ = _serve(eng, prompts, cancel)
    eng.close()
    return [o.tokens for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["unfused", "tp_fused"])
def test_quarantine_captures_every_graph_again(path):
    """Three ``step`` faults after the first decode step (2 retries, then
    a quarantine): the two in-flight requests fail, the queued ones equal
    a fault-free engine's, the decode graph is captured once more and
    each prefill width at most once more."""
    _card()
    family, kw = PATHS[path]
    model = _model(family)
    prompts = _prompts()
    want = _clean(model, prompts, **kw)
    faults = FaultInjector()
    eng = _engine(model, faults, **kw)
    core = eng.core
    before = []
    rebuild = core._rebuild_device_plane

    def rebuild_device_plane():
        before.append(dict(core.capture_counts))
        rebuild()

    core._rebuild_device_plane = rebuild_device_plane
    faults.enable("step", at=1, times=3)
    outs, _ = _serve(eng, prompts)
    assert eng.metrics_dict()["quarantines"] == 1
    assert [o.status for o in outs] == ["failed"] * 2 + ["finished"] * 3
    assert all("quarantine" in o.status_reason for o in outs[:2])
    assert [o.tokens for o in outs[2:]] == want[2:]
    (counts,) = before
    assert counts["decode"] == 1 and core.capture_counts["decode"] == 2
    # one capture a width the new plane served
    assert core.capture_counts["prefill"] == \
        counts["prefill"] + len(core._prefill_graphs)
    assert core._decode_graph is not None
    assert eng.health.state == "healthy"
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "tp_fused_block"])
def test_fused_rung_captures_the_new_decode_step(path):
    """Two ``step`` faults on a fused engine after its decode graph was
    captured: the rung drops it, the next decode step captures the new
    path's, and a request served after equals that path's fault-free
    engine."""
    _card()
    family, kw = PATHS[path]
    model = _model(family)
    prompts = _prompts()
    faults = FaultInjector()
    eng = _engine(model, faults, **kw)
    core = eng.core
    faults.enable("step", at=2, times=2)
    outs, _ = _serve(eng, prompts[:4])
    assert core.capture_counts["decode"] == 2
    assert eng.decode_path == ("unfused" if path == "fused" else "tp_fused")
    assert eng.decode_fallback_reason.startswith("degraded")
    assert all(o.status == "finished" for o in outs)
    got, _ = _serve(eng, prompts[4:])
    eng.close()
    want = _clean(model, prompts[4:],
                  **{k: v for k, v in kw.items() if k != "fused_decode"})
    assert [o.tokens for o in got] == want


@pytest.mark.cuda
def test_rebuild_frees_the_old_plane_before_it_allocates():
    """At the moment the quarantine starts building the new plane, the
    graphs and their pool are gone and the device memory of the old slot
    slabs, block slab and staging lane has been given back."""
    _card()
    model = _model("gpt")
    eng = _engine(model, FaultInjector())
    core = eng.core
    _serve(eng, _prompts()[:2])
    assert core._decode_graph is not None
    plane = sum(t.numel() * t.element_size() for t in
                core.pool.ks + core.pool.vs + core.block_pool.bks +
                core.block_pool.bvs + core._lane_ks + core._lane_vs)
    seen = {}
    build = core._build_device_plane

    def build_device_plane():
        torch.cuda.synchronize()
        seen["allocated"] = torch.cuda.memory_allocated()
        seen["graphs"] = (core._decode_graph, core._graph_pool,
                          core._prefill_graphs)
        build()

    core._build_device_plane = build_device_plane
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    core._quarantine("test: rebuild")
    assert seen["graphs"] == (None, None, {})
    assert seen["allocated"] <= before - plane
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() >= seen["allocated"] + plane
    outs, _ = _serve(eng, _prompts()[2:])
    assert all(o.status == "finished" for o in outs)
    eng.close()


@pytest.mark.cuda
def test_raise_inside_a_capture_leaves_no_graph():
    """The decode body raises while it is being captured: no graph is
    kept, ``seq_pos`` is where the step found it, the watchdog retries,
    and the next step captures anew; every request equals a fault-free
    engine's."""
    _card()
    model = _model("gpt")
    prompts = _prompts()
    want = _clean(model, prompts)
    eng = _engine(model)
    core = eng.core
    calls = []
    body = core._decode_body

    def decode_body():
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls == [False, True]:
            raise RuntimeError("injected raise inside the capture")
        body()

    core._decode_body = decode_body
    outs, _ = _serve(eng, prompts)
    assert calls[:4] == [False, True, False, True]
    assert core.capture_counts["decode"] == 1
    # the failed attempt's eager run was undone (seq_pos put back): only
    # the retry's counts
    assert core.eager_decode_steps == 1
    assert eng.metrics_dict()["step_retries"] == 1
    assert [o.tokens for o in outs] == want
    eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["unfused", "fused", "spec",
                                  "tp_fused_block"])
def test_poisoned_slot_reaches_the_sentinel(path):
    """NaN written into a live slot's K row at a replayed decode (or
    verify) step fails exactly that slot's request with "non-finite";
    every other request equals a fault-free engine's in which that
    request is cancelled right after the same step."""
    _card()
    family, kw = PATHS[path]
    model = _model(family)
    prompts = _prompts(tiled=path == "spec")
    faults = FaultInjector()
    eng = _engine(model, faults, **kw)
    core = eng.core
    poisoned = []
    poison = core._poison_slot

    def poison_slot(slot, step_i):
        poisoned.append(core._slots[slot].req.request_id)
        poison(slot, step_i)

    core._poison_slot = poison_slot
    faults.enable("nan_logits", at=1)
    outs, done_at = _serve(eng, prompts)
    eng.close()
    assert len(poisoned) == 1
    victim = poisoned[0]
    assert outs[victim].status == "failed"
    assert "non-finite" in outs[victim].status_reason
    want = _clean(model, prompts, cancel=(victim, done_at[victim]), **kw)
    for i, (o, w) in enumerate(zip(outs, want)):
        if i != victim:
            assert o.status == "finished" and o.tokens == w, i
