"""The port's profiler (``paddle_tpu_torch.profiler``) against the JAX
package's on the CPU, and its hooks in the serving engine.

* ``make_scheduler``'s state for steps 0-20 equals the reference's for
  several ``(closed, ready, record, repeat, skip_first)``;
* ``Profiler.step()`` hands the trace to ``on_trace_ready`` at the same
  steps as the reference's (and ``stop()`` at the end of a window);
* ``RecordEvent`` host events, ``summary()``, the refcounted trace source
  of the obs tracer, and a CPU ``ServingEngine(record_events=True)``:
  its export holds ``serving.step`` events and request lanes, and
  ``close()`` detaches them;
* no fallback hides the device: a GPU target on a host with no CUDA
  device raises.
"""

import json
import os

import pytest
import torch

import paddle_tpu.profiler.profiler as jprof
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.obs import Tracer
from paddle_tpu_torch.profiler import profiler as pmod
from paddle_tpu_torch.serving import ServingEngine

CPU = [prof.ProfilerTarget.CPU]

SCHEDULES = [dict(closed=1, ready=1, record=2),
             dict(closed=0, ready=0, record=1),
             dict(closed=2, ready=0, record=3, repeat=2),
             dict(closed=1, ready=2, record=1, repeat=1, skip_first=3),
             dict(closed=0, ready=1, record=4, repeat=0, skip_first=1)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[str(i) for i in
                                               range(len(SCHEDULES))])
def test_make_scheduler_states_match_the_reference(kw):
    got = prof.make_scheduler(**kw)
    want = jprof.make_scheduler(**kw)
    assert [got(s).name for s in range(21)] == \
        [want(s).name for s in range(21)]


def _ready_steps(mod, scheduler, steps, **kw):
    """The step numbers at which ``on_trace_ready`` fires over ``steps``
    calls of ``step()`` inside the profiler's context."""
    fired = []
    p = mod.Profiler(scheduler=scheduler, timer_only=True,
                     on_trace_ready=lambda q: fired.append(q.step_num), **kw)
    with p:
        for _ in range(steps):
            p.step()
    return fired, p.current_state.name


@pytest.mark.parametrize("sched", [(1, 3), (0, 2), (2, 5), None,
                                   "cycle"], ids=str)
def test_step_hands_out_traces_like_the_reference(sched):
    if sched == "cycle":
        got = _ready_steps(prof, prof.make_scheduler(
            closed=1, ready=1, record=2, repeat=2), 12, targets=CPU)
        want = _ready_steps(jprof, jprof.make_scheduler(
            closed=1, ready=1, record=2, repeat=2), 12)
    else:
        got = _ready_steps(prof, sched, 6, targets=CPU)
        want = _ready_steps(jprof, sched, 6)
    assert got == want


def test_record_event_summary_and_timer_only(capsys):
    p = prof.Profiler(targets=CPU, scheduler=(1, 3), timer_only=True)
    p.start()
    with prof.RecordEvent("outside"):       # step 0: closed
        pass
    p.step()
    for _ in range(2):
        with prof.RecordEvent("work"):
            with prof.RecordEvent("inner"):
                pass
        p.step()
    p.stop()
    names = [e.name for e in p.events()]
    assert names.count("work") == 2 and names.count("inner") == 2
    assert "outside" not in names
    table = p.summary()
    assert "work" in table and "inner" in table
    assert "work" in capsys.readouterr().out
    assert p.device_trace is None and p.device_events() == []


def test_cpu_target_writes_a_device_side_trace(tmp_path):
    """Without ``timer_only`` the window runs ``torch.profiler``: its
    trace lands in ``trace_dir`` and the export merges its events (the
    RecordEvent ranges appear there as ``record_function`` ranges)."""
    out = tmp_path / "export"
    p = prof.Profiler(targets=CPU, scheduler=(0, 1),
                      trace_dir=str(tmp_path / "device"),
                      on_trace_ready=prof.export_chrome_tracing(str(out)))
    with p:
        with prof.RecordEvent("matmul_step"):
            torch.randn(8, 8) @ torch.randn(8, 8)
        p.step()
    assert p.device_trace and os.path.exists(p.device_trace)
    ev = prof.load_profiler_result(p.last_export)["traceEvents"]
    host = [e for e in ev if e.get("cat") == "host"]
    assert [e["name"] for e in host] == ["matmul_step"]
    dev = [e for e in ev if e.get("cat") != "host"]
    assert any(e.get("name") == "matmul_step" for e in dev)
    assert any("mm" in str(e.get("name")) for e in dev)


def test_gpu_target_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match=r"targets=\[ProfilerTarget.CPU\]"):
        prof.Profiler(targets=[prof.ProfilerTarget.GPU])
    with pytest.raises(ValueError, match="no tracer"):
        prof.Profiler(targets=[prof.ProfilerTarget.TPU])
    assert prof.Profiler().targets == CPU


def test_failing_device_trace_start_raises(monkeypatch):
    """The reference swallows a device trace that fails to start; the
    port raises."""
    def broken(self):
        raise RuntimeError("no tracer")
    monkeypatch.setattr(torch.profiler.profile, "start", broken)
    p = prof.Profiler(targets=CPU, scheduler=(0, 2))
    with pytest.raises(RuntimeError, match="no tracer"):
        p.start()
    assert not pmod._tracer.enabled


def test_tracer_source_is_refcounted():
    t = Tracer()
    t.install_profiler_source()
    t.install_profiler_source()
    assert t.chrome_events in pmod._trace_sources
    t.remove_profiler_source()
    assert t.chrome_events in pmod._trace_sources
    t.remove_profiler_source()
    assert t.chrome_events not in pmod._trace_sources
    t.remove_profiler_source()               # unbalanced: a no-op
    assert t.chrome_events not in pmod._trace_sources


def test_broken_source_is_written_into_the_trace(tmp_path):
    def broken():
        raise KeyError("gone")
    prof.register_trace_source(broken)
    try:
        p = prof.Profiler(targets=CPU, timer_only=True)
        with p:
            pass
        path = str(tmp_path / "t.json")
        p.export(path)
    finally:
        prof.unregister_trace_source(broken)
    ev = json.load(open(path))["traceEvents"]
    assert [e["args"]["error"] for e in ev
            if e["name"] == "trace_source_error"] == ["KeyError('gone')"]


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(gpt_tiny(), device="cpu").eval()


def test_serving_record_events_exports_steps_and_lanes(model, tmp_path):
    eng = ServingEngine(model, num_slots=2, record_events=True)
    quiet = ServingEngine(model, num_slots=2, tracer=eng.core.metrics.tracer)
    assert eng.core.metrics.tracer.chrome_events in pmod._trace_sources
    out = tmp_path / "export"
    p = prof.Profiler(targets=CPU, scheduler=(0, 100), timer_only=True,
                      on_trace_ready=prof.export_chrome_tracing(str(out)))
    with p:
        eng.serve_batch([[1, 2, 3, 4], [5, 6, 7]], max_new_tokens=3)
    ev = prof.load_profiler_result(p.last_export)["traceEvents"]
    steps = [e for e in ev if e.get("cat") == "host"]
    assert steps and {e["name"] for e in steps} == {"serving.step"}
    assert len(steps) == eng.core._step_index
    lanes = {e["tid"] for e in ev if e.get("cat") == "request"}
    assert len(lanes) == 2
    # a record_events=False engine on the same tracer: its close must not
    # take the shared source down
    quiet.close()
    assert eng.core.metrics.tracer.chrome_events in pmod._trace_sources
    eng.close()
    eng.close()
    assert eng.core.metrics.tracer.chrome_events not in pmod._trace_sources
    p.export(str(tmp_path / "after.json"))
    ev = json.load(open(tmp_path / "after.json"))["traceEvents"]
    assert not [e for e in ev if e.get("cat") == "request"]


def test_record_events_is_keyword_only(model):
    with pytest.raises(TypeError):
        ServingEngine(model, 2, None, 16, None, None, None, True, 16, None,
                      True)
