"""The semi-auto Engine, the profiler and ``record_events`` through the
kernels on the card (``-m cuda``; no JAX import).

An f32 Llama of 256 width with 64-wide heads (TF32 off), 2 layers:

* ``dp 2 x mp 2`` (every rank on the card) gives the serial Engine's
  losses at the reference oracle's bounds (rtol 2e-4, atol 2e-5), and a
  step launches each flash kernel once per layer and rank, each RMSNorm
  kernel 2L + 1 times;
* the port's ``Profiler`` with a GPU target exports the host events and
  the flash and RMSNorm kernels of the recorded steps;
* a ``ServingEngine(record_events=True)`` captures its graphs as often
  as one without, and its export holds ``serving.step`` events.
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.examples import train_llama_semi_auto as example
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                     gpt_tiny)
from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                       RecordEvent, export_chrome_tracing,
                                       load_profiler_result)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.optimizer import SGD

pytestmark = pytest.mark.cuda

CFG = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")


def _run(mesh, steps=3):
    _, eng = example.build(CFG, mesh, torch.device("cuda"), 3,
                           optimizer=SGD(learning_rate=0.1))
    data = example.batches(CFG.vocab_size, 8, 128, steps)
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, fn.rms_norm_fwd, fn.rms_norm_bwd)
    for k in counted:
        k.launches = 0
    losses = eng.fit(data)
    return losses, [k.launches for k in counted], eng, data


def test_sharded_engine_equals_serial_through_the_kernels(card):
    serial, s_launch, _, _ = _run(None)
    mesh = example.process_mesh(2, 2, "cuda")
    sharded, launch, _, _ = _run(mesh)
    np.testing.assert_allclose(sharded, serial, rtol=2e-4, atol=2e-5)
    L = CFG.num_layers
    assert s_launch == [3 * L] * 3 + [3 * (2 * L + 1)] * 2
    assert launch == [3 * L * 4] * 3 + [3 * (2 * L + 1)] * 2


def test_gpu_profiler_exports_host_events_and_kernels(card, tmp_path):
    mesh = example.process_mesh(2, 2, "cuda")
    _, _, eng, data = _run(mesh, steps=1)
    p = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                 scheduler=(1, 3), trace_dir=str(tmp_path / "device"),
                 on_trace_ready=export_chrome_tracing(str(tmp_path / "out")))
    with p:
        for _ in range(4):
            with RecordEvent("step"):
                eng.fit(data[:1])
            p.step()
    assert os.path.exists(p.device_trace)
    ev = load_profiler_result(p.last_export)["traceEvents"]
    host = [e["name"] for e in ev if e.get("cat") == "host"]
    assert host.count("step") == 2 and "Engine.backward" in host
    kernels = {e["name"] for e in ev if e.get("cat") == "kernel"}
    for want in ("fwd_f32_kernel", "dq_f32_kernel", "dkv_f32_kernel",
                 "rms_fwd_kernel", "norm_bwd_rows_kernel"):
        assert any(want in k for k in kernels), want
    table = p.summary(device_rows=len(kernels))
    assert "rms_fwd_kernel" in table and "aten::" not in table


def test_record_events_keeps_the_captures(card, tmp_path):
    m = GPTForCausalLM(gpt_tiny(), device="cuda").eval()
    prompts = [list(range(1, n)) for n in (20, 7, 40)]
    counts = []
    for record in (False, True):
        eng = ServingEngine(m, num_slots=4, record_events=record)
        p = Profiler(targets=[ProfilerTarget.CPU],
                     trace_dir=str(tmp_path / "device"),
                     on_trace_ready=export_chrome_tracing(
                         str(tmp_path / f"out{record}")))
        with p:
            eng.serve_batch(prompts, max_new_tokens=6)
        counts.append(dict(eng.core.capture_counts))
        ev = load_profiler_result(p.last_export)["traceEvents"]
        steps = [e for e in ev if e.get("cat") == "host"]
        assert len(steps) == (eng.core._step_index if record else 0)
        eng.close()
    assert counts[0] == counts[1] and counts[0]["decode"] == 1
