"""Speculative decoding on the card: every serving path of a
``ServingEngine(spec_k=4)`` on one CUDA device captures its verify step
once, however many steps and requests follow, replays it to the eager
body's bits, and serves the CPU engine's greedy tokens (the CPU side runs
the same bodies eagerly).  Skips without a card; the CPU tests are
``tests/test_torch_spec.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import _capture_stream

ENGINE_KW = dict(num_slots=4, max_seq=256, min_bucket=8, prefill_chunk=16,
                 block_len=16, spec_k=4)
PATHS = {"unfused": {}, "fused": dict(fused_decode=True),
         "tp_fused": dict(tensor_parallel=2),
         "tp_fused_block": dict(tensor_parallel=2, fused_decode=True),
         "tp_unfused": dict(tensor_parallel=2, collective_fusion=False)}


def _prompts():
    """Repetitive prompts (phrases tiled), so the n-gram tables draft."""
    rs = np.random.RandomState(7)
    return [rs.randint(0, 256, (n,)).tolist() * 3 for n in (5, 9, 3, 11, 4)]


def _eager_verify(core):
    stream = _capture_stream(core.device)
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        core._verify_body()
    current.wait_stream(stream)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_one_verify_capture_per_engine_on_the_card(path):
    """One verify capture per engine, ``serving.compiles`` the sum of the
    captures, the CPU engine's greedy tokens, and a replayed verify body
    bit-identical to its eager body (logits and the window's K/V rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tp = path.startswith("tp_")
    cls, cfg = (LlamaForCausalLM, llama_tiny()) if path == "fused" \
        else (GPTForCausalLM, gpt_tiny())
    cpu = cls(cfg, device="cpu").eval()
    card = cls(cfg, device="cuda").eval()
    card.load_state_dict({k: v.to("cuda") for k, v in
                          cpu.state_dict().items()})
    tokens = {}
    for where, model in (("cpu", cpu), ("cuda", card)):
        kw = dict(PATHS[path])
        if tp:
            kw["devices"] = [where if where == "cpu" else "cuda:0"] * 2
        eng = ServingEngine(model, **ENGINE_KW, **kw)
        assert eng.spec_on
        outs = eng.serve_batch(_prompts(), max_new_tokens=12,
                               max_steps=500)
        tokens[where] = [list(o.tokens) for o in outs]
        if where == "cuda":
            core = eng.core
            counts = core.capture_counts
            assert eng.decode_graph_reason is None
            assert counts["verify"] == 1 and core.eager_verify_steps == 1
            assert counts["decode"] == min(core.eager_decode_steps, 1)
            assert counts["prefill"] == len(core._prefill_graphs)
            assert eng.registry.get("serving.compiles").value == \
                sum(counts.values())
            assert eng.metrics_dict()["spec_accepted_tokens"] > 0
            # replay vs eager from the same state: the body reads the
            # slabs below each seq_pos, the last tokens and the drafts,
            # and rewrites the same window rows
            core._verify_io.copy_(torch.randint(
                0, cfg.vocab_size, core._verify_io.shape, device="cuda"))
            core._verify_io[:, -1] = core.spec_k
            pos = core.pool.seq_pos.clone()
            got = {}
            for name, fn in (("replay", core._verify_graph_step),
                             ("eager", lambda: _eager_verify(core))):
                fn()
                torch.cuda.synchronize()
                slabs = [t for row in core.pool.ks + core.pool.vs
                         for t in (row if isinstance(row, list) else [row])]
                got[name] = [core._verify_logits.clone()] + [
                    s[i, p:p + core.spec_k + 1].clone()
                    for s in slabs for i, p in enumerate(pos.tolist())]
            assert torch.equal(core.pool.seq_pos, pos)
            assert all(torch.equal(a, b)
                       for a, b in zip(got["replay"], got["eager"]))
        eng.close()
    # f32: the card's kernels and the CPU's plain versions agree to the
    # argmax here
    assert tokens["cuda"] == tokens["cpu"]
