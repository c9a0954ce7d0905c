"""The prefill graphs on the card: every decode path of a ``ServingEngine``
on one CUDA device captures its prefill chunk once per chunk width, beside
its one decode capture, serves the CPU engine's greedy tokens, and a
replayed chunk writes the eager body's bits.  Skips without a card; the
CPU tests of the same plane are ``tests/test_torch_prefill_graph.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import _capture_stream

# chunks of 16 over 16-token blocks, tails bucketed from 4: widths 16, 8, 4
ENGINE_KW = dict(num_slots=4, min_bucket=4, block_len=16, prefill_chunk=16)
PREFIX = 32
WAVES = (((40, True), (9, False), (23, False)),
         ((50, True), (35, True), (19, False)))
NEW = 4


def _waves():
    rs = np.random.RandomState(31)
    prefix = rs.randint(0, 256, (PREFIX,))
    return [[np.concatenate([prefix, rs.randint(0, 256, (n - PREFIX,))])
             if shared else rs.randint(0, 256, (n,)) for n, shared in wave]
            for wave in WAVES]


def _lane(core):
    return [t for row in (*core._lane_ks, *core._lane_vs)
            for t in (row if isinstance(row, list) else [row])]


def replay_and_eager(core, width: int, off: int, valid: int, ids):
    """The width's graph replayed and its body run eagerly (on the capture
    stream, as a capture's warm-up runs it) from the same lane rows and
    inputs: each run's last logits and the lane rows it wrote."""
    lane = _lane(core)
    saved = [t[:, off:off + width].clone() for t in lane]
    host = torch.zeros((2 + width,), dtype=torch.int64)
    host[0], host[1] = off, valid
    host[2:2 + valid] = torch.as_tensor(ids[:valid])
    core._prefill_io[:2 + width].copy_(host)
    out = {}
    for how in ("replay", "eager"):
        for t, s in zip(lane, saved):
            t[:, off:off + width].copy_(s)
        if how == "replay":
            core._prefill_graph_chunk(width)
        else:
            stream = _capture_stream(core.device)
            current = torch.cuda.current_stream()
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                core._prefill_body(width)
            current.wait_stream(stream)
        torch.cuda.synchronize()
        out[how] = (core._prefill_logits.clone(),
                    [t[:, off:off + width].clone() for t in lane])
    for t, s in zip(lane, saved):
        t[:, off:off + width].copy_(s)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["unfused", "fused", "tp_fused",
                                  "tp_fused_block"])
def test_one_prefill_capture_per_width_on_the_card(path):
    """Each chunk width is captured once (with the one decode capture
    beside it), every capture is one ``serving.compiles`` count, the
    tokens are the CPU engine's, and a replayed chunk's last logits and
    K/V rows equal the eager body's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tp = path.startswith("tp_")
    cls, cfg = (GPTForCausalLM, gpt_tiny()) if path != "fused" \
        else (LlamaForCausalLM, llama_tiny())
    cpu = cls(cfg, device="cpu").eval()
    card = cls(cfg, device="cuda").eval()
    card.load_state_dict({k: v.to("cuda") for k, v in
                          cpu.state_dict().items()})
    kw = dict(fused_decode=path in ("fused", "tp_fused_block"))
    tokens = {}
    for where, model, devs in (("cpu", cpu, ["cpu", "cpu"]),
                               ("cuda", card, ["cuda:0", "cuda:0"])):
        tp_kw = dict(tensor_parallel=2, devices=devs) if tp else {}
        eng = ServingEngine(model, **ENGINE_KW, **kw, **tp_kw)
        assert eng.decode_path == path
        core = eng.core
        tokens[where], widths = [], set()
        for wave in _waves():
            rids = [eng.submit(p, max_new_tokens=NEW) for p in wave]
            eng.run_until_complete(200)
            for p, r in zip(wave, rids):
                out = eng.purge(r)
                tokens[where].append(list(out.tokens))
                widths |= {w for _, w, _ in core.scheduler.chunk_plan(
                    out.prefix_hit_tokens, len(p), core.prefill_chunk)}
        if where == "cuda":
            assert widths == {16, 8, 4}
            assert eng.prefill_graph_reason is None
            captures = len(widths) + 1
            assert core.capture_counts == {"prefill": len(widths),
                                           "decode": 1, "verify": 0}
            assert eng.registry.get("serving.compiles").value == captures
            assert sum(attrs["count"] for *_, attrs in
                       eng.tracer.events("compile")) == captures
            assert core.eager_prefill_chunks == len(widths)
            assert set(core._prefill_graphs) == widths
            assert set(core.prefill_capture_seconds) == widths
            assert min(core.prefill_capture_seconds.values()) > 0
            rs = np.random.RandomState(4)
            for width in sorted(widths):
                runs = replay_and_eager(core, width, off=16,
                                        valid=width - 1,
                                        ids=rs.randint(0, 256, (width,)))
                (lr, kr), (le, ke) = runs["replay"], runs["eager"]
                assert torch.equal(lr, le), width
                assert all(torch.equal(a, b) for a, b in zip(kr, ke)), width
        eng.close()
    assert tokens["cuda"] == tokens["cpu"]
