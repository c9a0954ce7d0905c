"""The decode graph on the card: every decode path of a ``ServingEngine``
on one CUDA device captures its decode step once, however many steps and
requests follow, and serves the CPU engine's greedy tokens (the CPU side
runs the same body eagerly).  Skips without a card; the CPU tests of the
same plane are ``tests/test_torch_decode_graph.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.serving import ServingEngine

ENGINE_KW = dict(num_slots=4, min_bucket=8, block_len=16)
# 6 requests over 4 slots: two slots are released and re-admitted
LENGTHS = (5, 11, 3, 17, 9, 6)
NEW = (3, 6, 2, 5, 4, 3)
ZERO = {"prefill": 0, "decode": 0, "verify": 0}


def _submit_all(eng):
    rs = np.random.RandomState(21)
    return [eng.submit(rs.randint(0, 256, (n,)), max_new_tokens=m)
            for n, m in zip(LENGTHS, NEW)]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["unfused", "fused", "tp_fused",
                                  "tp_fused_block"])
def test_one_capture_per_engine_on_the_card(path):
    """On one card every decode path captures its decode step once, however
    many steps and requests follow, and serves the CPU engine's greedy
    tokens."""
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
        rids = _submit_all(eng)
        eng.run_until_complete(200)
        tokens[where] = [list(eng.purge(r).tokens) for r in rids]
        if where == "cuda":
            # beside one capture per prefill chunk width
            prefill = len(eng.core._prefill_graphs)
            assert eng.decode_graph_reason is None
            assert eng.core.capture_counts == {**ZERO, "decode": 1,
                                               "prefill": prefill}
            assert eng.registry.get("serving.compiles").value == prefill + 1
            assert sum(attrs["count"] for *_, attrs in
                       eng.tracer.events("compile")) == prefill + 1
            assert eng.core.eager_decode_steps == 1
            assert eng.core.capture_seconds["decode"] > 0
        eng.close()
    assert tokens["cuda"] == tokens["cpu"]
