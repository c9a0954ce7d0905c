"""The fleet tier on the card: what a CPU fleet cannot show, since its
engines capture no CUDA graph and run no hand-written kernel.

  * a disaggregated fleet's KV handoff lands the prefill replica's blocks
    in the decode replica's block slab bit for bit, captures no graph on
    either replica, and the fleet serves a single engine's greedy tokens;
  * replicas sharing one model on one card replay their own graphs in
    turn (the router steps them one after another) and serve a single
    engine's tokens, through a kill mid-decode.

Skips without a card; the CPU tests are ``tests/test_torch_fleet.py`` and
``tests/test_torch_disagg.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import (FaultToleranceConfig, Router,
                                      ServingEngine, fleet_accounting)

KW = dict(num_slots=2, min_bucket=8, prefill_chunk=16, block_len=8)
NEW = 5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _model():
    torch.manual_seed(0)
    return GPTForCausalLM(gpt_tiny(), device="cuda").eval()


def _prompts(lengths, seed=5):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)) for n in lengths]


def _single(model, prompts):
    eng = ServingEngine(model, **KW)
    outs = [o.tokens for o in eng.serve_batch(prompts, max_new_tokens=NEW)]
    eng.close()
    return outs


@pytest.mark.cuda
def test_handoff_moves_blocks_bit_for_bit_without_a_capture():
    _card()
    model = _model()
    prompts = _prompts((41, 57, 6))
    want = _single(model, prompts)
    router = Router.build(lambda: model, replicas=2,
                          roles=("prefill", "decode"), prefill_threshold=32,
                          fault_tolerance=FaultToleranceConfig(
                              backoff_base_s=0.0), **KW)
    src, dst = (h.engine.core for h in router.replicas)
    mgr = router._handoffs
    transfer, seen = mgr.transfer, []

    def checked(rec, s, d, prompt):
        caps = [dict(c.capture_counts) for c in (src, dst)]
        ok = transfer(rec, s, d, prompt)
        torch.cuda.synchronize()
        assert [dict(c.capture_counts) for c in (src, dst)] == caps
        got = dst.prefix_cache.match(prompt, count_stats=False)
        for a, b in zip(src.block_pool.bks, dst.block_pool.bks):
            assert torch.equal(a[rec._match.blocks], b[got.blocks[
                :len(rec._match.blocks)]])
        dst.prefix_cache.release(got)
        seen.append(rec.blocks_moved)
        return ok
    mgr.transfer = checked
    fids = [router.submit(p, max_new_tokens=NEW) for p in prompts]
    router.run_until_complete(300)
    assert [router.result(f).tokens for f in fids] == want
    # the blocks before each prompt's last 16-token chunk
    assert seen == [4, 6]
    acc = fleet_accounting(router)
    assert acc["ok"] and acc["handoffs_committed"] == 2, acc
    router.close()


@pytest.mark.cuda
def test_replicas_on_one_model_replay_their_own_graphs_through_a_kill():
    _card()
    model = _model()
    prompts = _prompts((9, 13, 17, 21), seed=6)
    want = _single(model, prompts)
    router = Router.build(lambda: model, replicas=2, **KW)
    seen = {i: [] for i in range(len(prompts))}
    fids = [router.submit(p, max_new_tokens=NEW,
                          stream=lambda req, tok, i=i: seen[i].append(tok))
            for i, p in enumerate(prompts)]
    while min(len(s) for s in seen.values()) < 2:
        router.step()
    assert all(h.engine.core.capture_counts["decode"] == 1
               for h in router.replicas)
    router.kill(1)
    router.run_until_complete(300)
    assert [router.result(f).tokens for f in fids] == want
    assert [seen[i] for i in range(len(prompts))] == want
    assert router.accounting()["ok"]
    router.replicas[1].engine.close()
    router.close()
