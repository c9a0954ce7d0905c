"""A regenerated fleet request keeps its first attempt's chunk schedule.

Failover, a hedge and recovery resubmit the whole prompt.  The target
matches its own radix cache, and a target holding more or less of the
prompt than the first attempt's replica would plan other chunk widths at
other offsets: in bf16 its prefill could then regenerate another first
token than the one the client already has, and the router's delivered
mark would splice two continuations.  The router carries the first
attempt's plan start (its radix hit); the target caps its match there,
prefills the rows below it that it lacks, and runs the rows from it in
the first attempt's chunks.

Two gpt_tiny replicas on the CPU (f32, ``prefill_chunk=16``, 8-token
radix blocks); the first attempt runs on replica 0, which is killed
after its first tokens; replica 1 holds a longer prefix (or none) of the
prompt.  Every admitted chunk plan is recorded.
"""

import numpy as np
import pytest

import paddle_tpu_torch.serving as serving
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving.engine import EngineCore

ENGINE_KW = dict(num_slots=2, min_bucket=8, block_len=8, prefill_chunk=16)
PROMPT_LEN = 60


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(gpt_tiny(), device="cpu").eval()


@pytest.fixture
def plans(monkeypatch):
    """``(engine core, prompt length, plan)`` of every admission."""
    seen = []
    begin = EngineCore._begin_prefill

    def record(self, req):
        begin(self, req)
        seen.append((self, req.prompt_len, list(self._prefills[-1].plan)))
    monkeypatch.setattr(EngineCore, "_begin_prefill", record)
    return seen


def _warm(engine, prompt):
    engine.submit(prompt, max_new_tokens=1)
    engine.run_until_complete(100)


@pytest.mark.parametrize("first_hit,target_hit", [(16, 48), (40, 0)],
                         ids=["target_holds_more", "target_holds_less"])
def test_regenerated_plan_matches_the_first_attempt(model, plans, first_hit,
                                                    target_hit):
    prompt = np.random.RandomState(2).randint(0, 256, (PROMPT_LEN,))
    single = serving.ServingEngine(model, **ENGINE_KW)
    rid = single.submit(prompt, max_new_tokens=6)
    single.run_until_complete(100)
    want = single.result(rid).tokens

    r = serving.Router.build(lambda: model, replicas=2, **ENGINE_KW)
    cores = [h.engine.core for h in r._handles]
    _warm(r._handles[0].engine, prompt[:first_hit + 4])
    fid = r.submit(prompt, max_new_tokens=6)
    fr = r._requests[fid]
    assert fr.replica == 0
    while fr.delivered < 2:
        r.step()
    if target_hit:
        _warm(r._handles[1].engine, prompt[:target_hit + 4])
    assert cores[1].prefix_probe(prompt) == max(target_hit, 0)
    r.kill(0)
    assert fr.replica == 1
    r.run_until_complete(300)
    out = r.result(fid)
    assert out.status == "finished" and out.tokens == want

    first = [p for c, n, p in plans if c is cores[0] and n == PROMPT_LEN]
    regen = [p for c, n, p in plans if c is cores[1] and n == PROMPT_LEN]
    assert len(first) == 1 and len(regen) == 1

    def tail(plan):
        return [c for c in plan if c[0] >= first_hit]
    assert first[0][0][0] == first_hit
    assert tail(regen[0]) == tail(first[0]), (first[0], regen[0])
    # rows the target lacked below the start ran first, in its own chunks
    assert regen[0][0][0] == min(target_hit, first_hit)
    assert fr.plan_start == first_hit


def test_plan_start_must_be_a_radix_boundary(model):
    eng = serving.ServingEngine(model, **ENGINE_KW)
    prompt = np.arange(30) % 256
    with pytest.raises(ValueError, match="plan_start"):
        eng.submit(prompt, max_new_tokens=2, plan_start=12)
    with pytest.raises(ValueError, match="plan_start"):
        eng.submit(prompt, max_new_tokens=2, plan_start=32)
    rid = eng.submit(prompt, max_new_tokens=2, plan_start=16)
    eng.run_until_complete(100)
    assert eng.result(rid).status == "finished"
