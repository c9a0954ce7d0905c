"""The port's fleet tier (``serving/router.py``, ``serving/fleet.py``)
against the JAX package's, on the CPU: unified replicas and the
tail-latency layer.

Each package builds two unified gpt_tiny replicas (f32, the weights
carried by ``state_dict_from_jax``, ``num_slots=2``, ``block_len=8``) once
for the module; every test fronts them with its own ``Router``, drives the
same traffic and the same fault arming on both sides, drains the fleet and
compares, request by request: the replica that owns it, its attempts,
terminal status and the class of its reason (the text before the first
colon), the greedy tokens exactly, the delivered mark, the failover /
hedge / handoff flags and the replicas of its history; and the fleet
verdict of ``fleet_accounting`` with its counters.  Scenarios: prefix
affinity over a shared prefix, failover after an injected engine ``step``
fault (a quarantine), a hedge race and a hedge that fails closed, the
brownout ladder and the rejections that carry every replica's refusal.
The straggler detector reads wall-clock step times, which no two packages
share, so it is driven in the port alone (``replica_slow``).

Seeded sampling is held inside the port (a ``torch.Generator`` does not
reproduce ``jax.random``): a fleet's sampled streams equal one engine's,
through a hedge whose primary is killed and a kill mid-decode, each
token reaching the client once.  Card-only checks are in
``tests/test_torch_fleet_card.py``.
"""

import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.serving as jax_serving
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.obs import MetricsRegistry as JaxRegistry
from paddle_tpu.obs import Tracer as JaxTracer
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.obs import MetricsRegistry, Tracer

ENGINE_KW = dict(num_slots=2, min_bucket=8, block_len=8)
SIDES = {"jax": (jax_serving, JaxRegistry, JaxTracer),
         "port": (port_serving, MetricsRegistry, Tracer)}
VERDICT_KEYS = ("ok", "all_terminal", "served_at_most_once_retry",
                "pools_at_baseline", "handoffs_settled", "hedges_settled",
                "hedges", "hedge_wins", "handoffs_staged",
                "handoffs_committed", "handoffs_aborted",
                "handoff_blocks_moved", "failovers", "failovers_exhausted",
                "killed_replicas")


@pytest.fixture(scope="module")
def models():
    paddle_tpu.seed(13)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    pm = GPTForCausalLM(gpt_tiny(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return {"jax": jm, "port": pm.eval()}


@pytest.fixture(scope="module")
def fleet(models):
    """Per side: two unified replicas sharing one model, each with its own
    engine injector, on one registry and tracer."""
    out = {}
    for side, (mod, registry_cls, tracer_cls) in SIDES.items():
        registry, tracer = registry_cls(), tracer_cls()
        faults = [mod.FaultInjector() for _ in range(2)]
        ft = mod.FaultToleranceConfig(max_step_retries=1,
                                      backoff_base_s=0.0)
        engines = [mod.ServingEngine(models[side], registry=registry,
                                     tracer=tracer, fault_tolerance=ft,
                                     faults=f, **ENGINE_KW)
                   for f in faults]
        out[side] = dict(mod=mod, engines=engines, faults=faults,
                         registry=registry, tracer=tracer)
    return out


def _router(f, **kw):
    """A router over the side's replicas.  The straggler detector reads
    wall-clock step times, which differ between the packages (the JAX
    side compiles on first use), so these routers never mark a replica
    slow; ``test_port_straggler_is_marked_and_hedged`` drives it."""
    return f["mod"].Router(f["engines"], registry=f["registry"],
                           tracer=f["tracer"], slow_threshold=1e9, **kw)


def _prompts(seed, lengths, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lengths]


def _reason_class(reason):
    return None if reason is None else str(reason).split(":")[0]


def summary(router, fids):
    """Every request's routing record and terminal view, and the fleet
    verdict's counters."""
    acc = router.accounting()
    rows = {r["fleet_id"]: r for r in acc["requests"]}
    per = []
    for fid in fids:
        out, row = router.result(fid), rows[fid]
        per.append((row["replica"], row["attempts"], out.status,
                    _reason_class(out.status_reason),
                    [int(t) for t in out.tokens], row["delivered"],
                    row["failed_over"], row["hedged"], row["stage"],
                    row["handoffs"],
                    [h["replica"] for h in row["history"]]))
    return per, {k: acc[k] for k in VERDICT_KEYS}


def both(fleet, scenario):
    """Run ``scenario(f) -> (router, fleet ids, extra)`` on both sides;
    returns ``{side: (summary, extra)}``."""
    out = {}
    for side in SIDES:
        router, fids, extra = scenario(fleet[side])
        out[side] = (summary(router, fids), extra)
    return out


# ------------------------------------------------------------ scenarios

def _affinity(f):
    r = _router(f)
    prefix = _prompts(0, (24,))[0]
    tails = _prompts(1, (3, 5, 4, 6))
    fids = [r.submit(np.concatenate([prefix, tails[0]]), max_new_tokens=4)]
    r.run_until_complete(300)
    fids += [r.submit(np.concatenate([prefix, t]), max_new_tokens=4)
             for t in tails[1:]]
    fids.append(r.submit(_prompts(2, (9,))[0], max_new_tokens=4))
    r.run_until_complete(300)
    return r, fids, r.metrics_dict()["prefix_hit_tokens"]


def test_affinity_lands_tails_on_the_warmed_replica(fleet):
    got = both(fleet, _affinity)
    assert got["port"] == got["jax"]
    (per, verdict), hit_tokens = got["port"]
    assert verdict["ok"], verdict
    warm = per[0][0]
    assert [p[0] for p in per[1:4]] == [warm] * 3
    assert per[4][0] != warm               # no hit anywhere: the lighter
    assert hit_tokens == 3 * 24
    assert all(p[2] == "finished" for p in per)


def _failover(f):
    r = _router(f)
    fids = [r.submit(p, max_new_tokens=5) for p in _prompts(3, (7, 9))]
    r.step()
    f["faults"][0].enable("step", times=2)     # retries 1: quarantine
    try:
        r.run_until_complete(300)
    finally:
        f["faults"][0].disable("step")
    quarantines = f["engines"][0].core.health.quarantine_count
    return r, fids, quarantines


def test_failover_after_a_step_fault_matches_the_reference(fleet):
    got = both(fleet, _failover)
    assert got["port"] == got["jax"]
    (per, verdict), _ = got["port"]
    assert verdict["ok"] and verdict["failovers"] == 1, verdict
    moved = [p for p in per if p[6]]
    assert len(moved) == 1 and moved[0][1] == 2 and moved[0][10] == [0]
    assert moved[0][2] == "finished" and moved[0][5] == 5


def _hedges(f):
    fi = f["mod"].FaultInjector()
    r = _router(f, faults=fi)
    fids = [r.submit(p, max_new_tokens=6, deadline_s=600.0)
            for p in _prompts(4, (6, 8))]
    r.step()
    issued = r.issue_hedge(r._requests[fids[0]])
    fi.enable("hedge_submit")
    try:
        failed_closed = r.issue_hedge(r._requests[fids[1]])
    finally:
        fi.disable("hedge_submit")
    r.run_until_complete(300)
    m = r.metrics_dict()
    return r, fids, (issued, failed_closed, m["hedges"], m["hedge_wins"],
                     m["hedges_failed"])


def test_hedge_race_and_failed_hedge_match_the_reference(fleet):
    got = both(fleet, _hedges)
    assert got["port"] == got["jax"]
    (per, verdict), counts = got["port"]
    assert counts == (True, False, 1, 0, 1)
    assert verdict["ok"] and verdict["hedges_settled"], verdict
    assert [p[7] for p in per] == [True, True]
    assert [p[2] for p in per] == ["finished", "finished"]


def _brownout(f):
    mod = f["mod"]
    r = _router(f, brownout_depth=1, brownout_hysteresis=1)
    fids = [r.submit(p, max_new_tokens=3)
            for p in _prompts(5, (5, 6, 7, 8, 9, 10, 11))]
    levels, refusals = [], []
    for _ in range(3):
        r.step()
        levels.append(r.brownout_level)
        for priority in ("batch", "interactive"):
            try:
                fids.append(r.submit(_prompts(6, (5,))[0],
                                     max_new_tokens=3, priority=priority))
                refusals.append(None)
            except mod.RequestRejected as e:
                refusals.append(e.reason)
    r.run_until_complete(300)
    while r.brownout_level:
        r.step()
    levels.append(r.brownout_level)
    # every replica refuses an unattainable TTFT: the rejection carries
    # each one's refusal
    try:
        r.submit(_prompts(7, (6,))[0], max_new_tokens=3,
                 ttft_deadline_s=1e-9)
        rejected = None
    except mod.RequestRejected as e:
        rejected = (e.reason, [(d["replica"], d["reason"])
                               for d in e.per_replica],
                    _reason_class(e.output.status_reason))
    return r, fids, (levels, refusals, rejected)


def test_brownout_and_per_replica_rejections_match_the_reference(fleet):
    got = both(fleet, _brownout)
    assert got["port"] == got["jax"]
    (per, verdict), (levels, refusals, rejected) = got["port"]
    assert verdict["ok"], verdict
    assert max(levels) >= 1 and levels[-1] == 0
    assert "brownout_shed_batch" in refusals
    assert rejected[0] == "slo_unattainable"
    assert sorted(i for i, _ in rejected[1]) == [0, 1]


# ----------------------------------------------------- the port alone

def test_port_seeded_streams_survive_a_hedge_and_kills(models):
    """Sampled requests through a fleet of three replicas give one
    engine's tokens: one request's hedge is promoted when its primary is
    killed, another request is re-attributed after a kill mid-decode,
    and each token reaches the client once."""
    m = models["port"]
    sampling = [port_serving.SamplingParams(do_sample=True, temperature=0.8,
                                            top_k=20, seed=s)
                for s in (3, 4, 5)]
    prompts = _prompts(8, (7, 9, 11))
    single = port_serving.ServingEngine(m, **ENGINE_KW)
    rids = [single.submit(p, max_new_tokens=8, sampling=s)
            for p, s in zip(prompts, sampling)]
    single.run_until_complete(300)
    want = [single.result(i).tokens for i in rids]

    ft = port_serving.FaultToleranceConfig(max_step_retries=1,
                                           backoff_base_s=0.0)
    r = port_serving.Router.build(lambda: m, replicas=3, fault_tolerance=ft,
                                  **ENGINE_KW)
    seen = {}
    fids = [r.submit(p, max_new_tokens=8, sampling=s, deadline_s=600.0,
                     stream=lambda req, tok, i=i: seen.setdefault(
                         i, []).append(tok))
            for i, (p, s) in enumerate(zip(prompts, sampling))]
    assert [r._requests[f].replica for f in fids] == [0, 1, 2]
    r.step()
    r.step()
    assert r.issue_hedge(r._requests[fids[0]])
    hedge_on = r._requests[fids[0]].hedge_replica
    r.step()
    r.kill(0)                  # the primary dies: the hedge survives
    r.step()
    r.kill(2)                  # mid-decode: re-attributed
    r.run_until_complete(300)
    for i, fid in enumerate(fids):
        out = r.result(fid)
        assert out.status == "finished", (i, out.status_reason)
        assert out.tokens == want[i], i
        assert seen[i] == want[i], i             # exactly once
    assert r._requests[fids[0]].replica == hedge_on
    acc = r.accounting()
    assert acc["ok"] and acc["killed_replicas"] == 2, acc
    assert acc["hedge_wins"] == 1


def test_tp_replicas_share_one_sharded_model(models):
    """At tensor-parallel degree 2 the factory may return one model: the
    first replica shards it, the second on the same mesh shares the
    bundle, and both serve the tp=1 engine's greedy tokens; a tp=1
    replica of that model raises, naming the cause."""
    prompts = _prompts(9, (6, 10))
    ref = port_serving.ServingEngine(models["port"], **ENGINE_KW)
    want = [o.tokens for o in ref.serve_batch(prompts, max_new_tokens=4)]
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.load_state_dict(models["port"].state_dict())
    r = port_serving.Router.build(lambda: m.eval(), replicas=2,
                                  tensor_parallel=2, devices=["cpu"] * 2,
                                  **ENGINE_KW)
    fids = [r.submit(p, max_new_tokens=4) for p in prompts]
    r.run_until_complete(300)
    assert sorted(r._requests[f].replica for f in fids) == [0, 1]
    assert [r.result(f).tokens for f in fids] == want
    assert r.accounting()["ok"]
    with pytest.raises(RuntimeError, match="tensor_parallel"):
        port_serving.ServingEngine(m, **ENGINE_KW)


def test_port_straggler_is_marked_and_cleared(models):
    """``replica_slow`` stretches replica 0's timed steps: the detector
    marks it slow against its peer, new work routes to the peer while the
    mark stands, and the mark clears once its steps are fast again.

    The stretch is sized from this host's own step times (4 warm-up fleet
    steps, both replicas serving): 10x the median fleet step of the last
    three (about 20x one replica's step), at least 0.2 s, so the victim's
    EWMA crosses the 3x bar however loaded the host is."""
    fi = port_serving.FaultInjector()
    r = port_serving.Router.build(lambda: models["port"], replicas=2,
                                  faults=fi, slow_hysteresis=2,
                                  **ENGINE_KW)
    fids = [r.submit(p, max_new_tokens=40) for p in _prompts(10, (5, 6))]
    took = []
    for _ in range(4):
        t0 = time.perf_counter()
        r.step()
        took.append(time.perf_counter() - t0)
    assert not r.replicas[0].engine.health.slow
    stretch = max(0.2, 10 * float(np.median(took[1:])))
    fi.enable("replica_slow", times=6, seconds=stretch)
    try:
        for _ in range(6):
            r.step()
    finally:
        fi.disable("replica_slow")
    assert r.replicas[0].engine.health.slow
    assert r.metrics_dict()["slow_replicas"] == 1
    fids.append(r.submit(_prompts(11, (7,))[0], max_new_tokens=4))
    assert r._requests[fids[-1]].replica == 1
    r.run_until_complete(300)
    assert not r.replicas[0].engine.health.slow
    assert [r.result(f).status for f in fids] == ["finished"] * 3
    assert r.accounting()["ok"]
