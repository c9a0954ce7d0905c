"""The port's disaggregated fleet (``serving/handoff.py``, the engine's
KV-handoff surface, ``serving/autoscaler.py``) against the JAX package's,
on the CPU.

Each package builds one ``prefill`` and one ``decode`` gpt_tiny replica
(f32, the weights carried by ``state_dict_from_jax``, ``num_slots=2``,
``block_len=8``, ``prefill_chunk=16``) once for the module; every test fronts them with its own
``Router`` (``prefill_threshold=16``, a router-level injector) and drives
the same traffic and arming on both sides.  Compared, request by request:
the owning replica, attempts, terminal status and reason class, the
greedy tokens exactly, the delivered mark, the stage and handoff count;
and the fleet verdict with the handoff ledger (staged, committed,
aborted, retries, blocks moved).  Scenarios: long prompts through the
prefill plane and the handoff, short ones direct; each handoff site
(``handoff_gather`` / ``handoff_scatter`` / ``handoff_commit``) armed
once (a retry to parity) and twice (an abort to a re-prefill); the
autoscaler's control loop (a failed spawn, a spawn, a drain-based
retire).  No handoff changes a replica's ``capture_counts``.

The port's handoff moves the blocks before the prefill's last chunk,
the reference's every full block (ROADMAP, design differences): at
chunk 16 and 40-token prompts both are the first 32 tokens.  In the port
alone: where the two differ, the autoscaler's spawned replica serving
traffic, and the handoff surface with the reference's names and
defaults.
"""

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

ENGINE_KW = dict(num_slots=2, min_bucket=8, block_len=8, prefill_chunk=16)
SIDES = {"jax": (jax_serving, JaxRegistry, JaxTracer),
         "port": (port_serving, MetricsRegistry, Tracer)}
LEDGER = ("handoffs_staged", "handoffs_committed", "handoffs_aborted",
          "handoff_blocks_moved")


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
    """Per side: a prefill and a decode replica sharing one model, on one
    registry and tracer."""
    out = {}
    for side, (mod, registry_cls, tracer_cls) in SIDES.items():
        registry, tracer = registry_cls(), tracer_cls()
        ft = mod.FaultToleranceConfig(max_step_retries=1,
                                      backoff_base_s=0.0)
        engines = [mod.ServingEngine(models[side], registry=registry,
                                     tracer=tracer, fault_tolerance=ft,
                                     role=role, **ENGINE_KW)
                   for role in ("prefill", "decode")]
        out[side] = dict(mod=mod, model=models[side], engines=engines,
                         registry=registry, tracer=tracer)
    return out


def _router(f, **kw):
    """A disaggregated router over the side's replicas (the straggler
    detector off: it reads wall-clock step times, which differ between
    the packages)."""
    return f["mod"].Router(f["engines"], prefill_threshold=16,
                           registry=f["registry"], tracer=f["tracer"],
                           slow_threshold=1e9, **kw)


def _prompts(seed, lengths, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lengths]


def _reason_class(reason):
    return None if reason is None else str(reason).split(":")[0]


def summary(router, fids):
    acc = router.accounting()
    rows = {r["fleet_id"]: r for r in acc["requests"]}
    per = []
    for fid in fids:
        out, row = router.result(fid), rows[fid]
        per.append((row["replica"], row["attempts"], out.status,
                    _reason_class(out.status_reason),
                    [int(t) for t in out.tokens], row["delivered"],
                    row["stage"], row["handoffs"]))
    mgr = router._handoffs
    return per, (acc["ok"], acc["handoffs_settled"],
                 *(acc[k] for k in LEDGER), mgr.retries)


def both(fleet, scenario):
    out = {}
    for side in SIDES:
        router, fids, extra = scenario(fleet[side])
        out[side] = (summary(router, fids), extra)
    return out


def _captures(f):
    return [dict(e.core.capture_counts) for e in f["engines"]
            if hasattr(e.core, "capture_counts")]


# ------------------------------------------------------------ scenarios

def _roles(f):
    r = _router(f)
    before = _captures(f)
    long_p, short_p = _prompts(1, (40,))[0], _prompts(2, (6,))[0]
    fids = [r.submit(long_p, max_new_tokens=5),
            r.submit(short_p, max_new_tokens=5)]
    stages = [(r._requests[i].replica, r._requests[i].role_stage)
              for i in fids]
    r.run_until_complete(300)
    hit = r.replicas[1].engine.metrics.prefix_hit_tokens
    assert _captures(f) == before
    return r, fids, (stages, hit)


def test_long_prompts_hand_off_and_short_ones_go_direct(fleet):
    got = both(fleet, _roles)
    assert got["port"] == got["jax"]
    (per, ledger), (stages, hit) = got["port"]
    assert stages == [(0, "prefill"), (1, "decode")]
    # 40 tokens at block_len 8: (40 - 1) // 8 = 4 blocks move, and the
    # decode replica's admission matches their 32 tokens
    assert ledger[:6] == (True, True, 1, 1, 0, 4)
    assert hit >= 32
    assert per[0][6:] == ("decode", 1) and per[0][5] == 5
    assert [p[2] for p in per] == ["finished", "finished"]


CASES = [(site, times) for site in ("handoff_gather", "handoff_scatter",
                                    "handoff_commit")
         for times in (1, 2)]


@pytest.mark.parametrize("site,times", CASES,
                         ids=[f"{s}-x{t}" for s, t in CASES])
def test_handoff_fault_outcome_matches_the_reference(fleet, site, times):
    """One fault retries the transfer to parity (a commit fault aborts:
    the blocks already landed, the request re-prefills over them); two
    abort it, and the request re-prefills on the decode side.  Either
    way the tokens are the faults-off ones and nothing leaks."""
    seed = 10 + CASES.index((site, times))

    def scenario(f):
        fi = f["mod"].FaultInjector()
        r = _router(f, faults=fi)
        before = _captures(f)
        fi.enable(site, times=times)
        try:
            fids = [r.submit(_prompts(seed, (40,))[0], max_new_tokens=5)]
            r.run_until_complete(300)
        finally:
            fi.disable(site)
        assert _captures(f) == before
        return r, fids, fi.fired[site]

    got = both(fleet, scenario)
    assert got["port"] == got["jax"]
    (per, ledger), fired = got["port"]
    ok, settled, staged, committed, aborted, _, retries = ledger
    # a commit fault aborts at once: the second arming is never reached
    assert ok and settled
    assert fired == (1 if site == "handoff_commit" else times)
    assert staged == committed + aborted == 1
    assert aborted == (1 if times == 2 or site == "handoff_commit" else 0)
    assert per[0][2] == "finished" and per[0][5] == 5
    for e in fleet["port"]["engines"]:
        assert port_serving.replica_accounting(e)["ok"]


def _autoscale(f):
    """The control loop on queued work alone (no step runs a request):
    a failed spawn, a spawn behind the gate, then the drain-based retire
    of the spawned replica once the queue is cancelled."""
    mod = f["mod"]
    fi = mod.FaultInjector()
    r = _router(f)
    spawn = lambda: mod.ServingEngine(  # noqa: E731
        f["model"], registry=f["registry"], tracer=f["tracer"],
        role="decode", **ENGINE_KW)
    scaler = mod.Autoscaler(r, spawn, scale_up_depth=2,
                            hysteresis_steps=2, cooldown_steps=1,
                            faults=fi)
    fids = [r.submit(p, max_new_tokens=4) for p in _prompts(20, (5,) * 4)]
    actions = []
    fi.enable("replica_spawn")
    try:
        actions += [scaler.tick() for _ in range(2)]
    finally:
        fi.disable("replica_spawn")
    actions += [scaler.tick() for _ in range(3)]
    for fid in fids:
        r.cancel(fid)
    actions += [scaler.tick() for _ in range(6)]
    snap = scaler.snapshot()
    roles = [(h.role, h.draining, h.retired) for h in r.replicas]
    return r, fids, (actions, snap, roles)


def test_autoscaler_control_loop_matches_the_reference(fleet):
    got = both(fleet, _autoscale)
    assert got["port"] == got["jax"]
    (per, _), (actions, snap, roles) = got["port"]
    assert "spawn" in actions and "retire" in actions
    assert any(a and a.startswith("retired:") for a in actions)
    assert snap["spawn_failures"] == 1 and snap["spawns"] == 1
    assert snap["retires"] == 1
    assert roles[2] == ("decode", True, True)
    assert [p[2] for p in per] == ["cancelled"] * 4


# ----------------------------------------------------- the port alone

def test_port_spawned_replica_serves_and_retires(models):
    """A spawned decode replica takes traffic with the same greedy
    tokens as one engine, and retires through drain once the fleet
    idles; the accounting holds on every replica."""
    m = models["port"]
    prompts = _prompts(30, (6, 7, 8, 9, 10, 11))
    ref = port_serving.ServingEngine(m, **ENGINE_KW)
    want = [o.tokens for o in ref.serve_batch(prompts, max_new_tokens=6)]
    r = port_serving.Router.build(lambda: m, replicas=1, **ENGINE_KW)
    spawn = lambda: port_serving.ServingEngine(  # noqa: E731
        m, registry=r.registry, tracer=r.tracer, role="decode",
        **ENGINE_KW)
    scaler = port_serving.Autoscaler(r, spawn, max_decode=2,
                                     scale_up_depth=2, hysteresis_steps=1,
                                     cooldown_steps=2)
    fids = [r.submit(p, max_new_tokens=6) for p in prompts[:4]]
    r.step()                                   # queue 2: spawn
    assert len(r.replicas) == 2
    fids += [r.submit(p, max_new_tokens=6) for p in prompts[4:]]
    assert {r._requests[f].replica for f in fids[4:]} == {1}
    r.run_until_complete(300)
    for _ in range(8):
        r.step()                               # idle: drain, retire
    assert r.replicas[1].retired
    assert [r.result(f).tokens for f in fids] == want
    acc = r.accounting()
    assert acc["ok"] and len(acc["replicas"]) == 2, acc


def test_port_handoff_surface_keeps_the_reference_names(models):
    """``role``, ``match(count_stats=)``, ``adopt(set_pos=)`` and
    ``RequestRejected(per_replica=)`` as the reference has them, and the
    handoff halves landing a prompt's blocks in another engine."""
    m = models["port"]
    for mod in (jax_serving, port_serving):
        with pytest.raises(ValueError, match="role must be"):
            mod.ServingEngine(models["jax" if mod is jax_serving
                                     else "port"], role="router",
                              **ENGINE_KW)
        e = mod.RequestRejected("queue_full", 0.5,
                                per_replica=[{"replica": 0}])
        assert e.per_replica == [{"replica": 0}]
    kw = dict(ENGINE_KW, prefill_chunk=8)
    src = port_serving.ServingEngine(m, role="prefill", **kw)
    dst = port_serving.ServingEngine(m, role="decode", **kw)
    assert (src.role, dst.role) == ("prefill", "decode")
    prompt = _prompts(40, (30,))[0]
    src.submit(prompt, max_new_tokens=1)
    src.run_until_complete(50)
    cache = src.core.prefix_cache
    stats = cache.stats()
    match = src.core.export_prompt_kv(prompt)
    assert match.tokens == 24 and cache.stats() == stats
    moved = dst.core.adopt_prompt_kv(prompt, src.core.export_gather(match),
                                     match.tokens)
    src.core.release_export(match)
    assert moved == 3 and dst.prefix_probe(prompt) == 24
    assert dst.core.pool.free_slots == dst.core.num_slots
    for a, b in zip(cache.pool.bks, dst.core.block_pool.bks):
        assert (a[match.blocks].numpy() == b[
            [n.block for n in dst.core.prefix_cache.match(
                prompt, count_stats=False)._nodes]].numpy()).all()
    pool = dst.core.pool
    rows = [(k[None], v[None]) for k, v in zip(*pool.slot_rows(0))]
    pool.seq_pos[1] = 7
    pool.adopt(1, rows, 3, set_pos=False)
    assert int(pool.seq_pos[1]) == 7
    pool.adopt(1, rows, 3)
    assert int(pool.seq_pos[1]) == 3


def test_port_handoff_moves_the_rows_before_the_last_chunk(models):
    """The export stops where the prefill's last chunk starts (from the
    source's own radix hit): the decode replica runs that chunk again at
    the same offset and width.  Chunked by 16, a 47-token prompt moves 32
    tokens where the reference moves every full block (40); unchunked,
    a fresh prompt moves nothing and one whose first 16 tokens the source
    had cached moves those.  The decode side's tokens are the source's."""
    m = models["port"]
    prompt = _prompts(50, (47,))[0]
    for chunk, hit, moved in ((16, 0, 32), (None, 0, 0), (None, 16, 16)):
        kw = dict(ENGINE_KW, prefill_chunk=chunk)
        src = port_serving.ServingEngine(m, **kw)
        if hit:
            src.serve_batch([prompt[:hit + 1]], max_new_tokens=1)
        rid = src.submit(prompt, max_new_tokens=4)
        src.run_until_complete(50)
        assert src.result(rid).prefix_hit_tokens == hit
        match = src.core.export_prompt_kv(prompt, hit)
        assert match.tokens == moved, (chunk, hit)
        dst = port_serving.ServingEngine(m, **kw)
        dst.core.adopt_prompt_kv(prompt, src.core.export_gather(match),
                                 match.tokens)
        src.core.release_export(match)
        out = dst.serve_batch([prompt], max_new_tokens=4)[0]
        assert out.prefix_hit_tokens == moved
        assert out.tokens == src.result(rid).tokens
