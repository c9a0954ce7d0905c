"""The port's fault-tolerance host classes (``serving/faults.py``,
``serving/health.py``) against the JAX package's, on the CPU: the same
call sequences give the same hits, fired counts, errors, backoffs, states,
state codes and breaker decisions.  The engine scenarios are
``tests/test_torch_chaos_serving.py``.
"""

import pytest

import paddle_tpu.serving.faults as jax_faults
import paddle_tpu.serving.health as jax_health
import paddle_tpu_torch.serving.faults as port_faults
import paddle_tpu_torch.serving.health as port_health
from paddle_tpu_torch.serving import ServingMetrics

SIDES = {"jax": (jax_faults, jax_health), "port": (port_faults, port_health)}


def _arming_trace(mod):
    """One fixed enable / check / fire / disable sequence; returns every
    observable outcome."""
    fi = mod.FaultInjector()
    out = []
    fi.enable("step", at=1, times=2)
    out += [fi.check("step") is not None for _ in range(4)]
    fi.enable("kv_alloc", at=0, times=1)
    try:
        fi.fire("kv_alloc")
    except mod.FaultError as e:
        out.append(("raised", e.site, e.hit, str(e)))
    out.append(fi.fire("kv_alloc"))                    # window spent
    fi.enable("slow_step", seconds=0.25)
    armed = fi.check("slow_step")
    out.append(armed.seconds)
    fi.enable("gather", at=2, times=3)
    out += [fi.check("gather") is not None for _ in range(6)]
    out.append(fi.active)
    fi.disable("gather")
    fi.disable("gather")                               # idempotent
    out.append(fi.active)
    fi.disable_all()
    out.append(fi.active)
    # re-arming counts from the site's current hit count
    fi.enable("step", at=0, times=1)
    out.append(fi.check("step") is not None)
    sites = port_faults.POINTS
    out.append({s: fi.hits[s] for s in sites})
    out.append({s: fi.fired[s] for s in sites})
    return out


def test_injector_arming_matches_the_reference():
    assert _arming_trace(port_faults) == _arming_trace(jax_faults)


@pytest.mark.parametrize("kw", [dict(times=0), dict(at=-1)])
def test_injector_rejects_bad_arming(kw):
    for mod in (jax_faults, port_faults):
        with pytest.raises(ValueError):
            mod.FaultInjector().enable("step", **kw)


def test_injector_knows_only_the_ported_sites():
    """The port knows every one of the reference's 21 sites, in its
    order (the fleet's seven joined with the router); arming an unknown
    site raises and names the known ones."""
    assert port_faults.POINTS == jax_faults.POINTS
    assert len(port_faults.POINTS) == 21
    for site in port_faults.POINTS:
        port_faults.FaultInjector().enable(site)
    with pytest.raises(ValueError, match="unknown fault site") as ei:
        port_faults.FaultInjector().enable("bogus")
    assert "hedge_submit" in str(ei.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(max_step_retries=0), dict(backoff_base_s=-1.0),
    dict(backoff_cap_s=-0.5), dict(ladder_threshold=0),
    dict(circuit_quarantine_limit=0), dict(max_queue=0),
    dict(max_queue=4, max_step_retries=1, circuit_window_steps=7)])
def test_config_validation_matches_the_reference(kw):
    outcome = {}
    for side, (_, health) in SIDES.items():
        try:
            cfg = health.FaultToleranceConfig(**kw)
            outcome[side] = ("ok", tuple(sorted(vars(cfg).items())))
        except ValueError as e:
            outcome[side] = ("ValueError", str(e))
    assert outcome["port"] == outcome["jax"]


def _ladder_trace(health, threshold):
    ladder = health.DegradationLadder(threshold)
    out = []
    for sub in ("prefix_cache", "fused_decode", "prefix_cache",
                "spec_verify", "prefix_cache", "chunked_prefill",
                "fused_decode", "spec_verify"):
        out.append((ladder.record_fault(sub), ladder.disabled(sub),
                    ladder.level, ladder.disabled_subsystems))
    with pytest.raises(ValueError):
        ladder.record_fault("nope")
    return out


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_ladder_sequence_matches_the_reference(threshold):
    assert port_health.SUBSYSTEMS == jax_health.SUBSYSTEMS
    assert _ladder_trace(port_health, threshold) == \
        _ladder_trace(jax_health, threshold)


def _health_trace(health, **kw):
    h = health.EngineHealth(health.FaultToleranceConfig(**kw))
    out = [(h.state, h.state_code, h.routable)]
    for _ in range(kw.get("max_step_retries", 3) + 1):
        out.append((h.record_step_fault("x"), h.state, h.state_code))
    q = h.enter_quarantine("spent")
    out.append((h.state, h.state_code, h.routable, h.circuit_open))
    h.leave_quarantine(q)
    out.append((h.state, h.consecutive_faults))
    h.degraded = True
    out.append((h.state, h.state_code, h.routable))
    h.degraded = False
    for gap in (1, 3, 40, 2, 2):
        for _ in range(gap):
            h.on_step_ok()
        q = h.enter_quarantine("again")
        h.leave_quarantine(q)
        out.append((h.state, h.circuit_open, h.quarantine_count,
                    h.step_index))
    h.mark_slow("outlier")
    out.append((h.slow, h.slow_reason, h.routable))
    h.clear_slow()
    out.append((h.slow, h.slow_reason))
    h.mark_dead("killed")
    out.append((h.state, h.state_code, h.routable, h.last_fault))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_step_retries=1, backoff_base_s=0.3, backoff_cap_s=0.5),
    dict(max_step_retries=4, backoff_base_s=0.01,
         circuit_quarantine_limit=2, circuit_window_steps=10),
    dict(circuit_quarantine_limit=3, circuit_window_steps=5)])
def test_health_sequence_matches_the_reference(kw):
    """Backoffs, states, state codes, ``routable`` and the breaker's
    window over the same sequence of faults, quarantines and steps."""
    assert port_health.STATE_CODES == jax_health.STATE_CODES
    assert _health_trace(port_health, **kw) == _health_trace(jax_health,
                                                             **kw)


def test_metrics_keys_and_reset():
    """The four watchdog keys are in the snapshot, the hooks move them,
    and ``reset()`` zeroes them (a fault-tolerant engine publishes its
    health state again at the end of every step)."""
    m = ServingMetrics()
    for key in ("step_retries", "quarantines", "health_state",
                "degradation_level"):
        assert m.snapshot()[key] == 0
    m.tracer.enable()
    m.on_retry(1, 0.02, step=3)
    m.on_quarantine("enter", "r", step=4)
    m.on_quarantine("leave", "r", step=4, seconds=0.5)
    m.on_degrade("prefix_cache", 1, "r")
    m.on_health_state("degraded", 1, step=4)
    m.on_health_state("degraded", 1, step=5)     # no new event
    snap = m.snapshot()
    assert (snap["step_retries"], snap["quarantines"], snap["health_state"],
            snap["degradation_level"]) == (1, 1, 1.0, 1.0)
    names = [e[0] for e in m.tracer.events()]
    assert names.count("health_state") == 1
    assert {"step_retry", "quarantine_enter", "quarantine_leave",
            "degrade"} <= set(names)
    m.reset()
    assert m.snapshot()["health_state"] == 0
    assert m.registry.get("serving.quarantines").value == 0
