"""The AOT store of the PyTorch port (``paddle_tpu_torch/serving/aot``) on
the CPU, where a store holds the legs' descriptors and no library, and an
engine captures no graph: the store's contract and its degradations.

  * round trip: ``build_engine_store`` publishes one leg a committed
    width, the decode leg and, with ``spec_k``, the verify leg; an engine
    on ``AOTStore.open`` is ``"warm"`` with ``aot.loads`` one a leg and
    serves the tokens of an engine without a store; ``close`` ends reads;
  * ``aot_fingerprint`` equals the reference's on the same dict;
  * a skewed store degrades to ``"skew"`` and the engine serves; width
    drift under a matching fingerprint raises;
  * a crashed build publishes nothing; publish refuses an incomplete or
    unbounded plane;
  * a flipped byte in a leg's object, ``aot_load`` and
    ``aot_store_corrupt`` each degrade one leg (``"partial"``, one
    ``aot_fallback``) with equal tokens;
  * a JAX-package store is refused at open;
  * ``install`` checks its payload, writes once and makes ``build`` skip
    ``nvcc``; the command line builds, verifies and collects.

The card tests are ``tests/test_torch_aot_card.py``.
"""

import json
import os

import numpy as np
import pytest

import paddle_tpu.serving.aot as jax_aot
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import (AOTStore, AOTStoreError,
                                      FaultInjector, ServingEngine,
                                      aot_fingerprint, build_engine_store)
from paddle_tpu_torch.serving.aot import (PLANE, AOTStoreWriter,
                                          __main__ as cli)

KW = dict(num_slots=2, min_bucket=8, prefill_chunk=16, block_len=16,
          max_seq=64)


@pytest.fixture(scope="module")
def model():
    import torch
    gen = torch.Generator()
    gen.manual_seed(0)
    return GPTForCausalLM(gpt_tiny(), device="cpu", generator=gen).eval()


@pytest.fixture(scope="module")
def want(model):
    """Tokens of an engine without a store."""
    return _serve(ServingEngine(model, **KW, spec_k=2))


def _serve(eng):
    rs = np.random.RandomState(4)
    rids = [eng.submit(rs.randint(0, 256, (n,)), max_new_tokens=5)
            for n in (5, 20, 40)]
    eng.run_until_complete(200)
    return [eng.result(r).tokens for r in rids]


def _build_store(model, path, **kw):
    eng = ServingEngine(model, **{**KW, "spec_k": 2, **kw})
    return build_engine_store(str(path), eng.core)


def test_round_trip_and_close(model, want, tmp_path):
    index = _build_store(model, tmp_path)
    store = AOTStore.open(str(tmp_path))
    eng = ServingEngine(model, **KW, spec_k=2, aot_store=store)
    widths = sorted(eng.core._warm_buckets)
    legs = [f"prefill:w{w}" for w in widths] + ["decode:unfused",
                                                "verify:unfused"]
    assert sorted(index["programs"]) == sorted(legs)
    assert list(store.widths) == widths and index["libraries"] == {}
    assert eng.aot_status == "warm"
    assert eng.registry.get("aot.loads").value == len(legs)
    assert _serve(eng) == want
    desc, libs = store.read_leg("decode:unfused")
    assert desc["leg"] == "decode:unfused" and libs == {}
    store.close()
    with pytest.raises(AOTStoreError, match="closed"):
        store.read_leg("decode:unfused")


def test_fingerprint_equals_the_reference(model):
    ctx = port_serving.engine_aot_context(
        ServingEngine(model, **KW).core)
    assert aot_fingerprint(ctx) == jax_aot.aot_fingerprint(ctx)
    assert {"torch", "cuda", "device", "libraries"} <= set(ctx)
    assert ctx["device"] == "cpu" and "jax" not in ctx
    assert ctx["libraries"] == {n: _build.library_key(n)
                                for n in ctx["libraries"]}


def test_skew_degrades_and_the_engine_serves(model, tmp_path):
    _build_store(model, tmp_path)
    store = AOTStore.open(str(tmp_path))
    eng = ServingEngine(model, **{**KW, "num_slots": 3}, spec_k=2,
                        aot_store=store)
    assert eng.aot_status == "skew"
    assert eng.registry.get("aot.misses").value == 1
    assert [e[3]["program"] for e in eng.tracer.events("aot_miss")] == \
        ["store"]
    assert _serve(eng) == _serve(ServingEngine(
        model, **{**KW, "num_slots": 3}, spec_k=2))


def test_width_drift_is_loud(model, tmp_path):
    _build_store(model, tmp_path)
    path = tmp_path / "index.json"
    index = json.loads(path.read_text())
    index["widths"] = index["widths"][:-1]
    path.write_text(json.dumps(index))
    with pytest.raises(AOTStoreError, match="width drift"):
        ServingEngine(model, **KW, spec_k=2,
                      aot_store=AOTStore.open(str(tmp_path)))


def test_crashed_build_publishes_nothing(model, tmp_path, monkeypatch):
    calls = []
    add = AOTStoreWriter.add

    def crash(self, name, **kw):
        calls.append(name)
        if len(calls) == 3:
            raise RuntimeError("build died")
        return add(self, name, **kw)

    monkeypatch.setattr(AOTStoreWriter, "add", crash)
    with pytest.raises(RuntimeError, match="build died"):
        _build_store(model, tmp_path)
    assert not (tmp_path / "index.json").exists()
    assert os.listdir(tmp_path / "objects") == []
    with pytest.raises(AOTStoreError, match="no published"):
        AOTStore.open(str(tmp_path))


@pytest.mark.parametrize("fault", ["incomplete", "unbounded"])
def test_publish_refuses_incomplete_or_unbounded_plane(tmp_path, fault):
    plane = json.loads(json.dumps(PLANE))
    if fault == "unbounded":
        plane["prefill"]["key_space"] = "unbounded"
    w = AOTStoreWriter(str(tmp_path), context={"spec_k": 2}, plane=plane,
                       widths=(8, 16))
    w.add("prefill:w8")
    w.add("decode:unfused")
    if fault == "unbounded":
        w.add("prefill:w16")
        w.add("verify:unfused")
    with pytest.raises(AOTStoreError,
                       match="UNBOUNDED" if fault == "unbounded"
                       else r"prefill:w16.*verify"):
        w.publish()
    w.discard()
    assert not (tmp_path / "index.json").exists()


@pytest.mark.parametrize("fault", ["flipped_byte", "aot_load",
                                   "aot_store_corrupt"])
def test_a_bad_leg_degrades_alone(model, want, tmp_path, fault):
    index = _build_store(model, tmp_path)
    # legs attach widest first: an armed fault at hit 1 takes the second
    second = f"prefill:w{sorted(index['widths'])[-2]}"
    faults = FaultInjector()
    if fault == "flipped_byte":
        obj = index["programs"][second]["object"]
        path = tmp_path / "objects" / f"{obj}.aot"
        raw = bytearray(path.read_bytes())
        raw[-3] ^= 0x20
        path.write_bytes(bytes(raw))
        store = AOTStore.open(str(tmp_path))
    elif fault == "aot_load":
        store = AOTStore.open(str(tmp_path))
        faults.enable("aot_load", at=1)
    else:
        store = AOTStore.open(str(tmp_path), faults=faults)
        faults.enable("aot_store_corrupt", at=1)
    eng = ServingEngine(model, **KW, spec_k=2, aot_store=store,
                        faults=faults if fault == "aot_load" else None)
    faults.disable_all()
    legs = len(index["programs"])
    assert eng.aot_status == "partial"
    assert eng.registry.get("aot.loads").value == legs - 1
    assert eng.registry.get("aot.fallbacks").value == 1
    (event,) = eng.tracer.events("aot_fallback")
    assert event[3]["program"] == second
    assert _serve(eng) == want


def test_a_jax_package_store_is_refused(tmp_path):
    class Exported:
        def serialize(self):
            return b"an exported jax program"

    w = jax_aot.AOTStore.create(str(tmp_path), context={"spec_k": 0},
                                plane={}, widths=(8,))
    w.add("prefill:w8", Exported())
    w.publish()
    assert jax_aot.AOTStore.open(str(tmp_path)).has("prefill:w8")
    with pytest.raises(AOTStoreError, match="JAX package"):
        AOTStore.open(str(tmp_path))


def test_install_checks_writes_once_and_build_skips_nvcc(tmp_path,
                                                         monkeypatch):
    import zlib

    def no_nvcc():
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    payload = b"\x7fELF a built library"
    with pytest.raises(ValueError, match="crc32"):
        _build.install("fused_norm", payload, zlib.crc32(payload) ^ 1)
    assert list(tmp_path.iterdir()) == []
    assert _build.install("fused_norm", payload, zlib.crc32(payload))
    assert not _build.install("fused_norm", b"other", zlib.crc32(b"other"))
    path = tmp_path / f"libfused_norm-{_build.library_key('fused_norm')}.so"
    assert path.read_bytes() == payload
    assert _build.build(["fused_norm"]) == {}


def test_cli_round_trip(tmp_path, capsys):
    store = str(tmp_path / "store")
    assert cli.main(["build", store, "--device", "cpu", "--spec-k", "2"]) \
        == 0
    assert cli.main(["verify", store]) == 0
    assert "verify OK: 7 legs" in capsys.readouterr().out
    stray = tmp_path / "store" / "objects" / ("0" * 64 + ".aot")
    stray.write_bytes(b"left by a crashed build")
    assert cli.main(["gc", store]) == 0
    assert not stray.exists()
    assert cli.main(["verify", store]) == 0
    obj = sorted((tmp_path / "store" / "objects").iterdir())[0]
    obj.write_bytes(obj.read_bytes()[:-1])
    assert cli.main(["verify", store]) == 1
    assert "corrupt" in capsys.readouterr().out
    assert cli.main(["verify", str(tmp_path / "none")]) == 1


def test_the_package_exports_and_fault_sites():
    for name in ("Journal", "JournalError", "AOTStore", "AOTStoreWriter",
                 "AOTStoreError", "build_engine_store",
                 "engine_aot_context", "aot_fingerprint"):
        assert name in port_serving.__all__
        assert getattr(port_serving, name) is not None
    new = ("journal_write", "journal_fsync", "journal_replay", "aot_load",
           "aot_store_corrupt")
    for site in new:
        FaultInjector().enable(site)
    # the fleet's seven sites joined with the router: all 21 are known
    fleet = ("handoff_gather", "handoff_scatter", "handoff_commit",
             "replica_spawn", "replica_crash", "replica_slow",
             "hedge_submit")
    for site in fleet:
        FaultInjector().enable(site)
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector().enable("bogus")
    assert len(port_serving.POINTS) == 21
