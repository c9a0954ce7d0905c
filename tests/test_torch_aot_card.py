"""The AOT store on the card: what a CPU engine cannot show, since it
captures no CUDA graph and loads no kernel library.

  * a warm engine (``aot_store=``) captures every leg at attach, so its
    ``capture_counts`` stay zero while it serves, and its tokens equal a
    cold engine's (greedy and seeded) at tp=1 unfused, fused and
    ``spec_k``, and at tp=2 ``tp_fused_block`` (both shards on the card);
  * a quarantine's rebuild attaches the store again: still no capture,
    and the queued requests equal a fault-free run's;
  * ``install`` then ``load`` of the store's libraries into an empty
    build directory runs no ``nvcc``;
  * an engine on the card that captures no graph (as a mesh over several
    cards does) still stores every leg's libraries at build.

Skips without a card; the CPU tests are ``tests/test_torch_aot.py`` and
``tests/test_torch_journal.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                     gpt_tiny, llama_tiny)
from paddle_tpu_torch.serving import (AOTStore, FaultInjector,
                                      FaultToleranceConfig, SamplingParams,
                                      ServingEngine, build_engine_store)
from paddle_tpu_torch.serving.engine import EngineCore

KW = dict(num_slots=2, min_bucket=8, prefill_chunk=16, block_len=8)
NEW = 6
ZERO = {"prefill": 0, "decode": 0, "verify": 0}
PATHS = {"unfused": ("gpt", {}),
         "fused": ("llama", dict(fused_decode=True)),
         "spec": ("gpt", dict(spec_k=4)),
         "tp_fused_block": ("gpt", dict(tensor_parallel=2,
                                        fused_decode=True))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _model(family):
    torch.manual_seed(0)
    cls, cfg = (GPTForCausalLM, gpt_tiny()) if family == "gpt" \
        else (LlamaForCausalLM, llama_tiny())
    return cls(cfg, device="cuda").eval()


def _engine(model, **kw):
    if kw.get("tensor_parallel", 1) > 1:
        kw["devices"] = ["cuda:0"] * kw["tensor_parallel"]
    return ServingEngine(model, **KW, **kw)


def _serve(eng, seed=3, n=5):
    """Greedy and seeded requests of 5-40 tokens to the end."""
    rs = np.random.RandomState(seed)
    rids = [eng.submit(rs.randint(0, 256, (int(rs.randint(5, 40)),)),
                       max_new_tokens=NEW,
                       sampling=SamplingParams(do_sample=i % 2 == 1,
                                               temperature=0.8, top_k=20,
                                               seed=i))
            for i in range(n)]
    eng.run_until_complete(300)
    return [eng.result(r).tokens for r in rids]


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_warm_engine_captures_nothing_while_serving(path, tmp_path):
    _card()
    family, kw = PATHS[path]
    model = _model(family)
    cold = _engine(model, **kw)
    want = _serve(cold)
    assert cold.core.capture_counts["decode"] == 1
    cold.close()
    build_eng = _engine(model, **kw)
    index = build_engine_store(str(tmp_path), build_eng.core)
    build_eng.close()
    assert index["libraries"], "the captures launched no library"
    store = AOTStore.open(str(tmp_path))
    try:
        eng = _engine(model, **kw, aot_store=store)
        legs = len(eng.core._warm_buckets) + 1 + (path == "spec")
        assert eng.aot_status == "warm"
        assert eng.registry.get("aot.loads").value == legs
        assert _serve(eng) == want
        assert eng.core.capture_counts == ZERO
        assert eng.core.eager_decode_steps == 0
        assert eng.registry.get("serving.compiles").value == 0
        eng.close()
    finally:
        store.close()


@pytest.mark.cuda
def test_quarantine_attaches_the_store_again(tmp_path):
    _card()
    model = _model("gpt")
    clean = _engine(model)
    want = _serve(clean)
    clean.close()
    build_eng = _engine(model)
    build_engine_store(str(tmp_path), build_eng.core)
    build_eng.close()
    store = AOTStore.open(str(tmp_path))
    try:
        faults = FaultInjector()
        eng = _engine(model, aot_store=store, faults=faults,
                      fault_tolerance=FaultToleranceConfig(
                          max_step_retries=2, backoff_base_s=0.0))
        loads = eng.registry.get("aot.loads").value
        rs = np.random.RandomState(9)
        inflight = [eng.submit(rs.randint(0, 256, (6,)), max_new_tokens=NEW)
                    for _ in range(2)]
        faults.enable("step", at=1, times=3)
        try:
            got = _serve(eng)
        finally:
            faults.disable("step")
        assert eng.metrics_dict()["quarantines"] == 1
        assert all(eng.result(r).status == "failed" for r in inflight)
        assert got == want
        assert eng.aot_status == "warm"
        assert eng.registry.get("aot.loads").value == 2 * loads
        assert eng.core.capture_counts == ZERO
        eng.close()
    finally:
        store.close()


@pytest.mark.cuda
def test_install_then_load_runs_no_nvcc(tmp_path, monkeypatch):
    _card()
    model = _model("gpt")
    build_eng = _engine(model)
    build_engine_store(str(tmp_path / "store"), build_eng.core)
    build_eng.close()
    store = AOTStore.open(str(tmp_path / "store"))
    libs = store.libraries()
    assert libs
    payloads = {}
    for leg in store.programs():
        payloads.update(store.read_leg(leg)[1])
    store.close()

    def no_nvcc():
        raise AssertionError("nvcc was called")

    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    for lib, (payload, crc) in payloads.items():
        assert _build.install(lib, payload, crc)
        assert not _build.install(lib, payload, crc)   # already there
        assert _build.load(lib) is not None
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        sorted(f"lib{lib}-{_build.library_key(lib)}.so" for lib in libs)


@pytest.mark.cuda
def test_a_card_engine_without_graphs_stores_its_libraries(tmp_path,
                                                           monkeypatch):
    """One card stands in for a mesh over several: the engine is told it
    spans two cards, so it captures no graph and runs every leg eagerly.
    The build still runs each leg once and stores what it launched, so
    ``"warm"`` on attach means every leg's libraries are installed."""
    _card()
    monkeypatch.setattr(
        EngineCore, "_resolve_decode_graph",
        lambda self: "the tensor-parallel mesh spans 2 CUDA devices")
    kw = PATHS["tp_fused_block"][1]
    model = _model("gpt")
    cold = _engine(model, **kw)
    want = _serve(cold)
    cold.close()
    build_eng = _engine(model, **kw)
    index = build_engine_store(str(tmp_path), build_eng.core)
    build_eng.close()
    assert index["libraries"]
    assert all(entry["libraries"] for entry in index["programs"].values())
    store = AOTStore.open(str(tmp_path))
    try:
        eng = _engine(model, **kw, aot_store=store)
        assert eng.core.decode_graph_reason is not None
        assert eng.aot_status == "warm"
        assert eng.registry.get("aot.loads").value == len(index["programs"])
        assert _serve(eng) == want
        assert eng.core.capture_counts == ZERO
        eng.close()
    finally:
        store.close()
