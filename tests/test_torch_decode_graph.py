"""The decode step's compiled-program plane in the PyTorch port
(``EngineCore``: one CUDA graph per engine on a card) against the JAX
package's engine, on the CPU.

A graph replays fixed device addresses, so on every decode path the
buffers the decode body reads and writes — the KV slabs, ``seq_pos``, the
last-token vector and the logits buffer — must keep their ``data_ptr()``
across steps and across a slot's release and re-admission.  CPU engines
run the same body eagerly every step (``decode_graph_reason == "cpu"``,
no capture) and must still serve the JAX engine's greedy tokens on the
same carried weights.  The card's side is
``tests/test_torch_decode_graph_card.py``.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.distributed.mesh import Mesh
from paddle_tpu_torch.kernels import decode_attention as da
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import EngineCore
from paddle_tpu_torch.serving.tp import (build_serving_mesh,
                                         build_tp_decode_program,
                                         shard_model_params, sharded_zeros)

SLOTS = 4
ENGINE_KW = dict(num_slots=SLOTS, min_bucket=8, block_len=16)
# 6 requests over 4 slots: two slots are released and re-admitted
LENGTHS = (5, 11, 3, 17, 9, 6)
NEW = (3, 6, 2, 5, 4, 3)
PATHS = {
    "unfused": dict(),
    "fused": dict(fused_decode=True),
    "tp_fused_block": dict(fused_decode=True, tensor_parallel=2,
                           devices=["cpu", "cpu"]),
}
ZERO = {"prefill": 0, "decode": 0, "verify": 0}


@pytest.fixture(scope="module")
def jax_model():
    paddle_tpu.seed(0)
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    return m


@pytest.fixture(scope="module")
def arrays(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state_dict().items()}


def _port(arrays):
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    m.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return m.eval()


def _prompts():
    rs = np.random.RandomState(21)
    return [rs.randint(0, 256, (n,)) for n in LENGTHS]


def _submit_all(eng):
    return [eng.submit(p, max_new_tokens=n) for p, n in
            zip(_prompts(), NEW)]


def _addresses(core):
    """Every buffer the decode body touches, by name -> data_ptr()."""
    pool = core.pool

    def ptrs(slab):
        return [t.data_ptr() for t in (slab if isinstance(slab, list)
                                       else [slab])]
    out = {"seq_pos": pool.seq_pos.data_ptr(),
           "last_tok": core._last_tok.data_ptr(),
           "logits": core._logits.data_ptr()}
    for i, (k, v) in enumerate(zip(pool.ks, pool.vs)):
        out[f"k{i}"], out[f"v{i}"] = ptrs(k), ptrs(v)
    return out


@pytest.fixture(scope="module")
def want(jax_model):
    eng = JaxEngine(jax_model, **ENGINE_KW)
    rids = _submit_all(eng)
    eng.run_until_complete(200)
    return [list(eng.purge(r).tokens) for r in rids]


@pytest.fixture(scope="module")
def served(arrays):
    """Each path served once, step by step: the buffer addresses before
    the first step and after every step, the tokens, the engine."""
    out = {}
    for path, kw in PATHS.items():
        eng = ServingEngine(_port(arrays), **ENGINE_KW, **kw)
        assert eng.decode_path == path
        rids = _submit_all(eng)
        history = [_addresses(eng.core)]
        while eng.step():
            history.append(_addresses(eng.core))
        history.append(_addresses(eng.core))
        out[path] = (eng, history, [list(eng.result(r).tokens)
                                    for r in rids])
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_decode_buffers_keep_their_addresses(served, path):
    eng, history, _ = served[path]
    core = eng.core
    # a slot was released and re-admitted during the run
    assert core.pool.alloc_count == len(LENGTHS) > SLOTS
    assert core.eager_decode_steps == \
        eng.registry.get("serving.phase.decode_dispatch_s").count > 0
    for seen in history[1:]:
        assert seen == history[0]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_greedy_tokens_equal_the_reference_engine(served, want, path):
    _, _, tokens = served[path]
    assert tokens == want
    assert [len(t) for t in tokens] == list(NEW)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cpu_engine_captures_nothing_and_says_why(served, path):
    eng, _, _ = served[path]
    assert eng.decode_graph_reason == "cpu"
    assert eng.core.capture_counts == ZERO
    assert eng.registry.get("serving.compiles").value == 0
    assert eng.tracer.events("compile") == []
    assert eng.core._decode_graph is None


def test_capture_counts_land_as_compile_events(arrays):
    """The reference's _record_events: a capture-counter delta becomes one
    ``compile`` event (program, count, step) and ``serving.compiles``."""
    eng = ServingEngine(_port(arrays), **ENGINE_KW)
    eng.core.capture_counts["decode"] += 1       # as a capture would
    eng.step()
    eng.step()
    evs = eng.tracer.events("compile")
    assert len(evs) == 1
    attrs = evs[0][3]
    assert (attrs["program"], attrs["count"], attrs["step"],
            attrs["seconds"]) == ("decode", 1, 0, 0.0)
    assert eng.registry.get("serving.compiles").value == 1


def test_mesh_over_several_cards_is_not_captured():
    """One graph captures one device's streams: a mesh over two cards
    names that, a mesh of shards on one card is captured."""
    def reason(devices, device):
        core = types.SimpleNamespace(
            mesh=None if devices is None else Mesh(devices), device=device)
        return EngineCore._resolve_decode_graph(core)
    assert reason(None, torch.device("cpu")) == "cpu"
    assert reason(["cpu", "cpu"], torch.device("cpu")) == "cpu"
    assert reason(None, torch.device("cuda:0")) is None
    assert reason(["cuda:0", "cuda:0"], torch.device("cuda:0")) is None
    why = reason(["cuda:0", "cuda:1"], torch.device("cuda:0"))
    assert "2 CUDA devices" in why and "one CUDA graph" in why


@pytest.mark.parametrize("pallas_block", [False, True])
def test_tp_decode_program_advances_seq_pos_in_place(arrays, pallas_block):
    """The ring decode program writes ``seq_pos + 1`` into the tensor it
    was given and returns that same tensor."""
    model = _port(arrays)
    cfg = model.cfg
    bundle = shard_model_params(model, build_serving_mesh(2, ["cpu", "cpu"]))
    prog = build_tp_decode_program(bundle, pallas_block=pallas_block,
                                   batch=SLOTS, max_seq=cfg.max_seq_len)
    shape = (SLOTS, cfg.max_seq_len, cfg.num_heads, cfg.head_dim)
    ks = [sharded_zeros(bundle["mesh"], shape, torch.float32)
          for _ in range(cfg.num_layers)]
    vs = [sharded_zeros(bundle["mesh"], shape, torch.float32)
          for _ in range(cfg.num_layers)]
    seq_pos = torch.tensor([0, 3, 7, 1], dtype=torch.int32)
    ptr = seq_pos.data_ptr()
    logits, ks2, vs2, pos2 = prog(ks, vs, seq_pos,
                                  torch.tensor([1, 2, 3, 4],
                                               dtype=torch.int32))
    assert pos2 is seq_pos and seq_pos.data_ptr() == ptr
    assert seq_pos.tolist() == [1, 4, 8, 2]
    assert ks2 is ks and vs2 is vs
    assert tuple(logits.shape) == (SLOTS, 1, cfg.vocab_size)


def test_decode_attention_workspace_keeps_what_it_replaces():
    """A larger call grows the split kernel's workspace; the pair it
    replaces stays alive (a captured graph may point at it) and the new
    counters start at zero."""
    dev, stream = torch.device("cpu"), -12345
    key = (dev.index, stream)
    retired = len(da._RETIRED)
    try:
        p1, c1 = da._workspace(dev, stream, 64, 8)
        again = da._workspace(dev, stream, 32, 4)
        assert again[0] is p1 and again[1] is c1
        c1.fill_(7)                              # as a graph's state
        p2, c2 = da._workspace(dev, stream, 256, 16)
        assert p2.numel() == 256 and c2.numel() == 16
        assert c2.eq(0).all()
        assert len(da._RETIRED) == retired + 1
        assert da._RETIRED[-1][0] is p1 and da._RETIRED[-1][1] is c1
        assert c1.eq(7).all()                    # still allocated, intact
        # growing one of the two keeps the other's size
        p3, c3 = da._workspace(dev, stream, 16, 32)
        assert p3.numel() == 256 and c3.numel() == 32
        assert da._RETIRED[-1][0] is p2
    finally:
        da._workspaces.pop(key, None)
        del da._RETIRED[retired:]
