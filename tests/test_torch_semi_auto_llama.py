"""The port's semi-auto Llama training (``llama_shard_fn`` + ``shard_layer``
+ the auto-parallel ``Engine``) against the JAX package's on the CPU.

llama_tiny in f32 (2 layers, 4 heads over 2 kv heads).  The JAX Engine
runs as ``tests/test_llama.py:120-148`` runs it (the conftest's 8 virtual
devices, GSPMD over ``dp 4 x mp 2``); its weights are carried into the
port's model by ``state_dict_from_jax``, and the port's ranks all sit on
the CPU.  Tolerances:

* port vs JAX, ``dp 4 x mp 2``, 2 epochs of 4 batches under ``SGD(0.1)``:
  rtol 1e-5, atol 1e-6 (f32 on both sides; the sums run in another
  order);
* port sharded vs port serial: the reference oracle's rtol 2e-4 / atol
  2e-5 (``tests/test_llama.py:148``);
* the example's defaults (``dp 2 x mp 4``: 2 kv heads over 4 ranks, the
  K / V heads gathered) against the JAX Engine on the same mesh, 2 epochs:
  rtol 1e-5, atol 1e-6 as above; against the port's serial run: the
  oracle's bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.models.llama import llama_shard_fn as jax_llama_shard_fn
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.examples import train_llama_semi_auto as example
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.models.convert import state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaDecoderLayer, llama_shard_fn
from paddle_tpu_torch.optimizer import SGD


def _batches():
    """tests/test_llama.py:122-126."""
    rs = np.random.RandomState(7)
    out = []
    for _ in range(4):
        ids = rs.randint(0, 256, (8, 13)).astype(np.int32)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _jax_xent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


def _mesh(dp, mp):
    return dist.ProcessMesh(np.arange(dp * mp).reshape(dp, mp),
                            dim_names=["dp", "mp"],
                            devices=["cpu"] * (dp * mp))


def _jax_fit(dp, mp):
    """The reference oracle's sharded run on a ``dp x mp`` mesh, and its
    starting weights."""
    paddle_tpu.seed(5)
    model = JaxLlama(jax_llama_tiny())
    arrays = {k: np.array(v) for k, v in model.state_dict().items()}
    mesh = jdist.ProcessMesh(np.arange(dp * mp).reshape(dp, mp),
                             dim_names=["dp", "mp"])
    jdist.shard_layer(model, mesh, jax_llama_shard_fn(mesh))
    eng = jdist.Engine(model, loss=_jax_xent,
                       optimizer=jopt.SGD(learning_rate=0.1),
                       process_mesh=mesh)
    return arrays, eng.fit(_batches(), epochs=2)


@pytest.fixture(scope="module")
def jax_run():
    """The starting weights and the JAX Engine's losses on ``dp 4 x mp 2``
    (the oracle's mesh) and ``dp 2 x mp 4`` (the example's)."""
    arrays, dp4_mp2 = _jax_fit(4, 2)
    _, dp2_mp4 = _jax_fit(2, 4)
    return arrays, dp4_mp2, dp2_mp4


def _port(arrays, mesh=None):
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    m.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    if mesh is not None:
        dist.shard_layer(m, mesh, llama_shard_fn(mesh))
    return m, dist.Engine(m, loss=example.loss_fn,
                          optimizer=SGD(learning_rate=0.1),
                          process_mesh=mesh)


@pytest.fixture(scope="module")
def port_runs(jax_run):
    arrays = jax_run[0]
    out = {}
    _, e = _port(arrays)
    out["serial"] = e.fit(_batches(), epochs=2)
    before = LlamaDecoderLayer.partial_calls
    _, e = _port(arrays, _mesh(4, 2))
    out["dp4_mp2"] = e.fit(_batches(), epochs=2)
    out["partial_calls"] = LlamaDecoderLayer.partial_calls - before
    _, e = _port(arrays, _mesh(2, 4))
    out["dp2_mp4"] = e.fit(_batches(), epochs=2)
    return out


def test_port_engine_matches_jax_engine(jax_run, port_runs):
    np.testing.assert_allclose(port_runs["dp4_mp2"], jax_run[1],
                               rtol=1e-5, atol=1e-6)


def test_port_sharded_equals_port_serial(port_runs):
    np.testing.assert_allclose(port_runs["dp4_mp2"], port_runs["serial"],
                               rtol=2e-4, atol=2e-5)
    assert port_runs["serial"][-1] < port_runs["serial"][0]


def test_per_rank_body_runs_every_rank(port_runs):
    """8 steps x 2 layers x 2 halves x (dp 4 x mp 2) ranks."""
    assert port_runs["partial_calls"] == 8 * 2 * 2 * 8


def test_shard_fn_placements_match_the_reference():
    """tests/test_llama.py:151-162: q / gate columns and o rows over mp."""
    mesh = _mesh(4, 2)
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    dist.shard_layer(m, mesh, llama_shard_fn(mesh))
    params = dict(m.named_parameters())
    spec = {n: dist.auto_parallel.placements_to_spec(
        p.placements, p.dim(), mesh.dim_names)
        for n, p in params.items() if hasattr(p, "placements")}
    assert spec["llama.layers.0.self_attn.q_proj.weight"] == (None, "mp")
    assert spec["llama.layers.0.self_attn.o_proj.weight"] == ("mp", None)
    assert spec["llama.layers.0.mlp.gate_proj.weight"] == (None, "mp")
    assert spec["llama.layers.1.mlp.down_proj.weight"] == ("mp", None)
    assert spec["llama.embed_tokens.weight"] == (None, "mp")
    assert spec["lm_head.weight"] == (None, "mp")
    # norms stay unplaced (replicated); every sharded tensor is held once
    assert "llama.norm.weight" not in spec
    q = params["llama.layers.0.self_attn.q_proj.weight"]
    pieces = dist.auto_parallel.local_pieces(q)
    assert [tuple(p.shape) for p in pieces[:2]] == [(64, 32)] * 2
    assert pieces[0].data_ptr() == q.data_ptr()
    assert pieces[2].data_ptr() == q.data_ptr()      # dp 1, mp 0: shared


def test_example_defaults_gather_kv_heads(jax_run, port_runs):
    """The example's mesh (dp 2 x mp 4): 2 kv heads over 4 ranks run
    exactly (each rank's K / V heads gathered), equal to the JAX Engine's
    GSPMD run on the same mesh and to the port's serial run."""
    np.testing.assert_allclose(port_runs["dp2_mp4"], jax_run[2],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port_runs["dp2_mp4"], port_runs["serial"],
                               rtol=2e-4, atol=2e-5)
    losses = example.main(["--device", "cpu", "--steps", "4"])
    assert len(losses) == 4 and losses[-1] < losses[0]


def test_heads_that_do_not_split_raise():
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    mesh = _mesh(1, 3)
    with pytest.raises(ValueError, match="num_heads 4 does not split"):
        dist.shard_layer(m, mesh, llama_shard_fn(mesh))


def test_unrunnable_placement_raises_naming_it():
    """A Shard placement no per-rank rule runs (a norm's weight) raises,
    naming the parameter and its placements; so does a weight split over
    the data dim."""
    mesh = _mesh(2, 2)
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    dist.shard_layer(m, mesh, llama_shard_fn(mesh))
    norm = m.llama.norm
    norm._parameters["weight"] = dist.shard_tensor(
        norm.weight, mesh, [dist.Replicate(), dist.Shard(0)])
    e = dist.Engine(m, loss=example.loss_fn, optimizer=SGD(0.1),
                    process_mesh=mesh)
    with pytest.raises(ValueError, match=r"llama\.norm\.weight"):
        e.fit(_batches()[:1])
    m = LlamaForCausalLM(llama_tiny(), device="cpu")
    head = m.lm_head
    head._parameters["weight"] = dist.shard_tensor(
        head.weight, mesh, [dist.Shard(1), dist.Replicate()])
    e = dist.Engine(m, loss=example.loss_fn, optimizer=SGD(0.1),
                    process_mesh=mesh)
    with pytest.raises(ValueError, match="data dim 'dp'"):
        e.fit(_batches()[:1])


def test_example_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        example.main(["--steps", "1"])
