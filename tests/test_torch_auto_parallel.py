"""The port's semi-auto parallel API (``ProcessMesh``, placements,
``shard_tensor`` / ``reshard``, the SPMD rules, ``shard_layer`` and the
auto-parallel ``Engine``) against the JAX package's on the CPU.

The JAX side runs as ``tests/test_auto_parallel.py`` runs it (the
conftest's 8 virtual devices); the port's 8 processes all sit on the CPU
(``devices=["cpu"] * 8``).  The reference MLP (16 -> 32 -> 10, fc1
column-parallel with its bias, fc2 row-parallel) is built by the JAX
package from a seed and its weights copied into the port's.

Tolerances: tensor values exact (a reshard moves no arithmetic but the
Partial split and its psum, which are exact on these values or held to
rtol 1e-6); Engine losses, evaluation and predictions port vs JAX in f32
at rtol 1e-5, atol 1e-6 (the sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu
import paddle_tpu.distributed.auto_parallel as japi
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework import io as jio
from paddle_tpu.metric import Accuracy as JaxAccuracy
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import auto_parallel as api
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.optimizer import SGD, Adam

TOL = dict(rtol=1e-5, atol=1e-6)


def mesh2d():
    return api.ProcessMesh(np.arange(8).reshape(4, 2), dim_names=["dp", "mp"],
                           devices=["cpu"] * 8)


def jmesh2d():
    return japi.ProcessMesh(np.arange(8).reshape(4, 2), dim_names=["dp", "mp"])


# ---------------------------------------------------------------- meshes
def test_process_mesh_matches_the_reference():
    m, j = mesh2d(), jmesh2d()
    assert m.shape == j.shape and m.dim_names == j.dim_names
    assert m.process_ids == j.process_ids and m.size == j.size
    assert m.get_dim_size("mp") == j.get_dim_size("mp")
    for p in range(8):
        for d in ("dp", "mp"):
            assert m.get_rank_by_dim_and_process_id(d, p) == \
                j.get_rank_by_dim_and_process_id(d, p)
    for d, i in (("dp", 1), ("mp", 0), ("mp", 1)):
        sub, jsub = m.get_submesh(d, i), j.get_submesh(d, i)
        assert sub.process_ids == jsub.process_ids
        assert sub.dim_names == jsub.dim_names
    grid = m.get_mesh()
    assert grid.axis_names == ("dp", "mp") and grid.dims == (4, 2)
    assert grid.coord(5) == {"dp": 2, "mp": 1}
    assert [str(d) for d in grid.devices] == ["cpu"] * 8
    one = api.ProcessMesh([0, 1], dim_names=["dp"], devices=["cpu"] * 2)
    assert one.get_submesh("dp", 0).process_ids == [0]


def test_process_mesh_default_devices_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = api.ProcessMesh(np.arange(8).reshape(4, 2), dim_names=["dp", "mp"])
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* 8"):
        m.get_mesh()


# ------------------------------------------------------ shard / reshard
_PLACEMENTS = [
    ("s0_s1", lambda: [api.Shard(0), api.Shard(1)],
     lambda: [japi.Shard(0), japi.Shard(1)]),
    ("r_s1", lambda: [api.Replicate(), api.Shard(1)],
     lambda: [japi.Replicate(), japi.Shard(1)]),
    ("s0_r", lambda: [api.Shard(0), api.Replicate()],
     lambda: [japi.Shard(0), japi.Replicate()]),
    ("s1_s1", lambda: [api.Shard(1), api.Shard(1)],
     lambda: [japi.Shard(1), japi.Shard(1)]),
]


@pytest.mark.parametrize("case", _PLACEMENTS, ids=[c[0] for c in _PLACEMENTS])
def test_shard_tensor_pieces_are_the_references_shards(case):
    """Rank r's piece equals the JAX array's shard on device r, and the
    placements and the spec agree."""
    _, pl, jpl = case
    x = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)
    d = api.shard_tensor(torch.as_tensor(x), mesh2d(), pl())
    jd = japi.shard_tensor(x, jmesh2d(), jpl())
    assert tuple(api.placements_to_spec(d.placements, 2, ["dp", "mp"])) == \
        tuple(jd.sharding.spec) + (None,) * (2 - len(jd.sharding.spec))
    assert api.get_placements(d) == pl()
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    shards = {s.device.id: np.asarray(s.data) for s in jd.addressable_shards}
    for r, p in enumerate(api.local_pieces(d)):
        np.testing.assert_array_equal(p.numpy(), shards[r])


def test_shard_parameter_keeps_its_storage():
    p = torch.nn.Parameter(torch.randn(4, 6))
    d = api.shard_tensor(p, mesh2d(), [api.Replicate(), api.Shard(1)])
    assert isinstance(d, torch.nn.Parameter) and d.requires_grad
    assert d.data_ptr() == p.data_ptr()


def _both(x, pl, jpl, to=None, jto=None):
    d = api.shard_tensor(torch.as_tensor(x), mesh2d(), pl)
    jd = japi.shard_tensor(x, jmesh2d(), jpl)
    if to is not None:
        d = api.reshard(d, mesh2d(), to)
        jd = japi.reshard(jd, jmesh2d(), jto)
    return d, jd


def test_partial_sum_to_replicate_and_shard():
    x = np.full((4, 4), 8.0, np.float32)
    d, jd = _both(x, [api.Partial(), api.Partial()],
                  [japi.Partial(), japi.Partial()])
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))   # x / 8
    r, jr = _both(x, [api.Partial(), api.Partial()],
                  [japi.Partial(), japi.Partial()],
                  [api.Replicate(), api.Replicate()],
                  [japi.Replicate(), japi.Replicate()])
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(r.numpy(), x, rtol=1e-6)
    y = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    r, jr = _both(y, [api.Partial(), api.Replicate()],
                  [japi.Partial(), japi.Replicate()],
                  [api.Shard(0), api.Replicate()],
                  [japi.Shard(0), japi.Replicate()])
    assert r.placements == [api.Shard(0), api.Replicate()]
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)


@pytest.mark.parametrize("rt", ["max", "min", "avg"])
def test_partial_reduce_types_round_trip(rt):
    x = np.full((4, 4), 5.0, np.float32)
    r, jr = _both(x, [api.Partial(rt), api.Replicate()],
                  [japi.Partial(rt), japi.Replicate()],
                  [api.Replicate(), api.Replicate()],
                  [japi.Replicate(), japi.Replicate()])
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6)
    d2 = api.reshard(api.shard_tensor(torch.as_tensor(x), mesh2d(),
                                      [api.Replicate()]),
                     mesh2d(), [api.Partial(rt)])
    jd2 = japi.reshard(japi.shard_tensor(x, jmesh2d(), [japi.Replicate()]),
                       jmesh2d(), [japi.Partial(rt)])
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6)
    back = api.reshard(d2, mesh2d(), [api.Replicate()])
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-6)


def test_reshard_unshard_and_dtensor_from_fn():
    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    r, jr = _both(x, [api.Shard(0), api.Replicate()],
                  [japi.Shard(0), japi.Replicate()],
                  [api.Replicate(), api.Shard(1)],
                  [japi.Replicate(), japi.Shard(1)])
    assert r.placements == [api.Replicate(), api.Shard(1)]
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    u = api.unshard_dtensor(r)
    assert u.placements == [api.Replicate(), api.Replicate()]
    np.testing.assert_array_equal(u.numpy(), x)
    d = api.dtensor_from_fn(torch.ones, mesh2d(), [api.Shard(0)], (8, 2))
    jd = japi.dtensor_from_fn(jnp.ones, jmesh2d(), [japi.Shard(0)], (8, 2))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert [tuple(p.shape) for p in api.local_pieces(d)][::2] == [(2, 2)] * 4
    with pytest.raises(ValueError, match="Partial"):
        api.dtensor_from_fn(torch.ones, mesh2d(), [api.Partial()], (8, 2))


# ------------------------------------------------------------ SPMD rules
def _spmd_cases():
    from paddle_tpu_torch.distributed.auto_parallel import spmd_rules as P
    from paddle_tpu.distributed.auto_parallel import spmd_rules as J
    S = lambda mod, *a: mod.DistTensorSpec(*a)  # noqa: E731
    return [
        ("matmul_mk_kn", lambda m: m.matmul_spmd(
            S(m, [64, 32], [0, -1]), S(m, [32, 48], [-1, 1]))),
        ("matmul_k_partial", lambda m: m.matmul_spmd(
            S(m, [64, 32], [-1, 1]), S(m, [32, 48], [1, -1]))),
        ("matmul_trans_x", lambda m: m.matmul_spmd(
            S(m, [32, 64], [-1, 0]), S(m, [32, 48], [-1, -1]), trans_x=True)),
        ("matmul_trans_y", lambda m: m.matmul_spmd(
            S(m, [64, 32], [0, 1]), S(m, [48, 32], [-1, 1]), trans_y=True)),
        ("matmul_dedup", lambda m: m.matmul_spmd(
            S(m, [64, 32], [0, -1]), S(m, [32, 48], [-1, 0]))),
        ("matmul_batch_k", lambda m: m.matmul_spmd(
            S(m, [4, 8, 16], [0, -1, -1]), S(m, [16, 32], [0, -1]))),
        ("elementwise_bcast", lambda m: m.elementwise_spmd(
            S(m, [8, 1, 4], [0, -1, -1]), S(m, [4], [1]))),
        ("elementwise_conflict", lambda m: m.elementwise_spmd(
            S(m, [8, 4], [0, -1]), S(m, [4], [0]))),
        ("reduction_partial", lambda m: m.reduction_spmd(
            S(m, [8, 4], [0, 1]), axis=[0])),
        ("reduction_keepdim", lambda m: m.reduction_spmd(
            S(m, [8, 4], [0, 1]), axis=[1], keepdim=True)),
        ("embedding", lambda m: m.embedding_spmd(
            S(m, [16, 8], [0, -1]), S(m, [1000, 64], [1, -1]))),
        ("softmax", lambda m: m.softmax_spmd(S(m, [8, 4], [0, 1]), axis=-1)),
        ("transpose", lambda m: m.transpose_spmd(
            S(m, [8, 4, 2], [0, 1, -1]), [2, 0, 1])),
        ("split", lambda m: m.split_spmd(S(m, [8, 4], [0, 1]), 2, 1)),
    ], P, J


_CASES, _PORT_RULES, _JAX_RULES = _spmd_cases()


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_spmd_rule_gives_the_references_result(case):
    got, want = case[1](_PORT_RULES), case[1](_JAX_RULES)
    assert (got.inputs, got.outputs, got.partial_dims) == \
        (want.inputs, want.outputs, want.partial_dims)


# ------------------------------------------------------- shard_layer + Engine
class JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 10)
        self.act = jnn.ReLU()

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MLP(torch.nn.Module):
    """tests/test_auto_parallel.py:192-202 on the port's Linear."""

    def __init__(self, weights):
        super().__init__()
        self.fc1 = Linear(16, 32, device="cpu")
        self.fc2 = Linear(32, 10, device="cpu")
        self.load_state_dict({k: torch.as_tensor(v)
                              for k, v in weights.items()})

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _mp_shard_fn(mod):
    def fn(name, sub, mesh):
        """Megatron TP: fc1 column-parallel, fc2 row-parallel."""
        R, S = mod.Replicate, mod.Shard
        if name == "fc1":
            sub._parameters["weight"] = mod.shard_tensor(
                sub._parameters["weight"], mesh, [R(), S(1)])
            sub._parameters["bias"] = mod.shard_tensor(
                sub._parameters["bias"], mesh, [R(), S(0)])
        elif name == "fc2":
            sub._parameters["weight"] = mod.shard_tensor(
                sub._parameters["weight"], mesh, [R(), S(0)])
    return fn


def _jxent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))


def _xent(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def _data(n=32, seed=0):
    rs = np.random.RandomState(seed)
    xs = rs.randn(n, 16).astype(np.float32)
    ys = rs.randint(0, 10, size=(n,)).astype(np.int32)
    return [(xs[i:i + 8], ys[i:i + 8]) for i in range(0, n, 8)]


def _jax_engine(seed, shard, opt, **kw):
    paddle_tpu.seed(seed)
    m = JaxMLP()
    w = {k: np.array(v) for k, v in m.state_dict().items()}
    mesh = jmesh2d()
    if shard:
        japi.shard_layer(m, mesh, _mp_shard_fn(japi))
    return w, japi.Engine(m, loss=_jxent, optimizer=opt, process_mesh=mesh,
                          **kw)


def _port_engine(w, shard, opt, **kw):
    m = MLP(w)
    mesh = mesh2d()
    if shard:
        api.shard_layer(m, mesh, _mp_shard_fn(api))
    return m, api.Engine(m, loss=_xent, optimizer=opt, process_mesh=mesh,
                         **kw)


@pytest.fixture(scope="module")
def fit_runs():
    """2 epochs of SGD(0.1) on the sharded MLP, JAX and port, then an
    evaluation with Accuracy and one prediction."""
    w, je = _jax_engine(42, True, jopt.SGD(learning_rate=0.1),
                        metrics=JaxAccuracy())
    jh = je.fit(_data(), epochs=2)
    jev = je.evaluate(_data())
    jpred = np.asarray(je.predict(_data(), steps=1)[0])
    m, e = _port_engine(w, True, SGD(learning_rate=0.1), metrics=Accuracy())
    h = e.fit(_data(), epochs=2)
    ev = e.evaluate(_data())
    pred = e.predict(_data(), steps=1)[0].numpy()
    return dict(jh=jh, h=h, jev=jev, ev=ev, jpred=jpred, pred=pred, w=w,
                model=m, engine=e)


def test_engine_fit_matches_jax_engine(fit_runs):
    np.testing.assert_allclose(fit_runs["h"], fit_runs["jh"], **TOL)
    assert fit_runs["h"][-1] < fit_runs["h"][0]


def test_engine_fit_matches_port_serial(fit_runs):
    _, e = _port_engine(fit_runs["w"], False, SGD(learning_rate=0.1))
    e.process_mesh = None
    np.testing.assert_allclose(e.fit(_data(), epochs=2), fit_runs["h"],
                               **TOL)


def test_engine_evaluate_and_predict_match_jax(fit_runs):
    ev, jev = fit_runs["ev"], fit_runs["jev"]
    assert set(ev) == set(jev) == {"loss", "acc"}
    np.testing.assert_allclose(ev["loss"], jev["loss"], **TOL)
    assert ev["acc"] == jev["acc"]
    assert fit_runs["pred"].shape == (8, 10)
    np.testing.assert_allclose(fit_runs["pred"], fit_runs["jpred"],
                               rtol=1e-5, atol=1e-5)


def test_shard_layer_keeps_pieces_as_views(fit_runs):
    m = fit_runs["model"]
    w1 = m.fc1.weight
    assert api.get_placements(w1) == [api.Replicate(), api.Shard(1)]
    pieces = api.local_pieces(w1)
    assert [tuple(p.shape) for p in pieces[:2]] == [(16, 16)] * 2
    assert pieces[1].data_ptr() == w1.data_ptr() + 16 * w1.element_size()
    # the unplaced fc2.bias stays a plain parameter
    assert not api.is_dist_tensor(m.fc2.bias)


# Before any update the port's amp and the JAX Engine's run the same bf16
# arithmetic on replicated parameters: step 1's loss, the evaluation loss
# and the predictions agreed to 1e-7, 2.5e-8 and 0 relative (seeds 3 and
# 7), while the f32 forward is 4.7e-5 relative or more away from either.
AMP_FWD_RTOL = 1e-6
# After an update they part by up to 1.9e-4 relative (replicated) and
# 5.8e-4 (fc1 / fc2 sharded over mp, where the row-parallel partials are
# summed): XLA may keep a bf16 intermediate in f32 where the port rounds
# it.  Held at 5x the larger reading.
AMP_RTOL = 3e-3


@pytest.mark.parametrize("knob", ["gradient_merge", "recompute", "amp"])
def test_engine_strategy_knob_matches_jax(knob):
    s, js = api.Strategy(), japi.Strategy()
    for st in (s, js):
        if knob == "gradient_merge":
            st.gradient_merge.enable = True
            st.gradient_merge.k_steps = 2
        elif knob == "recompute":
            st.recompute.enable = True
        else:
            st.amp.enable = True
    w, je = _jax_engine(3, True, jopt.SGD(learning_rate=0.1), strategy=js)
    _, e = _port_engine(w, True, SGD(learning_rate=0.1), strategy=s)
    tol = dict(rtol=AMP_RTOL) if knob == "amp" else TOL
    np.testing.assert_allclose(e.fit(_data(), epochs=2),
                               je.fit(_data(), epochs=2), **tol)


def test_engine_amp_casts_f32_parameters():
    """amp bf16 against the JAX Engine's amp, seeds 3 and 7: the forward
    runs on bf16 casts of the f32 parameters (a no-op amp, which would
    give the f32 numbers, fails); the f32 parameters take the update."""
    for seed in (3, 7):
        _check_amp_against_jax(seed)


def _check_amp_against_jax(seed):
    s, js = api.Strategy(), japi.Strategy()
    s.amp.enable = js.amp.enable = True
    w, je = _jax_engine(seed, False, jopt.SGD(learning_rate=0.1),
                        strategy=js)
    m, e = _port_engine(w, False, SGD(learning_rate=0.1), strategy=s)
    _, f32 = _port_engine(w, False, SGD(learning_rate=0.1))
    ev, jev, fev = (x.evaluate(_data())["loss"] for x in (e, je, f32))
    pred = e.predict(_data(), steps=1)[0]
    jpred = np.asarray(je.predict(_data(), steps=1)[0], np.float32)
    fpred = f32.predict(_data(), steps=1)[0].numpy()
    assert pred.dtype == torch.bfloat16
    got, want = e.fit(_data(), epochs=2), je.fit(_data(), epochs=2)
    plain = f32.fit(_data(), epochs=2)
    np.testing.assert_allclose(got[0], want[0], rtol=AMP_FWD_RTOL)
    np.testing.assert_allclose(ev, jev, rtol=AMP_FWD_RTOL)
    np.testing.assert_allclose(pred.float().numpy(), jpred,
                               rtol=AMP_FWD_RTOL, atol=1e-6)
    assert abs(plain[0] - want[0]) > 10 * AMP_FWD_RTOL * abs(want[0])
    assert abs(fev - jev) > 10 * AMP_FWD_RTOL * abs(jev)
    assert np.abs(fpred - jpred).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=AMP_RTOL)
    assert m.fc1.weight.dtype == torch.float32
    assert not torch.equal(m.fc1.weight.detach(),
                           torch.as_tensor(w["fc1.weight"]))


def test_to_static_matches_jax():
    w, je = _jax_engine(11, True, jopt.Adam(learning_rate=1e-2))
    jdm = japi.DistModel(je)
    _, e = _port_engine(w, True, Adam(learning_rate=1e-2))
    dm = api.DistModel(e)
    got = [float(dm(x, y)) for x, y in _data()]
    want = [float(jdm(x, y)) for x, y in _data()]
    np.testing.assert_allclose(got, want, **TOL)
    dm.eval()
    jdm.eval()
    np.testing.assert_allclose(float(dm(*_data()[0])),
                               float(jdm(*_data()[0])), **TOL)
    m = MLP(w)
    dm2 = api.to_static(m, loss=_xent, optimizer=SGD(0.1),
                        process_mesh=mesh2d())
    assert np.isfinite(float(dm2(*_data()[0])))
    out = m(torch.as_tensor(_data()[0][0]))
    assert torch.isfinite(out).all()


def test_shard_optimizer_sees_slot_names():
    w, _ = _jax_engine(0, False, jopt.SGD(0.1))
    m, e = _port_engine(w, True, None)
    seen = set()
    mesh = mesh2d()

    def zero1(name, p, s):
        seen.add(name)
        if s.dim() >= 1 and s.shape[0] % 4 == 0:
            return api.shard_tensor(s, mesh, [api.Shard(0)])
        return s

    o = api.shard_optimizer(Adam(learning_rate=1e-3), zero1)
    e.optimizer = o
    e.fit(_data()[:1])
    assert seen == {"moment1", "moment2"}
    slot = o.state["slots"]["fc1.weight"]["moment1"]
    assert api.get_placements(slot) == [api.Shard(0), api.Replicate()]
    assert float(slot.abs().sum()) > 0


def test_engine_save_load_round_trip(tmp_path):
    w, _ = _jax_engine(3, False, jopt.SGD(0.1))
    m, e = _port_engine(w, True, Adam(learning_rate=1e-2))
    e.fit(_data(), epochs=1)
    path = str(tmp_path / "ckpt.pdparams")
    e.save(path)
    trained = {k: v.clone() for k, v in e.state_dict().items()}
    moment = e.optimizer.state["slots"]["fc2.weight"]["moment1"].clone()
    e.fit(_data(), epochs=1)
    e.load(path)
    for k, v in e.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0)
    torch.testing.assert_close(
        e.optimizer.state["slots"]["fc2.weight"]["moment1"], moment,
        rtol=0, atol=0)
    assert api.get_placements(m.fc1.weight) == [api.Replicate(),
                                                api.Shard(1)]


def test_shard_dataloader_partial_batch():
    m = mesh2d()
    batches = [np.ones((8, 4), np.float32), np.ones((6, 4), np.float32)]
    out = list(api.shard_dataloader(batches, m, shard_dims="dp"))
    assert out[0].placements[0] == api.Shard(0)
    assert out[1].shape == (6, 4)
    assert out[1].placements == [api.Replicate(), api.Replicate()]


def test_engine_runs_a_batch_that_does_not_split_once():
    """6 rows over dp 4: run as one group (replicated), equal to serial."""
    w, _ = _jax_engine(5, False, jopt.SGD(0.1))
    x, y = _data()[0]
    _, e = _port_engine(w, True, SGD(learning_rate=0.1))
    got = e.fit([(x[:6], y[:6])])
    _, s = _port_engine(w, False, SGD(learning_rate=0.1))
    s.process_mesh = None
    np.testing.assert_allclose(got, s.fit([(x[:6], y[:6])]), **TOL)


def test_global_mesh():
    m = mesh2d()
    api.set_mesh(m)
    try:
        assert dist.get_mesh() is m
    finally:
        api.set_mesh(None)


def test_framework_io_round_trip_and_reference_load(tmp_path):
    """``save`` / ``load``: bf16 stored widened under its name and read
    back exactly; f32 and integer arrays as plain numpy, which the JAX
    package's ``load`` reads as they are."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=g).bfloat16(),
            "b": torch.randn(5, generator=g),
            "step": torch.arange(4), "meta": [1, ("x", 2.5)]}
    path = str(tmp_path / "t.pdparams")
    io.save(tree, path)
    back = io.load(path)
    assert back["w"].dtype == torch.bfloat16
    torch.testing.assert_close(back["w"], tree["w"], rtol=0, atol=0)
    torch.testing.assert_close(back["b"], tree["b"], rtol=0, atol=0)
    assert torch.equal(back["step"], tree["step"])
    assert back["meta"] == [1, ("x", 2.5)]
    raw = io.load(path, return_numpy=True)
    assert raw["w"].dtype == np.float32
    ref = jio.load(path, return_numpy=True)
    np.testing.assert_array_equal(ref["b"], tree["b"].numpy())
    np.testing.assert_array_equal(ref["step"], tree["step"].numpy())
