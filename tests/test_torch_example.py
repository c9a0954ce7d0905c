"""The reference's fleet example on the port, against the JAX package on
the CPU: the hybrid group's mesh, the trainer's clip, schedule, sp and
remat, the shard-aware checkpoint and auto-resume, and the example script
end to end.

gpt_tiny in f32; the JAX trainers run jitted on the conftest's virtual
devices, weights carried by ``hybrid_state_from_jax``.

* The reference trainer clips with ``ClipGradByGlobalNorm`` inside each of
  its two ``update`` calls (non-block tensors, block stack), so it takes
  two norms, not one (a JAX-only check, with a clip that binds); the
  port's serial trainer takes the same two.
* The port's ``{mp 2, pp 2}`` trainer with ``sp=True, remat=True``, a
  binding clip and a stepped schedule (``SGD``, so the clip moves every
  update) against the JAX trainer of the same configuration, 2 steps:
  losses at rtol 1e-5, parameters at atol 1e-5.
* A checkpoint written by either package loads in the other (f32 and
  bf16, sharded arrays and pieces).
* A run saved under ``{mp 2, pp 2}`` resumes under the serial trainer and
  under ZeRO-3 with the straight run's losses (rtol 1e-5), the
  optimizer's state and the scheduler's included.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP
import paddle_tpu
import paddle_tpu.distributed as jdist
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.models import GPTHybridTrainer as JaxTrainer
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed.fleet_utils import (latest_checkpoint,
                                                      load_auto_resume,
                                                      save_auto_resume)
from paddle_tpu_torch.distributed.sharding_utils import ShardedTensor
from paddle_tpu_torch.models import (GPTHybridTrainer, gpt_tiny,
                                     hybrid_state_from_jax,
                                     jax_trainer_arrays)
from paddle_tpu_torch.optimizer import SGD, AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr

LR, CLIP = 0.5, 0.1
HYBRID = {"mp_degree": 2, "pp_degree": 2}


@pytest.fixture(autouse=True)
def _no_group():
    yield
    topology.set_hybrid_communicate_group(None)


@pytest.fixture(scope="module")
def jax_example():
    """The JAX trainer of the example's layout with a binding clip and a
    stepped schedule: its mesh shape, first weights, losses and final
    weights."""
    s = jdist.DistributedStrategy()
    s.hybrid_configs = dict(HYBRID)
    jdist.fleet.init(is_collective=True, strategy=s)
    try:
        hcg = jdist.get_hybrid_communicate_group()
        paddle_tpu.seed(0)
        sched = jlr.StepDecay(LR, 1, gamma=0.5)
        tr = JaxTrainer(jax_gpt_tiny(sp=True, remat=True), hcg,
                        jopt.SGD(learning_rate=sched,
                                 grad_clip=jopt.ClipGradByGlobalNorm(CLIP)),
                        microbatches=4)
        st = tr.init_state()
        first = jax_trainer_arrays(st[0], st[1], tr.S)
        x, y = tr.make_batch(batch=8, seq=16, seed=5)
        losses = []
        for _ in range(2):
            st, loss = tr.train_step(st, x, y)
            losses.append(float(loss))
            sched.step()
        return (dict(hcg.get_mesh().shape), first, losses,
                jax_trainer_arrays(st[0], st[1], tr.S))
    finally:
        jdist.topology.set_hybrid_communicate_group(None)


def _group(hybrid):
    s = DistributedStrategy()
    s.hybrid_configs = dict(hybrid)
    world = int(np.prod(list(hybrid.values())))
    fleet.init(is_collective=True, strategy=s, devices=["cpu"] * world)
    return get_hybrid_communicate_group()


def test_hybrid_sp_remat_clip_schedule_match_the_jax_trainer(jax_example):
    mesh, first, jlosses, jfinal = jax_example
    hcg = _group(HYBRID)
    assert dict(hcg.get_mesh().shape) == mesh
    assert hcg.mesh is hcg.get_mesh()
    sched = tlr.StepDecay(LR, 1, gamma=0.5)
    tr = GPTHybridTrainer(gpt_tiny(sp=True, remat=True), hcg,
                          SGD(learning_rate=sched,
                              grad_clip=ClipGradByGlobalNorm(CLIP)),
                          microbatches=4)
    hybrid_state_from_jax(first, tr)
    x, y = tr.make_batch(8, 16, seed=5)
    losses = []
    for _ in range(2):
        losses.append(float(tr.train_step(x, y)))
        sched.step()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = tr.state_dict()
    for k, want in jfinal.items():
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-5,
                                   err_msg=k)


def test_reference_trainer_clips_each_update_group_on_its_own():
    """One jitted step of the JAX serial trainer with ``SGD(1.0)`` and a
    binding ``ClipGradByGlobalNorm``: the non-block tensors move by their
    gradient scaled with their own norm, the block stack with its own; one
    global norm would move them otherwise.  The port's serial trainer
    takes the same step."""
    s = jdist.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1}
    jdist.fleet.init(is_collective=True, strategy=s)
    try:
        paddle_tpu.seed(1)
        tr = JaxTrainer(jax_gpt_tiny(remat=False),
                        jdist.get_hybrid_communicate_group(),
                        jopt.SGD(learning_rate=1.0,
                                 grad_clip=jopt.ClipGradByGlobalNorm(CLIP)))
        st = tr.init_state()
        x, y = tr.make_batch(batch=4, seq=16, seed=2)
        before = [{k: np.asarray(v) for k, v in t.items()} for t in st[:2]]
        g = jax.jit(jax.grad(tr.loss_fn, argnums=(0, 1)))(st[0], st[1], x, y)
        g = [{k: np.asarray(v) for k, v in t.items()} for t in g]
        st, _ = tr.train_step(st, x, y)
        after = [{k: np.asarray(v) for k, v in t.items()} for t in st[:2]]
    finally:
        jdist.topology.set_hybrid_communicate_group(None)
    norms = [np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                         for v in grp.values())) for grp in g]
    both = np.sqrt(norms[0] ** 2 + norms[1] ** 2)
    assert max(norms) > CLIP                 # the clip binds
    for grp, n in enumerate(norms):
        for k in g[grp]:
            moved = before[grp][k] - after[grp][k]
            np.testing.assert_allclose(moved, g[grp][k] * min(1, CLIP / n),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
    k = next(iter(g[1]))
    assert not np.allclose(before[1][k] - after[1][k],
                           g[1][k] * min(1, CLIP / both), rtol=1e-2)
    # the port's serial trainer, from the same weights
    port = GPTHybridTrainer(gpt_tiny(remat=False),
                            optimizer=SGD(learning_rate=1.0,
                                          grad_clip=ClipGradByGlobalNorm(
                                              CLIP)), device="cpu")
    hybrid_state_from_jax((before[0], before[1]), port, n_stages=1)
    port.train_step(*port.make_batch(4, 16, seed=2))
    want = jax_trainer_arrays(after[0], after[1])
    for name, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name], atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_load_across_the_packages(tmp_path, dtype):
    rs = np.random.RandomState(7)
    w = rs.randn(8, 6).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("a", "b"))
    sharded = jax.device_put(jnp.asarray(w, jd),
                             NamedSharding(mesh, JP("a", "b")))
    replicated = jax.device_put(jnp.asarray(w[:3], jd),
                                NamedSharding(mesh, JP()))
    jck.save_state_dict({"w": sharded, "r": replicated,
                         "step": jnp.asarray(3)}, str(tmp_path / "jax"))
    got = tck.load_state_dict(
        {"w": ShardedTensor((8, 6), td, [((4, 0), torch.zeros(4, 6,
                                                               dtype=td)),
                                         ((0, 0), torch.zeros(4, 6,
                                                              dtype=td))]),
         "r": torch.zeros(3, 6, dtype=td),
         "step": torch.zeros((), dtype=torch.int32)}, str(tmp_path / "jax"))
    exact = torch.tensor(w).to(td)
    torch.testing.assert_close(got["w"].pieces[0][1], exact[4:], rtol=0,
                               atol=0)
    torch.testing.assert_close(got["r"], exact[:3], rtol=0, atol=0)
    assert int(got["step"]) == 3
    # the reverse: pieces written once each, loaded onto a JAX sharding
    st = ShardedTensor((8, 6), td, [((0, 0), exact[:, :4]),
                                    ((0, 4), exact[:, 4:])])
    tck.save_state_dict({"w": st, "r": exact[:3]}, str(tmp_path / "port"))
    back = jck.load_state_dict(
        {"w": jax.device_put(jnp.zeros((8, 6), jd),
                             NamedSharding(mesh, JP(None, "b"))),
         "r": jnp.zeros((3, 6), jd)}, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  exact.float().numpy())
    np.testing.assert_array_equal(np.asarray(back["r"], np.float32),
                                  exact[:3].float().numpy())


def _trainer(hybrid=None, zero=1, sp=True):
    g = torch.Generator()
    g.manual_seed(4)
    cfg = gpt_tiny(sp=sp, remat=True)
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(2e-3, 8), 2, 0.0,
                             2e-3)
    opt = AdamW(learning_rate=sched, grad_clip=ClipGradByGlobalNorm(0.5))
    if hybrid is None:
        return GPTHybridTrainer(cfg, optimizer=opt, device="cpu",
                                generator=g), sched
    return GPTHybridTrainer(cfg, _group(hybrid), opt, microbatches=2,
                            zero_stage=zero, generator=g), sched


def _steps(tr, sched, n):
    x, y = tr.make_batch(8, 16, seed=3)
    out = []
    for _ in range(n):
        out.append(float(tr.train_step(x, y)))
        sched.step()
    return out


def test_resume_across_layouts_continues_the_run(tmp_path):
    tr, sched = _trainer()
    straight = _steps(tr, sched, 4)
    final = tr.state_dict()
    tr, sched = _trainer(HYBRID)
    assert _steps(tr, sched, 2) == pytest.approx(straight[:2], rel=1e-5)
    save_auto_resume(tr.train_state(), str(tmp_path), step=2)
    topology.set_hybrid_communicate_group(None)
    for hybrid, zero in ((None, 1), ({"sharding_degree": 2}, 3)):
        tr, sched = _trainer(hybrid, zero)
        state, step = load_auto_resume(tr.train_state(), str(tmp_path))
        assert step == 2
        tr.load_train_state(state)
        assert tr.opt.get_lr() == sched.lr_at(2)
        got = _steps(tr, sched, 2)
        np.testing.assert_allclose(got, straight[2:], rtol=1e-5)
        h = tr.cfg.hidden_size
        for k, v in tr.state_dict().items():
            diff = (v - final[k]).abs()
            if k.endswith("qkv.bias"):
                # the key slice's exact gradient is 0: Adam moves its
                # rounding noise by up to 2·lr a step
                assert float(diff[h:2 * h].max()) <= 2 * 2e-3 * 4, k
                diff = torch.cat([diff[:h], diff[2 * h:]])
            assert float(diff.max()) <= 1e-5, k
        topology.set_hybrid_communicate_group(None)
    # every element of the sharded state once: each entry's pieces tile it
    md = tck.Metadata.from_json(
        open(tmp_path / "step_2" / "metadata_p0.json").read())
    for name, tm in md.tensors.items():
        assert sum(int(np.prod(s.local_shape)) for s in tm.shards) == \
            int(np.prod(tm.global_shape)), name
    assert {"opt.step", "lr.last_epoch", "gpt.wte.weight",
            "opt.moment2.gpt.h.1.qkv.weight"} <= set(md.tensors)


def test_keep_last_latest_and_async_saves(tmp_path):
    d = str(tmp_path / "ck")
    x = {"w": torch.arange(6.0).reshape(2, 3)}
    assert load_auto_resume(x, d) == (x, None)
    for step in (1, 2, 3, 4):
        save_auto_resume({"w": x["w"] + step}, d, step=step, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_3", "step_4"]
    os.makedirs(os.path.join(d, "step_9"))            # no .complete
    assert latest_checkpoint(d).endswith("step_4")
    got, step = load_auto_resume({"w": torch.zeros(2, 3)}, d)
    assert step == 4
    torch.testing.assert_close(got["w"], x["w"] + 4)
    t = tck.save_state_dict(x, str(tmp_path / "a"), async_save=True)
    x["w"] += 100          # the snapshot was taken at the call
    tck.wait_for_pending_saves()
    assert not t.is_alive()
    got = tck.load_state_dict({"w": torch.zeros(2, 3)}, str(tmp_path / "a"))
    torch.testing.assert_close(got["w"], torch.arange(6.0).reshape(2, 3))
    bad = tmp_path / "b"
    os.makedirs(bad / "data_p0.npz")       # the write cannot make its file
    tck.save_state_dict(x, str(bad), async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        tck.wait_for_pending_saves(str(bad))


def test_example_runs_and_resumes_on_the_cpu(tmp_path):
    """The example saves after its 10th step; a second run resumes there
    and gives the first run's 11th step."""
    from paddle_tpu_torch.examples.train_gpt_hybrid import main
    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--mp", "2", "--pp", "2", "--batch", "4",
            "--seq", "16", "--steps", "11", "--ckpt", ck]
    first = main(args)
    topology.set_hybrid_communicate_group(None)
    assert [s for s, _ in first] == list(range(11))
    assert latest_checkpoint(ck).endswith("step_10")
    resumed = main(args)
    assert [s for s, _ in resumed] == [10]
    np.testing.assert_allclose(resumed[0][1], first[10][1], rtol=1e-6)
