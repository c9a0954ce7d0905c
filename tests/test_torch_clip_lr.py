"""Gradient clipping and learning-rate schedulers of the port against the
JAX package on the CPU.

* each clipper on the same numpy gradients (f32 and bf16), at rtol 1e-6
  (f32) and within one bf16 ulp (bf16: the scale is an f32 norm summed in
  another order, then ``g·scale`` in f32 cast back);
* each of the 18 schedulers' ``lr_at(0..N)`` and ``get_lr`` while
  stepping, at rtol 1e-5 and atol 1e-7 (the reference evaluates in f32,
  the port in f64: a difference of two rates near 1 keeps f32's rounding
  of either, ~6e-8), and the ``state_dict`` round trip both ways;
* an optimizer built with ``grad_clip`` and a scheduler: the eager
  ``step()`` clips all gradients under one norm and reads ``get_lr()``,
  as the reference's ``update(grads, lr=get_lr())``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.optimizer.lr as tlr
from paddle_tpu_torch.optimizer.clip import clip_grads

SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3)}


def _grads(seed, scale):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


CLIPPERS = [("value", lambda m: m.ClipGradByValue(0.3)),
            ("value_min", lambda m: m.ClipGradByValue(0.3, min=-0.1)),
            ("norm", lambda m: m.ClipGradByNorm(0.7)),
            ("global_binding", lambda m: m.ClipGradByGlobalNorm(0.5)),
            ("global_loose", lambda m: m.ClipGradByGlobalNorm(1e3))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,make", CLIPPERS, ids=[c[0] for c in CLIPPERS])
def test_clippers_match_the_reference(name, make, dtype):
    g = _grads(1, 0.4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = make(jopt)({k: jnp.asarray(v, jd) for k, v in g.items()})
    got = make(topt)({k: torch.tensor(v).to(td) for k, v in g.items()})
    for k in g:
        w = np.asarray(want[k], np.float32)
        assert got[k].dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].float().numpy(), w,
                                       rtol=2 ** -7, atol=0, err_msg=k)
    assert clip_grads(g, None) is g


def test_clip_scale_stays_on_the_device_and_groups_take_their_own_norm():
    """``scales`` returns device tensors (no host read); ``tensor_of``'s
    groups each take a global norm, as the reference trainer's two
    ``update`` calls do."""
    g = {k: torch.tensor(v) for k, v in _grads(2, 1.0).items()}
    clip = topt.ClipGradByGlobalNorm(0.5)
    groups = {"w": ("a", "w"), "b": ("a", "b"), "emb": ("b", "emb")}
    s = clip.scales(g, groups.__getitem__)
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in s.values())
    na = math.sqrt(sum(float((g[k] ** 2).sum()) for k in ("w", "b")))
    nb = float(g["emb"].norm())
    np.testing.assert_allclose(float(s["w"]), 0.5 / na, rtol=1e-6)
    np.testing.assert_allclose(float(s["emb"]), 0.5 / nb, rtol=1e-6)
    assert float(s["w"]) == float(s["b"])


def _sched(m, name):
    """The scheduler ``name`` of module ``m`` (either package's lr)."""
    return {
        "Noam": lambda: m.NoamDecay(64, 4, learning_rate=2.0),
        "Step": lambda: m.StepDecay(0.5, 3, gamma=0.5),
        "MultiStep": lambda: m.MultiStepDecay(0.5, [2, 5, 9], gamma=0.3),
        "Constant": lambda: m.ConstantLR(0.5, factor=0.25, total_steps=4),
        "Linear": lambda: m.LinearLR(0.5, 8, start_factor=0.2),
        "Cyclic": lambda: m.CyclicLR(0.1, 0.9, 3, step_size_down=5),
        "Cyclic2": lambda: m.CyclicLR(0.1, 0.9, 2, mode="triangular2"),
        "CyclicExp": lambda: m.CyclicLR(0.1, 0.9, 2, mode="exp_range",
                                        exp_gamma=0.9),
        "Exponential": lambda: m.ExponentialDecay(0.5, 0.8),
        "NaturalExp": lambda: m.NaturalExpDecay(0.5, 0.3),
        "InverseTime": lambda: m.InverseTimeDecay(0.5, 0.5),
        "Polynomial": lambda: m.PolynomialDecay(0.5, 6, end_lr=0.01,
                                                power=2.0),
        "PolynomialCycle": lambda: m.PolynomialDecay(0.5, 4, cycle=True),
        "Warmup": lambda: m.LinearWarmup(m.CosineAnnealingDecay(0.5, 6), 4,
                                         0.0, 0.5),
        "WarmupFloat": lambda: m.LinearWarmup(0.3, 3, 0.01, 0.3),
        "Cosine": lambda: m.CosineAnnealingDecay(0.5, 7, eta_min=0.05),
        "Lambda": lambda: m.LambdaDecay(0.5, lambda s: 0.9 ** s),
        "Piecewise": lambda: m.PiecewiseDecay([2, 5], [0.3, 0.2, 0.1]),
        "OneCycle": lambda: m.OneCycleLR(0.9, 12),
        "OneCycleLinear": lambda: m.OneCycleLR(0.9, 12,
                                               anneal_strategy="linear"),
        "Plateau": lambda: m.ReduceOnPlateau(0.5, patience=1, factor=0.5),
        "WarmRestarts": lambda: m.CosineAnnealingWarmRestarts(0.5, 3),
        "WarmRestarts2": lambda: m.CosineAnnealingWarmRestarts(
            0.5, 2, T_mult=2),
        "Multiplicative": lambda: m.MultiplicativeDecay(0.5,
                                                        lambda t: 0.9),
    }[name]()


SCHEDULERS = ["Noam", "Step", "MultiStep", "Constant", "Linear", "Cyclic",
              "Cyclic2", "CyclicExp", "Exponential", "NaturalExp",
              "InverseTime", "Polynomial", "PolynomialCycle", "Warmup",
              "WarmupFloat", "Cosine", "Lambda", "Piecewise", "OneCycle",
              "OneCycleLinear", "Plateau", "WarmRestarts", "WarmRestarts2",
              "Multiplicative"]
N = 14


@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_matches_the_reference(name):
    js, ts = _sched(jlr, name), _sched(tlr, name)
    want = [float(js.lr_at(s)) for s in range(N)]
    got = [ts.lr_at(s) for s in range(N)]
    assert all(isinstance(x, float) for x in got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    metrics = [5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0]
    for m in metrics:
        np.testing.assert_allclose(ts.get_lr(), js.get_lr(), rtol=1e-5,
                                   atol=1e-7)
        if name == "Plateau":
            js.step(m)
            ts.step(m)
        else:
            js.step()
            ts.step()
    np.testing.assert_allclose(ts.get_lr(), js.get_lr(), rtol=1e-5, atol=1e-7)
    sd = ts.state_dict()
    assert sd["last_epoch"] == js.state_dict()["last_epoch"]
    fresh_t, fresh_j = _sched(tlr, name), _sched(jlr, name)
    fresh_t.set_state_dict(sd)
    fresh_j.set_state_dict(js.state_dict())
    np.testing.assert_allclose(fresh_t.get_lr(), ts.get_lr(), rtol=0)
    if name != "Plateau":   # the reference's state leaves its lr out
        np.testing.assert_allclose(fresh_t.get_lr(), fresh_j.get_lr(),
                                   rtol=1e-5, atol=1e-7)
    # the reference's state dict loads into the port
    fresh_t = _sched(tlr, name)
    fresh_t.set_state_dict(js.state_dict())
    assert fresh_t.last_epoch == js.last_epoch


def test_step_clips_then_uses_the_scheduled_rate():
    """``AdamW(learning_rate=scheduler, grad_clip=ClipGradByGlobalNorm)``:
    two eager steps with the scheduler stepped between them, against the
    reference's ``update(grads, lr=get_lr())`` on the same values."""
    rs = np.random.RandomState(3)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    mod = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                  for k, v in p0.items()})
    tsched, jsched = tlr.StepDecay(0.1, 1, 0.5), jlr.StepDecay(0.1, 1, 0.5)
    t = topt.AdamW(learning_rate=tsched,
                   grad_clip=topt.ClipGradByGlobalNorm(0.5),
                   weight_decay=0.01, parameters=mod)
    j = jopt.AdamW(learning_rate=jsched,
                   grad_clip=jopt.ClipGradByGlobalNorm(0.5),
                   weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = j.init(jp)
    for step in range(2):
        g = _grads(10 + step, 2.0)
        for k, p in mod.items():
            p.grad = torch.tensor(g[k])
        t.step()
        jp, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                          lr=jnp.asarray(j.get_lr(), jnp.float32))
        np.testing.assert_allclose(t.get_lr(), j.get_lr(), rtol=1e-7)
        tsched.step()
        jsched.step()
    for k in p0:
        np.testing.assert_allclose(mod[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-6)
    t.set_lr(0.25)
    assert t.get_lr() == 0.25
    sd = t.state_dict()
    assert sd["state"]["step"] == 2 and sd["lr"] == {"last_epoch": 0}
