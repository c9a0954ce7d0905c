"""Fused AdamW and the optimizers of the PyTorch port
(paddle_tpu_torch/kernels/fused_adamw.py, paddle_tpu_torch/optimizer)
against the JAX package on identical numpy inputs, on the CPU.

The kernel's plain version is held to the Pallas kernel in interpret mode
for an f32 and a bf16 parameter; ``AdamW`` and ``FusedAdamW`` to the JAX
optimizers' ``update`` over 3 steps on a parameter dict with an f32 and a
bf16 entry under ``multi_precision=True``, comparing every state slot
(moment1, moment2, master, step).  Tolerances: f32 values rtol 1e-6 /
atol 1e-7 (scalars rounded alike, element order identical; only the
compilers' contraction of products may differ); bf16 values within one
bf16 ulp (an f32 value a hair either side of a rounding boundary).  The
fused kernels (both packages') take ``1 - beta2`` in f32 from the f32
``beta2`` (0.99900001 -> 9.9998713e-4) where AdamW rounds the double
``1 - 0.999`` (1e-3): moment2 then differs by 1.3e-5 relative, so
FusedAdamW is held to the JAX AdamW at rtol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.fused_adamw import fused_adamw_update
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import FusedAdamW as JaxFusedAdamW
from paddle_tpu_torch.kernels.fused_adamw import (fused_adamw,
                                                  fused_adamw_reference)
from paddle_tpu_torch.optimizer import AdamW, FusedAdamW

F32 = dict(rtol=1e-6, atol=1e-7)


def _close(got, want, dtype=torch.float32, rtol=F32["rtol"]):
    got = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    if dtype == torch.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=F32["atol"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_matches_pallas_interpret(dtype):
    rs = np.random.RandomState(0)
    n = 1000            # not a multiple of the kernel's vector width
    p = rs.randn(n).astype(np.float32)
    g = rs.randn(n).astype(np.float32) * 0.1
    m = rs.randn(n).astype(np.float32) * 0.01
    v = np.abs(rs.randn(n).astype(np.float32)) * 1e-3
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
              weight_decay=0.01)
    jp, jm, jv = fused_adamw_update(jnp.asarray(p, jdt), jnp.asarray(g, jdt),
                                    jnp.asarray(m), jnp.asarray(v), step=3,
                                    interpret=True, **kw)
    tp = torch.tensor(p).to(dtype)
    tg = torch.as_tensor(g).to(dtype)
    tm, tv = torch.as_tensor(m).clone(), torch.as_tensor(v).clone()
    fused_adamw(tp, tg, tm, tv, step=3, **kw)     # CPU: the plain version
    _close(tp, np.asarray(jp, np.float32), dtype)
    _close(tm, jm)
    _close(tv, jv)
    assert fused_adamw.launches == 0


@pytest.fixture(scope="module")
def problem():
    """Parameters {"w": f32 [5, 7], "b": bf16 [13]} and 3 steps of
    gradients (bf16 for the bf16 entry), as numpy."""
    rs = np.random.RandomState(1)
    params = {"w": rs.randn(5, 7).astype(np.float32),
              "b": rs.randn(13).astype(np.float32)}
    dtypes = {"w": torch.float32, "b": torch.bfloat16}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, dtypes, grads


def _jax_run(opt, params, dtypes, grads):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    p = {k: jnp.asarray(v, jdt[dtypes[k]]) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        gj = {k: jnp.asarray(v, jdt[dtypes[k]]) for k, v in g.items()}
        p, state = opt.update(gj, state, p)
    return p, state


@pytest.fixture(scope="module")
def jax_adamw(problem):
    return _jax_run(JaxAdamW(learning_rate=1e-3, weight_decay=0.01,
                             multi_precision=True), *problem)


def _port_run(cls, params, dtypes, grads):
    mod = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.tensor(v).to(dtypes[k]))
        for k, v in params.items()})
    opt = cls(learning_rate=1e-3, weight_decay=0.01, multi_precision=True,
              parameters=mod)
    for g in grads:
        opt.step({k: torch.as_tensor(v).to(dtypes[k]) for k, v in g.items()})
    return mod, opt.state


def _compare(mod, state, jp, jstate, dtypes, rtol=F32["rtol"]):
    assert state["step"] == int(jstate["step"]) == 3
    for k, dtype in dtypes.items():
        assert mod[k].dtype == dtype
        _close(mod[k].detach(), np.asarray(jp[k], np.float32), dtype, rtol)
        for slot in ("moment1", "moment2"):
            _close(state["slots"][k][slot], jstate["slots"][k][slot],
                   rtol=rtol)
        jm = jstate["master"][k]
        if dtype == torch.float32:
            assert jm is None and state["master"][k] is None
        else:
            assert state["master"][k].dtype == torch.float32
            _close(state["master"][k], jm, rtol=rtol)


@pytest.mark.parametrize("cls", [AdamW, FusedAdamW],
                         ids=["AdamW", "FusedAdamW"])
def test_port_optimizers_match_jax_adamw(problem, jax_adamw, cls):
    """Both of the port's optimizers against the JAX AdamW (their
    semantics are equal without apply_decay_param_fun)."""
    mod, state = _port_run(cls, *problem)
    _compare(mod, state, *jax_adamw, problem[1],
             rtol=2e-5 if cls is FusedAdamW else F32["rtol"])


def test_fused_adamw_matches_jax_fused_adamw(problem):
    """The port's FusedAdamW against the JAX FusedAdamW (its per-tensor
    Pallas kernel in interpret mode)."""
    jp, jstate = _jax_run(JaxFusedAdamW(learning_rate=1e-3,
                                        weight_decay=0.01,
                                        multi_precision=True), *problem)
    mod, state = _port_run(FusedAdamW, *problem)
    _compare(mod, state, jp, jstate, problem[1])


def test_optimizer_refuses_what_is_not_ported():
    """``grad_clip`` and schedulers are ported: what is refused now is a
    clip that is no clipper and a rate that is neither a float nor a
    scheduler."""
    with pytest.raises(TypeError, match="ClipGradByGlobalNorm"):
        AdamW(learning_rate=1e-3, grad_clip=object())
    with pytest.raises(TypeError, match="LRScheduler"):
        FusedAdamW(learning_rate=object())
    with pytest.raises(ValueError, match="bind"):
        AdamW(learning_rate=1e-3).step()


def test_apply_decay_param_fun_and_clear_grad():
    """A name the filter excludes is not decayed (zero gradient: an
    excluded parameter stays put, a decayed one shrinks by lr * wd),
    with either optimizer; clear_grad drops the gradients."""
    for cls in (AdamW, FusedAdamW):
        mod = torch.nn.ParameterDict({
            "w": torch.nn.Parameter(torch.ones(4)),
            "bias": torch.nn.Parameter(torch.ones(4))})
        opt = cls(learning_rate=0.1, weight_decay=0.5, parameters=mod,
                  apply_decay_param_fun=lambda n: not n.endswith("bias"))
        for p in mod.values():
            p.grad = torch.zeros(4)
        opt.step()
        torch.testing.assert_close(mod["w"].detach(), torch.full((4,), 0.95))
        torch.testing.assert_close(mod["bias"].detach(), torch.ones(4))
        opt.clear_grad()
        assert all(p.grad is None for p in mod.values())


def test_fused_adamw_low_copy_and_plain_version_agree():
    """``low`` receives the updated master cast to its dtype, in the same
    call, and the wrapper takes the plain version for CPU tensors."""
    rs = np.random.RandomState(2)
    p = torch.as_tensor(rs.randn(37).astype(np.float32))
    g = torch.as_tensor(rs.randn(37).astype(np.float32)).bfloat16()
    low = p.bfloat16()
    m, v = torch.zeros(37), torch.zeros(37)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    fused_adamw(p, g, m, v, lr=1e-2, weight_decay=0.1, step=1, low=low)
    fused_adamw_reference(p2, g, m2, v2, lr=1e-2, weight_decay=0.1, step=1)
    assert torch.equal(p, p2) and torch.equal(m, m2) and torch.equal(v, v2)
    assert torch.equal(low, p.bfloat16())
