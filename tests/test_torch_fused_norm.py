"""The fused-norm kernels of the PyTorch port (paddle_tpu_torch/kernels/
fused_norm.py) against the JAX package's Pallas kernels on the CPU.

The JAX side is ``fused_rms_norm_pallas`` / ``fused_layer_norm_pallas``
in interpret mode (forward kernels 7 and 9) and their ``jax.grad``
(backward kernels 8 and 10, whose dw / db accumulate across the grid),
with ``block_rows`` forcing a multi-block grid, and a 1-row input.  The
port side is ``RMSNormFunction`` / ``LayerNormFunction`` on CPU tensors,
i.e. the kernels' plain versions through the same forward/backward
decomposition the card runs.

Two tests model a CUDA kernel's summation order in numpy (the LayerNorm
forward's rows; the backward's rows, dw / db column partials and column
sum on its launch plan) and hold it within the card's limit of the plain
version.

Tolerances, relative to ``scale = max(1, max |want|)``: f32 outputs and
gradients at 1e-5 (the two frameworks sum rows in different orders);
bfloat16 outputs within one bf16 ulp of the JAX value beyond that same
f32 error (both round the same f32 arithmetic once, so a value near a
rounding boundary may land one ulp apart); dw / db at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as jax_incubate
from paddle_tpu.kernels.fused_norm import (fused_layer_norm_pallas,
                                           fused_rms_norm_pallas)
from paddle_tpu.nn import functional as jax_F
from paddle_tpu_torch.incubate.nn import functional as incubate
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.nn import functional as F

EPS = 1e-5
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}
_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}


def _ok(got, want, rel, dtype):
    """``|got - want| <= rel * scale`` (+ one output ulp in a 16-bit
    ``dtype``)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    tol = rel * scale
    if dtype in _MANTISSA:
        tol = tol + np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                        1e-30)))
                            - _MANTISSA[dtype])
    err = np.abs(got - want) - tol
    assert (err <= 0).all(), f"max excess {err.max()} (scale {scale})"


def _inputs(rows, h, dtype, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, h).astype(np.float32) * 2 + 0.5
    w = rs.randn(h).astype(np.float32) * 0.5 + 1
    b = rs.randn(h).astype(np.float32) * 0.3
    g = rs.randn(rows, h).astype(np.float32)
    # round through the dtype once so both frameworks see the same values
    cast = [torch.as_tensor(a).to(dtype) for a in (x, w, b, g)]
    return cast, [jnp.asarray(t.float().numpy()).astype(_JDT[dtype])
                  for t in cast]


def _torch_run(fn_, args, g):
    leaves = [a.clone().requires_grad_() for a in args]
    y = fn_(*leaves)
    y.backward(g)
    return y.detach(), [a.grad for a in leaves]


# (rows, h, JAX block_rows): a multi-block JAX grid, one row, a wide row
CASES = [(32, 256, 8), (1, 128, None), (16, 1024, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,h,block", CASES)
def test_rms_norm_matches_pallas(rows, h, block, dtype):
    (x, w, _, g), (jx, jw, _, jg) = _inputs(rows, h, dtype, seed=rows + h)

    def jfn(x_, w_):
        return fused_rms_norm_pallas(x_, w_, EPS, interpret=True,
                                     block_rows=block)
    want = jax.jit(jfn)(jx, jw)
    jdx, jdw = jax.jit(jax.grad(lambda a, c: jnp.sum(
        jfn(a, c).astype(jnp.float32) * jg.astype(jnp.float32)),
        argnums=(0, 1)))(jx, jw)
    y, (dx, dw) = _torch_run(
        lambda a, c: fn.RMSNormFunction.apply(a, c, EPS), (x, w), g)
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == dtype
    _ok(y.float(), want.astype(jnp.float32), 1e-5, dtype)
    _ok(dx.float(), jdx.astype(jnp.float32), 1e-5, dtype)
    _ok(dw.float(), jdw.astype(jnp.float32), 1e-4, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,h,block", CASES)
def test_layer_norm_matches_pallas(rows, h, block, dtype):
    (x, w, b, g), (jx, jw, jb, jg) = _inputs(rows, h, dtype, seed=rows * h)

    def jfn(x_, w_, b_):
        return fused_layer_norm_pallas(x_, w_, b_, EPS, interpret=True,
                                       block_rows=block)
    want = jax.jit(jfn)(jx, jw, jb)
    jdx, jdw, jdb = jax.jit(jax.grad(lambda a, c, d: jnp.sum(
        jfn(a, c, d).astype(jnp.float32) * jg.astype(jnp.float32)),
        argnums=(0, 1, 2)))(jx, jw, jb)
    y, (dx, dw, db) = _torch_run(
        lambda a, c, d: fn.LayerNormFunction.apply(a, c, d, EPS),
        (x, w, b), g)
    assert y.dtype == dtype and dw.dtype == dtype and db.dtype == dtype
    _ok(y.float(), want.astype(jnp.float32), 1e-5, dtype)
    _ok(dx.float(), jdx.astype(jnp.float32), 1e-5, dtype)
    _ok(dw.float(), jdw.astype(jnp.float32), 1e-4, dtype)
    _ok(db.float(), jdb.astype(jnp.float32), 1e-4, dtype)


def _ln_rows_model(x, w, b, n):
    """y, mean, rstd of ``ln_fwd_rows_kernel`` (csrc/fused_norm.cu) in
    its summation order, f32 numpy: a row of h = groups x n elements is
    split over tpr threads (the least power of two with tpr x vpt >=
    groups; vpt 4 groups a thread up to 512 groups, else 8), thread t
    holding groups t, t + tpr, ...; each thread adds its groups' elements
    in order, then an xor shuffle tree over min(tpr, 32) lanes, then the
    row's warps in order.  The variance adds ``fma(d, d, acc)``, as the
    compiler contracts ``acc += d * d``."""
    rows, h = x.shape
    groups = h // n
    vpt = 4 if groups <= 512 else 8
    tpr = 1
    while tpr * vpt < groups:
        tpr *= 2
    held = np.arange(vpt * tpr)[None, :, None] < groups   # [1, slot, 1]

    def layout(t):                                        # [rows, j, t, n]
        pad = np.zeros((rows, vpt * tpr * n), np.float32)
        pad[:, :h] = t
        return pad.reshape(rows, vpt, tpr, n), held.reshape(1, vpt, tpr, 1)

    def tree(s):                                          # [rows, tpr]
        lanes = min(tpr, 32)
        off = lanes // 2
        while off:
            s = (s + s[:, np.arange(tpr) ^ off]).astype(np.float32)
            off //= 2
        total = np.zeros(rows, np.float32)
        for warp in range(max(1, tpr // 32)):
            total = (total + s[:, warp * 32]).astype(np.float32)
        return total

    xs, mask = layout(x)
    s = np.zeros((rows, tpr), np.float32)
    for j in range(vpt):
        for e in range(n):
            s = (s + xs[:, j, :, e]).astype(np.float32)
    mu = (tree(s) / np.float32(h)).astype(np.float32)
    d = np.where(mask, xs - mu[:, None, None, None], 0).astype(np.float32)
    s = np.zeros((rows, tpr), np.float32)
    for j in range(vpt):
        for e in range(n):
            dd = d[:, j, :, e].astype(np.float64)
            s = (dd * dd + s.astype(np.float64)).astype(np.float32)
    var = (tree(s) / np.float32(h)).astype(np.float32)
    rstd = (1 / np.sqrt(var.astype(np.float64) + EPS)).astype(np.float32)
    y = ((x - mu[:, None]) * rstd[:, None] * w + b).astype(np.float32)
    return y, mu, rstd


# (h, elements a 16-byte group): 512 bf16 groups (128 threads a row, 4
# groups each), 96 (32 x 3 of 4), 8 (2 x 4), the scalar instantiation at
# 1000 and 777 (128 x 8, 7), f32 at 4096 (1024 groups, 128 x 8)
@pytest.mark.parametrize("h,n,dtype", [
    (4096, 8, torch.bfloat16), (768, 8, torch.bfloat16),
    (64, 8, torch.bfloat16), (1000, 1, torch.bfloat16),
    (777, 1, torch.bfloat16), (4096, 4, torch.float32)])
def test_ln_fwd_row_order_model_within_the_limit(h, n, dtype):
    """The LayerNorm forward kernel sums each row in another order than
    the plain version: in that order y stays within the card's limit of
    it (``chip_smoke.norm_excess``: 1e-5 x max(1, max |plain|), plus one
    output ulp in bf16), and so do mean and rstd."""
    (x, w, b, _), _ = _inputs(5, h, dtype, seed=h)
    y32, mu, rstd = _ln_rows_model(x.float().numpy(), w.float().numpy(),
                                   b.float().numpy(), n)
    want, wmu, wrstd = fn.layer_norm_fwd_reference(x, w, b, EPS)
    _ok(torch.as_tensor(y32).to(dtype).float(), want.float(), 1e-5, dtype)
    _ok(mu, wmu[:, 0], 1e-5, torch.float32)
    _ok(rstd, wrstd[:, 0], 1e-5, torch.float32)


def _bwd_model(x, w, mean, rstd, g, n, per_card, rms):
    """dx, dw (and db) of the backward kernels (csrc/fused_norm.cu) in
    their summation order, f32 numpy, on the launch ``fn.bwd_plan``
    gives: a row split over tpr threads (the long-row kernel: 512 threads,
    a row a block at a time), thread t holding groups t, t + tpr, ...;
    each thread adds fma(g·w, x̂, s) (and g·w) over its groups' elements
    in order, then an xor shuffle tree over min(tpr, 32) lanes, then the
    row's warps in order.  Segment s of block b walks rows b·R + s + k·
    stride (R = 512 / tpr, stride = blocks·R), adding fma(g, x̂, acc) (and
    g) per column; the block adds its segments in order; the column sum's
    16 warps add blocks k, k + 16, ... in order, then the warps in order.
    The fma is computed in f64 and rounded once to f32."""
    f32, f64 = np.float32, np.float64
    rows, h = x.shape
    groups = h // n
    tpr_log2, blocks = fn.bwd_plan(rows, h, n, per_card)
    if tpr_log2 < 0:
        tpr, vpt, per_block = 512, -(-groups // 512), 1
    else:
        tpr, vpt, per_block = 1 << tpr_log2, 2 if n > 1 else 8, \
            512 >> tpr_log2
    xhat = ((x - mean) * rstd).astype(f32)
    gw = (g * w).astype(f32)

    def fma(a, b, c):
        return (a.astype(f64) * b + c.astype(f64)).astype(f32)

    def layout(t):                                        # [rows, j, t, n]
        pad = np.zeros((rows, vpt * tpr * n), f32)
        pad[:, :h] = t
        return pad.reshape(rows, vpt, tpr, n)

    def tree(s):                                          # [rows, tpr]
        off = min(tpr, 32) // 2
        while off:
            s = (s + s[:, np.arange(tpr) ^ off]).astype(f32)
            off //= 2
        total = s[:, 0]
        if tpr > 32:
            total = np.zeros(rows, f32)
            for warp in range(tpr // 32):
                total = (total + s[:, warp * 32]).astype(f32)
        return total

    xs, gws = layout(xhat), layout(gw)
    s0 = np.zeros((rows, tpr), f32)
    s1 = np.zeros((rows, tpr), f32)
    for j in range(vpt):
        for e in range(n):
            s0 = fma(gws[:, j, :, e], xs[:, j, :, e], s0)
            s1 = (s1 + gws[:, j, :, e]).astype(f32)
    mean_gx = (tree(s0) / f32(h)).astype(f32)[:, None]
    inner = (gw - (xhat * mean_gx).astype(f32)).astype(f32) if rms else (
        ((gw - (tree(s1) / f32(h)).astype(f32)[:, None]).astype(f32)
         - (xhat * mean_gx).astype(f32)).astype(f32))
    dx = (rstd * inner).astype(f32)

    stride = blocks * per_block
    turns = -(-rows // stride)

    def column_sums(v):
        acc = np.zeros((stride, h), f32)                  # [segment slot, h]
        for k in range(turns):
            r = np.arange(k * stride, min(rows, (k + 1) * stride))
            acc[r - k * stride] = v(r, acc[r - k * stride])
        part = acc[0::per_block].copy()                   # [blocks, h]
        for seg in range(1, per_block):
            part = (part + acc[seg::per_block]).astype(f32)
        out = None
        for warp in range(16):
            red = np.zeros(h, f32)
            for blk in range(warp, blocks, 16):
                red = (red + part[blk]).astype(f32)
            out = red if out is None else (out + red).astype(f32)
        return out

    dw = column_sums(lambda r, acc: fma(g[r], xhat[r], acc))
    if rms:
        return dx, dw
    return dx, dw, column_sums(lambda r, acc: (acc + g[r]).astype(f32))


# (rows, h, elements a group, blocks that fit, the plan): 32 threads a
# row and 16 rows a block over 2 turns; 512 threads a row (f32 at 4096);
# the scalar instantiation (128 threads a row, 8 scalars each); the
# long-row kernel (4100 f32, 1025 groups); 2 threads a row, 256 rows a
# block in one
@pytest.mark.parametrize("rows,h,n,per_card,plan", [
    (37, 256, 4, 2, (5, 2)), (45, 4096, 4, 5, (9, 5)),
    (30, 1000, 1, 4, (7, 4)), (9, 4100, 4, 4, (-1, 3)),
    (70, 12, 4, 3, (1, 1))])
def test_norm_bwd_order_model_within_the_limit(rows, h, n, per_card, plan):
    """The backward kernels sum each row and each column of dw / db in
    another order than the plain versions: in that order (f32 inputs) dx,
    dw and db stay within the card's limit of them (``chip_smoke.
    norm_excess``: 1e-5 x max(1, max |plain|) for dx, 1e-4 for dw / db).
    The launch plan is pinned here, and at the train shape x [4096, 4096]
    bf16 (256 threads a row, 2 rows a block, 128 of 132 SMs' blocks over
    16 turns) and its scalar form."""
    assert fn.bwd_plan(4096, 4096, 8, 132) == (8, 128)
    assert fn.bwd_plan(4096, 4096, 1, 132) == (9, 128)
    assert fn.bwd_plan(rows, h, n, per_card) == plan
    (x, w, b, g), _ = _inputs(rows, h, torch.float32, seed=h + rows)
    _, rstd = fn.rms_norm_fwd_reference(x, w, EPS)
    _, mean, lrstd = fn.layer_norm_fwd_reference(x, w, b, EPS)
    xn, wn, gn = x.numpy(), w.numpy(), g.numpy()
    for got, want in (
            (_bwd_model(xn, wn, np.float32(0), rstd.numpy(), gn, n,
                        per_card, True), fn.rms_norm_bwd_reference(
                            x, w, rstd, g)),
            (_bwd_model(xn, wn, mean.numpy(), lrstd.numpy(), gn, n,
                        per_card, False), fn.layer_norm_bwd_reference(
                            x, w, mean, lrstd, g))):
        assert len(got) == len(want)
        for i, (a, c) in enumerate(zip(got, want)):
            _ok(a, c, 1e-5 if i == 0 else 1e-4, torch.float32)


def test_saved_statistics_and_f32_weight_on_half_input():
    """The forward wrappers' statistics are f32 [rows, 1]; a float32
    weight on a bfloat16 input keeps y in bf16 and dw in f32."""
    (x, _, _, g), _ = _inputs(5, 64, torch.bfloat16, seed=3)
    w = torch.linspace(0.5, 1.5, 64)
    y, rstd = fn.rms_norm_fwd(x, w, EPS)
    assert y.dtype == torch.bfloat16 and rstd.shape == (5, 1)
    want = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + EPS)
    torch.testing.assert_close(rstd, want, rtol=1e-6, atol=0)
    dx, dw = fn.rms_norm_bwd(x, w, rstd, g)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _, mean, rstd = fn.layer_norm_fwd(x, w, torch.zeros(64), EPS)
    torch.testing.assert_close(mean, x.float().mean(-1, keepdim=True))
    assert rstd.dtype == torch.float32 and rstd.shape == (5, 1)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match=r"x \[rows, h\]"):
        fn.rms_norm_fwd(x[None], torch.ones(32), EPS)
    with pytest.raises(ValueError, match=r"w must be \[32\]"):
        fn.rms_norm_fwd(x, torch.ones(31), EPS)
    with pytest.raises(ValueError, match="x's dtype"):
        fn.layer_norm_fwd(x, torch.ones(32, dtype=torch.bfloat16),
                          torch.zeros(32, dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError, match="b is"):
        fn.layer_norm_fwd(x.bfloat16(), torch.ones(32, dtype=torch.bfloat16),
                          torch.zeros(32), EPS)
    with pytest.raises(ValueError, match=r"rstd must be float32 \[4, 1\]"):
        fn.rms_norm_bwd(x, torch.ones(32), torch.ones(4), x)
    with pytest.raises(ValueError, match="unsupported x dtype"):
        fn.rms_norm_fwd(x.double(), torch.ones(32).double(), EPS)


def test_functionals_route_the_affine_form_and_keep_the_rest():
    """``layer_norm`` / ``rms_norm`` on the kernels' form go through the
    autograd Functions (no new launches on the CPU); ``layer_norm``'s
    other forms take the reference's XLA form on the CPU and match it;
    ``rms_norm`` has no other form and refuses one."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 48).astype(np.float32)
    w = rs.randn(48).astype(np.float32)
    b = rs.randn(48).astype(np.float32)
    tx, tw, tb = (torch.as_tensor(a) for a in (x, w, b))
    for got, want in (
            (F.layer_norm(tx, 48, tw, tb),
             jax_F.layer_norm(jnp.asarray(x), 48, jnp.asarray(w),
                              jnp.asarray(b))),
            (F.layer_norm(tx, (3, 48)),
             jax_F.layer_norm(jnp.asarray(x), (3, 48))),
            (F.rms_norm(tx, tw, epsilon=EPS),
             jax_F.rms_norm(jnp.asarray(x), jnp.asarray(w), epsilon=EPS)),
            (incubate.fused_rms_norm(tx, tw, epsilon=EPS),
             jax_incubate.fused_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                         epsilon=EPS)),
            (incubate.fused_layer_norm(tx, tw, tb, residual=tx),
             jax_incubate.fused_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b),
                                           residual=jnp.asarray(x))),
            (incubate.swiglu(tx), jax_incubate.swiglu(jnp.asarray(x)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    assert fn.rms_norm_fwd.launches == 0 and fn.layer_norm_fwd.launches == 0
    # rms_norm has the kernel's form only
    with pytest.raises(ValueError, match="weight"):
        F.rms_norm(tx, None)
    with pytest.raises(NotImplementedError, match="norm_bias"):
        incubate.fused_rms_norm(tx, tw, tb)
    with pytest.raises(NotImplementedError, match="begin_norm_axis"):
        incubate.fused_rms_norm(tx, tw, begin_norm_axis=1)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Each of the four kernels against its plain version on the card:
    vector and scalar paths, every dtype pair, one row to many."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for dtype, wdt in ((torch.float32, torch.float32),
                       (torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32),
                       (torch.float16, torch.float16)):
        for rows, h in ((1, 64), (3, 777), (300, 1000), (64, 4096)):
            (x, w, b, g), _ = _inputs(rows, h, dtype, seed=h)
            x, g = x.to(dev), g.to(dev)
            w, b = w.to(dev, wdt), b.to(dev, wdt)
            y, rstd = fn.rms_norm_fwd(x, w, EPS)
            ry, rrstd = fn.rms_norm_fwd_reference(x, w, EPS)
            dx, dw = fn.rms_norm_bwd(x, w, rrstd, g)
            rdx, rdw = fn.rms_norm_bwd_reference(x, w, rrstd, g)
            ly, mean, lrstd = fn.layer_norm_fwd(x, w, b, EPS)
            rly, rmean, rlrstd = fn.layer_norm_fwd_reference(x, w, b, EPS)
            ldx, ldw, ldb = fn.layer_norm_bwd(x, w, rmean, rlrstd, g)
            rldx, rldw, rldb = fn.layer_norm_bwd_reference(x, w, rmean,
                                                           rlrstd, g)
            torch.cuda.synchronize()
            for got, want, rel in ((y, ry, 1e-5), (dx, rdx, 1e-5),
                                   (ly, rly, 1e-5), (ldx, rldx, 1e-5),
                                   (rstd, rrstd, 1e-5), (mean, rmean, 1e-5),
                                   (lrstd, rlrstd, 1e-5), (dw, rdw, 1e-4),
                                   (ldw, rldw, 1e-4), (ldb, rldb, 1e-4)):
                _ok(got.float().cpu(), want.float().cpu(), rel, got.dtype)
