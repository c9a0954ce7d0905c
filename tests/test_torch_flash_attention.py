"""Flash attention in the PyTorch port (paddle_tpu_torch/kernels/
flash_attention.py) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, on identical numpy inputs.

On CPU tensors each wrapper takes its plain version, so this holds the
plain forward (out, lse), dq and dk/dv — the decomposition the CUDA
kernels compute on the card — to ``_flash_fwd`` / ``_flash_bwd``, and the
port's autograd path to ``jax.grad`` of ``flash_attention``.  Cases: causal
with Sq = Sk, Sq < Sk, and Sq > Sk (rows that see no key: out 0, lse
-inf, finite gradients).  Float32 throughout; atol 1e-5 (the two
frameworks sum in different orders; the values are O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import (_flash_bwd, _flash_fwd,
                                                flash_attention as
                                                jax_flash_attention)
from paddle_tpu.nn.functional.attention import \
    sdpa_reference as jax_sdpa_reference
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_fwd)
from paddle_tpu_torch.nn.functional import (scaled_dot_product_attention,
                                            sdpa_reference)

ATOL = 1e-5
B, H, D = 1, 2, 64
BLOCK = 16
CASES = {"sq_eq_sk": (32, 32), "sq_lt_sk": (16, 48), "sq_gt_sk": (48, 16)}


def _to3(x):
    """[B, S, H, D] -> the reference kernels' [B*H, S, D]."""
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from3(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One causal case through the JAX kernels (interpret mode): inputs,
    (out, lse) of ``_flash_fwd`` and (dq, dk, dv) of ``_flash_bwd`` on the
    same residuals and cotangent."""
    sq, sk = CASES[request.param]
    rs = np.random.RandomState(sq * 100 + sk)
    q = rs.randn(B, sq, H, D).astype(np.float32)
    k = rs.randn(B, sk, H, D).astype(np.float32)
    v = rs.randn(B, sk, H, D).astype(np.float32)
    g = rs.randn(B, sq, H, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    q3, k3, v3 = (jnp.asarray(_to3(x)) for x in (q, k, v))
    out3, lse3 = _flash_fwd(q3, k3, v3, scale, True, BLOCK, BLOCK, True)
    dq3, dk3, dv3 = _flash_bwd((q3, k3, v3, out3, lse3),
                               jnp.asarray(_to3(g)), scale, True, BLOCK,
                               BLOCK, True)
    want = {"out": _from3(out3, B, H),
            "lse": np.asarray(lse3).reshape(B, H, sq),
            "dq": _from3(dq3, B, H), "dk": _from3(dk3, B, H),
            "dv": _from3(dv3, B, H)}
    return request.param, (q, k, v, g), want


def _port_fwd_bwd(q, k, v, g):
    tq, tk, tv, tg = (torch.as_tensor(x) for x in (q, k, v, g))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    delta = (tg * out).sum(-1).transpose(1, 2)
    dq = flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, causal=True)
    dk, dv = flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta, causal=True)
    return out, lse, dq, dk, dv


def test_plain_forward_matches_pallas_interpret(case):
    name, (q, k, v, g), want = case
    out, lse, *_ = _port_fwd_bwd(q, k, v, g)
    np.testing.assert_allclose(out.numpy(), want["out"], atol=ATOL)
    np.testing.assert_array_equal(np.isinf(lse.numpy()),
                                  np.isinf(want["lse"]))
    np.testing.assert_allclose(lse.numpy(), want["lse"], atol=ATOL)
    if name == "sq_gt_sk":
        # the first Sq - Sk query rows see no key
        blind = CASES[name][0] - CASES[name][1]
        assert np.all(out.numpy()[:, :blind] == 0.0)
        assert np.all(np.isneginf(lse.numpy()[:, :, :blind]))


def test_plain_dq_dkv_match_pallas_interpret(case):
    _, (q, k, v, g), want = case
    _, _, dq, dk, dv = _port_fwd_bwd(q, k, v, g)
    for got, key in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        assert np.all(np.isfinite(got.numpy())), key
        np.testing.assert_allclose(got.numpy(), want[key], atol=ATOL,
                                   err_msg=key)


def test_autograd_matches_jax_grad_gqa_rows_without_keys():
    """The port's flash_attention autograd path against jax.grad of the
    reference's flash_attention(interpret=True): grouped-query heads (4
    query heads over 2 kv heads) and Sq > Sk (rows that see no key)."""
    rs = np.random.RandomState(7)
    sq, sk = 48, 32
    q = rs.randn(1, sq, 4, D).astype(np.float32)
    k = rs.randn(1, sk, 2, D).astype(np.float32)
    v = rs.randn(1, sk, 2, D).astype(np.float32)
    w = rs.randn(1, sq, 4, D).astype(np.float32)

    def jloss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(out * w)
    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    loss = (flash_attention(tq, tk, tv, causal=True) * torch.as_tensor(w)
            ).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    for t, jg, name in zip((tq, tk, tv), jgrads, "qkv"):
        assert t.grad.shape == t.shape
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, err_msg=f"d{name}")


def test_sdpa_matches_jax_sdpa_reference():
    """scaled_dot_product_attention (flash path) and the port's dense
    sdpa_reference against the reference's sdpa_reference, causal with
    Sq < Sk and grouped-query heads, where every row sees a key (the dense
    form's f32-minimum mask then equals the flash kernels' -inf)."""
    sq, sk, kh = 16, 48, 1
    rs = np.random.RandomState(3)
    q = rs.randn(2, sq, 2, D).astype(np.float32)
    k = rs.randn(2, sk, kh, D).astype(np.float32)
    v = rs.randn(2, sk, kh, D).astype(np.float32)
    want = np.asarray(jax_sdpa_reference(
        *(jnp.asarray(x) for x in (q, k, v)), is_causal=True))
    args = [torch.as_tensor(x) for x in (q, k, v)]
    np.testing.assert_allclose(
        scaled_dot_product_attention(*args, is_causal=True).numpy(), want,
        atol=ATOL)
    np.testing.assert_allclose(
        sdpa_reference(*args, is_causal=True).numpy(), want, atol=ATOL)


def test_sdpa_refuses_mask_and_training_dropout():
    """The flash path takes neither an ``attn_mask`` nor dropout in
    training: such calls take the dense form (counted in ``dense_calls``),
    and dropout there needs an explicit generator (it raises without
    one).  Dropout outside training is a no-op on the flash path, as in
    the reference."""
    x = torch.zeros(1, 4, 2, 64)
    scaled_dot_product_attention.dense_calls = 0
    out = scaled_dot_product_attention(x, x, x,
                                       attn_mask=torch.ones(4, 4).bool())
    assert out.shape == x.shape
    assert scaled_dot_product_attention.dense_calls == 1
    with pytest.raises(ValueError, match="generator"):
        scaled_dot_product_attention(x, x, x, dropout_p=0.1)
    assert scaled_dot_product_attention.dense_calls == 2
    out = scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                       training=False)
    assert out.shape == x.shape
    assert scaled_dot_product_attention.dense_calls == 2


@pytest.mark.parametrize("name", ("flash_attention_fwd",
                                  "flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv"))
def test_tma_layout_check_is_shared_by_the_16_bit_kernels(name):
    """The 16-bit forward, dq and dkv read q/k/v (and dO) through TMA
    tensor maps, so each refuses, with one message, a layout TMA cannot
    address (a dim of more than one row with a zero byte stride), and
    takes strided views of a fused QKV projection."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    qkv = torch.zeros(2, 8, 3, 2, 64, dtype=torch.bfloat16)
    fa._check_tma(name, [("q", qkv[:, :, 0]), ("dout", qkv[:, :, 1])])
    broadcast = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16).expand(
        2, 8, 2, 64)
    with pytest.raises(ValueError, match=f"{name}: dout's stride 0 in dim 0 "
                                         f"cannot be read by TMA"):
        fa._check_tma(name, [("q", qkv[:, :, 0]), ("dout", broadcast)])


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On a card: each of the three kernels against its plain version,
    causal and not, f32 / bf16 / f16, head_dim 64 and 128, at the
    forward's 128-row tile edges (Sq = Sk of 127, 128, 129 and 257), Sq <
    Sk and Sq > Sk (rows that see no key when causal: out 0, lse -inf),
    GQA with 2 and 4 query heads a kv head, and q/k/v as strided views of
    one fused QKV tensor.  Max abs error over max(1, max |plain|): f32
    1e-5 (summation order), 16-bit 2e-2 (the output cast and the 16-bit P
    and dS of the second products); 16-bit elements each within 2 ulps of
    itself + 2 ulps of its row's largest + 1e-4, lse within 1e-4 relative
    (``chip_smoke.check_pairs``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
        flash_attention_fwd_reference)
    rs = np.random.RandomState(0)

    def r(*shape, dtype):
        return torch.as_tensor(rs.randn(*shape)).to("cuda", dtype)
    # (Sq, Sk, H, KVH, fused QKV views)
    shapes = ((127, 127, 4, 1, False), (128, 128, 4, 2, False),
              (129, 129, 4, 1, False), (257, 257, 4, 2, False),
              (129, 257, 4, 1, False), (257, 127, 4, 2, False),
              (192, 64, 4, 2, False), (257, 257, 4, 4, True))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (64, 128):
            for sq, sk, h, kvh, fused in shapes:
                if fused:
                    qkv = r(2, sq, 3, h, d, dtype=dtype)
                    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                else:
                    q = r(2, sq, h, d, dtype=dtype)
                    k, v = (r(2, sk, kvh, d, dtype=dtype) for _ in range(2))
                g = r(2, sq, h, d, dtype=dtype)
                for causal in (True, False):
                    out, lse = flash_attention_fwd(q, k, v, causal=causal)
                    ro, rl = flash_attention_fwd_reference(q, k, v,
                                                           causal=causal)
                    delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
                    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                causal=causal)
                    rdq = flash_attention_bwd_dq_reference(
                        q, k, v, g, lse, delta, causal=causal)
                    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                     causal=causal)
                    rdk, rdv = flash_attention_bwd_dkv_reference(
                        q, k, v, g, lse, delta, causal=causal)
                    torch.cuda.synchronize()
                    what = (f"{dtype} D={d} Sq={sq} Sk={sk} H={h} KVH={kvh} "
                            f"fused={fused} causal={causal}")
                    chip_smoke.check_pairs(what, dtype, ((out, ro),),
                                           ((lse, rl),))
                    chip_smoke.check_pairs(what, dtype, ((dq, rdq),
                                                         (dk, rdk),
                                                         (dv, rdv)))
                    if causal and sq > sk:
                        assert not bool(out[:, :sq - sk].any()), what
                        assert bool(torch.isneginf(
                            lse[:, :, :sq - sk]).all()), what


@pytest.mark.cuda
def test_kernels_launch_on_every_device():
    """The 16-bit forward, dq and dk/dv kernels (each takes more than 48 KB
    of dynamic shared memory, an attribute held per device) on every
    visible card, each held to its plain version as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv_reference, flash_attention_bwd_dq_reference,
        flash_attention_fwd_reference)
    rs = np.random.RandomState(0)
    for i in range(torch.cuda.device_count()):
        q, k, v, g = (torch.as_tensor(rs.randn(2, 257, 4, 128)).to(
            torch.device("cuda", i), torch.bfloat16) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, causal=True)
        ro, rl = flash_attention_fwd_reference(q, k, v, causal=True)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, causal=True)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal=True)
        rdq = flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                               causal=True)
        rdk, rdv = flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                     causal=True)
        what = f"cuda:{i}"
        assert out.device == q.device, what
        chip_smoke.check_pairs(what, torch.bfloat16, ((out, ro),),
                               ((lse, rl),))
        chip_smoke.check_pairs(what, torch.bfloat16,
                               ((dq, rdq), (dk, rdk), (dv, rdv)))
