"""The fused decode block in the PyTorch port (paddle_tpu_torch/kernels/
decode_block.py) against the JAX reference on the CPU.

The port's plain version is held against JAX ``decode_block_layer`` — the
Pallas kernel pair run in interpret mode, as the JAX package's own tests
run it on the CPU — on identical numpy inputs.  In float32 only the
summation order differs (atol/rtol 2e-5).  In bfloat16 the f32
projections summed in another order may round the stored K/V row
differently, so the slabs are held to one bf16 ulp and y to 2e-2.  The
CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
the plain version there, and so does the last test below, which skips
without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.decode_block import (
    decode_block_layer as jax_layer)
from paddle_tpu_torch.kernels.decode_block import (
    SMEM_BUDGET, decode_block_attn, decode_block_layer, decode_block_mlp,
    decode_block_reference, fusion_legal, plan_decode_block)

_WEIGHTS = ("norm1_w", "norm1_b", "wq", "wk", "wv", "bq", "bkv", "bv", "wo",
            "bo", "norm2_w", "norm2_b", "w1", "b1", "w2", "b2", "w_gate")


def _gpt_weights(rs, d, ffn):
    a = lambda *s: (rs.randn(*s) * 0.08).astype(np.float32)
    return dict(norm="layer", eps1=1e-5, eps2=1e-5,
                norm1_w=a(d) + 1, norm1_b=a(d),
                wq=a(d, d), wk=a(d, d), wv=a(d, d),
                bq=a(d), bkv=a(d), bv=a(d), wo=a(d, d), bo=a(d),
                norm2_w=a(d) + 1, norm2_b=a(d),
                w1=a(d, ffn), b1=a(ffn), w2=a(ffn, d), b2=a(d),
                act="gelu_tanh")


def _llama_weights(rs, d, h, kh, dh, ffn):
    a = lambda *s: (rs.randn(*s) * 0.08).astype(np.float32)
    return dict(norm="rms", eps1=1e-5, eps2=1e-5,
                norm1_w=a(d) + 1, norm1_b=None,
                wq=a(d, h * dh), wk=a(d, kh * dh), wv=a(d, kh * dh),
                bq=None, bkv=None, bv=None, wo=a(h * dh, d), bo=None,
                norm2_w=a(d) + 1, norm2_b=None,
                w1=a(d, ffn), b1=None, w2=a(ffn, d), b2=None,
                w_gate=a(d, ffn))


def _jax_args(kw, dtype):
    return {k: (jnp.asarray(v, dtype) if k in _WEIGHTS + ("rope_cos",
                                                          "rope_sin")
                and v is not None else v) for k, v in kw.items()}


def _torch_args(kw, dtype):
    return {k: (torch.as_tensor(np.asarray(v, np.float32)).to(dtype)
                if k in _WEIGHTS + ("rope_cos", "rope_sin")
                and v is not None else v) for k, v in kw.items()}


def _both(x, k, v, pos, kh, dh, kw, dtype="float32", jax_tiles=None,
          **tiles):
    """Run JAX decode_block_layer (interpret mode, at ``jax_tiles``) and the
    port's layer (at ``tiles``) on the same numpy inputs; returns numpy
    (y, k, v) of each in f32."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jk, jv = jax_layer(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                           jnp.asarray(v, jdt), jnp.asarray(pos),
                           kv_heads=kh, head_dim=dh, interpret=True,
                           **_jax_args(kw, jdt), **(jax_tiles or {}))
    tk = torch.as_tensor(k).to(tdt)
    tv = torch.as_tensor(v).to(tdt)
    ty, tk2, tv2 = decode_block_layer(
        torch.as_tensor(x).to(tdt), tk, tv, torch.as_tensor(pos),
        kv_heads=kh, head_dim=dh, **_torch_args(kw, tdt), **tiles)
    assert tk2 is tk and tv2 is tv                  # updated in place
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    return ((f32(jy), f32(jk), f32(jv)),
            (ty.float().numpy(), tk2.float().numpy(), tv2.float().numpy()))


def test_gpt_wiring_f32_ragged_pos():
    """LayerNorm, all biases, gelu_tanh, MHA over an empty (pos 0), a mid,
    a last-row (S-1) and a full (S) slot."""
    rs = np.random.RandomState(0)
    B, S, H, Dh = 4, 64, 4, 16
    D = H * Dh
    x = (rs.randn(B, 1, D) * 0.1).astype(np.float32)
    k = (rs.randn(B, S, H, Dh) * 0.1).astype(np.float32)
    v = (rs.randn(B, S, H, Dh) * 0.1).astype(np.float32)
    pos = np.array([0, 17, 63, 64], np.int32)
    want, got = _both(x, k, v, pos, H, Dh, _gpt_weights(rs, D, 4 * D))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


def test_bf16_gqa_rope_swiglu():
    """bf16 storage, GQA (2 q heads per kv head), rotary, SwiGLU — the
    Llama wiring."""
    rs = np.random.RandomState(1)
    B, S, H, KH, Dh, F = 3, 32, 4, 2, 16, 176
    D = H * Dh
    x = (rs.randn(B, 1, D) * 0.1).astype(np.float32)
    k = (rs.randn(B, S, KH, Dh) * 0.1).astype(np.float32)
    v = (rs.randn(B, S, KH, Dh) * 0.1).astype(np.float32)
    pos = np.array([0, 9, 31], np.int32)
    ang = rs.rand(B, Dh // 2).astype(np.float32)
    kw = _llama_weights(rs, D, H, KH, Dh, F)
    kw.update(rope_cos=np.concatenate([np.cos(ang)] * 2, -1),
              rope_sin=np.concatenate([np.sin(ang)] * 2, -1))
    (jy, jk, jv), (ty, tk, tv) = _both(x, k, v, pos, KH, Dh, kw,
                                       dtype="bfloat16")
    np.testing.assert_allclose(ty, jy, atol=2e-2, rtol=2e-2)
    for g, w in ((tk, jk), (tv, jv)):
        # one bf16 ulp: 2^-7 relative to the value's binade
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp)


def test_mixed_biases_and_scalar_pos():
    """Each bias is optional on its own, and a 0-d pos broadcasts to every
    row exactly like the uniform vector."""
    rs = np.random.RandomState(7)
    B, S, H, KH, Dh, F = 2, 32, 4, 2, 16, 64
    D = H * Dh
    a = lambda *s: (rs.randn(*s) * 0.08).astype(np.float32)
    kw = dict(norm="layer", eps1=1e-5, eps2=1e-5,
              norm1_w=a(D) + 1, norm1_b=a(D),
              wq=a(D, H * Dh), wk=a(D, KH * Dh), wv=a(D, KH * Dh),
              bq=a(H * Dh), bkv=None, bv=None, wo=a(H * Dh, D), bo=a(D),
              norm2_w=a(D) + 1, norm2_b=a(D),
              w1=a(D, F), b1=None, w2=a(F, D), b2=a(D))
    x, k, v = a(B, 1, D), a(B, S, KH, Dh), a(B, S, KH, Dh)
    want, got = _both(x, k, v, np.array([3, 17], np.int32), KH, Dh, kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)
    tkw = _torch_args(kw, torch.float32)
    outs = []
    for pos in (torch.tensor(5, dtype=torch.int32),
                torch.full((B,), 5, dtype=torch.int32)):
        tk, tv = torch.as_tensor(k).clone(), torch.as_tensor(v).clone()
        y, _, _ = decode_block_layer(torch.as_tensor(x), tk, tv, pos,
                                     kv_heads=KH, head_dim=Dh, **tkw)
        outs.append((y, tk, tv))
    for a_, b_ in zip(*outs):
        torch.testing.assert_close(a_, b_, atol=0, rtol=0)


def test_exact_gelu():
    rs = np.random.RandomState(4)
    B, S, H, Dh = 2, 32, 2, 16
    D = H * Dh
    x = (rs.randn(B, 1, D) * 0.1).astype(np.float32)
    k = (rs.randn(B, S, H, Dh) * 0.1).astype(np.float32)
    v = (rs.randn(B, S, H, Dh) * 0.1).astype(np.float32)
    kw = _gpt_weights(rs, D, 4 * D)
    kw["act"] = "gelu"
    want, got = _both(x, k, v, np.array([5, 30], np.int32), H, Dh, kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


def test_append_lands_only_at_clamped_position():
    rs = np.random.RandomState(2)
    B, S, KH, Dh, H = 3, 16, 2, 16, 2
    D = H * Dh
    x = (rs.randn(B, 1, D) * 0.1).astype(np.float32)
    k0 = rs.randn(B, S, KH, Dh).astype(np.float32)
    v0 = rs.randn(B, S, KH, Dh).astype(np.float32)
    kw = _torch_args(_llama_weights(rs, D, H, KH, Dh, 64), torch.float32)
    tk, tv = torch.as_tensor(k0).clone(), torch.as_tensor(v0).clone()
    decode_block_layer(torch.as_tensor(x), tk, tv,
                       torch.tensor([0, 5, 16], dtype=torch.int32),
                       kv_heads=KH, head_dim=Dh, **kw)
    for slab, before in ((tk.numpy(), k0), (tv.numpy(), v0)):
        for b, p in enumerate([0, 5, 15]):            # 16 clamps to 15
            assert not np.allclose(slab[b, p], before[b, p])
            np.testing.assert_array_equal(np.delete(slab[b], p, axis=0),
                                          np.delete(before[b], p, axis=0))


@pytest.mark.parametrize("tiles", [dict(block_k=8, block_f=512),
                                   dict(block_k=64, block_f=2048)])
def test_tiles_do_not_change_the_result(tiles):
    """block_k / block_f pick the kernels' tiles, never the function:
    each tiling equals the JAX pair run at its own (block_k=8) tiling."""
    rs = np.random.RandomState(3)
    B, S, KH, Dh, H = 2, 64, 2, 16, 2
    D = H * Dh
    x = (rs.randn(B, 1, D) * 0.1).astype(np.float32)
    k = (rs.randn(B, S, KH, Dh) * 0.1).astype(np.float32)
    v = (rs.randn(B, S, KH, Dh) * 0.1).astype(np.float32)
    kw = _llama_weights(rs, D, H, KH, Dh, 64)
    want, got = _both(x, k, v, np.array([33, 64], np.int32), KH, Dh, kw,
                      jax_tiles=dict(block_k=8), **tiles)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5)


def test_halves_compose_to_the_layer_and_the_reference():
    rs = np.random.RandomState(5)
    B, S, H, Dh = 2, 32, 2, 16
    D = H * Dh
    kw = _torch_args(_gpt_weights(rs, D, 4 * D), torch.float32)
    x = torch.as_tensor((rs.randn(B, 1, D) * 0.1).astype(np.float32))
    k = torch.as_tensor((rs.randn(B, S, H, Dh) * 0.1).astype(np.float32))
    v = torch.as_tensor((rs.randn(B, S, H, Dh) * 0.1).astype(np.float32))
    pos = torch.tensor([4, 20], dtype=torch.int32)
    before = decode_block_attn.launches, decode_block_mlp.launches
    y, k1, v1 = decode_block_layer(x, k.clone(), v.clone(), pos, kv_heads=H,
                                   head_dim=Dh, **kw)
    yr, k2, v2 = decode_block_reference(x, k.clone(), v.clone(), pos,
                                        kv_heads=H, head_dim=Dh, **kw)
    for a, b in ((y, yr), (k1, k2), (v1, v2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (decode_block_attn.launches, decode_block_mlp.launches) == before


# ------------------------------------------------------ planning / legality
def test_fusion_legal_named_refusals():
    base = dict(max_seq=64, hidden=64, heads=4, kv_heads=2, head_dim=16,
                ffn=176, batch=2)
    assert fusion_legal(dtype="float32", gated=True, **base) == (True, None)
    assert fusion_legal(dtype=torch.bfloat16, **base) == (True, None)
    for dtype in ("float16", torch.float16):
        ok, reason = fusion_legal(dtype=dtype, **base)
        assert not ok and "float16" in reason
    cases = [
        (dict(base, heads=3), "hidden"),
        (dict(base, kv_heads=3), "kv_heads"),
        (dict(base, hidden=60, heads=4, head_dim=15), "even"),
        (dict(base, hidden=48, heads=4, head_dim=12), "multiple of 8"),
        (dict(base, hidden=1056, heads=2, head_dim=528), "multiple of 8"),
        (dict(base, ffn=100), "ffn"),
    ]
    for kw, word in cases:
        ok, reason = fusion_legal(dtype="float32", **kw)
        assert not ok and word in reason, (kw, reason)
    # tp > 1: the sharded block's real checks (the reference's words)
    assert fusion_legal(dtype="float32", tp=2, **base) == (True, None)
    wide = dict(max_seq=64, hidden=128, heads=16, kv_heads=16, head_dim=8,
                ffn=184, batch=16)
    for kw, tp, word in ((dict(base, batch=3), 2, "batch 3 not divisible"),
                         (dict(base, kv_heads=1), 2, "kv_heads 1 not"),
                         (wide, 16, "ffn 184 not divisible")):
        ok, reason = fusion_legal(dtype="float32", tp=tp, **kw)
        assert not ok and word in reason \
            and f"tensor_parallel {tp}" in reason, (kw, reason)


def test_plan_shrinks_then_refuses_under_the_budget():
    """Tiles shrink to fit a tighter budget, and the figures are what the
    kernels allocate; below the irreducible residents the plan refuses
    with a reason starting "smem:"."""
    base = dict(max_seq=2048, hidden=768, heads=8, kv_heads=8,
                head_dim=96, ffn=3072, batch=8, itemsize=4)
    roomy, why = plan_decode_block(**base)
    assert why is None
    assert (roomy["block_k"], roomy["block_f"]) == (64, 2048)
    assert max(roomy["smem_attn"], roomy["smem_mlp"]) <= SMEM_BUDGET
    tight, why = plan_decode_block(smem_budget=40_000, **base)
    assert why is None
    assert tight["block_k"] < roomy["block_k"]
    assert tight["block_f"] < roomy["block_f"]
    assert max(tight["smem_attn"], tight["smem_mlp"]) <= 40_000
    plan, why = plan_decode_block(smem_budget=4096, **base)
    assert plan is None and why.startswith("smem:")
    ok, reason = fusion_legal(dtype="float32", smem_budget=4096,
                              **{k: v for k, v in base.items()
                                 if k != "itemsize"})
    assert not ok and reason.startswith("smem:")


def test_gpt3_6_7b_serving_shape_is_legal():
    """The TPU plan refuses this width (its out-projection must stay
    resident in VMEM); on Hopper the weights stream, so it is legal."""
    shape = dict(max_seq=2048, hidden=4096, heads=32, kv_heads=32,
                 head_dim=128, ffn=16384, batch=8)
    assert fusion_legal(dtype="bfloat16", **shape) == (True, None)
    plan, _ = plan_decode_block(itemsize=2, **shape)
    assert plan["block_k"] == 64 and plan["block_f"] == 2048
    assert max(plan["smem_attn"], plan["smem_mlp"]) <= SMEM_BUDGET


def test_kernel_wrappers_refuse_tensors_off_the_card():
    rs = np.random.RandomState(6)
    kw = _torch_args(_gpt_weights(rs, 32, 128), torch.float32)
    x = torch.zeros(2, 1, 32)
    k = torch.zeros(2, 16, 2, 16)
    with pytest.raises(ValueError, match="sq=1"):
        decode_block_attn(torch.zeros(2, 3, 32), k, k.clone(), 0,
                          kw["norm1_w"], kw["norm1_b"], kw["wq"], kw["wk"],
                          kw["wv"], kv_heads=2, head_dim=16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_block_attn(x.to("meta"), k.to("meta"), k.to("meta"), 0,
                          *(kw[n].to("meta") for n in ("norm1_w", "norm1_b",
                                                       "wq", "wk", "wv")),
                          kv_heads=2, head_dim=16)


@pytest.mark.cuda
def test_kernels_match_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rs = np.random.RandomState(8)
    B, S, H, KH, Dh, F = 4, 256, 8, 2, 64, 512
    D = H * Dh
    kw = _llama_weights(rs, D, H, KH, Dh, F)
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0)),
                       (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
        tkw = {n: (t.to("cuda") if isinstance(t, torch.Tensor) else t)
               for n, t in _torch_args(kw, dtype).items()}
        x = torch.as_tensor(rs.randn(B, 1, D) * 0.1).to("cuda", dtype)
        k = torch.as_tensor(rs.randn(B, S, KH, Dh) * 0.1).to("cuda", dtype)
        v = torch.as_tensor(rs.randn(B, S, KH, Dh) * 0.1).to("cuda", dtype)
        pos = torch.tensor([0, 100, S - 1, S], dtype=torch.int32,
                           device="cuda")
        before = decode_block_attn.launches, decode_block_mlp.launches
        y, k1, v1 = decode_block_layer(x, k.clone(), v.clone(), pos,
                                       kv_heads=KH, head_dim=Dh, **tkw)
        torch.cuda.synchronize()
        assert decode_block_attn.launches == before[0] + 1
        assert decode_block_mlp.launches == before[1] + 1
        yr, k2, v2 = decode_block_reference(x, k.clone(), v.clone(), pos,
                                            kv_heads=KH, head_dim=Dh, **tkw)
        torch.testing.assert_close(y.float(), yr.float(), **tol)
        torch.testing.assert_close(k1.float(), k2.float(), **tol)
        torch.testing.assert_close(v1.float(), v2.float(), **tol)
