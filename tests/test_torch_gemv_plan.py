"""The bf16 stream GEMV's planner (``kernels.decode_block.plan_gemv``) at
every serving shape, and a plain model of its summation order.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
one bf16 ulp of its plain version at each of these shapes); here the
plan it launches with is checked against what the kernel indexes: the
strips cover N exactly, the shared memory fits an H100 block, the K
splits and column groups fit the SMs and give every block work, the
workspace and the tile counters cover every slot the kernel writes, and
a plan without a K split leaves each strip to one block.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import decode_block as db
from paddle_tpu_torch.kernels.decode_block import (
    SMEM_BUDGET, _STRIP, _TILE, _MAX_TILES, _PART_SLOT, _norm_f32,
    decode_block_attn_reference, decode_block_mlp_reference, gemv_blocks,
    gemv_reference, plan_gemv)

H100_SMS = 132
# (name, K, output columns of each weight segment): the six tp=2 ring
# hops and the eight tp=1 projections of gpt3_6_7b and llama_7b
SHAPES = {
    "tp2_qkv_hop": (4096, (6144,)),
    "tp2_mlp_up_hop": (4096, (8192,)),
    "tp2_llama_up_hop": (4096, (11008,)),
    "tp2_out_proj_hop": (2048, (4096,)),
    "tp2_down_hop": (8192, (4096,)),
    "tp2_llama_down_hop": (5504, (4096,)),
    "gpt_qkv": (4096, (4096, 4096, 4096)),
    "gpt_out": (4096, (4096,)),
    "gpt_up": (4096, (16384,)),
    "gpt_down": (16384, (4096,)),
    "llama_qkv": (4096, (4096, 4096, 4096)),
    "llama_out": (4096, (4096,)),
    "llama_up_gate": (4096, (11008, 11008)),
    "llama_down": (11008, (4096,)),
}


@pytest.mark.parametrize("rows", [4, 8, 16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_covers_the_shape_and_fits(shape, rows):
    k, widths = SHAPES[shape]
    plan, why = plan_gemv(k, widths, rows, sms=H100_SMS)
    assert why is None
    groups, gc, gk = plan["groups"], plan["grid"], plan["ksplit"]
    assert groups == -(-rows // 16)
    assert plan["smem"] <= SMEM_BUDGET and 2 <= plan["stages"] <= 12
    assert gc * gk * groups <= H100_SMS
    # the strips cover each segment's columns exactly once
    covered = []
    for w in widths:
        covered += [min(_STRIP, w - c0) for c0 in range(0, w, _STRIP)]
    assert len(covered) == plan["strips"] and sum(covered) == sum(widths)
    assert plan["kT"] * _TILE >= k > (plan["kT"] - 1) * _TILE
    # every block has work, and the busiest one has plan["units"]
    blocks = gemv_blocks(plan)
    assert len(blocks) == gc * gk
    units = [len(strips) * (t1 - t0) for strips, (t0, t1) in blocks]
    assert min(units) > 0 and max(units) == plan["units"]
    # each (strip, K tile) is taken by exactly one block
    seen = np.zeros((plan["strips"], plan["kT"]), np.int32)
    for strips, (t0, t1) in blocks:
        for s in strips:
            seen[s, t0:t1] += 1
    assert (seen == 1).all()
    # the plan is the best layout of column groups x K splits that fits,
    # by the planner's cost model (weight bytes over the card's rate or the
    # busiest block's units, plus a K split and each strip after a
    # block's first)
    fit = H100_SMS // groups
    assert gk <= 8

    def cost(c, q):
        per_s, per_k = -(-plan["strips"] // c), -(-plan["kT"] // q)
        return (max(plan["strips"] * plan["kT"] * db._STAGE_BYTES
                    / db._CARD_BYTES_PER_US, per_s * per_k * db._UNIT_US)
                + (db._SPLIT_US if q > 1 else 0.0)
                + (per_s - 1) * db._STRIP_US)
    best = min(cost(c, q) for q in range(1, min(plan["kT"], fit, 8) + 1)
               for c in range(1, min(plan["strips"], fit // q) + 1))
    assert cost(gc, gk) <= best + 1e-9
    # the slots the kernel writes: (y ksplit + q) strips + strip, 1024
    # floats each, only when K is split; counters y strips + strip
    if gk == 1:
        for strips, _ in blocks:
            assert len(set(strips)) == len(strips)
    slots = {((y * gk + b // gc) * plan["strips"] + s)
             for y in range(groups) for b, (strips, _) in enumerate(blocks)
             for s in strips}
    assert len(slots) == groups * gk * plan["strips"]
    assert (max(slots) + 1) * _PART_SLOT == plan["workspace"]
    assert plan["counters"] == groups * plan["strips"] <= _MAX_TILES


def test_plan_refuses_below_two_stages():
    plan, why = plan_gemv(4096, (4096,), 8, smem_budget=30_000)
    assert plan is None and why.startswith("smem:")
    plan, _ = plan_gemv(4096, (4096,), 8, smem_budget=40_000)
    assert plan["stages"] == 2 and plan["smem"] <= 40_000
    # a stage holds more for an f32 input, a second half and more rows
    small = plan_gemv(4096, (4096,), 8)[0]["smem"] / plan_gemv(
        4096, (4096,), 8)[0]["stages"]
    big = plan_gemv(4096, (4096,), 16, in_mode=2, in_f32=True)[0]
    assert big["smem"] / big["stages"] > small and big["stages"] >= 2


def _model(x, weights, plan, **kw):
    return gemv_reference(x, weights, plan=plan, out_f32=True, **kw)


def test_stream_order_model_matches_the_references_in_f32():
    """The plain model of the kernel's summation order (per strip, each K
    split's partial, added in split order) composed into the two halves'
    projections agrees with the plain halves in f32; the planted faults
    (a dropped K tile, a tile read one row late) do not."""
    rs = np.random.RandomState(0)
    b, d, heads, dh, ffn = 3, 320, 5, 64, 704
    t = lambda *s: torch.as_tensor((rs.randn(*s) * 0.1).astype(np.float32))
    x = t(b, 1, d) * 10
    w = dict(norm1_w=t(d) + 1, norm1_b=t(d), wq=t(d, d), wk=t(d, d),
             wv=t(d, d), bq=t(d), bkv=t(d), bv=t(d))
    # the attention half's projection: norm with the row statistics
    xf = x[:, 0]
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    stats = torch.cat([mu, torch.rsqrt(var + 1e-5)], 1)
    widths = (d, d, d)
    # a plan with K split three ways, so that the model merges partials
    plan = dict(plan_gemv(d, widths, b, in_mode=1, sms=7)[0], ksplit=3)
    qkv = _model(xf, [w["wq"], w["wk"], w["wv"]], plan,
                 biases=[w["bq"], w["bkv"], w["bv"]], in_mode=1, stats=stats,
                 norm_w=w["norm1_w"], norm_b=w["norm1_b"])
    xn = _norm_f32(xf, w["norm1_w"], w["norm1_b"], "layer", 1e-5)
    want = torch.cat([xn @ w["wq"] + w["bq"], xn @ w["wk"] + w["bkv"],
                      xn @ w["wv"] + w["bv"]], 1)
    torch.testing.assert_close(qkv, want, atol=1e-5, rtol=1e-5)
    # ... and the whole attention half through its plain version: the
    # projections feed it the same q/k/v
    k = t(b, 16, heads, dh)
    v = t(b, 16, heads, dh)
    attn, _, _ = decode_block_attn_reference(
        x, k.clone(), v.clone(), torch.tensor([3, 9, 15]),
        *(w[n] for n in ("norm1_w", "norm1_b", "wq", "wk", "wv", "bq", "bkv",
                         "bv")), kv_heads=heads, head_dim=dh)
    assert torch.isfinite(attn).all()
    # the MLP half: out-proj + residual, norm2, gelu up, down + residual
    m = dict(wo=t(d, d), bo=t(d), norm2_w=t(d) + 1, norm2_b=t(d),
             w1=t(d, ffn), b1=t(ffn), w2=t(ffn, d), b2=t(d))
    plans = {n: dict(plan_gemv(kk, ww, b, sms=7)[0], ksplit=q)
             for n, kk, ww, q in (("o", d, (d,), 2), ("u", d, (ffn,), 1),
                                  ("d", ffn, (d,), 4))}
    xm = _model(attn[:, 0].float(), [m["wo"]], plans["o"], biases=[m["bo"]],
                res=xf)
    mu = xm.mean(-1, keepdim=True)
    var = ((xm - mu) ** 2).mean(-1, keepdim=True)
    st2 = torch.cat([mu, torch.rsqrt(var + 1e-5)], 1)
    u = _model(xm, [m["w1"]], plans["u"], biases=[m["b1"]], in_mode=1,
               stats=st2, norm_w=m["norm2_w"], norm_b=m["norm2_b"], act=1)
    y = _model(u, [m["w2"]], plans["d"], biases=[m["b2"]], res=xm)
    want = decode_block_mlp_reference(
        x, attn, *(m[n] for n in ("wo", "bo", "norm2_w", "norm2_b", "w1",
                                  "b1", "w2", "b2")))[:, 0]
    torch.testing.assert_close(y, want, atol=2e-5, rtol=2e-5)
    for fault in (dict(drop=plans["d"]["kT"] + 1), dict(late=2)):
        bad = _model(u, [m["w2"]], plans["d"], biases=[m["b2"]], res=xm,
                     **fault)
        assert (bad - want).abs().max() > 1e-2, fault
