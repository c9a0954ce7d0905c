"""The sharded decode block of the PyTorch port
(``kernels/decode_block_tp.py``) against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: ``shard_map`` over the
conftest's virtual CPU devices, the Pallas kernels in interpret mode.
The port's values are per-shard lists on ``["cpu"] * tp``, where every
wrapper takes its plain version.  Same numpy inputs, f32.  Bars (those
of tests/test_zz_decode_block_tp.py): a layer's output within 2e-5, the
slabs within 1e-6, a single hop or attention block within 1e-5, at
ragged positions with an empty (0) and a full (== S) slot.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed._jax_compat import shard_map
from paddle_tpu.kernels import decode_block_tp as ref
from paddle_tpu.kernels.decode_block import \
    plan_decode_block as ref_plan_decode_block
from paddle_tpu_torch.distributed import Mesh
from paddle_tpu_torch.kernels.decode_block import (SMEM_BUDGET, _gemv_smem,
                                                   _k_slice, _pick_block_f,
                                                   plan_gemv,
                                                   decode_block_reference,
                                                   fusion_legal,
                                                   plan_decode_block,
                                                   resolve_fused_decode)
from paddle_tpu_torch.kernels.decode_block_tp import (
    _attn_tp_plan, _pick_block_k_tp, _split_smem, decode_block_attn_tp,
    decode_block_attn_tp_reference,
    plan_decode_block_tp, ring_entry_hop, ring_entry_hop_reference,
    ring_entry_matmul, ring_exit_hop, ring_exit_hop_reference,
    ring_exit_matmul, tp_fused_block_layer)

POS = [0, 3, 7, 32]
S = 32


def _jax_mesh(tp):
    return JaxMesh(np.array(jax.devices()[:tp]), ("mp",))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _chunks(a, tp, dim):
    return [c.contiguous() for c in torch.chunk(_t(a), tp, dim=dim)]


# ------------------------------------------------------------ ring hops
@pytest.mark.parametrize("tp", [2, 4])
def test_entry_ring_matches_the_reference(tp):
    rs = np.random.RandomState(0)
    B, K, N = 8, 32, 8 * tp
    h = rs.randn(B, K).astype(np.float32)
    w = rs.randn(K, N).astype(np.float32)
    b = rs.randn(N).astype(np.float32)

    def body(hs, ws, bs):
        return ref.ring_entry_matmul(hs, ws, bs, "mp", tp)
    want = jax.jit(shard_map(body, mesh=_jax_mesh(tp),
                             in_specs=(P("mp", None), P(None, "mp"),
                                       P("mp")),
                             out_specs=P(None, "mp"), check_vma=False))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    before = ring_entry_hop.launches
    got = ring_entry_matmul(_chunks(h, tp, 0), _chunks(w, tp, 1),
                            _chunks(b, tp, 0), Mesh(["cpu"] * tp))
    assert ring_entry_hop.launches == before     # CPU: the plain version
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), h @ w + b,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu", "swiglu"])
@pytest.mark.parametrize("tp", [2, 4])
def test_exit_ring_matches_the_reference(tp, act):
    """For swiglu each shard's y block is ``[gate_d | up_d]``: the gate in
    the FIRST half."""
    rs = np.random.RandomState(1)
    B, K_l, N = 8, 16, 24
    width = K_l * (2 if act == "swiglu" else 1)
    y = rs.randn(B, tp * width).astype(np.float32)
    w = rs.randn(tp * K_l, N).astype(np.float32)

    def body(ys, ws):
        return ref.ring_exit_matmul(ys, ws, "mp", tp, act=act)
    want = jax.jit(shard_map(body, mesh=_jax_mesh(tp),
                             in_specs=(P(None, "mp"), P("mp", None)),
                             out_specs=P("mp", None), check_vma=False))(
        jnp.asarray(y), jnp.asarray(w))
    got = ring_exit_matmul(_chunks(y, tp, 1), _chunks(w, tp, 0),
                           Mesh(["cpu"] * tp), act=act)
    np.testing.assert_allclose(torch.cat(got, 0).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_hop_wrappers_take_the_plain_version_on_cpu_and_check_shapes():
    x, w, b = torch.randn(4, 16), torch.randn(16, 8), torch.randn(8)
    assert torch.equal(ring_entry_hop(x, w, b),
                       ring_entry_hop_reference(x, w, b))
    y = torch.randn(4, 32)
    assert torch.equal(ring_exit_hop(y, w, "swiglu"),
                       ring_exit_hop_reference(y, w, "swiglu"))
    with pytest.raises(ValueError, match="act must be one of"):
        ring_exit_hop(y, w, "relu")
    with pytest.raises(ValueError, match="ring_exit_hop wants"):
        ring_exit_hop(y, w, "none")
    with pytest.raises(ValueError, match="ring_entry_hop wants"):
        ring_entry_hop(x, w.t(), b)


# ------------------------------------------------- per-shard attention
@pytest.mark.parametrize("rope", [False, True])
def test_attention_block_matches_the_reference(rope):
    """One shard's attention (GQA rep 2) at pos 0, 3, 7 and S: the
    output, and the slabs updated in place at min(pos, S-1) only."""
    rs = np.random.RandomState(2)
    B, KH, rep, DH = len(POS), 2, 2, 8
    q = (rs.randn(B, KH * rep * DH) * 0.5).astype(np.float32)
    k = (rs.randn(B, KH * DH) * 0.5).astype(np.float32)
    v = (rs.randn(B, KH * DH) * 0.5).astype(np.float32)
    ks = (rs.randn(B, S, KH, DH) * 0.5).astype(np.float32)
    vs = (rs.randn(B, S, KH, DH) * 0.5).astype(np.float32)
    pos = np.asarray(POS, np.int32)
    cos = sin = None
    if rope:
        t = rs.rand(B, DH // 2).astype(np.float32)
        cos = np.concatenate([np.cos(t)] * 2, -1)
        sin = np.concatenate([np.sin(t)] * 2, -1)
    wa, wk, wv = ref.decode_block_attn_tp(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)), kv_heads=KH,
        head_dim=DH, rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin))
    tk, tv = _t(ks).clone(), _t(vs).clone()
    ga, gk, gv = decode_block_attn_tp(
        _t(q), _t(k), _t(v), tk, tv, _t(pos), kv_heads=KH, head_dim=DH,
        rope_cos=None if cos is None else _t(cos),
        rope_sin=None if sin is None else _t(sin))
    assert gk is tk and gv is tv                  # in place
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6,
                               rtol=0)
    changed = (gk.numpy() != ks).any(axis=(2, 3))
    rows = np.minimum(pos, S - 1)
    changed[np.arange(B), rows] = False
    assert not changed.any()
    # q/k/v as column views of one fused [B, qkv] row, as the layer passes
    fused = torch.cat([_t(q), _t(k), _t(v)], dim=1)
    n_q = KH * rep * DH
    ga2, _, _ = decode_block_attn_tp_reference(
        fused[:, :n_q], fused[:, n_q:n_q + KH * DH], fused[:, n_q + KH * DH:],
        _t(ks).clone(), _t(vs).clone(), _t(pos), kv_heads=KH, head_dim=DH,
        rope_cos=None if cos is None else _t(cos),
        rope_sin=None if sin is None else _t(sin))
    torch.testing.assert_close(ga2, ga, atol=0, rtol=0)


# ----------------------------------------------------------- one layer
def _layer_case(tp, gated, use_rope, norm, bias):
    """One layer through the port's tp_fused_block_layer (per-shard lists
    on the CPU) and through the reference's under shard_map; returns the
    max-abs diffs of the output and the slabs, and the port's output
    against its own tp=1 oracle (decode_block_reference)."""
    B = len(POS)
    KH = max(tp, 2)
    DH, H = 8, 2 * max(tp, 2)
    FF = 24 * tp
    D = H * DH
    rs = np.random.RandomState(0)

    def A(*sh):
        return (rs.randn(*sh) * 0.1).astype(np.float32)
    x = A(B, 1, D)
    k_slab, v_slab = A(B, S, KH, DH), A(B, S, KH, DH)
    pos = np.asarray(POS, np.int32)
    n1w, n2w = A(D) + 1, A(D) + 1
    n1b = A(D) if norm == "layer" else None
    n2b = A(D) if norm == "layer" else None
    wq, wk, wv = A(D, H * DH), A(D, KH * DH), A(D, KH * DH)
    bq = A(H * DH) if bias else None
    bkv = A(KH * DH) if bias else None
    bv = A(KH * DH) if bias else None
    wo, w1, w2 = A(H * DH, D), A(D, FF), A(FF, D)
    bo = A(D) if bias else None
    b1 = A(FF) if bias else None
    b2 = A(D) if bias else None
    wg = A(D, FF) if gated else None
    cos = sin = None
    if use_rope:
        t = np.random.RandomState(1).rand(B, DH // 2).astype(np.float32)
        cos = np.concatenate([np.cos(t), np.cos(t)], -1)
        sin = np.concatenate([np.sin(t), np.sin(t)], -1)
    act = "swiglu" if gated else "gelu_tanh"
    # the tp_decode_weights bundle layout
    h_l, kh_l, f_l = H // tp, KH // tp, FF // tp
    qs, kvs = h_l * DH, kh_l * DH
    parts, bparts, mparts, mbparts = [], [], [], []
    for d in range(tp):
        parts += [wq[:, d * qs:(d + 1) * qs], wk[:, d * kvs:(d + 1) * kvs],
                  wv[:, d * kvs:(d + 1) * kvs]]
        if bias:
            bparts += [bq[d * qs:(d + 1) * qs], bkv[d * kvs:(d + 1) * kvs],
                       bv[d * kvs:(d + 1) * kvs]]
        if gated:
            mparts += [wg[:, d * f_l:(d + 1) * f_l],
                       w1[:, d * f_l:(d + 1) * f_l]]
        else:
            mparts += [w1[:, d * f_l:(d + 1) * f_l]]
            if bias:
                mbparts += [b1[d * f_l:(d + 1) * f_l]]
    blk = {"n1w": n1w, "n1b": n1b, "wqkv": np.concatenate(parts, 1),
           "bqkv": np.concatenate(bparts) if bias else None,
           "wo": wo, "bo": bo, "n2w": n2w, "n2b": n2b,
           "wup": np.concatenate(mparts, 1),
           "bup": np.concatenate(mbparts) if (bias and not gated) else None,
           "wdown": w2, "bdown": b2}
    axis = {"n1w": None, "n1b": None, "wqkv": 1, "bqkv": 0, "wo": 0,
            "bo": None, "n2w": None, "n2b": None, "wup": 1, "bup": 0,
            "wdown": 0, "bdown": None}
    arch = {"norm": norm, "eps": 1e-5, "act": act, "heads": H,
            "kv_heads": KH, "head_dim": DH}

    # the reference, under shard_map
    rplan, why = ref_plan_decode_block(
        max_seq=S, hidden=D, heads=H, kv_heads=KH, head_dim=DH, ffn=FF,
        batch=B, itemsize=4, gated=gated, tp=tp)
    assert rplan is not None, why
    specs = {"n1w": P(), "n1b": P(), "wqkv": P(None, "mp"),
             "bqkv": P("mp"), "wo": P("mp", None), "bo": P(),
             "n2w": P(), "n2b": P(), "wup": P(None, "mp"),
             "bup": P("mp"), "wdown": P("mp", None), "bdown": P()}
    jblk = {k: None if v is None else jnp.asarray(v) for k, v in blk.items()}
    blk_specs = {k: (None if blk[k] is None else specs[k]) for k in blk}
    jrope = (jnp.asarray(cos), jnp.asarray(sin)) if use_rope else None

    def body(x_s, pk, pv, p, blk_l):
        return ref.tp_fused_block_layer(x_s, pk, pv, p, blk_l, arch, jrope,
                                        "mp", tp, rplan)
    slab = P(None, None, "mp", None)
    f = shard_map(body, mesh=_jax_mesh(tp),
                  in_specs=(P("mp", None), slab, slab, P(), blk_specs),
                  out_specs=(P("mp", None), slab, slab), check_vma=False)
    wy, wk2, wv2 = jax.jit(f)(jnp.asarray(x[:, 0]), jnp.asarray(k_slab),
                              jnp.asarray(v_slab), jnp.asarray(pos), jblk)

    # the port, per-shard lists on the CPU
    mesh = Mesh(["cpu"] * tp)
    plan, why = plan_decode_block(
        max_seq=S, hidden=D, heads=H, kv_heads=KH, head_dim=DH, ffn=FF,
        batch=B, itemsize=4, gated=gated, tp=tp)
    assert plan is not None, why
    blks = [{} for _ in range(tp)]
    for key, val in blk.items():
        for d in range(tp):
            blks[d][key] = None if val is None else (
                _t(val) if axis[key] is None
                else _chunks(val, tp, axis[key])[d])
    xs = _chunks(x[:, 0], tp, 0)
    pks, pvs = _chunks(k_slab, tp, 2), _chunks(v_slab, tp, 2)
    ropes = [(_t(cos), _t(sin))] * tp if use_rope else None
    ys, gk, gv = tp_fused_block_layer(xs, pks, pvs, [_t(pos)] * tp, blks,
                                      arch, ropes, mesh)
    y = torch.cat(ys, 0).numpy()
    gk, gv = torch.cat(gk, 2).numpy(), torch.cat(gv, 2).numpy()

    # the port's tp=1 oracle
    def opt(a):
        return None if a is None else _t(a)
    oy, _, _ = decode_block_reference(
        _t(x), _t(k_slab).clone(), _t(v_slab).clone(), _t(pos),
        kv_heads=KH, head_dim=DH, norm=norm, eps1=1e-5, eps2=1e-5,
        norm1_w=_t(n1w), norm1_b=opt(n1b), wq=_t(wq), wk=_t(wk), wv=_t(wv),
        bq=opt(bq), bkv=opt(bkv), bv=opt(bv), wo=_t(wo), bo=opt(bo),
        norm2_w=_t(n2w), norm2_b=opt(n2b), w1=_t(w1), b1=opt(b1),
        w2=_t(w2), b2=opt(b2), w_gate=opt(wg), act=act,
        rope_cos=opt(cos), rope_sin=opt(sin))
    return (np.abs(y - np.asarray(wy)).max(),
            np.abs(gk - np.asarray(wk2)).max(),
            np.abs(gv - np.asarray(wv2)).max(),
            np.abs(y - oy[:, 0].numpy()).max())


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("style", ["gpt", "llama"])
def test_layer_matches_the_reference(tp, style):
    """GPT style: LayerNorm, every bias, gelu_tanh, MHA.  Llama style:
    RMSNorm, GQA, rotary, SwiGLU over the bundle's [gate | up] columns."""
    gpt = style == "gpt"
    dy, dk, dv, d1 = _layer_case(tp, gated=not gpt, use_rope=not gpt,
                                 norm="layer" if gpt else "rms", bias=gpt)
    assert dy < 2e-5 and dk < 1e-6 and dv < 1e-6, (dy, dk, dv)
    assert d1 < 2e-5, d1


# --------------------------------------------------- plan and legality
def test_plan_shrinks_then_refuses():
    base = dict(max_seq=2048, hidden=4096, heads=32, kv_heads=32,
                head_dim=128, ffn=16384, batch=8, itemsize=2, tp=2)
    roomy, why = plan_decode_block_tp(**base)
    assert why is None and roomy["block_k"] == 32
    assert sorted(roomy) == ["block_k", "smem_attn", "smem_hop"]
    assert plan_decode_block(**{k: v for k, v in base.items()}) == \
        (roomy, None)
    # one source per tile: the attention tile and bytes are those of the
    # launch the kernel's wrapper makes (bf16 at head_dim 128: the split
    # kernel's 32-row TMA tile and its fixed shared memory; f32: the tile
    # _pick_block_k_tp picks), and the hop bytes are those of the launches
    # the hops plan (decode_block's projection rule: in bf16 the stream
    # kernel's plan, in f32 the K slice) at the four seams: QKV and MLP-up
    # over hidden, out-proj over the local heads, MLP-down over the local
    # ffn
    assert (roomy["block_k"], roomy["smem_attn"]) == \
        _attn_tp_plan(2048, 1, 128, 2, SMEM_BUDGET) == \
        (32, _split_smem(1, 128))
    seams = ((4096, 6144), (4096, 8192), (2048, 4096), (8192, 4096))
    assert roomy["smem_hop"] == max(plan_gemv(k, (n,), 4)[0]["smem"]
                                    for k, n in seams)
    assert roomy["smem_hop"] <= SMEM_BUDGET
    cap = _pick_block_f(4, SMEM_BUDGET)
    f32_plan, _ = plan_decode_block_tp(**dict(base, itemsize=4))
    assert f32_plan["block_k"] == _pick_block_k_tp(2048, 1, 128, 4,
                                                   SMEM_BUDGET)
    assert f32_plan["smem_hop"] == max(
        _gemv_smem(_k_slice(k, n, 4, 4, cap)[0], 4) for k, n in seams)
    # f32 tiles: the K/V stages shrink under a tighter budget; below the
    # smallest tile the attention block refuses, and below a hop block's
    # reduction buffer the hop does
    f32 = dict(base, itemsize=4)
    tight, why = plan_decode_block_tp(smem_budget=100_000, **f32)
    assert why is None and tight["block_k"] == 32
    assert max(tight["smem_attn"], tight["smem_hop"]) <= 100_000
    none, why = plan_decode_block_tp(smem_budget=4_000, **f32)
    assert none is None and why.startswith("smem: tp attention residents")
    none, why = plan_decode_block_tp(smem_budget=20_000, **f32)
    assert none is None and why.startswith("smem: tp entry hop needs")
    # a cache shorter than a tile: the split kernel's TMA boxes read past
    # S as zeros and mask them; the f32 kernel's tile shrinks to the cache
    short, _ = plan_decode_block_tp(**dict(base, max_seq=16))
    assert short["block_k"] == 32
    short, _ = plan_decode_block_tp(**dict(f32, max_seq=16))
    assert short["block_k"] == 16


def test_fusion_legal_tp_refusals_in_the_reference_words():
    base = dict(max_seq=64, hidden=64, heads=4, kv_heads=4, head_dim=16,
                ffn=256, batch=4, dtype="float32")
    assert fusion_legal(tp=2, **base) == (True, None)
    assert fusion_legal(tp=4, **base) == (True, None)
    cases = [(dict(base, kv_heads=2), 4,
              "kv_heads 2 not divisible by tensor_parallel 4 (the slab "
              "shards on the kv-head axis)"),
             (dict(base, batch=6), 4,
              "batch 6 not divisible by tensor_parallel 4 (the residual "
              "stream slot-shards between the ring collectives)"),
             (dict(base, ffn=264), 16, "ffn 264 not divisible by "
              "tensor_parallel 16 (MLP column shards)")]
    for kw, tp, reason in cases:
        if tp == 16:
            kw = dict(kw, heads=16, kv_heads=16, hidden=128, head_dim=8,
                      batch=16)
        assert fusion_legal(tp=tp, **kw) == (False, reason)


def test_resolve_fused_decode_tp_leg():
    class NoTp:
        def fused_decode_supported(self, **kw):
            return True, None

        def fused_decode_step(self):
            pass

    class Indivisible(NoTp):
        def tp_decode_weights(self, tp):
            pass

        def tp_decode_supported(self, tp):
            return False, f"num_heads 3 not divisible by tensor_parallel {tp}"
    ok, why = resolve_fused_decode(NoTp(), batch=4, kv_len=64, tp=2)
    assert not ok and why.startswith("model has no tp_decode_weights")
    assert resolve_fused_decode(Indivisible(), batch=4, kv_len=64, tp=2) \
        == (False, "num_heads 3 not divisible by tensor_parallel 2")
    assert resolve_fused_decode(NoTp(), batch=4, kv_len=64) == (True, None)


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0)),
                       (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
        def r(*shape):
            return (torch.randn(shape, generator=g, device="cuda")
                    * 0.1).to(dtype)
        x, w, b = r(4, 512), r(512, 384), r(384)
        torch.testing.assert_close(ring_entry_hop(x, w, b),
                                   ring_entry_hop_reference(x, w, b), **tol)
        for act in ("none", "gelu_tanh", "gelu", "swiglu"):
            y = r(4, 1024 if act == "swiglu" else 512)
            torch.testing.assert_close(ring_exit_hop(y, w, act),
                                       ring_exit_hop_reference(y, w, act),
                                       **tol)
        B, KH, rep, DH, SS = 4, 2, 2, 128, 256
        q, k, v = r(B, KH * rep * DH), r(B, KH * DH), r(B, KH * DH)
        ks, vs = r(B, SS, KH, DH), r(B, SS, KH, DH)
        pos = torch.tensor([0, 100, SS - 1, SS], dtype=torch.int32,
                           device="cuda")
        ang = torch.rand((B, DH // 2), generator=g, device="cuda")
        cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2,
                                                             -1)
        k1, v1, k2, v2 = ks.clone(), vs.clone(), ks.clone(), vs.clone()
        a1, _, _ = decode_block_attn_tp(q, k, v, k1, v1, pos, kv_heads=KH,
                                        head_dim=DH, rope_cos=cos,
                                        rope_sin=sin)
        a2, _, _ = decode_block_attn_tp_reference(
            q, k, v, k2, v2, pos, kv_heads=KH, head_dim=DH, rope_cos=cos,
            rope_sin=sin)
        torch.cuda.synchronize()
        torch.testing.assert_close(a1, a2, **tol)
        torch.testing.assert_close(k1, k2, **tol)
        torch.testing.assert_close(v1, v2, **tol)
