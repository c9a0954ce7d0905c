"""A model of the tensor-parallel shard attention's split walk
(``attn_tp_split_kernel`` in paddle_tpu_torch/kernels/csrc/
decode_block_tp.cu, on the walk of csrc/decode_split.cuh) on the CPU.

``chip_smoke.attn_tp_split`` models it: rotary and the scale on q and the
fresh k, the fresh row cast to the slab dtype, a partial softmax (m, l,
acc) over each run of ``split_rows`` slab rows of the live rows
``kpos < min(pos, S - 1)``, the partials merged in split order, the fresh
row folded in last.  It is held, on numpy inputs from a seed, against the
JAX package's ``decode_block_attn_tp`` (its Pallas kernel in interpret
mode, as tests/test_torch_decode_block_tp.py runs it) and the port's plain
version at f32 atol/rtol 1e-5 (only the summation order differs): rotary
on and off, GQA rep 1 and 3, positions 0, ending on a split's last row,
on the next split's first row, S - 1 and past S.  Rows past min(pos, S-1)
holding NaN leave it as it was.  A dropped split and the fresh row not
folded (the faults chip_smoke plants on the card) must read above that
tolerance.  The launch's grid and workspace follow from the shapes and
S_max alone.  A few seconds in all.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.kernels import decode_block_tp as ref
from paddle_tpu_torch.kernels import decode_block_tp as dbt

B, KH, DH, S = 6, 2, 16, 40
SPLIT = 8
# none; ends on split 0's last row; on split 1's first row; ragged; S - 1;
# past S
POS = [0, SPLIT, SPLIT + 1, 23, S - 1, S + 5]


def _inputs(rep, rope, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, KH * rep * DH).astype(np.float32)
    k = rs.randn(B, KH * DH).astype(np.float32)
    v = rs.randn(B, KH * DH).astype(np.float32)
    ks = rs.randn(B, S, KH, DH).astype(np.float32)
    vs = rs.randn(B, S, KH, DH).astype(np.float32)
    cos = sin = None
    if rope:
        t = rs.rand(B, DH // 2).astype(np.float32) * 3
        cos = np.concatenate([np.cos(t)] * 2, -1)
        sin = np.concatenate([np.sin(t)] * 2, -1)
    return q, k, v, ks, vs, np.asarray(POS, np.int32), cos, sin


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _model(case, split, **fault):
    q, k, v, ks, vs, pos, cos, sin = case
    return chip_smoke.attn_tp_split(
        _t(q), _t(k), _t(v), _t(ks), _t(vs), _t(pos), kv_heads=KH,
        head_dim=DH, split_rows=split, rope_cos=_t(cos), rope_sin=_t(sin),
        **fault).numpy()


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("rep", [1, 3])
def test_split_model_matches_jax_and_the_plain_version(rep, rope):
    case = _inputs(rep, rope)
    q, k, v, ks, vs, pos, cos, sin = case
    want_jax, _, _ = ref.decode_block_attn_tp(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)), kv_heads=KH,
        head_dim=DH, rope_cos=None if cos is None else jnp.asarray(cos),
        rope_sin=None if sin is None else jnp.asarray(sin))
    want_jax = np.asarray(want_jax)
    plain, _, _ = dbt.decode_block_attn_tp_reference(
        _t(q), _t(k), _t(v), _t(ks).clone(), _t(vs).clone(), _t(pos),
        kv_heads=KH, head_dim=DH, rope_cos=_t(cos), rope_sin=_t(sin))
    plain = plain.numpy()
    # the kernel's runs, one split, and uneven ones
    for split in (SPLIT, 16, S, 3):
        got = _model(case, split)
        np.testing.assert_allclose(got, want_jax, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    # at pos 0 only the fresh row is seen: the output is its v
    np.testing.assert_allclose(got[0].reshape(KH, rep, DH),
                               np.repeat(v[0].reshape(KH, 1, DH), rep, 1),
                               atol=1e-6, rtol=0)
    # every slab row from min(pos, S-1) on holding NaN changes nothing
    posw = np.minimum(pos, S - 1)
    stale = np.arange(S)[None, :] >= posw[:, None]
    ks_nan, vs_nan = ks.copy(), vs.copy()
    ks_nan[stale], vs_nan[stale] = np.nan, np.nan
    got_nan = _model((q, k, v, ks_nan, vs_nan, pos, cos, sin), SPLIT)
    np.testing.assert_allclose(got_nan, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fault", [dict(drop=1), dict(fold=False)])
def test_planted_faults_read_above_the_tolerance(fault):
    case = _inputs(1, True)
    plain = _model(case, SPLIT)
    wrong = _model(case, SPLIT, **fault)
    assert np.abs(wrong - plain).max() > 100 * (1e-5 + 1e-5 * np.abs(
        plain).max())


def test_grid_and_workspace_follow_s_max_alone():
    # the gpt3_6_7b tp=2 shard: 8 slots x 16 kv heads, one head a block,
    # 256-row splits of a 2048-row slab, (m, l, acc[128]) per head and split
    assert dbt._split_grid(8, 16, 1, 128, 2048) == (128, 8, 8 * 16 * 8 * 130)
    # a GQA group of 8: 4 heads a block, two blocks a kv head
    assert dbt._split_grid(8, 4, 8, 128, 1024) == (64, 4, 8 * 32 * 4 * 130)
    for s_max in (1, 255, 256, 257, 4096):
        rows, splits, part = dbt._split_grid(8, 16, 3, 64, s_max)
        assert rows == 8 * 16 * 3 and splits == -(-s_max // 256)
        assert part == 8 * 16 * 3 * splits * 66
