"""KV-cache plumbing of the PyTorch port (paddle_tpu_torch/models/
kv_cache.py) against the JAX reference on identical numpy inputs,
compared exactly: the functions only move data.

The cases are the ones torch does not give for free: writes past the
row end clamp like ``dynamic_update_slice``, out-of-range block ids clip
on gather, and out-of-range destinations drop on scatter.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu_torch.models import kv_cache as tkv


def _bufs(b=3, max_len=10, h=2, d=4, s=3, seed=0):
    rs = np.random.RandomState(seed)
    pk = rs.randn(b, max_len, h, d).astype(np.float32)
    pv = rs.randn(b, max_len, h, d).astype(np.float32)
    k = rs.randn(b, s, h, d).astype(np.float32)
    v = rs.randn(b, s, h, d).astype(np.float32)
    return pk, pv, k, v


def _append_both(pk, pv, k, v, pos):
    jk, jv = jkv.append_kv(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(k),
                           jnp.asarray(v), jnp.asarray(pos, jnp.int32)
                           if np.ndim(pos) else pos)
    tpos = torch.as_tensor(pos, dtype=torch.int32) if np.ndim(pos) else pos
    tk_, tv_ = tkv.append_kv(torch.as_tensor(pk.copy()),
                             torch.as_tensor(pv.copy()), torch.as_tensor(k),
                             torch.as_tensor(v), tpos)
    return (np.asarray(jk), np.asarray(jv)), (tk_.numpy(), tv_.numpy())


@pytest.mark.parametrize("pos", [0, 4, 7, 9, 25])
def test_append_scalar_pos_clamps_like_jax(pos):
    want, got = _append_both(*_bufs(), pos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("pos", [[0, 3, 7], [9, 10, 40], [2, 2, 8]])
def test_append_per_row_pos_clamps_like_jax(pos):
    want, got = _append_both(*_bufs(), pos)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_append_is_in_place():
    pk, pv, k, v = _bufs()
    tpk, tpv = torch.as_tensor(pk), torch.as_tensor(pv)
    out_k, out_v = tkv.append_kv(tpk, tpv, torch.as_tensor(k),
                                 torch.as_tensor(v),
                                 torch.tensor([1, 2, 3], dtype=torch.int32))
    assert out_k is tpk and out_v is tpv


def test_cache_lens():
    for pos, s in ((0, 5), (7, 1)):
        np.testing.assert_array_equal(
            tkv.cache_lens(pos, s, 4).numpy(),
            np.asarray(jkv.cache_lens(pos, s, 4)))
    vec = np.array([0, 5, 31], np.int32)
    got = tkv.cache_lens(torch.as_tensor(vec), 3, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkv.cache_lens(jnp.asarray(vec), 3, 3)))


def test_gather_block_rows_clips_out_of_range_ids():
    rs = np.random.RandomState(1)
    buf = rs.randn(5, 4, 2, 3).astype(np.float32)
    idx = np.array([2, 0, 7, -3, 4, 5], np.int32)
    want = np.asarray(jkv.gather_block_rows(jnp.asarray(buf),
                                            jnp.asarray(idx)))
    got = tkv.gather_block_rows(torch.as_tensor(buf), idx).numpy()
    assert got.shape == (6 * 4, 2, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dest", [[1, 5, 3, 9], [5, 5, 5, 5], [0, 1, 2, 3],
                                  [-1, 4, 6, 2]])
def test_scatter_block_rows_drops_out_of_range(dest):
    rs = np.random.RandomState(2)
    buf = rs.randn(5, 4, 2, 3).astype(np.float32)
    row = rs.randn(4 * 4, 2, 3).astype(np.float32)
    dest = np.array(dest, np.int32)
    want = np.asarray(jkv.scatter_block_rows(jnp.asarray(buf),
                                             jnp.asarray(row),
                                             jnp.asarray(dest)))
    tbuf = torch.as_tensor(buf.copy())
    out = tkv.scatter_block_rows(tbuf, torch.as_tensor(row), dest)
    assert out is tbuf
    np.testing.assert_array_equal(out.numpy(), want)
