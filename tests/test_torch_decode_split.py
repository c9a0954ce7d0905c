"""Models of the 16-bit decode-attention kernels' walks
(paddle_tpu_torch/kernels/csrc/decode_attention.cu) on the CPU.

``chip_smoke.decode_split`` models the sq == 1 kernel's split: partial
softmaxes (m, l, acc) over fixed runs of cache rows, merged in split
order.  It is held, on numpy inputs from a seed, against the JAX Pallas
kernel (interpret mode, as the JAX package's own tests run it on the CPU),
the JAX dense reference and the port's plain version, at f32 atol/rtol
1e-5 (only the summation order differs): ragged lengths with 0, a length
that ends on a split's last row and one on the next split's first row, a
length past S_max, sq > seq_len, causal tail on and off, GQA groups of 1
and 4.  A dropped split or a shifted query offset (the faults chip_smoke
plants on the card) must read above that tolerance; in bf16 the model
must keep every element within the limit the card's check holds the
kernel to (``chip_smoke.row_reading`` <= 1) and each fault must read
``chip_smoke.FAULT_READING`` times that limit or more.

``chip_smoke.chunk_walk`` models the key tiles each query block and group
of the chunk kernel loads and computes; it is held against a brute-force
walk over the visible (query, key) pairs: each pair lies in exactly one
computed tile, no computed tile is empty, and no tile past the block's
visible end is loaded.  Small: a few seconds in all.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_reference as jax_reference)
from paddle_tpu_torch.kernels.decode_attention import (
    decode_attention_reference)

B, H, S_MAX, D = 6, 8, 40, 16
SPLIT = 8


def _inputs(sq, rep, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, sq, H, D).astype(np.float32)
    k = rs.randn(B, S_MAX, H // rep, D).astype(np.float32)
    v = rs.randn(B, S_MAX, H // rep, D).astype(np.float32)
    # 0; ends on split 0's last row; on split 1's first row; past S_max;
    # shorter than the chunk (sq > seq_len for sq >= 3); ragged
    lens = np.array([0, SPLIT, SPLIT + 1, S_MAX + 5, 2, 23], np.int32)
    return q, k, v, lens


def _torch(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("sq", [1, 5])
def test_split_model_matches_jax(sq, rep, causal):
    q, k, v, lens = _inputs(sq, rep)
    jq, jk, jv, jl = (jnp.asarray(x) for x in (q, k, v, lens))
    want_kernel = np.asarray(jax_decode_attention(
        jq, jk, jv, jl, causal_tail=causal, interpret=True))
    want_dense = np.asarray(jax_reference(jq, jk, jv, jl, causal_tail=causal))
    plain = decode_attention_reference(*_torch(q, k, v, lens),
                                       causal_tail=causal).numpy()
    # one split, a split per tile of the kernel's sizes, and uneven splits
    for split in (SPLIT, 16, S_MAX, 3):
        got = chip_smoke.decode_split(*_torch(q, k, v, lens), split,
                                      causal=causal).numpy()
        np.testing.assert_allclose(got, want_kernel, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, want_dense, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    # a query that sees no row yields exactly 0
    assert np.all(got[0] == 0.0)
    if causal and sq > 2:
        assert np.all(got[4, :sq - 2] == 0.0)


@pytest.mark.parametrize("fault", ["drop", "shift"])
def test_planted_faults_read_above_tolerance(fault):
    q, k, v, lens = _inputs(5, 1, seed=1)
    args = _torch(q, k, v, lens)
    want = decode_attention_reference(*args).numpy()
    kw = dict(drop=1) if fault == "drop" else dict(shift=1)
    got = chip_smoke.decode_split(*args, SPLIT, **kw).numpy()
    assert not np.allclose(got, want, atol=1e-5, rtol=1e-5)
    # the planted fault changes the rows it should and no others
    off = ~np.isclose(got, want, atol=1e-5, rtol=1e-5).all(axis=(1, 2, 3))
    if fault == "drop":
        # rows with a visible row in split 1: lengths past SPLIT
        want_off = lens > SPLIT
    else:
        # rows where some query gains a key below min(seq_len, S_max)
        want_off = np.array([any(0 <= n - 5 + t + 1 < min(n, S_MAX)
                                 for t in range(5)) for n in lens])
    np.testing.assert_array_equal(off, want_off)


@pytest.mark.parametrize("fault", ["drop", "shift"])
def test_planted_faults_read_above_element_limit(fault):
    q, k, v, lens = _inputs(5, 1, seed=2)
    args = [x.to(torch.bfloat16) for x in _torch(q, k, v)] + _torch(lens)
    want = decode_attention_reference(*args)
    kw = dict(drop=1) if fault == "drop" else dict(shift=1)
    assert chip_smoke.row_reading(chip_smoke.decode_split(*args, SPLIT),
                                  want) <= 1.0
    assert chip_smoke.row_reading(chip_smoke.decode_split(*args, SPLIT, **kw),
                                  want) >= chip_smoke.FAULT_READING


def _visible(seq_len, sq, s_max, causal):
    """[sq, S_max] bool: query t sees cache row key, by brute force."""
    t = np.arange(sq)[:, None]
    key = np.arange(s_max)[None, :]
    seen = np.broadcast_to(key < seq_len, (sq, s_max))
    return seen & (key <= seq_len - sq + t) if causal else seen.copy()


# (seq_len, sq, S_max, causal): the serving chunks (GPT at 1536, Llama at
# 3072), a short chunk, sq > seq_len, a length past S_max, a chunk at and
# just past one tile, no keys at all, and the full non-causal walk
WALKS = [(1536, 512, 2048, True), (3072, 512, 4096, True),
         (100, 7, 256, True), (5, 48, 256, True), (300, 65, 256, True),
         (64, 64, 64, True), (129, 128, 512, True), (200, 129, 512, True),
         (0, 7, 128, True), (129, 128, 512, False), (5, 48, 256, False)]


@pytest.mark.parametrize("seq_len,sq,s_max,causal", WALKS)
def test_chunk_walk_matches_brute_force(seq_len, sq, s_max, causal):
    q_tile, k_tile, groups = 128, 128, 2
    rows = q_tile // groups
    walk = chip_smoke.chunk_walk(seq_len, sq, s_max, causal, q_tile, k_tile,
                                 groups)
    assert sorted(walk) == list(range(0, sq, q_tile))
    visible = _visible(seq_len, sq, s_max, causal)
    covered = np.zeros((sq + q_tile, s_max + k_tile), np.int64)
    for q0, (loaded, computed) in walk.items():
        # the block loads exactly the tiles up to its last visible key
        keys = np.nonzero(visible[q0:q0 + q_tile].any(axis=0))[0]
        last = keys[-1] if len(keys) else -1
        assert loaded == list(range(0, last + 1, k_tile))
        for w0, tiles in computed.items():
            assert set(tiles) <= set(loaded) and len(set(tiles)) == len(tiles)
            for k0 in tiles:
                # no computed tile is empty
                assert visible[w0:w0 + rows, k0:k0 + k_tile].any(), \
                    (q0, w0, k0)
                covered[w0:w0 + rows, k0:k0 + k_tile] += 1
    # every visible pair is computed, and once
    assert np.all(covered[:sq, :s_max][visible] == 1)
