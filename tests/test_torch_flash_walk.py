"""``chip_smoke.tile_pairs``, the model of the flash kernels' walks over
segment ids (csrc/flash_attention.cu), against a brute-force count on the
CPU: the forward's 128-query blocks of two 64-row consumer groups over
128-key tiles, dq's 128-query blocks of two 64-row groups over 64-key
tiles, and dkv's 128-key blocks of two 64-key groups over 64-query tiles,
on ids made as ``chip_smoke._varlen_ids`` makes them (packed documents,
padding, a segment with no keys, ids in no order); and that each walk
computes every visible pair.  Small: well under a second.
"""

import numpy as np
import pytest

import chip_smoke

T = 600
# (q_tile, k_tile, by_keys, groups) as the kernels walk
WALKS = {"fwd": (128, 128, False, 2), "dq": (128, 64, False, 2),
         "dkv": (64, 128, True, 2)}
PATTERNS = ("packed", "padding", "no_keys", "scrambled")


def _ids(pattern, monkeypatch, seed=3):
    """One row of query ids as chip_smoke draws them, on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    qs, _ = chip_smoke._varlen_ids(pattern, 1, T, T, seed)
    return qs[0].numpy()


def _apart(a, b):
    return max(a) < min(b) or max(b) < min(a)


def _brute(ids, q_tile, k_tile, groups):
    """The walk by queries, one (group, tile) at a time in plain Python:
    a group of a block computes a key tile below the block's causal limit
    when its last query sees the tile's first key and the two id sets'
    [min, max] ranges meet."""
    t, rows, pairs = len(ids), q_tile // groups, 0
    for q0 in range(0, t, q_tile):
        kend = min(q0 + q_tile, t)
        for g0 in range(q0, kend, rows):
            group = range(g0, min(g0 + rows, t))
            qids = [int(ids[i]) for i in group]
            for k0 in range(0, kend, k_tile):
                keys = range(k0, min(k0 + k_tile, kend))
                if keys[0] > group[-1]:
                    continue
                if _apart([int(ids[k]) for k in keys], qids):
                    continue
                pairs += rows * k_tile
    return pairs


def _brute_keys(ids, q_tile, k_tile, groups):
    """The walk by keys (dkv): a group of a block of keys computes a query
    tile from the one holding the block's first key on, when the tile's
    last query sees the group's first key and the id ranges meet."""
    t, rows, pairs = len(ids), k_tile // groups, 0
    for k0 in range(0, t, k_tile):
        for g0 in range(k0, min(k0 + k_tile, t), rows):
            kids = [int(ids[k]) for k in range(g0, min(g0 + rows, t))]
            for q0 in range(k0 // q_tile * q_tile, t, q_tile):
                queries = range(q0, min(q0 + q_tile, t))
                if q0 + q_tile - 1 < g0:
                    continue
                if _apart([int(ids[q]) for q in queries], kids):
                    continue
                pairs += q_tile * rows
    return pairs


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_tile_pairs_matches_brute_force(pattern, walk, monkeypatch):
    ids = _ids(pattern, monkeypatch)
    q_tile, k_tile, by_keys, groups = WALKS[walk]
    brute = _brute_keys if by_keys else _brute
    assert chip_smoke.tile_pairs(ids, q_tile, k_tile, by_keys, groups) == \
        brute(ids, q_tile, k_tile, groups)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_forward_walk_covers_every_visible_pair(pattern, monkeypatch):
    """Every pair a query sees (same id, key at or before it) lies in a
    tile its group computes, and one segment gives the causal walk."""
    ids = _ids(pattern, monkeypatch)
    q_tile, k_tile, _, groups = WALKS["fwd"]
    rows = q_tile // groups
    for q in range(T):
        g0 = q // rows * rows
        qids = ids[g0:g0 + rows]
        for j in np.unique(np.nonzero(ids[:q + 1] == ids[q])[0] // k_tile):
            k0 = j * k_tile
            kids = ids[k0:min(k0 + k_tile, q // q_tile * q_tile + q_tile, T)]
            assert not (kids.max() < qids.min() or qids.max() < kids.min())
    one = np.zeros(T, np.int32)
    causal = sum(min(g0 + rows, T) // k_tile + (min(g0 + rows, T) % k_tile > 0)
                 for g0 in range(0, T, rows))
    assert chip_smoke.tile_pairs(one, q_tile, k_tile, False, groups) == \
        causal * rows * k_tile


@pytest.mark.parametrize("walk", ("dq", "dkv"))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_backward_walks_cover_every_visible_pair(pattern, walk, monkeypatch):
    """dq: every pair a query sees lies in a key tile below its block's
    causal limit that its group computes; dkv: every pair a key is seen
    in lies in a query tile its block walks and its group computes.  One
    segment gives the causal walk."""
    ids = _ids(pattern, monkeypatch)
    q_tile, k_tile, by_keys, groups = WALKS[walk]
    if not by_keys:
        rows = q_tile // groups
        for q in range(T):
            g0 = q // rows * rows
            qids = ids[g0:min(g0 + rows, T)]
            kend = min(q // q_tile * q_tile + q_tile, T)
            for j in np.unique(np.nonzero(ids[:q + 1] == ids[q])[0]
                               // k_tile):
                k0 = j * k_tile
                assert k0 <= min(g0 + rows, T) - 1     # not causally skipped
                assert not _apart(ids[k0:min(k0 + k_tile, kend)], qids)
        causal = sum((min(g0 + rows, T) + k_tile - 1) // k_tile
                     for g0 in range(0, T, rows))
        tile = rows * k_tile
    else:
        rows = k_tile // groups
        for k in range(T):
            g0 = k // rows * rows
            kids = ids[g0:min(g0 + rows, T)]
            first = k // k_tile * k_tile // q_tile * q_tile  # the walk's start
            for j in np.unique((np.nonzero(ids[k:] == ids[k])[0] + k)
                               // q_tile):
                q0 = j * q_tile
                assert q0 >= first and q0 + q_tile - 1 >= g0
                assert not _apart(ids[q0:min(q0 + q_tile, T)], kids)
        causal = sum(len(range(max(g0 // q_tile * q_tile,
                                   g0 // k_tile * k_tile // q_tile * q_tile),
                               T, q_tile))
                     for g0 in range(0, T, rows))
        tile = q_tile * rows
    one = np.zeros(T, np.int32)
    assert chip_smoke.tile_pairs(one, q_tile, k_tile, by_keys, groups) == \
        causal * tile
