"""``chip_smoke.tile_pairs``, the model of the flash kernels' walks over
segment ids (csrc/flash_attention.cu), against a brute-force count on the
CPU: the forward's 128-query blocks of two 64-row consumer groups over
128-key tiles, and dq's 64-query blocks over 32-key tiles, on ids made as
``chip_smoke._varlen_ids`` makes them (packed documents, padding, a
segment with no keys, ids in no order).  Small: well under a second.
"""

import numpy as np
import pytest

import chip_smoke

T = 600
WALKS = {"fwd": (128, 128, 2), "dq": (64, 32, 1)}
PATTERNS = ("packed", "padding", "no_keys", "scrambled")


def _ids(pattern, monkeypatch, seed=3):
    """One row of query ids as chip_smoke draws them, on the CPU."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    qs, _ = chip_smoke._varlen_ids(pattern, 1, T, T, seed)
    return qs[0].numpy()


def _brute(ids, q_tile, k_tile, groups):
    """The walk, one (group, tile) at a time in plain Python: a group of
    a block computes a key tile below the block's causal limit when its
    last query sees the tile's first key and the two id sets' [min, max]
    ranges meet."""
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
                kids = [int(ids[k]) for k in keys]
                if max(kids) < min(qids) or max(qids) < min(kids):
                    continue
                pairs += rows * k_tile
    return pairs


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("pattern", PATTERNS)
def test_tile_pairs_matches_brute_force(pattern, walk, monkeypatch):
    ids = _ids(pattern, monkeypatch)
    q_tile, k_tile, groups = WALKS[walk]
    assert chip_smoke.tile_pairs(ids, q_tile, k_tile, False, groups) == \
        _brute(ids, q_tile, k_tile, groups)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_forward_walk_covers_every_visible_pair(pattern, monkeypatch):
    """Every pair a query sees (same id, key at or before it) lies in a
    tile its group computes, and one segment gives the causal walk."""
    ids = _ids(pattern, monkeypatch)
    q_tile, k_tile, groups = WALKS["fwd"]
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
