"""The placement the ``chain_compact`` kernel relies on, pinned on the CPU.

The kernel (``src/repro_torch/kernels/csrc/chain_compact.cu``) writes what
the plain compaction (``ops.chain_compact_fused``: one stable sort of the
arena keyed on (bucket, arena index), dead nodes last) writes, without
sorting the arena.  It reads the layout the last compaction left: bucket
b's nodes of the sorted prefix ``[0, sorted_upto)`` are the run
``[bstart[b], bstart[b] + blen[b])``; every node allocated since lies in the
dirty tail ``[sorted_upto, arena - free_top)``, and b's tail nodes are the
nodes of b's chain in front of its run.  A live node goes to its bucket's
start (an exclusive scan of the live counts) plus its rank among the live
nodes of its run, or plus the run's live count and its rank by arena index
among the bucket's live tail nodes.  A bucket's thread walks its chain's
tail part (newest batch first, each batch in arena order) and sorts what it
found; a bucket with more live tail nodes than ``small``, or a longer walk
than ``walk``, is ranked by one ordered pass over the tail instead.

The buckets are cut into tiles: the kernel's block of a tile ranks the
tail of each listed bucket of its tile, scans its bucket totals (each
bucket's start within the tile) and writes the tile's sum; the first
block of the next launch scans the tile sums into each tile's start and the
live count, so a bucket's start is its tile's start plus its start within
the tile.

``model_compact`` below is that placement in numpy, step for step, with
small limits and small tiles so that both ways are taken and an arena has
several tiles.  On arenas built by the port's chain ops on the CPU (inserts
in several batches, so that a chain's walk order is not the arena order;
deletes; a chunk migrated by the extract; a compaction between; a bucket
flooded with tail nodes; floods in several tiles and at a tile's edge; a
tile of empty buckets; a fresh arena whose every node is tail; a full
arena; nothing live) it must equal the plain compaction on all ten arrays,
tolerance 0.  A model that ranked tail nodes in walk order departs from
it.  The wrapper's guard (the flag and the dirty count) is held
on the CPU too; the card holds the kernel to the plain version
(``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.core import hashing  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402

LIVE, EMPTY = 1, 0
SMALL, WALK, TILE = 4, 8, 8


def fields(t) -> list:
    return [x.clone() for x in tbe._chain_fields(t)]


def exclusive(x: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(x)[:-1]]).astype(np.int64)


def model_compact(t, *, small: int = SMALL, walk: int = WALK,
                  tile: int = TILE, sort: bool = True) -> list:
    """The kernel's three launches in numpy; returns the ten arrays.
    ``sort`` False ranks a bucket's tail nodes in walk order (a
    departure).  Sets ``model_compact.listed``: the listed buckets by tile."""
    akey, aval, astate, anext, heads, _, free_top, bstart, blen, su = (
        x.numpy().copy() for x in tbe._chain_fields(t))
    n, nb = akey.size, t.nbuckets
    su, end = int(su), n - int(free_top)
    bucket = hashing.bucket_of(t.hfn, torch.as_tensor(akey), nb).numpy()
    live = astate == LIVE
    ntiles = -(-nb // tile)
    tot, lstart, rank = (np.zeros(k, np.int64) for k in (nb, nb, n))
    tsum = np.zeros(ntiles, np.int64)
    listed = {}
    # 1. cc_scan: a block a tile, a thread a bucket
    for tl in range(ntiles):
        lo, hi = tl * tile, min(nb, (tl + 1) * tile)
        for b in range(lo, hi):
            c = 0
            for i in range(bstart[b], bstart[b] + blen[b]):
                if live[i]:
                    rank[i] = c
                    c += 1
            mine, hops, over, v = [], 0, False, heads[b]
            while v >= su:
                hops += 1
                if hops > walk:
                    over = True
                    break
                if live[v]:
                    if len(mine) == small:
                        over = True
                        break
                    mine.append(v)
                v = anext[v]
            tot[b] = c
            if over:
                listed.setdefault(tl, []).append(b)
                continue
            for r, v in enumerate(sorted(mine) if sort else mine):
                rank[v] = c + r
            tot[b] = c + len(mine)
        # the tile's block: each listed bucket by an ordered pass over the
        # tail, then the exclusive scan of the tile's totals
        for b in listed.get(tl, []):
            mine = [i for i in range(su, end) if live[i] and bucket[i] == b]
            for r, v in enumerate(mine):
                rank[v] = tot[b] + r
            tot[b] += len(mine)
        lstart[lo:hi] = exclusive(tot[lo:hi])
        tsum[tl] = tot[lo:hi].sum()
    # 2. cc_gather: the first block scans the tile sums; each live node goes
    #    to its tile's start + its bucket's start in the tile + its rank
    tpre, nlive = exclusive(tsum), int(tsum.sum())
    start = tpre[np.arange(nb) // tile] + lstart
    out_k, out_v, out_b = (np.zeros(n, np.int64) for _ in range(3))
    for i in range(end):
        if not live[i]:
            continue
        b = bucket[i]
        dst = start[b] + rank[i]
        out_k[dst], out_v[dst], out_b[dst] = akey[i], aval[i], b
    # 3. cc_write
    idx = np.arange(n)
    on = idx < nlive
    nxt = np.zeros(n, bool)
    nxt[:-1] = on[1:] & (out_b[1:] == out_b[:-1])
    model_compact.listed = listed
    return [np.where(on, out_k, 0), np.where(on, out_v, 0),
            np.where(on, LIVE, EMPTY), np.where(on & nxt, idx + 1, -1),
            np.where(tot > 0, start, -1), n - 1 - idx,
            np.array(n - nlive), start, tot, np.array(nlive)]


def plain(t) -> list:
    f = fields(t)
    tprobe.chain_compact_plain(f, t.hfn, t.nbuckets)
    return f


def table(nb: int = 32, arena: int = 512):
    return tbe._make_chain(arena, 7, nbuckets=nb, dirty_cap=64, device="cpu")


def insert(t, keys):
    k = torch.as_tensor(np.asarray(keys, np.int32))
    tbe.chain_insert_fused(t, k, k * 3 + 1, torch.ones_like(k, dtype=bool))


def keys_of_bucket(t, b: int, n: int, rng) -> np.ndarray:
    cand = rng.choice(np.arange(1, 1 << 20), 40 * n * t.nbuckets,
                      replace=False).astype(np.int32)
    hit = hashing.bucket_of(t.hfn, torch.as_tensor(cand), t.nbuckets).numpy()
    out = cand[hit == b][:n]
    assert out.size == n
    return out


def arena(case: str):
    rng = np.random.default_rng(sum(map(ord, case)))
    t = table()
    if case == "nothing_live":
        return t
    keys = rng.choice(np.arange(1, 1 << 16), 300, replace=False)
    if case == "fresh_tail":                 # every node in the tail
        for part in np.array_split(keys[:200], 5):
            insert(t, part)
        return t
    if case == "full":                       # live == arena: no free node
        keys = rng.choice(np.arange(1, 1 << 16), t.akey.numel(),
                          replace=False)
        insert(t, keys[:400])
        tbe.chain_compact_fused(t)
        for part in np.array_split(keys[400:], 2):
            insert(t, part)
        assert int(t.free_top) == 0
        return t
    if case == "empty_tile":                 # buckets 16..23: no key
        b = hashing.bucket_of(t.hfn, torch.as_tensor(keys.astype(np.int32)),
                              t.nbuckets).numpy()
        keys = keys[(b < 2 * TILE) | (b >= 3 * TILE)]
    for part in np.array_split(keys[:160], 4):
        insert(t, part)
    d = torch.as_tensor(keys[:160:5].astype(np.int32))
    tbe.chain_delete_fused(t, d, torch.ones_like(d, dtype=bool))
    tbe.chain_compact_fused(t)               # the sorted prefix
    for part in np.array_split(keys[160:260], 3):
        insert(t, part)                      # a tail from three batches
    d = torch.as_tensor(keys[100:240:4].astype(np.int32))
    tbe.chain_delete_fused(t, d, torch.ones_like(d, dtype=bool))
    t2, *_ = tbe.chain_extract_chunk_fused(t, torch.tensor(64), 64)
    if case in ("flood", "flood_deleted"):   # one bucket's long tail
        fk = keys_of_bucket(t, 5, 50, rng)
        for part in np.array_split(fk, 3):
            insert(t, part)
        if case == "flood_deleted":          # a long walk, few live nodes
            d = torch.as_tensor(fk[3:].astype(np.int32))
            tbe.chain_delete_fused(t, d, torch.ones_like(d, dtype=bool))
    if case in FLOODED:                      # long tails in several tiles
        for b in FLOODED[case]:
            fk = keys_of_bucket(t, b, 12, rng)
            for part in np.array_split(fk, 2):
                insert(t, part)
    return t


# flooded buckets: in three tiles; on both sides of the edge of tiles 0 and 1
FLOODED = {"floods_in_tiles": (2, 13, 29), "tile_edge": (TILE - 1, TILE)}
CASES = ["mixed", "flood", "flood_deleted", "fresh_tail", "nothing_live",
         "floods_in_tiles", "tile_edge", "empty_tile", "full"]


@pytest.mark.parametrize("case", CASES)
def test_model_equals_the_plain_compaction(case):
    t = arena(case)
    want, got = plain(t), model_compact(t)
    names = ("akey", "aval", "astate", "anext", "heads", "free_stack",
             "free_top", "bstart", "blen", "sorted_upto")
    for a, b, name in zip(got, want, names):
        assert np.array_equal(np.asarray(a), b.numpy()), (case, name)
    listed = model_compact.listed
    if case in ("flood", "flood_deleted"):
        assert 5 in listed.get(0, []), "the flood took the thread's way"
    if case in FLOODED:
        for b in FLOODED[case]:
            assert b in listed.get(b // TILE, []), (case, b)
    if case == "empty_tile":
        assert not want[8][2 * TILE:3 * TILE].any()
    if case == "full":
        assert int(want[9]) == t.akey.numel() and listed, case
    if case == "mixed":
        assert int(t.sorted_upto) > 0 and int((t.astate == 3).sum()) > 0
    if case != "nothing_live":
        # with limits high enough no bucket is listed, and with one tile the
        # scan is one block's: the same result
        for tile in (TILE, t.nbuckets):
            high = model_compact(t, small=1 << 20, walk=1 << 20, tile=tile)
            assert model_compact.listed == {}
            for a, b in zip(high, want):
                assert np.array_equal(np.asarray(a), b.numpy()), case


def test_ranks_in_walk_order_depart():
    """A chain's walk visits its newest batch first: ranking a bucket's tail
    nodes in that order, not by arena index, misplaces them."""
    t = arena("mixed")
    want = plain(t)
    got = model_compact(t, small=1 << 20, walk=1 << 20, sort=False)
    assert not all(np.array_equal(np.asarray(a), b.numpy())
                   for a, b in zip(got, want))


@pytest.mark.parametrize("where,dirty_cap,runs", [
    (None, -1, True), (True, -1, True), (False, -1, False),
    (None, 10_000, False), (True, 0, True), (False, 0, False)])
def test_the_guard(where, dirty_cap, runs):
    """The plain version takes the compaction where the flag is set (or not
    given) and the dirty tail is longer than ``dirty_cap`` (or none is
    given), else leaves every array as it was."""
    t = arena("mixed")
    before, want = fields(t), plain(t)
    f = fields(t)
    flag = None if where is None else torch.tensor(where)
    tprobe.chain_compact(f, t.hfn, t.nbuckets, flag, dirty_cap)
    for a, b, c in zip(f, want, before):
        assert torch.equal(a, b if runs else c)
    assert int(tb.chain_dirty(t)) > 0
