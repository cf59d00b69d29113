"""Port vs reference: the chain backend — its table and plain ops, its
oracles, its compaction, and the op layer that holds the two chain kernels
(``chain_probe``, ``chain_probe2``).

The same arenas (built by the reference and carried across with
``repro_torch.convert``) and the same numpy batches go through the JAX
functions — the fused ones with their Pallas kernels in interpret mode, the
default — and through ``repro_torch`` on the CPU, where the kernel wrappers
take their plain versions.  Tolerance 0 on every output: found, values,
node locations, ok flags and every arena array (``akey``, ``aval``,
``astate``, ``anext``, ``heads``, ``free_stack``, ``free_top``, ``bstart``,
``blen``, ``sorted_upto``), slot for slot.

The arenas are chosen to reach every branch of the kernels' contract: hits
in the sorted segments and in the dirty tail, tombstoned and migrated nodes,
a segment longer than ``max_chain`` and a dirty tail longer than the window
(both settle through the bounded walk), empty buckets, a new arena 4x the
old, and inserts refused because the free stack is empty.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backend as jbe  # noqa: E402
from repro.core import buckets as jb  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_convert import (CHAIN_ARRAYS, assert_tree_equal,  # noqa: E402
                                jax_table_tree)

LIVE, TOMB, MIGRATED = 1, 2, 3
J = jnp.asarray


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def same(*pairs):
    for i, (a, b) in enumerate(pairs):
        a, b = N(a), N(b)
        assert a.shape == b.shape and np.array_equal(a, b), (i, a, b)


def port(t) -> tb.ChainTable:
    """The port's copy of a reference chain table."""
    return convert.table_from_numpy(jax_table_tree(t), device="cpu")


def assert_tables_equal(jt, pt, where=""):
    assert_tree_equal(jax_table_tree(jt), convert.table_to_numpy(pt), where)


def keys_from(rng, lo: int, n: int) -> np.ndarray:
    return rng.choice(np.arange(lo, lo + 1_000_000), n,
                      replace=False).astype(np.int32)


def arena(nb=64, n=2048, n_items=600, seed=1, max_chain=64, compact=True,
          dead=0.0):
    """A reference arena with ``n_items`` keys placed by the plain insert,
    a share of them tombstoned and as many marked MIGRATED, then compacted
    (or left with every node in the dirty tail).  Returns (table, keys)."""
    rng = np.random.default_rng(seed)
    t = jb.chain_make(nb, n, jh.fresh("mix32", seed), max_chain=max_chain)
    keys = keys_from(rng, 0, n_items)
    t, ok = jax.jit(jb.chain_insert)(t, J(keys), J(keys * 3),
                                     jnp.ones(n_items, bool))
    assert bool(ok.all())
    if compact:
        t = jb.chain_compact_fused(t)
    if dead:
        st = np.array(t.astate)
        live = np.flatnonzero(st == LIVE)
        pick = rng.permutation(live)[: 2 * int(len(live) * dead)]
        st[pick[: len(pick) // 2]] = TOMB
        st[pick[len(pick) // 2:]] = MIGRATED
        t = jb.replace(t, astate=J(st))
    return t, keys


def queries(rng, keys: np.ndarray, n_miss: int) -> np.ndarray:
    return rng.permutation(np.concatenate([
        keys, rng.integers(5_000_000, 6_000_000, n_miss).astype(np.int32)]))


def parts(t):
    """The ops' argument triple of a port table."""
    return tb._chain_parts(t)


# ---------------------------------------------------------------------------
# the table and its plain ops
# ---------------------------------------------------------------------------

def test_chain_make_and_clear_equal_the_reference():
    for nb, n, mc in ((8, 96, 64), (256, 8192, 96)):
        jt = jb.chain_make(nb, n, jh.fresh("mix32", 5), max_chain=mc)
        pt = tb.chain_make(nb, n, tb.hashing.fresh("mix32", 5, "cpu"),
                           max_chain=mc)
        assert_tables_equal(jt, pt)
        assert pt.dirty_cap == tops.DIRTY_CAP == jops.DIRTY_CAP
        full, _ = arena(nb, n, n // 3, seed=nb, max_chain=mc)
        assert_tables_equal(jb.chain_clear(full), tb.chain_clear(port(full)))
    assert int(tb.chain_dirty(pt)) == 0


@pytest.mark.parametrize("compact", [False, True])
def test_plain_chain_ops_slot_for_slot(compact):
    """buckets.chain_insert / lookup / delete / extract_chunk / compact /
    count_live of both packages on one arena: duplicates, masked-out and
    already-present keys, and refusals once the free stack runs out."""
    rng = np.random.default_rng(7)
    jt, keys = arena(nb=32, n=700, n_items=500, seed=3, compact=compact)
    pt = port(jt)
    fresh = keys_from(rng, 2_000_000, 260)
    batch = np.concatenate([fresh, fresh[:40], keys[:30]]).astype(np.int32)
    mask = np.ones(batch.size, bool)
    mask[-7:] = False
    jt, jok = jax.jit(jb.chain_insert)(jt, J(batch), J(batch * 7), J(mask))
    pt, pok = tb.chain_insert(pt, T(batch), T(batch * 7), T(mask))
    same((jok, pok))
    assert N(pok).sum() == 200, "the free stack runs out: 200 of 260 fit"
    assert_tables_equal(jt, pt, "insert")
    qs = queries(rng, np.concatenate([keys, fresh]), 101)
    same(*zip(jb.chain_lookup(jt, J(qs)), tb.chain_lookup(pt, T(qs))))
    dels = np.concatenate([keys[::3], fresh[:50], qs[-20:]]).astype(np.int32)
    dm = rng.random(dels.size) < 0.9
    jt, jok = jax.jit(jb.chain_delete)(jt, J(dels), J(dm))
    pt, pok = tb.chain_delete(pt, T(dels), T(dm))
    same((jok, pok))
    assert_tables_equal(jt, pt, "delete")
    for cur in (0, 256, 650):
        jo = jb.chain_extract_chunk(jt, J(np.int32(cur)), 128)
        po = tb.chain_extract_chunk(pt, T(np.int32(cur)), 128)
        assert_tables_equal(jo[0], po[0], f"extract {cur}")
        same(*zip(jo[1:], po[1:]))
    jc, pc = jb.chain_compact(jt), tb.chain_compact(pt)
    assert_tables_equal(jc, pc, "compact")
    assert int(jb.chain_count_live(jt)) == int(tb.chain_count_live(pt))
    assert int(jb.chain_dirty(jt)) == int(tb.chain_dirty(pt))


def test_chain_oracles_match_the_reference():
    """The four ``ref.chain_*_ref`` of both packages on one arena."""
    rng = np.random.default_rng(11)
    jt, keys = arena(nb=16, n=1024, n_items=700, seed=4, max_chain=48,
                     dead=0.1)
    pt = port(jt)
    jn, pn = arena(nb=64, n=2048, n_items=300, seed=5)
    pn = port(jn)
    qs = queries(rng, keys, 77)
    bj = jh.bucket_of(jt.hfn, J(qs), jt.nbuckets)
    bn = jh.bucket_of(jn.hfn, J(qs), jn.nbuckets)
    ja = ((jt.akey, jt.aval, jt.astate), (jt.anext, jt.heads))
    pa = ((pt.akey, pt.aval, pt.astate), (pt.anext, pt.heads))
    jna = ((jn.akey, jn.aval, jn.astate), (jn.anext, jn.heads))
    pna = ((pn.akey, pn.aval, pn.astate), (pn.anext, pn.heads))
    for mc in (48, 8):        # 8: some chains are longer than the bound
        same(*zip(jref.chain_lookup_ref(*ja[0], *ja[1], bj, J(qs), mc),
                  tref.chain_lookup_ref(*pa[0], *pa[1], T(bj), T(qs), mc)))
    mask = J(rng.random(qs.size) < 0.8)
    same(*zip(jref.chain_delete_ref(*ja[0], *ja[1], bj, J(qs), mask, 48),
              tref.chain_delete_ref(*pa[0], *pa[1], T(bj), T(qs), T(mask),
                                    48)))
    ins = np.concatenate([keys_from(rng, 3_000_000, 400), keys[:20]])
    bi = jh.bucket_of(jt.hfn, J(ins), jt.nbuckets)
    win = jb.batch_winners(J(ins), jnp.ones(ins.size, bool))
    same(*zip(jref.chain_insert_ref(*ja[0], *ja[1], jt.free_stack,
                                    jt.free_top, bi, J(ins), J(ins * 5), win,
                                    48),
              tref.chain_insert_ref(*pa[0], *pa[1], pt.free_stack,
                                    pt.free_top, T(bi), T(ins), T(ins * 5),
                                    T(win), 48)))
    hk = keys_from(rng, 7_000_000, 64)
    hl = rng.random(64) < 0.7
    qh = np.concatenate([qs, hk, jn.akey[:50]]).astype(np.int32)
    bo = jh.bucket_of(jt.hfn, J(qh), jt.nbuckets)
    bn = jh.bucket_of(jn.hfn, J(qh), jn.nbuckets)
    same(*zip(
        jref.chain_ordered_lookup_ref(*ja, *jna, J(hk), J(hk * 7), J(hl), bo,
                                      bn, J(qh), 48),
        tref.chain_ordered_lookup_ref(*pa, *pna, T(hk), T(hk * 7), T(hl),
                                      T(bo), T(bn), T(qh), 48)))


def test_chain_compact_fused_all_ten_outputs():
    """``ops.chain_compact_fused`` of both packages, all ten outputs, on an
    arena with tombstones, migrated nodes and a dirty tail; and the
    invariants of the reference's test: the segments tile the live prefix,
    each holds only its bucket's keys, the walk still sees exactly the
    surviving keys."""
    jt, keys = arena(nb=64, n=2048, n_items=600, compact=False)
    jt, _ = jax.jit(jb.chain_delete)(jt, J(keys[:150]), jnp.ones(150, bool))
    st = np.array(jt.astate)
    st[np.flatnonzero(st == LIVE)[:40]] = MIGRATED
    jt = jb.replace(jt, astate=J(st))
    pt = port(jt)
    bj = jh.bucket_of(jt.hfn, jt.akey, jt.nbuckets)
    jo = jops.chain_compact_fused(jt.akey, jt.aval, jt.astate, bj,
                                  nbuckets=jt.nbuckets)
    po = tops.chain_compact_fused(pt.akey, pt.aval, pt.astate, T(bj),
                                  nbuckets=pt.nbuckets)
    assert len(po) == 10
    same(*zip(jo, po))
    pc = tbe.chain_compact_fused(pt)             # in place, the same values
    assert pc is pt
    assert_tables_equal(jb.chain_compact_fused(jt), pc)
    live = 600 - 150 - 40
    assert int(tb.chain_dirty(pc)) == 0 and int(pc.sorted_upto) == live
    assert int(pc.free_top) == pc.arena - live
    bstart, blen = N(pc.bstart), N(pc.blen)
    assert np.array_equal(bstart, np.concatenate([[0], blen.cumsum()[:-1]]))
    b_of = N(tb.hashing.bucket_of(pc.hfn, pc.akey, pc.nbuckets))
    for b in range(pc.nbuckets):
        assert (b_of[bstart[b]:bstart[b] + blen[b]] == b).all()
    f, v, _ = tb.chain_lookup(pc, T(keys))
    alive = np.isin(keys, N(pc.akey)[N(pc.astate) == LIVE])
    assert np.array_equal(N(f), alive) and alive.sum() == live
    assert np.array_equal(N(v)[alive], keys[alive] * 3)


def test_dirty_window_matches_the_reference():
    """``probe.chain_dirty_window`` against the reference's
    ``_chain_dirty_window``: window inside the arena, clamped at its end,
    covering the tail and not."""
    rng = np.random.default_rng(2)
    n = 700
    st = rng.integers(0, 4, n).astype(np.int32)
    ak = rng.integers(0, 300, n).astype(np.int32)
    av = ak * 5
    qk = rng.integers(0, 320, 211).astype(np.int32)
    for su, dirty, cap in ((100, 40, 64), (100, 80, 64), (650, 50, 64),
                           (690, 10, 512), (0, 700, 512)):
        args = (np.int32(su), np.int32(dirty))
        jo = jops._chain_dirty_window((J(ak), J(av), J(st)), *map(J, args),
                                      J(qk), cap)
        po = tprobe.chain_dirty_window((T(ak), T(av), T(st)),
                                       *map(T, args), T(qk), cap)
        same(*zip(jo, po))


# ---------------------------------------------------------------------------
# the single-arena fused ops (chain_probe)
# ---------------------------------------------------------------------------

def _stale(seed=9):
    """The reference's staleness case: every node in a dirty tail past the
    window (dirty = DIRTY_CAP + 188), so every miss takes the walk."""
    rng = np.random.default_rng(seed)
    t = jb.chain_make(64, 4096, jh.fresh("mix32", seed), max_chain=96)
    keys = keys_from(rng, 0, jops.DIRTY_CAP + 188)
    t, ok = jax.jit(jb.chain_insert_fused)(t, J(keys), J(keys * 2),
                                           jnp.ones(keys.size, bool))
    assert bool(ok.all()) and int(jb.chain_dirty(t)) > jops.DIRTY_CAP
    return t, keys


def _long_segment():
    """A compacted arena whose hot bucket holds 120 nodes (max_chain 64):
    its segment is not scanned, so its keys settle through the walk; plus a
    small dirty tail of keys in that bucket and elsewhere."""
    rng = np.random.default_rng(13)
    t = jb.chain_make(32, 2048, jh.fresh("mix32", 13), max_chain=64)
    cand = keys_from(rng, 0, 20_000)
    b = np.asarray(jh.bucket_of(t.hfn, J(cand), 32))
    hot = cand[b == 3][:120]
    keys = np.concatenate([hot, cand[b != 3][:300]]).astype(np.int32)
    t, _ = jax.jit(jb.chain_insert)(t, J(keys), J(keys * 3),
                                    jnp.ones(keys.size, bool))
    t = jb.chain_compact_fused(t)
    tail = np.concatenate([cand[b == 3][120:130], cand[b != 3][300:340]])
    t, _ = jax.jit(jb.chain_insert_fused)(t, J(tail), J(tail * 3),
                                          jnp.ones(tail.size, bool))
    assert int(jb.chain_dirty(t)) == 50
    assert int(np.asarray(t.blen).max()) == 120
    return t, np.concatenate([keys, tail]).astype(np.int32)


CASES = {
    "compacted": lambda: arena(dead=0.1),
    "dirty-tail": lambda: _tail(arena(n_items=500)),
    "stale-past-cap": _stale,
    "long-segment": _long_segment,
}


def _tail(tk):
    """Add a 90-node dirty tail (inside the window) to a compacted arena."""
    t, keys = tk
    extra = keys_from(np.random.default_rng(5), 3_000_000, 90)
    t, _ = jax.jit(jb.chain_insert_fused)(t, J(extra), J(extra * 3),
                                          jnp.ones(90, bool))
    return t, np.concatenate([keys, extra]).astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_single_arena_fused_ops_match_the_reference(case):
    """lookup / insert / delete through ``chain_probe`` against the
    reference's fused chain ops (found, val, loc; the whole arena after the
    insert and the delete; ok) and against both plain paths."""
    rng = np.random.default_rng(21)
    jt, keys = CASES[case]()
    pt = port(jt)
    qs = queries(rng, keys, 150)
    jl = jbe.chain_lookup_fused(jt, J(qs))
    pl = tbe.chain_lookup_fused_loc(pt, T(qs))
    same(*zip(jl, pl))
    f, v, _ = tb.chain_lookup(pt, T(qs))
    assert np.array_equal(N(f), N(pl[0])) and N(f).any() and not N(f).all()
    assert np.array_equal(N(v), N(pl[1]))

    fresh = keys_from(rng, 8_000_000, 150)
    batch = np.concatenate([fresh, fresh[:20], keys[:30]]).astype(np.int32)
    mask = rng.random(batch.size) < 0.95
    jt2, jok = jbe.chain_insert_fused(jt, J(batch), J(batch * 7), J(mask))
    pt2, pok, ppr = tbe.chain_insert_fused(pt, T(batch), T(batch * 7),
                                           T(mask), with_present=True)
    assert pt2 is pt
    same((jok, pok))
    assert_tables_equal(jt2, pt2, f"{case} insert")
    win = N(tb.batch_winners(T(batch), T(mask)))
    assert np.array_equal(N(ppr), win & N(jb.chain_lookup(jt, J(batch))[0]))

    dels = np.concatenate([keys[::4], fresh[:40],
                           qs[-30:]]).astype(np.int32)
    dm = np.ones(dels.size, bool)
    jt3, jok = jbe.chain_delete_fused(jt2, J(dels), J(dm))
    pt3, pok = tbe.chain_delete_fused(pt2, T(dels), T(dm))
    same((jok, pok))
    assert_tables_equal(jt3, pt3, f"{case} delete")
    # the plain path agrees on the answers (its arena is not compacted)
    qs2 = queries(rng, np.concatenate([keys, fresh]), 50)
    same(*zip(tb.chain_lookup(pt3, T(qs2)),
              tbe.chain_lookup_fused_loc(pt3, T(qs2))))


@pytest.mark.parametrize("case", ["compacted", "stale-past-cap"])
def test_chain_probe_plain_is_the_wrapper_on_the_cpu(case):
    """On CPU tensors the wrapper IS its plain version, and neither counts a
    launch; a window wider than the kernels stage is refused."""
    jt, keys = CASES[case]()
    pt = port(jt)
    qs = queries(np.random.default_rng(1), keys, 60)
    b = tb.hashing.bucket_of(pt.hfn, T(qs), pt.nbuckets)
    tprobe.reset_launches()
    a = tprobe.chain_probe(*parts(pt), b, T(qs), 64, 512)
    p = tprobe.chain_probe_plain(*parts(pt), b, T(qs), 64, 512)
    same(*zip(a, p))
    assert tprobe.launch_counts()["chain_probe"] == 0
    with pytest.raises(ValueError, match="dirty window"):
        tprobe._window(1024, parts(pt)[0])


def test_maybe_compact_on_both_sides_of_its_threshold():
    """``chain_maybe_compact`` at dirty == ``dirty_cap`` leaves the arena as it
    is, one node past it compacts, as the reference's ``lax.cond`` does;
    selected on the device and written in place."""
    rng = np.random.default_rng(17)
    jt, _ = arena(nb=64, n=4096, n_items=300, seed=17)
    ks = keys_from(rng, 9_000_000, jops.DIRTY_CAP + 40)   # one batch shape
    for extra in (jops.DIRTY_CAP, jops.DIRTY_CAP + 1):
        m = J(np.arange(ks.size) < extra)
        j1, _ = jbe.chain_insert_fused(jt, J(ks), J(ks), m)
        p1 = port(j1)
        assert int(tb.chain_dirty(p1)) == extra
        j2 = jbe.chain_maybe_compact(j1)
        tensors = [getattr(p1, f) for f in CHAIN_ARRAYS]
        p2 = tbe.chain_maybe_compact(p1)
        assert p2 is p1 and all(getattr(p2, f) is x
                                for f, x in zip(CHAIN_ARRAYS, tensors))
        assert_tables_equal(j2, p2, f"dirty {extra}")
        assert int(tb.chain_dirty(p2)) == (0 if extra > jops.DIRTY_CAP
                                           else extra)
    # the descriptor's insert is the fused insert plus this trigger
    m = jnp.ones(ks.size, bool)
    j3, jok = jbe._chain_insert_fused_compacting(jt, J(ks), J(ks), m)
    p3, pok = tbe.get("chain").insert_fused(port(jt), T(ks), T(ks), T(m))
    same((jok, pok))
    assert_tables_equal(j3, p3)
    assert int(tb.chain_dirty(p3)) == 0


# ---------------------------------------------------------------------------
# the rebuild-epoch fused ops (chain_probe2)
# ---------------------------------------------------------------------------

def _grown(old_case: str):
    """The reference's grown-arena case: a 4x new arena, partially landed
    and compacted, with a 120-node dirty tail; live and killed hazard
    entries."""
    rng = np.random.default_rng(1)
    told, k1 = CASES[old_case]() if old_case != "plain" else arena(seed=2)
    tnew = jb.chain_make(256, 8192, jh.fresh("mix32", 3), max_chain=64)
    k2 = keys_from(rng, 1_000_000, 400)
    tnew, _ = jax.jit(jb.chain_insert)(tnew, J(k2), J(k2 * 5),
                                       jnp.ones(400, bool))
    tnew = jb.chain_compact_fused(tnew)
    k3 = keys_from(rng, 4_000_000, 120)
    tnew, _ = jax.jit(jb.chain_insert_fused)(tnew, J(k3), J(k3 * 9),
                                             jnp.ones(120, bool))
    assert int(jb.chain_dirty(tnew)) == 120
    hk = keys_from(rng, 6_000_000, 64)
    hk[:5] = k1[:5]                      # also in the old arena: old wins
    hl = rng.random(64) < 0.7
    return rng, told, tnew, k1, k2, k3, hk, hl


@pytest.mark.parametrize("old_case", ["plain", "long-segment",
                                      "stale-past-cap"])
def test_ordered_ops_on_a_grown_arena_match_the_reference(old_case):
    """ordered lookup / delete through ``chain_probe2`` against the
    reference's fused ordered ops and the pointer-chasing ordered oracle,
    with a 4x new arena carrying a dirty tail, live and killed hazard
    entries, duplicates and absent keys; the old arena compacted, with a
    segment longer than max_chain, or all in a stale tail."""
    rng, told, tnew, k1, k2, k3, hk, hl = _grown(old_case)
    po, pn = port(told), port(tnew)
    qs = np.concatenate([k1[:200], k2[:200], k3[:60], hk,
                         np.tile(k1[:64], 2), rng.integers(
                             8_000_000, 9_000_000, 333)]).astype(np.int32)
    jf, jv = jbe.chain_ordered_lookup_fused(told, tnew, J(hk), J(hk * 7),
                                            J(hl), J(qs))
    pf, pv = tbe.chain_ordered_lookup_fused(po, pn, T(hk), T(hk * 7), T(hl),
                                            T(qs))
    same((jf, pf), (jv, pv))
    bo = jh.bucket_of(told.hfn, J(qs), told.nbuckets)
    bn = jh.bucket_of(tnew.hfn, J(qs), tnew.nbuckets)
    rf, rv = tref.chain_ordered_lookup_ref(
        (po.akey, po.aval, po.astate), (po.anext, po.heads),
        (pn.akey, pn.aval, pn.astate), (pn.anext, pn.heads),
        T(hk), T(hk * 7), T(hl), T(bo), T(bn), T(qs), 64)
    same((pf, rf), (pv, rv))

    dels = np.concatenate([k1[::5], k2[::5], k3[::5], hk[:20],
                           rng.integers(8_000_000, 9_000_000, 41)
                           ]).astype(np.int32)
    dm = np.ones(dels.size, bool)
    jo = jbe.chain_ordered_delete_fused(told, tnew, J(hk), J(hk * 7), J(hl),
                                        J(dels), J(dm))
    pout = tbe.chain_ordered_delete_fused(po, pn, T(hk), T(hk * 7), T(hl),
                                          T(dels), T(dm))
    same(*zip(jo, pout))
    assert pout[0] is po.astate and pout[1] is pn.astate    # in place
    assert N(pout[3]).any() and (N(pout[2]) != hl).any()


def test_chain_probe2_components_have_probe2s_meaning():
    """``chain_probe2``'s location outputs: f_old / loc_old for an old hit,
    hz_idx only where the old arena did not resolve, loc_new only where
    neither did; found and val as the ordered lookup's."""
    rng, told, tnew, k1, k2, k3, hk, hl = _grown("plain")
    po, pn = port(told), port(tnew)
    qs = np.concatenate([k1[:50], k2[:50], k3[:20], hk,
                         rng.integers(8_000_000, 9_000_000, 30)
                         ]).astype(np.int32)
    bo = tb.hashing.bucket_of(po.hfn, T(qs), po.nbuckets)
    bn = tb.hashing.bucket_of(pn.hfn, T(qs), pn.nbuckets)
    found, val, f_old, loc_old, hz, loc_new = tprobe.chain_probe2(
        parts(po), parts(pn), T(hk), T(hk * 7), T(hl), bo, bn, T(qs), 64,
        512)
    f_old, hz, loc_new = N(f_old), N(hz), N(loc_new)
    assert f_old[:50].all() and (N(loc_old)[f_old] >= 0).all()
    assert (hz[f_old] == -1).all() and (loc_new[f_old | (hz >= 0)] == -1).all()
    assert (hz >= 0).any() and (loc_new >= 0).any()
    assert np.array_equal(N(found), f_old | (hz >= 0) | (loc_new >= 0))
    assert (N(val)[~N(found)] == 0).all()


def test_window_escape_divergence_is_pinned():
    """The one divergence from the reference's fused chain lookup (ROADMAP
    C): its kernel probes a two-block window of the padded arena and sends
    a query whose segment lies outside the window to the bounded walk,
    which stops after ``max_chain`` nodes counted from the head — dirty
    nodes of the bucket first.  A key at the end of a short segment behind
    enough dirty nodes is then reported absent, though it is LIVE.  The
    port scans every segment of at most ``max_chain`` nodes, so it finds
    the key wherever the segment lies (as the reference does when the
    window holds it); both plain paths walk, and miss it, as the
    reference's."""
    rng = np.random.default_rng(31)
    t = jb.chain_make(2048, 16384, jh.fresh("mix32", 31), max_chain=8)
    keys = keys_from(rng, 0, 12_000)
    t, _ = jax.jit(jb.chain_insert)(t, J(keys), J(keys * 3),
                                    jnp.ones(keys.size, bool))
    t = jb.chain_compact_fused(t)
    bstart, blen = np.asarray(t.bstart), np.asarray(t.blen)
    b = int(np.flatnonzero((bstart > 8192 + 64) & (blen >= 5)
                           & (blen <= 8))[0])
    target = int(np.asarray(t.akey)[bstart[b] + blen[b] - 1])
    cand = keys_from(rng, 3_000_000, 200_000)
    front = cand[np.asarray(jh.bucket_of(t.hfn, J(cand), 2048)) == b][:4]
    t, _ = jax.jit(jb.chain_insert_fused)(t, J(front), J(front),
                                          jnp.ones(4, bool))
    qs = np.concatenate([keys[:100], [target]]).astype(np.int32)
    jf = np.asarray(jbe.chain_lookup_fused(t, J(qs))[0])
    pt = port(t)
    pf, pv, _ = tbe.chain_lookup_fused_loc(pt, T(qs))
    assert not jf[-1] and not N(jb.chain_lookup(t, J(qs))[0])[-1]
    assert not N(tb.chain_lookup(pt, T(qs))[0])[-1]
    assert N(pf)[-1] and N(pv)[-1] == target * 3
    assert np.array_equal(jf[:-1], N(pf)[:-1])      # the rest agree


@pytest.mark.parametrize("backend", ["linear", "twochoice", "cuckoo", "chain"])
def test_fused_engine_steps_read_nothing_uncounted(backend):
    """The glue around the kernels reads nothing on the host: engine steps
    on the fused path between polls — steady state, a rebuild epoch and its
    end (the swap, and in continuous mode the next start, taken on the
    device; in requested mode the inserts after the swap, which pick their
    table on the device; on a policy engine the reclaim rehash its policy
    starts on the device, and that epoch) — dispatch no scalar read
    (``aten::_local_scalar_dense``, what ``item()``, ``bool()``, ``int()``
    and indexing with a 0-dim tensor run) and no ``nonzero`` outside the
    kernel wrappers (on the CPU those run their plain versions, which may
    read; on the card they launch and read nothing), on every backend."""
    from unittest import mock

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import dhash as tdhash
    from repro_torch.core.engine import DHashEngine as TEngine

    class Reads(TorchDispatchMode):
        paused, seen = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if not self.paused and ("_local_scalar_dense" in name
                                    or name.startswith("nonzero")):
                self.seen.append(name)
            return func(*args, **(kwargs or {}))

    mode = Reads()
    mode.seen = []

    def pausing(fn):
        def run(*a, **k):
            mode.paused += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return run

    from repro_torch.core import policy as tpol
    for continuous, policy in ((True, False), (False, False), (False, True)):
        # a policy engine: its tombstone reclaim starts on the device
        eng = TEngine(tdhash.make(backend, capacity=512, chunk=128,
                                  fused=True, seed=3, device="cpu"),
                      continuous_rebuild=continuous, poll_every=10**6,
                      policy=tpol.make(tomb_load=0.01, device="cpu")
                      if policy else None)
        rng = np.random.default_rng(5)
        keys = rng.choice(1 << 20, 1200, replace=False).astype(np.int32)
        eng.step(keys[:0], keys[:250], keys[:250], keys[:0])
        if not (continuous or policy):
            eng.request_rebuild(seed=11)
        epoch0 = int(eng.state.epoch)
        # every kernel wrapper: the twelve, and the entries that launch one
        # of them (each has a plain version beside it)
        wrappers = [k for k in dir(tprobe) if hasattr(tprobe, f"{k}_plain")]
        assert set(tprobe.KERNELS) <= set(wrappers)
        patches = [mock.patch.object(tprobe, k, pausing(getattr(tprobe, k)))
                   for k in wrappers]
        for p in patches:
            p.start()
        try:
            with mode:
                for s in range(28):
                    look = rng.choice(keys, 100).astype(np.int32)
                    ins = keys[250 + 30 * s:280 + 30 * s]
                    eng.step(look, ins, ins * 3, look[:20])
        finally:
            for p in patches:
                p.stop()
        assert int(eng.state.epoch) > epoch0, (continuous, "no epoch ended")
        assert eng._stats.host_syncs == 0
        assert mode.seen == [], (continuous, mode.seen)
