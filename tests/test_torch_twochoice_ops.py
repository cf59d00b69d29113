"""Port vs reference: the op layer that holds the three two-row kernels
(``tc_lookup``, ``tc_insert``, ``tc_probe2``), which serve twochoice and
cuckoo.

The same numpy [B, W] tables and batches go through the JAX ``kernels/ops.py``
twochoice functions (their Pallas kernels in interpret mode, the default) and
through ``repro_torch.kernels.ops`` on the CPU, where the wrappers take the
kernels' plain versions.  Tolerance 0; ``loc`` is the flat slot row * W +
lane in both packages.  Widths 8 and 6 (6 is not a multiple of the 16-byte
row loads of the kernels); bucket counts that are not powers of two.

Read-side outputs (found, val, loc, delete ok and states, the hazard kill,
the extract outputs) are held against the JAX ops.  Insert placement is held
slot for slot against the plain oracle (``ref.tc_insert_ref`` /
``buckets.twochoice_insert`` of BOTH packages); the reference's fused insert
is a different legal linearisation under contention (an a-claim shadows a
b-claim, first claimant across tiles), so against it only ``ok`` and the live
key -> value map are compared, at a load where no row fills.
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
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_convert import jax_table_tree  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
J = jnp.asarray


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rows_of(hfns, keys: np.ndarray, b: int):
    return tuple(np.array(jh.bucket_of(h, J(keys), b)) for h in hfns)


def make_rows(b: int, w: int, n_live: int, seed: int, dead: float = 0.15,
              key_lo: int = -50_000):
    """Numpy [B, W] arrays with ``n_live`` keys placed by the reference's
    insert oracle, then a share tombstoned and a share marked MIGRATED.
    Returns (hash functions, (key, val, state), keys)."""
    rng = np.random.default_rng(seed)
    hfns = (jh.fresh("mix32", seed), jh.fresh("mix32", seed + 100))
    keys = rng.choice(np.arange(key_lo, key_lo + 100_000), n_live,
                      replace=False).astype(np.int32)
    ra, rb = rows_of(hfns, keys, b)
    z = jnp.zeros((b, w), jnp.int32)
    tk, tv, ts, _ = jref.tc_insert_ref(z, z, z, J(ra), J(rb), J(keys),
                                       J(keys * 7), jnp.ones(n_live, bool), 8)
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    live = np.flatnonzero(ts.reshape(-1) == LIVE)
    pick = rng.permutation(live)
    n = int(len(live) * dead)
    ts.reshape(-1)[pick[:n]] = TOMB
    ts.reshape(-1)[pick[n:2 * n]] = MIGRATED
    return hfns, (tk, tv, ts), keys


def queries(keys: np.ndarray, q: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hit = rng.choice(keys, q // 2)
    miss = rng.integers(200_000, 2**31 - 1, q - q // 2).astype(np.int32)
    return rng.permutation(np.concatenate([hit, miss])).astype(np.int32)


# (B, W, live keys, Q): small, non-power-of-two, ragged, width 6 and 8
SHAPES = [(64, 8, 300, 77), (509, 8, 2_400, 600), (100, 6, 380, 301)]


@pytest.mark.parametrize("b,w,n,q", SHAPES)
def test_tc_lookup_matches_reference(b, w, n, q):
    hfns, tab, keys = make_rows(b, w, n, seed=b)
    qk = queries(keys, q, seed=1)
    ra, rb = rows_of(hfns, qk, b)
    rb[: q // 8] = ra[: q // 8]                    # both choices one row
    jf, jv, jl = jops.twochoice_lookup(*map(J, tab), J(ra), J(rb), J(qk))
    tf, tv, tl = tops.twochoice_lookup(*map(T, tab), T(ra), T(rb), T(qk))
    for a, c in ((jf, tf), (jv, tv), (jl, tl)):
        assert np.array_equal(np.asarray(a), N(c))
    assert N(tf).any() and not N(tf).all()
    assert (N(tl)[N(tf)] // w == rb[N(tf)]).any(), "some hits in row b"
    # the per-row oracles of both packages agree
    for rows in (ra, rb):
        for a, c in zip(jref.tc_row_lookup_ref(*map(J, tab), J(rows), J(qk)),
                        tref.tc_row_lookup_ref(*map(T, tab), T(rows), T(qk))):
            assert np.array_equal(np.asarray(a), N(c))
    # and so do the plain table lookups (values where found: a miss's is
    # unspecified there, but the same in both packages)
    jt = jb.TwoChoiceTable(nbuckets=b, width=w, max_rounds=8, hfn_a=hfns[0],
                           hfn_b=hfns[1], key=J(tab[0]), val=J(tab[1]),
                           state=J(tab[2]))
    pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
    for a, c in zip(jb.twochoice_lookup(jt, J(qk)),
                    tb.twochoice_lookup(pt, T(qk))):
        assert np.array_equal(np.asarray(a), N(c))
    pf, _, pl = tb.twochoice_lookup(pt, T(qk))
    hf, _, hl = tops.twochoice_lookup(*map(T, tab), *(T(r) for r in rows_of(
        hfns, qk, b)), T(qk))
    assert torch.equal(pf, hf) and torch.equal(pl, hl)


@pytest.mark.parametrize("b,w,n,q", SHAPES)
def test_tc_delete_matches_reference(b, w, n, q):
    hfns, tab, keys = make_rows(b, w, n, seed=b + 1)
    rng = np.random.default_rng(2)
    qk = queries(keys, q, seed=3)
    qk[: q // 10] = qk[q // 10: 2 * (q // 10)]          # duplicates
    mask = rng.random(q) < 0.8
    win = np.asarray(jb.batch_winners(J(qk), J(mask)))
    ra, rb = rows_of(hfns, qk, b)
    js, jok = jops.twochoice_delete(*map(J, tab), J(ra), J(rb), J(qk),
                                    J(win))
    tt = [T(x) for x in tab]
    ts, tok = tops.twochoice_delete(*tt, T(ra), T(rb), T(qk), T(win))
    assert ts is tt[2], "twochoice_delete writes the state array in place"
    assert np.array_equal(np.asarray(jok), N(tok))
    assert np.array_equal(np.asarray(js), N(ts))
    assert N(tok).any()
    rs, rok = tref.tc_delete_ref(*map(T, tab), T(ra), T(rb), T(qk), T(win))
    assert torch.equal(rs, ts) and torch.equal(rok, tok)
    js2, jok2 = jref.tc_delete_ref(*map(J, tab), J(ra), J(rb), J(qk), J(win))
    assert np.array_equal(np.asarray(js2), N(ts))


# --- insert -----------------------------------------------------------------

def insert_batch(kind: str, b: int, w: int, seed: int):
    """(table arrays, rows_a, rows_b, keys, vals, winner mask) for one
    adversarial case."""
    rng = np.random.default_rng(seed)
    hfns, tab, keys = make_rows(b, w, b * w // 3, seed=seed)
    q = {"ragged": 599, "hot": 300}.get(kind, 200)
    k = rng.choice(np.arange(300_000, 900_000), q,
                   replace=False).astype(np.int32)
    if kind == "dups":        # duplicates and re-inserts of live/dead keys
        k[: q // 4] = rng.choice(keys, q // 4)
        k[q // 4: q // 2] = k[q // 2: q // 2 + q // 4]
    ra, rb = rows_of(hfns, k, b)
    if kind == "hot":         # one hot row pair: most fail after max_rounds
        ra[:], rb[: q // 2] = 3, 5
    if kind == "same":        # both choices the same row
        rb[:] = ra
    if kind == "full":        # fill some rows LIVE first
        full = rng.choice(b, b // 4, replace=False)
        tab[2][full] = LIVE
        ra[: q // 3] = full[0]
        rb[: q // 6] = full[1]
    mask = rng.random(q) < 0.9
    win = np.asarray(jb.batch_winners(J(k), J(mask)))
    return tab, ra, rb, k, (k * 5 + 1).astype(np.int32), win


INSERT_CASES = [("plain", 64, 8, 8), ("dups", 509, 8, 8), ("hot", 64, 8, 8),
                ("hot", 100, 6, 2), ("ragged", 509, 8, 8),
                ("same", 100, 6, 8), ("full", 128, 8, 2),
                ("ragged", 100, 6, 2)]


@pytest.mark.parametrize("kind,b,w,rounds", INSERT_CASES)
def test_tc_insert_slot_for_slot_vs_oracle(kind, b, w, rounds):
    tab, ra, rb, k, v, win = insert_batch(kind, b, w, seed=b + w + rounds)
    jk, jv, js, jok = jref.tc_insert_ref(*map(J, tab), J(ra), J(rb), J(k),
                                         J(v), J(win), rounds)
    tt = [T(x) for x in tab]
    tk, tv, ts, tok, present = tops.twochoice_insert(
        *tt, T(ra), T(rb), T(k), T(v), T(win), max_rounds=rounds,
        with_present=True)
    assert tk is tt[0] and tv is tt[1] and ts is tt[2], "in place"
    for a, c in ((jk, tk), (jv, tv), (js, ts), (jok, tok)):
        assert np.array_equal(np.asarray(a), N(c)), kind
    if kind == "hot":
        assert (win & ~N(tok) & ~N(present)).sum() > win.sum() // 3, \
            "most hot-row inserts must find no lane"
    rk, rv, rs, rok = tref.tc_insert_ref(*map(T, tab), T(ra), T(rb), T(k),
                                         T(v), T(win), rounds)
    assert all(torch.equal(a, c) for a, c in
               ((rk, tk), (rv, tv), (rs, ts), (rok, tok)))
    fa, _, _ = tref.tc_row_lookup_ref(*map(T, tab), T(ra), T(k))
    fb, _, _ = tref.tc_row_lookup_ref(*map(T, tab), T(rb), T(k))
    assert torch.equal(present, (fa | fb) & T(win))


@pytest.mark.parametrize("b,w", [(16, 8), (101, 6)])
def test_twochoice_insert_slot_for_slot_both_packages(b, w):
    """buckets.twochoice_insert (plain) of both packages and the port's fused
    adapter: identical tables and ok on duplicates, re-inserts, masked tails;
    then lookups, deletes and the chunk scan of the plain surface."""
    rng = np.random.default_rng(b)
    base = rng.choice(100_000, b * w // 3, replace=False).astype(np.int32)
    fresh = rng.choice(np.arange(200_000, 300_000), b * w // 4,
                       replace=False).astype(np.int32)
    batch = np.concatenate([fresh, fresh[: b * w // 8], base[: b * w // 10]])
    mask = np.ones(batch.shape, bool)
    mask[-(b * w // 20):] = False
    jt = jb.twochoice_make(b, jh.fresh("mix32", 1), jh.fresh("mix32", 2),
                           width=w)
    plain = tb.twochoice_make(b, th.fresh("mix32", 1, "cpu"),
                              th.fresh("mix32", 2, "cpu"), width=w)
    fused = tb.twochoice_make(b, plain.hfn_a, plain.hfn_b, width=w)
    for keys, m in ((base, np.ones(base.shape, bool)), (batch, mask)):
        jt, jok = jax.jit(jb.twochoice_insert)(jt, J(keys), J(keys * 3), J(m))
        plain, pok = tb.twochoice_insert(plain, T(keys), T(keys * 3), T(m))
        fused, fok = tbe.twochoice_insert_fused(fused, T(keys), T(keys * 3),
                                                T(m))
        assert np.array_equal(np.asarray(jok), N(pok))
        assert np.array_equal(np.asarray(jok), N(fok))
    for f in ("key", "val", "state"):
        assert np.array_equal(np.asarray(getattr(jt, f)), N(getattr(plain, f)))
        assert np.array_equal(np.asarray(getattr(jt, f)), N(getattr(fused, f)))
    probe = np.concatenate([base, fresh, fresh + 1_000_000]).astype(np.int32)
    for a, c in zip(jax.jit(jb.twochoice_lookup)(jt, J(probe)),
                    tb.twochoice_lookup(plain, T(probe))):
        assert np.array_equal(np.asarray(a), N(c))
    jt2, jok = jax.jit(jb.twochoice_delete)(jt, J(probe[::3]),
                                            jnp.ones(probe[::3].shape, bool))
    pt2, pok = tb.twochoice_delete(plain, T(probe[::3]),
                                   torch.ones(probe[::3].shape,
                                              dtype=torch.bool))
    assert np.array_equal(np.asarray(jok), N(pok))
    assert np.array_equal(np.asarray(jt2.state), N(pt2.state))
    cur = b * w - 40
    jt3, *jh3 = jb.twochoice_extract_chunk(jt2, J(np.int32(cur)), 64)
    pt3, *ph3 = tb.extract_chunk(pt2, torch.tensor(cur, dtype=torch.int32),
                                 64)
    assert np.array_equal(np.asarray(jt3.state), N(pt3.state))
    for a, c in zip(jh3, ph3):
        assert np.array_equal(np.asarray(a), N(c))
    assert int(jb.twochoice_count_live(jt3)) == int(tb.count_live(pt3))


def test_tc_insert_vs_reference_fused_low_load():
    """Against the reference's FUSED insert at a load where no row fills:
    identical ok and an identical live key -> value map (placement may
    differ)."""
    rng = np.random.default_rng(5)
    b, w = 509, 8
    hfns = (jh.fresh("mix32", 5), jh.fresh("mix32", 6))
    keys = rng.choice(1_000_000, 600, replace=False).astype(np.int32)
    keys[:40] = keys[40:80]                               # duplicates
    win = np.asarray(jb.batch_winners(J(keys), jnp.ones(keys.shape, bool)))
    ra, rb = rows_of(hfns, keys, b)
    z = np.zeros((b, w), np.int32)
    jk, jv, js, jok = jops.twochoice_insert(J(z), J(z), J(z), J(ra), J(rb),
                                            J(keys), J(keys * 5), J(win))
    tk, tv, ts, tok = tops.twochoice_insert(T(z), T(z), T(z), T(ra), T(rb),
                                            T(keys), T(keys * 5), T(win))
    assert np.array_equal(np.asarray(jok), N(tok)) and N(tok).sum() == 560

    def live_map(k, v, s):
        k, v, s = (np.asarray(x) for x in (k, v, s))
        return dict(zip(k[s == LIVE].tolist(), v[s == LIVE].tolist()))
    assert live_map(jk, jv, js) == live_map(N(tk), N(tv), N(ts))


# --- the rebuild epoch: extract on the flattened rows, the ordered ops -------

def ordered_case(b_old: int, b_new: int, w: int, chunk: int, q: int,
                 seed: int):
    """Old table mid-rebuild (the chunk at `chunk` extracted by the fused
    extract on its flattened arrays), a hazard buffer with killed entries, a
    new table, and queries that hit each of them and nothing."""
    rng = np.random.default_rng(seed)
    hfo, old, ko = make_rows(b_old, w, b_old * w // 2, seed=seed)
    hfn, new, kn = make_rows(b_new, w, b_new * w // 8, seed=seed + 1,
                             key_lo=200_000)
    os_, hk, hv, hl, _ = jops.extract_chunk_fused(
        *(J(x.reshape(-1)) for x in old), J(np.int32(chunk)), chunk=chunk)
    old = (old[0], old[1], np.array(os_).reshape(b_old, w))
    hk, hv, hl = np.array(hk), np.array(hv), np.array(hl)
    n_hz = int(hl.sum())
    assert n_hz > 2
    hl &= rng.random(chunk) < 0.7                        # killed entries
    qk = np.concatenate([
        rng.choice(ko, q // 4), rng.choice(hk[:n_hz], q // 4),
        rng.choice(kn, q // 4),
        rng.integers(1_000_000, 2**31 - 1, q - 3 * (q // 4))]).astype(np.int32)
    qk = rng.permutation(qk)
    return (old, new, hk, hv, hl, *rows_of(hfo, qk, b_old),
            *rows_of(hfn, qk, b_new), qk)


# (old rows, new rows, W, chunk, Q): growth 1x and 4x, non-power-of-two rows
ORDERED = [(61, 61, 8, 64, 77), (100, 4 * 100 + 5, 6, 256, 600)]


@pytest.mark.parametrize("bo,bn,w,chunk,q", ORDERED)
def test_tc_ordered_lookup_matches_reference(bo, bn, w, chunk, q):
    old, new, hk, hv, hl, rao, rbo, ran, rbn, qk = ordered_case(
        bo, bn, w, chunk, q, bo)
    jf, jv = jops.twochoice_ordered_lookup(
        tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl), J(rao),
        J(rbo), J(ran), J(rbn), J(qk))
    targs = (tuple(map(T, old)), tuple(map(T, new)), T(hk), T(hv), T(hl),
             T(rao), T(rbo), T(ran), T(rbn), T(qk))
    tf, tv = tops.twochoice_ordered_lookup(*targs)
    assert np.array_equal(np.asarray(jf), N(tf))
    assert np.array_equal(np.asarray(jv), N(tv))
    found, _, f_old, _, hz, ln = tprobe.tc_probe2(*targs)
    assert torch.equal(found, tf)
    assert f_old.any() and (hz >= 0).any() and (ln >= 0).any()
    assert not tf.all()


@pytest.mark.parametrize("bo,bn,w,chunk,q", ORDERED)
def test_tc_ordered_delete_matches_reference(bo, bn, w, chunk, q):
    old, new, hk, hv, hl, rao, rbo, ran, rbn, qk = ordered_case(
        bo, bn, w, chunk, q, bo + 5)
    rng = np.random.default_rng(6)
    qk[: q // 10] = qk[q // 10: 2 * (q // 10)]
    mask = rng.random(q) < 0.8
    win = np.asarray(jb.batch_winners(J(qk), J(mask)))
    rows = (rao, rbo, ran, rbn)
    jos, jns, jhl, jok = jops.twochoice_ordered_delete(
        tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl),
        *map(J, rows), J(qk), J(win))
    to, tn = tuple(map(T, old)), tuple(map(T, new))
    tos, tns, thl, tok = tops.twochoice_ordered_delete(
        to, tn, T(hk), T(hv), T(hl), *map(T, rows), T(qk), T(win))
    assert tos is to[2] and tns is tn[2], "states written in place"
    for a, c in ((jos, tos), (jns, tns), (jhl, thl), (jok, tok)):
        assert np.array_equal(np.asarray(a), N(c))
    assert (N(tos) != old[2]).any() and (N(tns) != new[2]).any()
    assert (N(thl) != hl).any()


@pytest.mark.parametrize("backend", ["twochoice", "cuckoo"])
def test_extract_chunk_fused_on_flat_rows_matches_reference(backend):
    """The rebuild chunk scan of both two-row backends: the extract kernel's
    plain version on the flattened arrays, against the reference's fused
    scan and both packages' plain scans (hazard as a set), mid-table and at
    the partial last chunk; and the chunk contract on the CPU (plain scan
    above 4096)."""
    jt = jbe.get(backend).make(400, seed=3)
    keys = np.arange(1, 301, dtype=np.int32)
    jt, _ = jax.jit(jbe.get(backend).insert)(jt, J(keys), J(keys * 9),
                                             jnp.ones(300, bool))
    pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
    be = tbe.get(backend)
    cap = be.capacity_of(pt)
    assert cap == jbe.get(backend).capacity_of(jt)
    for cur in (0, 128, cap - 40):
        c = torch.tensor(cur, dtype=torch.int32)
        jt2, *jh2 = jbe.get(backend).extract_chunk_fused(jt, J(np.int32(cur)),
                                                         64)
        t2 = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
        out, hk, hv, hl, ncur = be.extract_chunk_fused(t2, c, 64)
        assert out.state is t2.state, "in place"
        assert np.array_equal(np.asarray(jt2.state), N(out.state))
        assert int(jh2[3]) == int(ncur)
        pl_t, phk, phv, phl, pcur = be.extract_chunk(pt, c, 64)
        assert np.array_equal(N(pl_t.state), N(out.state))
        assert set(zip(N(hk)[N(hl)].tolist(), N(hv)[N(hl)].tolist())) == \
            set(zip(N(phk)[N(phl)].tolist(), N(phv)[N(phl)].tolist()))
    big = be.extract_chunk_fused(pt, torch.tensor(0, dtype=torch.int32), 8192)
    assert big[1].shape == (8192,)


def test_two_row_descriptor_telemetry_matches_reference():
    """slots_for, capacity_of, count_tomb and probe_cost of both two-row
    descriptors against the reference's."""
    for name in ("twochoice", "cuckoo"):
        jd, td = jbe.get(name), tbe.get(name)
        for cap in (10, 96, 1000, 1 << 20):
            assert jd.slots_for(cap) == td.slots_for(cap)
        jt = jd.make(200, seed=1)
        keys = np.arange(-90, 90, dtype=np.int32)
        jt, _ = jax.jit(jd.insert)(jt, J(keys), J(keys),
                                   jnp.ones(keys.shape, bool))
        jt, _ = jax.jit(jd.delete)(jt, J(keys[::4]),
                                   jnp.ones(keys[::4].shape, bool))
        pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
        assert jd.capacity_of(jt) == td.capacity_of(pt)
        assert int(jd.count_tomb(jt)) == int(td.count_tomb(pt)) > 0
        assert int(jd.count_live(jt)) == int(td.count_live(pt))
        f, v, loc = td.lookup(pt, T(keys))
        jf, jv, jl = jax.jit(jd.lookup)(jt, J(keys))
        assert np.array_equal(
            np.asarray(jd.probe_cost(jt, J(keys), jf, jl)),
            N(td.probe_cost(pt, T(keys), f, loc)))
        assert len(td.hash_fns(pt)) == 2


def test_two_row_wrappers_refuse_bad_operands():
    """A wrapper takes the plain version only for CPU tensors; the checks a
    CUDA launch would make are plain Python and can be exercised here."""
    def meta(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    q = meta(8)
    with pytest.raises(ValueError, match="widths 1..32"):
        tprobe.tc_lookup(meta(4, 33), meta(4, 33), meta(4, 33), q, q, q)
    with pytest.raises(ValueError, match="one width"):
        tprobe.tc_probe2((meta(4, 8),) * 3, (meta(4, 4),) * 3, meta(64),
                         meta(64), meta(64, dtype=torch.bool), q, q, q, q, q)
    with pytest.raises(ValueError, match="exceeds"):
        tprobe.tc_probe2((meta(4, 8),) * 3, (meta(4, 8),) * 3, meta(8192),
                         meta(8192), meta(8192, dtype=torch.bool),
                         q, q, q, q, q)
    with pytest.raises(ValueError):
        tprobe.tc_insert(meta(4, 8), meta(4, 8), meta(4, 8), q, q, q, q,
                         meta(8, dtype=torch.bool), 8, claim=meta(16))
    assert tprobe.launch_counts() == dict.fromkeys(tprobe.KERNELS, 0)
