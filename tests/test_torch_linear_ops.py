"""Port vs reference: the op layer that holds the four linear kernels.

The same numpy tables and batches go through the JAX ``kernels/ops.py``
functions (their Pallas kernels in interpret mode, the default) and through
``repro_torch.kernels.ops`` on the CPU, where the wrappers take the kernels'
plain versions.  Tolerance 0.  ``loc`` is compared modulo C: the reference
reports an unwrapped padded coordinate, the port the physical slot.

Insert placement is held slot for slot against the plain oracle
(``ref.probe_insert_ref`` / ``buckets.linear_insert`` of BOTH packages); the
reference's fused insert is a different legal linearisation under contention,
so against it only ``ok`` and the live key->value map are compared at low
load, and its own pressure invariants are checked under pressure.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import buckets as jb  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def make_table(c: int, n_live: int, max_probes: int, seed: int,
               dead: float = 0.15):
    """Numpy table arrays: ``n_live`` keys placed by the reference's insert
    oracle, then a share tombstoned and a share marked MIGRATED."""
    rng = np.random.default_rng(seed)
    hfn = jh.fresh("mix32", seed)
    keys = rng.choice(np.arange(-50_000, 50_000), n_live,
                      replace=False).astype(np.int32)
    h0 = np.asarray(jh.bucket_of(hfn, jnp.asarray(keys), c))
    z = jnp.zeros(c, jnp.int32)
    tk, tv, ts, _ = jref.probe_insert_ref(
        z, z, z, jnp.asarray(h0), jnp.asarray(keys), jnp.asarray(keys * 7),
        jnp.ones(n_live, bool), max_probes)
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    live = np.flatnonzero(ts == LIVE)
    pick = rng.permutation(live)
    n = int(len(live) * dead)
    ts[pick[:n]] = TOMB
    ts[pick[n:2 * n]] = MIGRATED
    return hfn, (tk, tv, ts), keys


def queries(keys: np.ndarray, q: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hit = rng.choice(keys, q // 2)
    miss = rng.integers(100_000, 2**31 - 1, q - q // 2).astype(np.int32)
    return rng.permutation(np.concatenate([hit, miss])).astype(np.int32)


def h0_of(hfn, qk: np.ndarray, c: int) -> np.ndarray:
    return np.array(jh.bucket_of(hfn, jnp.asarray(qk), c))


# (C, live keys, Q, max_probes): small, non-power-of-two, several query tiles
SHAPES = [(64, 30, 50, 8), (1000, 500, 300, 16), (8192, 4000, 1124, 32)]


@pytest.mark.parametrize("c,n,q,p", SHAPES)
def test_probe_lookup_matches_reference(c, n, q, p):
    hfn, tab, keys = make_table(c, n, p, seed=c)
    qk = queries(keys, q, seed=1)
    h0 = h0_of(hfn, qk, c)
    h0[: q // 8] = c - 1 - np.arange(q // 8) % 5        # wrap past the end
    jf, jv, jl = jops.probe_lookup(*map(jnp.asarray, tab), jnp.asarray(h0),
                                   jnp.asarray(qk), max_probes=p,
                                   with_loc=True)
    tf, tv, tl = tops.probe_lookup(*map(T, tab), T(h0), T(qk), max_probes=p,
                                   with_loc=True)
    assert np.array_equal(np.asarray(jf), N(tf))
    assert np.array_equal(np.asarray(jv), N(tv))
    jl = np.asarray(jl)
    assert np.array_equal(np.where(jl >= 0, jl % c, -1), N(tl))
    assert N(tf).any() and not N(tf).all()
    # without loc: the same first two outputs
    f2, v2 = tops.probe_lookup(*map(T, tab), T(h0), T(qk), max_probes=p)
    assert torch.equal(f2, tf) and torch.equal(v2, tv)
    # and the port's own oracle agrees
    rf, rv = tref.probe_lookup_ref(*map(T, tab), T(h0), T(qk), p)
    assert torch.equal(rf, tf) and torch.equal(rv, tv)


@pytest.mark.parametrize("c,n,q,p", SHAPES)
def test_probe_delete_matches_reference(c, n, q, p):
    hfn, tab, keys = make_table(c, n, p, seed=c + 1)
    rng = np.random.default_rng(2)
    qk = queries(keys, q, seed=3)
    qk[: q // 10] = qk[q // 10: 2 * (q // 10)]          # duplicates
    mask = rng.random(q) < 0.8
    win = np.asarray(jb.batch_winners(jnp.asarray(qk), jnp.asarray(mask)))
    assert np.array_equal(win, N(tb.batch_winners(T(qk), T(mask))))
    h0 = h0_of(hfn, qk, c)
    js, jok = jops.probe_delete(*map(jnp.asarray, tab), jnp.asarray(h0),
                                jnp.asarray(qk), jnp.asarray(win),
                                max_probes=p)
    tt = [T(x) for x in tab]
    ts, tok = tops.probe_delete(*tt, T(h0), T(qk), T(win), max_probes=p)
    assert ts is tt[2], "probe_delete writes the state array in place"
    assert np.array_equal(np.asarray(jok), N(tok))
    assert np.array_equal(np.asarray(js), N(ts))
    assert N(tok).any()
    rs, rok = tref.probe_delete_ref(*map(T, tab), T(h0), T(qk), T(win), p)
    assert torch.equal(rs, ts) and torch.equal(rok, tok)


@pytest.mark.parametrize("c,n,chunk,p", [(64, 30, 16, 8), (1000, 600, 256, 16),
                                         (8192, 4000, 128, 32)])
def test_extract_chunk_fused_matches_reference(c, n, chunk, p):
    _, tab, _ = make_table(c, n, p, seed=c + 2)
    last = (c // chunk) * chunk if c % chunk else c - chunk
    for cur in (0, chunk, last - chunk // 2, last + chunk // 2, c):
        js, jhk, jhv, jhl, jcur = jops.extract_chunk_fused(
            *map(jnp.asarray, tab), jnp.asarray(cur, jnp.int32), chunk=chunk)
        tt = [T(x) for x in tab]
        ts, hk, hv, hl, tcur = tops.extract_chunk_fused(
            *tt, torch.tensor(cur, dtype=torch.int32), chunk=chunk)
        assert ts is tt[2]
        for a, b in ((js, ts), (jhk, hk), (jhv, hv), (jhl, hl), (jcur, tcur)):
            assert np.array_equal(np.asarray(a), N(b)), cur
        assert hl.dtype == torch.bool and tcur.dtype == torch.int32


def ordered_case(c_old: int, c_new: int, chunk: int, q: int, p: int,
                 seed: int):
    """Old table mid-rebuild, a hazard buffer with killed entries, a new
    table, and queries that hit each of them and nothing."""
    rng = np.random.default_rng(seed)
    hfo, old, ko = make_table(c_old, c_old // 2, p, seed=seed)
    hfn, new, kn = make_table(c_new, c_new // 8, p, seed=seed + 1)
    kn = kn + 200_000                                    # disjoint from old
    h0 = h0_of(hfn, kn, c_new)
    z = jnp.zeros(c_new, jnp.int32)
    new = tuple(np.array(x) for x in jref.probe_insert_ref(
        z, z, z, jnp.asarray(h0), jnp.asarray(kn), jnp.asarray(kn * 3),
        jnp.ones(kn.shape, bool), p)[:3])
    os_, hk, hv, hl, _ = jops.extract_chunk_fused(
        *map(jnp.asarray, old), jnp.asarray(chunk, jnp.int32), chunk=chunk)
    old = (old[0], old[1], np.array(os_))
    hk, hv, hl = np.array(hk), np.array(hv), np.array(hl)
    n_hz = int(hl.sum())
    assert n_hz > 2
    hl &= rng.random(chunk) < 0.7                        # killed entries
    qk = np.concatenate([
        rng.choice(ko, q // 4), rng.choice(hk[:n_hz], q // 4),
        rng.choice(kn, q // 4),
        rng.integers(1_000_000, 2**31 - 1, q - 3 * (q // 4))]).astype(np.int32)
    qk = rng.permutation(qk)
    return (old, new, hk, hv, hl, h0_of(hfo, qk, c_old),
            h0_of(hfn, qk, c_new), qk)


ORDERED = [(64, 64, 16, 60, 8), (1000, 4000, 64, 300, 16),
           (2048, 8192, 256, 1124, 32)]


@pytest.mark.parametrize("co,cn,chunk,q,p", ORDERED)
def test_ordered_lookup_fused_matches_reference(co, cn, chunk, q, p):
    old, new, hk, hv, hl, h0o, h0n, qk = ordered_case(co, cn, chunk, q, p, co)
    J = jnp.asarray
    jf, jv = jops.ordered_lookup_fused(
        tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl), J(h0o),
        J(h0n), J(qk), max_probes=p)
    targs = (tuple(map(T, old)), tuple(map(T, new)), T(hk), T(hv), T(hl),
             T(h0o), T(h0n), T(qk))
    tf, tv = tops.ordered_lookup_fused(*targs, max_probes=p)
    assert np.array_equal(np.asarray(jf), N(tf))
    assert np.array_equal(np.asarray(jv), N(tv))
    # the unfused composition and the port's oracle give the same answers
    uf, uv = tops.ordered_lookup(*targs, max_probes=p)
    assert torch.equal(uf, tf) and torch.equal(torch.where(uf, uv, 0), tv)
    rf, rv = tref.ordered_lookup_ref(*targs, p)
    assert torch.equal(rf, tf) and torch.equal(torch.where(rf, rv, 0), tv)
    # every source is hit
    _, _, f_old, _, hz, ln = tprobe.probe2(*targs, p)
    assert f_old.any() and (hz >= 0).any() and (ln >= 0).any()
    assert not tf.all()


@pytest.mark.parametrize("co,cn,chunk,q,p", ORDERED)
def test_ordered_delete_fused_matches_reference(co, cn, chunk, q, p):
    old, new, hk, hv, hl, h0o, h0n, qk = ordered_case(co, cn, chunk, q, p,
                                                      co + 5)
    rng = np.random.default_rng(6)
    qk[: q // 10] = qk[q // 10: 2 * (q // 10)]
    mask = rng.random(q) < 0.8
    win = np.asarray(jb.batch_winners(jnp.asarray(qk), jnp.asarray(mask)))
    J = jnp.asarray
    jos, jns, jhl, jok = jops.ordered_delete_fused(
        tuple(map(J, old)), tuple(map(J, new)), J(hk), J(hv), J(hl), J(h0o),
        J(h0n), J(qk), J(win), max_probes=p)
    to, tn = tuple(map(T, old)), tuple(map(T, new))
    tos, tns, thl, tok = tops.ordered_delete_fused(
        to, tn, T(hk), T(hv), T(hl), T(h0o), T(h0n), T(qk), T(win),
        max_probes=p)
    assert tos is to[2] and tns is tn[2]
    for a, b in ((jos, tos), (jns, tns), (jhl, thl), (jok, tok)):
        assert np.array_equal(np.asarray(a), N(b))
    assert (N(tos) != old[2]).any() and (N(tns) != new[2]).any()
    assert (N(thl) != hl).any()


# --- insert -----------------------------------------------------------------

def insert_batch(kind: str, c: int, p: int, seed: int):
    """(table arrays, h0, keys, vals, winner mask) for one adversarial case."""
    rng = np.random.default_rng(seed)
    hfn, tab, keys = make_table(c, c // 3, p, seed=seed)
    q = {"ragged": 1124, "hot": 3 * p + 40}.get(kind, 200)
    q = min(q, c)
    fresh = rng.choice(np.arange(100_000, 900_000), q,
                       replace=False).astype(np.int32)
    k = fresh.copy()
    if kind == "dups":        # duplicates and re-inserts of live/dead keys
        k[: q // 4] = rng.choice(keys, q // 4)
        k[q // 4: q // 2] = k[q // 2: q // 2 + q // 4]
    h0 = h0_of(hfn, k, c)
    if kind == "hot":         # one start slot, more keys than max_probes
        h0[:] = c - 3
    if kind == "wrap":
        h0[: q // 2] = c - 1 - np.arange(q // 2) % 4
    mask = rng.random(q) < 0.9
    win = np.asarray(jb.batch_winners(jnp.asarray(k), jnp.asarray(mask)))
    return tab, h0, k, (k * 5 + 1).astype(np.int32), win


INSERT_CASES = [("plain", 64, 8), ("dups", 1000, 16), ("hot", 256, 8),
                ("wrap", 1000, 16), ("ragged", 8192, 32), ("hot", 1000, 16)]


@pytest.mark.parametrize("kind,c,p", INSERT_CASES)
def test_probe_insert_slot_for_slot_vs_oracle(kind, c, p):
    tab, h0, k, v, win = insert_batch(kind, c, p, seed=c + p)
    J = jnp.asarray
    jk, jv, js, jok = jref.probe_insert_ref(*map(J, tab), J(h0), J(k), J(v),
                                            J(win), p)
    tt = [T(x) for x in tab]
    tk, tv, ts, tok = tops.probe_insert(*tt, T(h0), T(k), T(v), T(win),
                                        max_probes=p)
    assert tk is tt[0] and tv is tt[1] and ts is tt[2], "in place"
    for a, b in ((jk, tk), (jv, tv), (js, ts), (jok, tok)):
        assert np.array_equal(np.asarray(a), N(b)), kind
    if kind == "hot":
        assert (win & ~N(tok)).any(), "some inserts must find no slot"
    # the port's own functional oracle, and `present`
    rk, rv, rs, rok = tref.probe_insert_ref(*map(T, tab), T(h0), T(k), T(v),
                                            T(win), p)
    assert all(torch.equal(a, b) for a, b in
               ((rk, tk), (rv, tv), (rs, ts), (rok, tok)))
    *_, ok2, present = tops.probe_insert(*map(T, tab), T(h0), T(k), T(v),
                                         T(win), max_probes=p,
                                         with_present=True)
    f, _ = tref.probe_lookup_ref(*map(T, tab), T(h0), T(k), p)
    assert torch.equal(present, f & T(win)) and torch.equal(ok2, tok)


@pytest.mark.parametrize("kind,c,p", INSERT_CASES)
def test_plain_early_exit_equals_every_round(kind, c, p, monkeypatch):
    """On the CPU the plain ``probe_lookup`` and ``probe_insert`` stop their
    lock-step rounds once no query is left (``probe._settled``); on the
    card they run every round.  Both give the same answers and tables."""
    tab, h0, k, v, win = insert_batch(kind, c, p, seed=c + p)

    def run():
        tt = [T(x) for x in tab]
        f, val, loc = tprobe.probe_lookup_plain(*tt, T(h0), T(k), p)
        ok, present = tprobe.probe_insert_plain(*tt, T(h0), T(k), T(v),
                                                T(win), p)
        return [f, val, loc, ok, present, *tt]
    settled, fired = tprobe._settled, []

    def seen(live):
        fired.append(settled(live))
        return fired[-1]
    monkeypatch.setattr(tprobe, "_settled", seen)
    early = run()
    monkeypatch.setattr(tprobe, "_settled", lambda live: False)
    full = run()
    assert all(torch.equal(a, b) for a, b in zip(early, full)), kind
    assert any(fired) or kind == "hot", "no plain version stopped early"


@pytest.mark.parametrize("c,p,kind", [(64, 8, "mix32"), (1000, 16, "mix32"),
                                      (1000, 16, "tabulation"),
                                      (4096, 32, "multiply_shift")])
def test_linear_insert_slot_for_slot_both_packages(c, p, kind):
    """buckets.linear_insert (plain) of both packages and the port's fused
    adapter: identical tables and ok on duplicates, re-inserts, masked tails."""
    from repro_torch.core import backend as tbe
    rng = np.random.default_rng(c)
    base = rng.choice(100_000, c // 3, replace=False).astype(np.int32)
    fresh = rng.choice(np.arange(200_000, 300_000), c // 4,
                       replace=False).astype(np.int32)
    batch = np.concatenate([fresh, fresh[: c // 8], base[: c // 10]])
    mask = np.ones(batch.shape, bool)
    mask[-c // 20:] = False
    jt = jb.linear_make(c, jh.fresh(kind, 1), max_probes=p)
    plain = tb.linear_make(c, th.fresh(kind, 1, "cpu"), max_probes=p)
    fused = tb.linear_make(c, th.fresh(kind, 1, "cpu"), max_probes=p)
    for keys, m in ((base, np.ones(base.shape, bool)), (batch, mask)):
        jt, jok = jb.linear_insert(jt, jnp.asarray(keys),
                                   jnp.asarray(keys * 3), jnp.asarray(m))
        plain, pok = tb.linear_insert(plain, T(keys), T(keys * 3), T(m))
        fused, fok = tbe.linear_insert_fused(fused, T(keys), T(keys * 3), T(m))
        assert np.array_equal(np.asarray(jok), N(pok))
        assert np.array_equal(np.asarray(jok), N(fok))
    for f in ("key", "val", "state"):
        assert np.array_equal(np.asarray(getattr(jt, f)), N(getattr(plain, f)))
        assert np.array_equal(np.asarray(getattr(jt, f)), N(getattr(fused, f)))
    # lookups, deletes and the chunk scan of the plain surface agree too
    probe = np.concatenate([base, fresh, fresh + 1_000_000]).astype(np.int32)
    jf, jv, jl = jb.linear_lookup(jt, jnp.asarray(probe))
    tf, tv, tl = tb.linear_lookup(plain, T(probe))
    for a, b in ((jf, tf), (jv, tv), (jl, tl)):
        assert np.array_equal(np.asarray(a), N(b))
    jt2, jok = jb.linear_delete(jt, jnp.asarray(probe[::3]),
                                jnp.ones(probe[::3].shape, bool))
    pt2, pok = tb.linear_delete(plain, T(probe[::3]),
                                torch.ones(probe[::3].shape, dtype=torch.bool))
    assert np.array_equal(np.asarray(jok), N(pok))
    assert np.array_equal(np.asarray(jt2.state), N(pt2.state))
    jt3, *jh3 = jb.linear_extract_chunk(jt2, jnp.asarray(c - 40, jnp.int32), 64)
    pt3, *ph3 = tb.linear_extract_chunk(
        pt2, torch.tensor(c - 40, dtype=torch.int32), 64)
    assert np.array_equal(np.asarray(jt3.state), N(pt3.state))
    for a, b in zip(jh3, ph3):
        assert np.array_equal(np.asarray(a), N(b))
    assert int(jb.linear_count_live(jt3)) == int(tb.linear_count_live(pt3))


def test_probe_insert_vs_reference_fused_low_load():
    """Against the reference's FUSED insert at low load: identical ok and an
    identical live key -> value map (placement may differ)."""
    rng = np.random.default_rng(5)
    c, p = 8192, 32
    hfn = jh.fresh("mix32", 5)
    keys = rng.choice(1_000_000, 3_000, replace=False).astype(np.int32)
    keys[:100] = keys[100:200]                            # duplicates
    mask = np.ones(keys.shape, bool)
    win = np.asarray(jb.batch_winners(jnp.asarray(keys), jnp.asarray(mask)))
    h0 = h0_of(hfn, keys, c)
    z = np.zeros(c, np.int32)
    J = jnp.asarray
    jk, jv, js, jok = jops.probe_insert(J(z), J(z), J(z), J(h0), J(keys),
                                        J(keys * 5), J(win), max_probes=p)
    tk, tv, ts, tok = tops.probe_insert(T(z), T(z), T(z), T(h0), T(keys),
                                        T(keys * 5), T(win), max_probes=p)
    assert np.array_equal(np.asarray(jok), N(tok)) and N(tok).sum() == 2_900

    def live_map(k, v, s):
        k, v, s = (np.asarray(x) for x in (k, v, s))
        return dict(zip(k[s == LIVE].tolist(), v[s == LIVE].tolist()))
    assert live_map(jk, jv, js) == live_map(N(tk), N(tv), N(ts))


def test_probe_insert_full_table_pressure():
    """Near-capacity insert with a short probe bound (the reference's own
    pressure invariants): successful claims are readable, failures genuinely
    exhausted their windows, no slot double-claimed; and ok equals the
    oracle's exactly, because the port's linearisation IS the oracle's."""
    rng = np.random.default_rng(4)
    c, p = 1024, 16
    hfn = jh.fresh("mix32", 5)
    keys = rng.choice(1_000_000, 1_200, replace=False).astype(np.int32)
    h0 = h0_of(hfn, keys, c)
    mask = np.ones(keys.shape, bool)
    z = np.zeros(c, np.int32)
    tk, tv, ts, ok = tops.probe_insert(T(z), T(z), T(z), T(h0), T(keys),
                                       T(keys), T(mask), max_probes=p)
    J = jnp.asarray
    _, _, js, ok_ref = jref.probe_insert_ref(J(z), J(z), J(z), J(h0), J(keys),
                                             J(keys), J(mask), p)
    assert np.array_equal(np.asarray(ok_ref), N(ok))
    assert np.array_equal(np.asarray(js), N(ts))
    assert int((ts == LIVE).sum()) == int(ok.sum())       # no double-claims
    f, v = tref.probe_lookup_ref(tk, tv, ts, T(h0), T(keys), p)
    assert bool(f[ok].all()) and bool((v[ok] == T(keys)[ok]).all())
    assert not bool(f[~ok].any())                         # failures not inserted
    assert not bool(ok.all())


def test_batch_winners_signed_keys():
    keys = np.array([5, -3, 5, -3, 0, -2**31, 2**31 - 1, -2**31, 5], np.int32)
    mask = np.array([0, 1, 1, 1, 1, 1, 1, 0, 1], bool)
    want = np.asarray(jb.batch_winners(jnp.asarray(keys), jnp.asarray(mask)))
    assert np.array_equal(want, N(tb.batch_winners(T(keys), T(mask))))
    assert want.tolist() == [0, 1, 1, 0, 1, 1, 1, 0, 0]


def test_wrappers_refuse_mixed_or_wrong_operands():
    """A wrapper takes the plain version only for CPU tensors; the checks a
    CUDA launch would make are plain Python and can be exercised here."""
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tprobe._check((z, torch.int32))                   # not on a CUDA device
    with pytest.raises(ValueError):
        tprobe.extract(z.to("meta"), z.to("meta"), z.to("meta"),
                       torch.tensor(0, dtype=torch.int32, device="meta"),
                       8192)                              # chunk contract
    assert tprobe.launch_counts() == dict.fromkeys(tprobe.KERNELS, 0)
