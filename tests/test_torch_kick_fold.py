"""The cuckoo kick-out folded into the two-row insert, and the lookup that
hashes its keys itself, held to the reference on the CPU.

The port's cuckoo insert is one ``tc_insert`` launch (``probe.cuckoo_insert``):
the claim rounds (two, one a side), then, in the resolve's last block, the
bounded kick-out over the list the rounds left (``csrc/tc_insert.cu``,
``dhash_kick_rounds`` in ``csrc/dhash_common.cuh``).  Pinned here:

* the list rule the fold rests on, in a numpy model of the kernel's list
  handling (the resolve appends round 0's losers in an order of its own;
  round 1 turns a placed entry INT_MIN): the entries >= 0 left after round
  1 are exactly ``winner & ~ok & ~present``, and the kick-out run over that
  list in any order gives ``cuckoo_kick_ref``'s placement;
* ``probe.cuckoo_insert`` (on the CPU its plain version, ``tc_insert_plain``
  then ``cuckoo_kick_plain``) equal to the JAX ``tc_insert_ref(max_rounds=2)``
  then ``cuckoo_kick_ref``, slot for slot and ``ok`` for ``ok``, on a
  main-path-like batch, a flooded row, a crowded table (93 % LIVE) and a
  batch that leaves nothing pending;
* ``probe_lookup_hashed`` (through ``ops.probe_lookup`` / ``probe_delete``
  given the table's hash function as ``hfn``) equal to the JAX ``bucket_of`` followed
  by ``ops.probe_lookup`` / ``probe_delete``, with keys found by rejection
  sampling whose hash lands in the last 40 slots, so that walks wrap, for
  the three hash kinds and a slot count that is not a power of two.

Tolerance 0.  The card holds the kernels to the same plain versions
(``chip_smoke.py`` phase 2).
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
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
FREE = 2**31 - 1                # a claim word between launches
INT_MIN = -2**31                # a list entry placed by a round
J = jnp.asarray


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the model of the fold: the resolve's list, round 1, the kick-out on it
# ---------------------------------------------------------------------------

def first_free(ts, row: int) -> int:
    lanes = np.flatnonzero(ts[row] != LIVE)
    return int(lanes[0]) if lanes.size else -1


def model_rounds(tk, tv, ts, ra, rb, keys, vals, mask, rng):
    """tc_insert with two rounds as the kernel resolves it: bid on the
    table before the batch, round 0's winners written, its losers (and the
    queries whose row a was full) appended to the list in a shuffled order,
    round 1 over the list, a placed entry turned INT_MIN.  Returns (table,
    ok, present, list)."""
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    W, Q = ts.shape[1], len(keys)

    def found(row, key):
        return bool(((ts[row] == LIVE) & (tk[row] == key)).any())

    present = np.array([bool(mask[i]) and (found(ra[i], keys[i])
                                           or found(rb[i], keys[i]))
                        for i in range(Q)], bool)
    ok = np.zeros(Q, bool)
    claim = np.full(ts.shape[0], FREE, np.int64)

    def write(s, i):
        tk.flat[s], tv.flat[s], ts.flat[s] = keys[i], vals[i], LIVE
        ok[i] = True

    slot = np.full(Q, -2, np.int64)                      # not pending
    for i in range(Q):
        if mask[i] and not present[i]:
            lane = first_free(ts, ra[i])
            slot[i] = -1 if lane < 0 else ra[i] * W + lane
            if lane >= 0:
                claim[ra[i]] = min(claim[ra[i]], i)
    lst = []
    for i in rng.permutation(Q):
        s = slot[i]
        if s >= 0 and claim[s // W] == i:
            write(s, i)
            claim[s // W] = FREE
        elif s != -2:
            lst.append(int(i))
    lst = np.array(lst, np.int64)
    # round 1 (row b) over the list
    bid = np.full(len(lst), -1, np.int64)
    for j, i in enumerate(lst):
        lane = first_free(ts, rb[i])
        if lane >= 0:
            bid[j] = rb[i] * W + lane
            claim[rb[i]] = min(claim[rb[i]], i)
    won = [bid[j] >= 0 and claim[bid[j] // W] == i for j, i in enumerate(lst)]
    for j, i in enumerate(lst):
        if bid[j] >= 0:
            claim[bid[j] // W] = FREE
            if won[j]:
                write(bid[j], i)
                lst[j] = INT_MIN
    assert (claim == FREE).all()
    return (tk, tv, ts), ok, present, lst


def model_kick(tab, ra, rb, alt_of, keys, vals, ok, lst, max_kick, rng):
    """dhash_kick_rounds in numpy over ``lst`` (entries < 0 skipped), the
    entries visited in a shuffled order each pass: plans on the table at the
    start of an iteration, a row's lock to the lowest batch index among the
    plans that touch it, the writes of the queries that hold every row of
    their plan.  ``alt_of(keys, side_a)`` gives victims' alternate rows."""
    tk, tv, ts = (np.array(x) for x in tab)
    ok, lst = ok.copy(), lst.copy()
    W = ts.shape[1]
    it = 0
    while it < max_kick:
        plans = {}
        for j in rng.permutation(len(lst)):
            i = lst[j]
            if i < 0:
                continue
            la = first_free(ts, ra[i])
            lb = -1 if la >= 0 else first_free(ts, rb[i])
            if la >= 0 or lb >= 0:
                plans[j] = ("A", ra[i] * W + la if la >= 0 else rb[i] * W + lb,
                            None)
                continue
            for r in range(2 * W):
                lane = (r + it) % (2 * W)
                vs = (ra[i] if lane < W else rb[i]) * W + lane % W
                if ts.flat[vs] != LIVE:
                    continue
                alt = int(alt_of(tk.flat[vs], lane < W))
                if first_free(ts, alt) >= 0:
                    plans[j] = ("B", vs, alt)
                    break
        if not plans:
            break
        it += 1
        lock = {}
        for j, (_, s, alt) in plans.items():
            for row in (s // W, alt):
                if row is not None:
                    lock[row] = min(lock.get(row, FREE), lst[j])
        for j, (kind, s, alt) in plans.items():
            i = lst[j]
            if lock[s // W] != i or (alt is not None and lock[alt] != i):
                continue
            if kind == "B":
                a = alt * W + first_free(ts, alt)
                tk.flat[a], tv.flat[a], ts.flat[a] = tk.flat[s], tv.flat[s], \
                    LIVE
            tk.flat[s], tv.flat[s], ts.flat[s] = keys[i], vals[i], LIVE
            ok[i] = True
            lst[j] = INT_MIN
        if not (lst >= 0).any():
            break
    return (tk, tv, ts), ok


# ---------------------------------------------------------------------------
# the cases: a cuckoo table's arrays and a batch, in numpy
# ---------------------------------------------------------------------------

def cuckoo_case(case: str, width: int, seed: int):
    """(tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb): a [2 nb, W]
    table and a winner-filtered batch.  ``main`` a half-full table and a
    batch with duplicates, keys already live and masked-out entries;
    ``flood`` half the batch on one row a and one row b; ``crowded`` 93 %
    of the lanes LIVE; ``nothing`` a batch of keys already live or masked
    out, so no key is left for the kick-out."""
    rng = np.random.default_rng([seed, width, sum(map(ord, case))])
    nb = 16
    hfa, hfb = jh.fresh("mix32", seed), jh.fresh("mix32", seed + 1)
    live = {"main": 0.5, "flood": 0.5, "crowded": 0.93,
            "nothing": 0.5}[case]
    tk = rng.integers(-(1 << 30), 1 << 30, (2 * nb, width)).astype(np.int32)
    ts = np.where(rng.random((2 * nb, width)) < live, LIVE,
                  rng.choice([EMPTY, TOMB, MIGRATED], (2 * nb, width))
                  ).astype(np.int32)
    q = 48
    keys = rng.choice(np.arange(1 << 20, (1 << 20) + 40 * q), q,
                      replace=False).astype(np.int32)
    mask = rng.random(q) < 0.9
    ra = np.array(jh.bucket_of(hfa, J(keys), nb)).astype(np.int32)
    rb = nb + np.array(jh.bucket_of(hfb, J(keys), nb)).astype(np.int32)
    if case == "main":
        keys[:4] = keys[4:8]                                  # duplicates
        ra[:4], rb[:4] = ra[4:8], rb[4:8]
    elif case == "flood":
        ra[: q // 2], rb[: q // 2] = 3, nb + 5
    if case in ("main", "nothing"):
        n = 6 if case == "main" else q                        # already live
        lanes = rng.integers(0, width, n)
        tk[ra[:n], lanes] = keys[:n]
        ts[ra[:n], lanes] = LIVE
        if case == "nothing":
            mask[: q // 3] = False
            mask &= ((ts[ra] == LIVE) & (tk[ra] == keys[:, None])).any(1)
    win = np.asarray(jb.batch_winners(J(keys), J(mask)))
    return (tk, (tk * 3).astype(np.int32), ts, ra, rb, keys,
            (keys * 5 + 1).astype(np.int32), win, hfa, hfb, nb)


CASES = [(c, w) for c in ("main", "flood", "crowded", "nothing")
         for w in (8, 4)]


def jax_composition(tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb,
                    max_kick):
    """The reference's oracles composed: the claim rounds, the flags, the
    kick-out on the winners left.  Returns (table, ok, present, pending)."""
    k1, v1, s1, ok1 = jref.tc_insert_ref(J(tk), J(tv), J(ts), J(ra), J(rb),
                                         J(keys), J(vals), J(win), 2)
    fa, _, _ = jref.tc_row_lookup_ref(J(tk), J(tv), J(ts), J(ra), J(keys))
    fb, _, _ = jref.tc_row_lookup_ref(J(tk), J(tv), J(ts), J(rb), J(keys))
    present = J(win) & (fa | fb)
    pend = J(win) & ~ok1 & ~present
    k2, v2, s2, done = jref.cuckoo_kick_ref(k1, v1, s1, J(ra), J(rb), hfa,
                                            hfb, nb, J(keys), J(vals), pend,
                                            max_kick)
    return ((np.asarray(k2), np.asarray(v2), np.asarray(s2)),
            np.asarray(ok1 | done), np.asarray(present), np.asarray(pend))


@pytest.mark.parametrize("case,width", CASES)
def test_list_rule_and_folded_kick_model(case, width):
    """After round 1 the list's entries >= 0 are exactly winner & ~ok &
    ~present, whatever order the resolve appended them in; the kick-out run
    over that list (entries visited in shuffled orders) gives the
    reference's composition slot for slot."""
    tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb = cuckoo_case(
        case, width, 5)
    max_kick = 32
    want_tab, want_ok, want_present, want_pend = jax_composition(
        tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb, max_kick)
    tfa = th.fresh("mix32", 5, "cpu")
    tfb = th.fresh("mix32", 6, "cpu")

    def alt_of(key, side_a):
        k = torch.tensor([key], dtype=torch.int32)
        return (nb + th.bucket_of(tfb, k, nb)) if side_a \
            else th.bucket_of(tfa, k, nb)

    for order in range(3):
        rng = np.random.default_rng(order)
        tab, ok, present, lst = model_rounds(tk, tv, ts, ra, rb, keys, vals,
                                             win, rng)
        assert np.array_equal(present, want_present)
        left = np.zeros(len(keys), bool)
        left[lst[lst >= 0]] = True
        assert np.array_equal(left, win & ~ok & ~present)
        assert np.array_equal(left, want_pend)
        assert (lst[lst < 0] == INT_MIN).all()
        tab, ok = model_kick(tab, ra, rb, alt_of, keys, vals, ok, lst,
                             max_kick, rng)
        for a, b in zip(tab, want_tab):
            assert np.array_equal(a, b)
        assert np.array_equal(ok, want_ok)
    if case == "nothing":
        assert not want_pend.any()
    elif case in ("flood", "crowded"):
        assert want_pend.any()


@pytest.mark.parametrize("case,width", CASES)
def test_cuckoo_insert_equals_jax_composition(case, width):
    """``probe.cuckoo_insert`` and ``ops.cuckoo_insert`` (the table written
    in place) equal the JAX composition slot for slot, ``ok`` and
    ``present`` too, and launch nothing on the CPU."""
    tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb = cuckoo_case(
        case, width, 9)
    max_kick = 32
    want_tab, want_ok, want_present, want_pend = jax_composition(
        tk, tv, ts, ra, rb, keys, vals, win, hfa, hfb, nb, max_kick)
    tfa = th.fresh("mix32", 9, "cpu")
    tfb = th.fresh("mix32", 10, "cpu")
    tprobe.reset_launches()
    tab = [T(x) for x in (tk, tv, ts)]
    ok, present = tprobe.cuckoo_insert(*tab, T(ra), T(rb), tfa, tfb, nb,
                                       T(keys), T(vals), T(win), max_kick)
    for a, b in zip(tab, want_tab):
        assert np.array_equal(N(a), b)
    assert np.array_equal(N(ok), want_ok)
    assert np.array_equal(N(present), want_present)
    tab2 = [T(x) for x in (tk, tv, ts)]
    out = tops.cuckoo_insert(*tab2, T(ra), T(rb), tfa, tfb, nb, T(keys),
                             T(vals), T(win), max_kick=max_kick,
                             with_present=True)
    assert out[0] is tab2[0], "written in place"
    for a, b in zip(out, (*want_tab, want_ok, want_present)):
        assert np.array_equal(N(a), b)
    assert tprobe.launch_counts() == dict.fromkeys(tprobe.KERNELS, 0)
    if case == "crowded":
        placed = want_ok & want_pend
        assert placed.any() and not want_ok[want_pend].all()


# ---------------------------------------------------------------------------
# the lookup that hashes its keys itself
# ---------------------------------------------------------------------------

def last_slot_keys(hfn, c: int, n: int, seed: int, lo: int = 40):
    """``n`` distinct keys whose hash lands in the last ``lo`` of ``c``
    slots, by rejection sampling."""
    rng = np.random.default_rng(seed)
    cand = np.unique(rng.integers(1 << 20, 1 << 30, 400_000)).astype(np.int32)
    got = cand[np.asarray(jh.bucket_of(hfn, J(cand), c)) >= c - lo]
    assert got.size >= n
    return rng.permutation(got)[:n]


def lookup_table(c: int, kind: str, seed: int):
    """A linear table of ``c`` slots, half full, placed by the reference's
    insert oracle under a ``kind`` hash function, four of its keys hashed
    to the last slot (their run wraps at C), a share of the others TOMB and
    MIGRATED; and its keys."""
    rng = np.random.default_rng(seed)
    hfn = jh.fresh(kind, seed)
    keys = rng.choice(np.arange(-50_000, 50_000), c // 2 - 4,
                      replace=False).astype(np.int32)
    keys = np.concatenate([keys, last_slot_keys(hfn, c, 4, seed, 1)])
    z = jnp.zeros(c, jnp.int32)
    tk, tv, ts, _ = jref.probe_insert_ref(
        z, z, z, jh.bucket_of(hfn, J(keys), c), J(keys), J(keys * 7),
        jnp.ones(keys.shape, bool), 16)
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    live = np.flatnonzero((ts == LIVE) & ~np.isin(tk, keys[-4:]))
    live = rng.permutation(live)
    n = len(live) // 8
    ts[live[:n]] = TOMB
    ts[live[n:2 * n]] = MIGRATED
    return hfn, (tk, tv, ts), keys


def wrapping_queries(hfn, c: int, keys, q: int, seed: int) -> np.ndarray:
    """``q`` queries: hits, misses, the table's keys hashed into the last 40
    slots, and fresh keys found by rejection sampling whose hash lands
    there (their walks wrap at C)."""
    rng = np.random.default_rng(seed)
    h = np.asarray(jh.bucket_of(hfn, J(keys), c))
    near = rng.permutation(keys[h >= c - 40])[:q // 4]
    fresh = last_slot_keys(hfn, c, q // 4, seed)
    fresh = fresh[~np.isin(fresh, keys)]
    rest = q - near.size - fresh.size
    hit = rng.choice(keys, rest // 2)
    miss = rng.integers(100_000, 1 << 20, rest - rest // 2).astype(np.int32)
    return rng.permutation(np.concatenate([near, fresh, hit, miss])
                           ).astype(np.int32)


LOOKUPS = [(c, kind) for c in (64, 1000, 4096)
           for kind in ("mix32", "multiply_shift", "tabulation")]


@pytest.mark.parametrize("c,kind", LOOKUPS)
def test_hashed_lookup_equals_jax_bucket_of_then_probe_lookup(c, kind):
    hfn, tab, keys = lookup_table(c, kind, seed=c)
    qk = wrapping_queries(hfn, c, keys, 200, seed=1)
    h0 = jh.bucket_of(hfn, J(qk), c)
    jf, jv, jl = jops.probe_lookup(*map(J, tab), h0, J(qk), max_probes=16,
                                   with_loc=True)
    thfn = th.fresh(kind, c, "cpu")
    assert np.array_equal(np.asarray(hfn.seeds).astype(np.int64),
                          N(thfn.seeds))
    tf, tv, tl = tops.probe_lookup(*map(T, tab), None, T(qk), hfn=thfn,
                                   max_probes=16, with_loc=True)
    assert np.array_equal(np.asarray(jf), N(tf))
    assert np.array_equal(np.asarray(jv), N(tv))
    jl = np.asarray(jl)
    assert np.array_equal(np.where(jl >= 0, jl % c, -1), N(tl))
    # the same through the wrapper, and the same as the start-slot form
    pf, pv, pl = tprobe.probe_lookup_hashed(*map(T, tab), thfn, T(qk), 16)
    sf, sv, sl = tprobe.probe_lookup(*map(T, tab), T(np.asarray(h0)), T(qk),
                                     16)
    for a, b, x in ((pf, sf, tf), (pv, sv, tv), (pl, sl, tl)):
        assert torch.equal(a, b) and torch.equal(a, x)
    h = np.asarray(h0)
    assert (N(tf) & (N(tl) < h)).any(), "a hit must wrap at C"
    assert N(tf).any() and not N(tf).all()


@pytest.mark.parametrize("c", [64, 1000, 4096])
def test_hashed_delete_equals_jax_bucket_of_then_probe_delete(c):
    hfn, tab, keys = lookup_table(c, "mix32", seed=c + 1)
    qk = wrapping_queries(hfn, c, keys, 120, seed=2)
    qk[:10] = qk[10:20]                                   # duplicates
    mask = np.random.default_rng(3).random(qk.size) < 0.8
    win = np.asarray(jb.batch_winners(J(qk), J(mask)))
    js, jok = jops.probe_delete(*map(J, tab), jh.bucket_of(hfn, J(qk), c),
                                J(qk), J(win), max_probes=16)
    tt = [T(x) for x in tab]
    ts, tok = tops.probe_delete(*tt, None, T(qk), T(win),
                                hfn=th.fresh("mix32", c + 1, "cpu"),
                                max_probes=16)
    assert ts is tt[2], "the state array is written in place"
    assert np.array_equal(np.asarray(jok), N(tok)) and N(tok).any()
    assert np.array_equal(np.asarray(js), N(ts))


@pytest.mark.parametrize("give", ["both", "neither"])
def test_lookup_takes_exactly_one_of_start_slots_and_hash(give):
    hfn, tab, keys = lookup_table(64, "mix32", seed=5)
    thfn = th.fresh("mix32", 64, "cpu")
    h0 = T(np.asarray(jh.bucket_of(hfn, J(keys), 64)))
    with pytest.raises(ValueError, match="exactly one"):
        tops.probe_lookup(*map(T, tab), h0 if give == "both" else None,
                          T(keys), hfn=thfn if give == "both" else None)
