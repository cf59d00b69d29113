"""Port vs reference: the cuckoo backend's insert.

The port's fused cuckoo insert is the ``tc_insert`` claim kernel
(``max_rounds=2``, one try a side) followed by the ``cuckoo_kick`` kernel,
the bounded kick-out on the winners it left unplaced, guarded on the device
(with nothing pending it does nothing).  It is held slot for
slot against the same composition of the JAX package's own oracles:
``ref.tc_insert_ref(max_rounds=2)``, then ``ref.cuckoo_kick_ref`` on the
winners unplaced and absent from both rows.  The plain insert (the kick-out
alone) is held slot for slot against the JAX ``buckets.cuckoo_insert``; plain
and fused are different linearisations under contention, so between them
only ``ok`` and the live key -> value map are compared.  ``cuckoo_kick_ref``
of both packages is compared on its own, the kick-out's plain version against
it and against the staged composition the port ran before the kernel, and
the reference's collision-flood contract (probe depth below the row width)
is checked on the port.
Tolerance 0.
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
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_convert import jax_table_tree  # noqa: E402

LIVE = 1
J = jnp.asarray


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def live_map(k, v, s) -> dict:
    k, v, s = (N(x).reshape(-1) for x in (k, v, s))
    return dict(zip(k[s == LIVE].tolist(), v[s == LIVE].tolist()))


def loaded_table(width: int, n_base: int, seed: int):
    """A reference cuckoo table (8 rows a side) holding ``n_base`` keys, and
    the same table in the port."""
    jt = jbe.get("cuckoo").make(10 * width, seed=seed, bucket_width=width)
    assert jt.nbuckets == 8
    base = np.arange(1, n_base + 1, dtype=np.int32) * 7919
    jt, ok = jax.jit(jb.cuckoo_insert)(jt, J(base), J(base * 3),
                                       jnp.ones(base.shape, bool))
    assert bool(ok.all())
    return jt, base


@pytest.mark.parametrize("width,n_base,q", [(8, 60, 64), (4, 24, 40)])
def test_fused_insert_equals_composed_jax_oracles(width, n_base, q):
    """A batch that overflows the claim kernel's two rounds, so the kick-out
    runs: placement, ok and present equal the composition of the JAX
    oracles slot for slot; every acknowledged key is found."""
    jt, base = loaded_table(width, n_base, seed=2)
    rng = np.random.default_rng(width)
    keys = rng.choice(np.arange(100_000, 200_000), q,
                      replace=False).astype(np.int32)
    keys[: q // 8] = keys[q // 8: q // 4]                 # duplicates
    keys[q // 4: q // 4 + 4] = base[:4]                   # already present
    mask = rng.random(q) < 0.95
    vals = keys * 5 + 1
    # the composition of the reference's oracles
    win = jb.batch_winners(J(keys), J(mask))
    ra, rb = jb._ck_rows(jt, J(keys))
    k1, v1, s1, ok1 = jref.tc_insert_ref(jt.key, jt.val, jt.state, ra, rb,
                                         J(keys), J(vals), win, 2)
    fa, _, _ = jref.tc_row_lookup_ref(k1, v1, s1, ra, J(keys))
    fb, _, _ = jref.tc_row_lookup_ref(k1, v1, s1, rb, J(keys))
    pend = win & ~ok1 & ~(fa | fb)
    assert int(pend.sum()) > 0, "the batch must overflow the claim rounds"
    k2, v2, s2, done = jref.cuckoo_kick_ref(
        k1, v1, s1, ra, rb, jt.hfn_a, jt.hfn_b, jt.nbuckets, J(keys), J(vals),
        pend, jt.max_kick)
    want_ok = ok1 | done
    # the port's fused adapter
    pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
    tprobe.reset_launches()
    t2, ok, present = tbe.cuckoo_insert_fused(pt, T(keys), T(vals), T(mask),
                                              with_present=True)
    assert t2.key is pt.key, "written in place"
    for a, c in ((k2, t2.key), (v2, t2.val), (s2, t2.state),
                 (want_ok, ok)):
        assert np.array_equal(np.asarray(a), N(c))
    f0, _, _ = jb.cuckoo_lookup(jt, J(keys))
    assert np.array_equal(np.asarray(f0 & win), N(present))
    assert int(done.sum()) > 0, "the kick-out must place some keys"
    f, v, _ = tb.cuckoo_lookup(t2, T(keys))
    assert bool(f[ok].all()) and torch.equal(v[ok], T(vals)[ok])
    # plain vs fused: different linearisations, the same ok and live map
    pl, pok = tb.cuckoo_insert(
        convert.table_from_numpy(jax_table_tree(jt), device="cpu"),
        T(keys), T(vals), T(mask))
    assert torch.equal(pok, ok)
    assert live_map(pl.key, pl.val, pl.state) == live_map(t2.key, t2.val,
                                                          t2.state)


def test_guarded_kick_out_does_nothing_when_no_winner_is_pending():
    """The kick-out's guard: a batch with no pending winner (every key
    placed by the claim kernel, present, or masked out) leaves the table and
    ``ok`` as they were, bit for bit — also on a crowded table where a
    kick-out would move residents."""
    jt, base = loaded_table(8, 60, seed=4)
    pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
    keys = np.array([base[0], base[1], 523_457, 623_459], np.int32)
    ra, rb = tb._ck_rows(pt, T(keys))
    winner = T([True, True, False, True])
    ok = T([False, False, False, True])
    present = T([True, True, False, False])
    before = [x.clone() for x in (pt.key, pt.val, pt.state, ok)]
    got = tprobe.cuckoo_kick(pt.key, pt.val, pt.state, ra, rb, pt.hfn_a,
                             pt.hfn_b, pt.nbuckets, T(keys), T(keys), winner,
                             ok, present, pt.max_kick)
    assert got is ok
    for a, b in zip(before, (pt.key, pt.val, pt.state, ok)):
        assert torch.equal(a, b)
    # the same flags with one winner pending: the kick-out runs and places it
    ok2 = T([False, False, False, False])
    tprobe.cuckoo_kick(pt.key, pt.val, pt.state, ra, rb, pt.hfn_a, pt.hfn_b,
                       pt.nbuckets, T(keys), T(keys), winner, ok2, present,
                       pt.max_kick)
    assert ok2.tolist() == [False, False, False, True]
    f, v, _ = tb.cuckoo_lookup(pt, T(keys[3:]))
    assert bool(f.all()) and int(v[0]) == keys[3]


def _staged_kick(tk, tv, ts, ra, rb, hfa, hfb, nb, keys, vals, pend,
                 max_kick, stages=(1, 2, 4, 8, 16)):
    """The kick-out as the port ran it before its kernel: on the pending
    keys only, in stages of iterations numbered on, each stage on the keys
    the last one left unplaced."""
    sel = pend.nonzero().squeeze(1)
    k, v, s = tk.clone(), tv.clone(), ts.clone()
    left = torch.ones(sel.numel(), dtype=torch.bool)
    done = torch.zeros_like(left)
    it = 0
    for stop in (*[n for n in stages if n < max_kick], max_kick):
        k, v, s, d = tref.cuckoo_kick_ref(
            k, v, s, ra[sel], rb[sel], hfa, hfb, nb, keys[sel], vals[sel],
            left, stop - it, first_iter=it)
        done |= d
        left &= ~d
        it = stop
    out = torch.zeros_like(pend)
    out[sel] = done
    return k, v, s, out


def test_kick_out_plain_equals_staged_calls_and_jax():
    """The kick-out kernel's plain version over ``max_kick`` iterations (the
    whole batch, ``ok`` updated in place) equals the staged composition the
    port ran before the kernel and the JAX ``cuckoo_kick_ref``, slot for
    slot, on a crowded table with full rows and a row shared by many
    queries."""
    rng = np.random.default_rng(18)
    nb, w = 16, 4
    hfa, hfb = jh.fresh("mix32", 3), jh.fresh("mix32", 4)
    tk = rng.integers(1, 10_000, (2 * nb, w)).astype(np.int32)
    ts = np.where(rng.random((2 * nb, w)) < 0.85, LIVE,
                  rng.integers(0, 4, (2 * nb, w))).astype(np.int32)
    keys = rng.choice(np.arange(20_000, 30_000), 48,
                      replace=False).astype(np.int32)
    ra = np.array(jh.bucket_of(hfa, J(keys), nb))
    rb = nb + np.array(jh.bucket_of(hfb, J(keys), nb))
    ra[:10] = 5                                           # a shared row
    winner = rng.random(48) < 0.9
    ok = rng.random(48) < 0.2
    present = rng.random(48) < 0.1
    pend = winner & ~ok & ~present
    max_kick = 32
    jk = jref.cuckoo_kick_ref(J(tk), J(tk * 3), J(ts), J(ra), J(rb), hfa, hfb,
                              nb, J(keys), J(keys * 5), J(pend), max_kick)
    tfa, tfb = th.fresh("mix32", 3, "cpu"), th.fresh("mix32", 4, "cpu")
    args = [T(x) for x in (tk, tk * 3, ts, ra, rb)]
    staged = _staged_kick(*args, tfa, tfb, nb, T(keys), T(keys * 5),
                          T(pend), max_kick)
    tab = [x.clone() for x in args[:3]]
    ok_t = T(ok)
    tprobe.cuckoo_kick_plain(*tab, args[3], args[4], tfa, tfb, nb, T(keys),
                             T(keys * 5), T(winner), ok_t, T(present),
                             max_kick)
    for a, b, c in zip(jk[:3], staged[:3], tab):
        assert np.array_equal(np.asarray(a), N(b))
        assert torch.equal(b, c)
    assert np.array_equal(np.asarray(jk[3]), N(staged[3]))
    assert torch.equal(ok_t, T(ok) | staged[3])
    assert staged[3].any() and not bool(staged[3][T(pend)].all())


@pytest.mark.parametrize("width,n_base,q", [(8, 60, 64), (4, 24, 40)])
def test_plain_insert_slot_for_slot_both_packages(width, n_base, q):
    jt, _ = loaded_table(width, n_base, seed=3)
    pt = convert.table_from_numpy(jax_table_tree(jt), device="cpu")
    rng = np.random.default_rng(q)
    keys = rng.choice(np.arange(300_000, 400_000), q,
                      replace=False).astype(np.int32)
    keys[:3] = keys[3:6]
    mask = rng.random(q) < 0.9
    jt2, jok = jax.jit(jb.cuckoo_insert)(jt, J(keys), J(keys * 2), J(mask))
    pt2, pok = tb.cuckoo_insert(pt, T(keys), T(keys * 2), T(mask))
    assert np.array_equal(np.asarray(jok), N(pok)) and N(pok).any()
    for f in ("key", "val", "state"):
        assert np.array_equal(np.asarray(getattr(jt2, f)),
                              N(getattr(pt2, f)))
    assert int((pt.state == LIVE).sum()) == n_base, "functional"


def test_cuckoo_kick_ref_both_packages_equal():
    """The kick-out alone on a crowded table with full rows, rows shared by
    many queries and queries of one row on both sides of the rotation: both
    packages give the same tables and done flags."""
    rng = np.random.default_rng(8)
    nb, w = 16, 4
    hfa, hfb = jh.fresh("mix32", 1), jh.fresh("mix32", 2)
    tk = rng.integers(1, 10_000, (2 * nb, w)).astype(np.int32)
    tv = tk * 3
    ts = np.where(rng.random((2 * nb, w)) < 0.8, LIVE,
                  rng.integers(0, 4, (2 * nb, w))).astype(np.int32)
    keys = rng.choice(np.arange(20_000, 30_000), 48,
                      replace=False).astype(np.int32)
    ra = np.array(jh.bucket_of(hfa, J(keys), nb))
    rb = nb + np.array(jh.bucket_of(hfb, J(keys), nb))
    ra[:8] = 3                                            # a shared row
    pending = rng.random(48) < 0.9
    out_j = jref.cuckoo_kick_ref(J(tk), J(tv), J(ts), J(ra), J(rb), hfa, hfb,
                                 nb, J(keys), J(keys * 5), J(pending), 12)
    tfa = th.fresh("mix32", 1, "cpu")
    tfb = th.fresh("mix32", 2, "cpu")
    args = [T(x) for x in (tk, tv, ts, ra, rb)]
    out_t = tref.cuckoo_kick_ref(*args, tfa, tfb, nb, T(keys), T(keys * 5),
                                 T(pending), 12)
    for a, c in zip(out_j, out_t):
        assert np.array_equal(np.asarray(a), N(c))
    assert torch.equal(args[2], T(ts)), "functional: inputs untouched"
    done = N(out_t[3])
    assert done.any() and not done.all()
    moved = (N(out_t[0]) != tk) & (ts == LIVE)
    assert moved.any(), "some victims must relocate (plan B)"


def _colliding_keys(hfn, nbuckets: int, want: int, rng, bucket: int = 0):
    """``want`` distinct keys that all hash into ``bucket`` under hfn."""
    got = np.empty((0,), np.int32)
    while got.size < want:
        cand = rng.integers(1, 1_000_000_000, 1 << 14).astype(np.int32)
        b = th.bucket_of(hfn, torch.as_tensor(cand), nbuckets).numpy()
        got = np.unique(np.concatenate([got, cand[b == bucket]]))
    return got[:want]


@pytest.mark.parametrize("fused", [False, True])
def test_probe_depth_bounded_under_collision_flood(fused):
    """The reference's defense contract on the port: flood ONE side-A row
    with 3x more colliders than it has lanes; the kick-out places them all
    and every lookup's probe depth stays below the row width."""
    rng = np.random.default_rng(7)
    be = tbe.get("cuckoo")
    t = be.make(1500, seed=9, device="cpu")
    insert = be.insert_fused if fused else be.insert
    normal = (rng.choice(500_000, 600, replace=False) + 1).astype(np.int32)
    t, ok = insert(t, T(normal), T(normal * 3),
                   torch.ones(normal.shape, dtype=torch.bool))
    assert bool(ok.all())
    atk = _colliding_keys(t.hfn_a, int(t.nbuckets), 3 * t.width, rng)
    if fused:
        # the claim kernel's two rounds alone leave some unplaced: the
        # kick-out must run
        k, v, s = (x.clone() for x in (t.key, t.val, t.state))
        ra, rb = tb._ck_rows(t, T(atk))
        ok2, _ = tprobe.tc_insert(k, v, s, ra, rb, T(atk), T(atk * 3),
                                  torch.ones(atk.shape, dtype=torch.bool), 2)
        assert not bool(ok2.all())
    t, ok = insert(t, T(atk), T(atk * 3),
                   torch.ones(atk.shape, dtype=torch.bool))
    assert bool(ok.all()), "kick-out must place a modest collider flood"
    qs = T(np.concatenate([normal, atk]))
    f, v, loc = be.lookup(t, qs)
    assert bool(f.all()) and torch.equal(v, qs * 3)
    cost = be.probe_cost(t, qs, f, loc)
    assert int(cost.max()) < t.width <= t.max_kick
    # the same flood on the reference: the same answers
    jt = jbe.get("cuckoo").make(1500, seed=9)
    jins = jax.jit(jbe.get("cuckoo").insert)
    for ks in (normal, atk):
        jt, _ = jins(jt, J(ks), J(ks * 3), jnp.ones(ks.shape, bool))
    if not fused:
        assert live_map(jt.key, jt.val, jt.state) == live_map(
            t.key, t.val, t.state)
        assert np.array_equal(np.asarray(jt.state), N(t.state))
