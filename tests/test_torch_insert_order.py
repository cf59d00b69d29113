"""The ordering the ``probe_insert`` kernel relies on, pinned on the CPU.

The kernel (``src/repro_torch/kernels/csrc/probe_insert.cu``) runs none of
the reference's lock-step claim rounds.  It resolves each range of start
slots on its own, as a greedy pass in DESCENDING start slot over the range
and a halo of ``max_probes - 1`` slots above it (each group of queries with
one start slot takes, in ascending batch index, the first slots of its
window that are not LIVE and that no higher group took; the halo's groups
are only counted); a range whose queries do not fit is halved, one hot
start slot is counted and its queries ranked in batch order, and windows
wider than 64 slots or than the table take lock-step rounds with claims
resolved a chunk of the batch at a time.  ``model_insert`` below is that resolution in numpy, step for step;
it must equal the reference's ``probe_insert_ref`` (JAX and port),
``probe_insert_plain`` and the JAX ``buckets.linear_insert`` slot for slot,
on seeded tables with TOMB and MIGRATED slots, clustered start slots,
random masks and range widths.  Tolerance 0.  The card holds the kernel to
``probe_insert_plain`` on the same kinds of input (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import buckets as jb  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
WINDOW = 64           # the widest window of the greedy path (a 64-bit mask)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def present_before(tk, ts, h0, keys, P):
    """Whether each key is LIVE within its probe run, on the table before
    the batch (the reference's presence probe)."""
    c = len(ts)
    found = np.zeros(len(keys), bool)
    active = np.ones(len(keys), bool)
    pos = h0.astype(np.int64) % c
    for _ in range(P):
        st = ts[pos]
        hit = active & (st == LIVE) & (tk[pos] == keys)
        found |= hit
        active &= ~hit & (st != EMPTY)
        pos = (pos + 1) % c
    return found


def free_mask(ts, h: int, P: int) -> int:
    """Bit j: slot (h + j) mod C is not LIVE before the batch."""
    c = len(ts)
    return sum(1 << j for j in range(P) if ts[(h + j) % c] != LIVE)


def lowest(m: int, n: int) -> int:
    """The lowest ``n`` set bits of m."""
    rest = m
    for _ in range(n):
        if not rest:
            break
        rest &= rest - 1
    return m ^ rest


def nth_bit(m: int, r: int) -> int:
    for _ in range(r):
        m &= m - 1
    return (m & -m).bit_length() - 1


def blocks_for(c: int, q: int, P: int, sms: int) -> int:
    """``pi_blocks``: one block a 64 queries, at most ``sms``, and enough
    that no range and its halo wrap onto themselves."""
    return max(min((q + 63) // 64, sms), -(-c // (c - P + 1)))


class Model:
    """The kernel's resolution on numpy arrays; ``run`` returns the table
    after the batch and (ok, present)."""

    def __init__(self, tk, tv, ts, h0, keys, vals, mask, P, *, sms=132,
                 cap=2048, chunk=1024, halo=None):
        self.tk, self.tv, self.ts = tk.copy(), tv.copy(), ts.copy()
        self.h0, self.keys, self.vals = h0.astype(np.int64), keys, vals
        self.mask, self.P, self.cap, self.chunk = mask, P, cap, chunk
        self.sms = sms
        self.halo = P - 1 if halo is None else halo
        self.c, self.q = len(ts), len(keys)
        self.present = np.zeros(self.q, bool)
        self.slot = np.full(self.q, -7)            # -7: never written
        self.ranges = []                           # (a, lo, hi) resolved
        self.hot = []                              # (a, o) counted

    def run(self):
        c, P = self.c, self.P
        if 1 <= P <= WINDOW and P <= c:
            blocks = blocks_for(c, self.q, P, self.sms)
            w = -(-c // blocks)
            assert w + P - 1 <= c
            for r in range(blocks):
                a = r * w
                if a >= c:
                    continue
                stack, root = [(0, min(w, c - a))], True
                while stack:
                    lo, hi = stack.pop()
                    done, root = self.resolve(a, lo, hi, root), False
                    if done:
                        continue
                    if hi - lo > 1:
                        mid = lo + (hi - lo) // 2
                        stack += [(lo, mid), (mid, hi)]
                    else:
                        self.hot_slot(a, lo)
        else:
            self.lockstep()
        assert (self.slot >= -1).all(), "a query's target was never written"
        ok = self.slot >= 0
        s = self.slot[ok]
        assert len(np.unique(s)) == len(s), "two queries share a slot"
        self.tk[s], self.tv[s], self.ts[s] = self.keys[ok], self.vals[ok], LIVE
        return self.tk, self.tv, self.ts, ok, self.present

    def _off(self, a):
        return (self.h0 - a) % self.c

    def halo_taken(self, a, base, off, pending):
        """``pi_halo``: the slots of [base, base + P - 1) that the groups
        starting there (pending queries counted, highest first) take, bit j
        for slot base + j."""
        c, P = self.c, self.P
        cnt = np.bincount(off[pending] - base, minlength=P)[:max(self.halo, 0)]
        full, taken, prev = (1 << P) - 1, 0, None
        for d in range(len(cnt) - 1, -1, -1):
            if not cnt[d]:
                continue
            if prev is not None:
                taken <<= prev - d
            f = free_mask(self.ts, (a + base + d) % c, P)
            taken |= lowest(f & ~taken & full, min(cnt[d], P))
            prev = d
        return taken << prev if prev else taken

    def halo_pending(self, a, base, off):
        """The masked queries of the halo above ``base`` that are pending."""
        inh = (off >= base) & (off < base + self.halo) & self.mask
        there = present_before(self.tk, self.ts, self.h0, self.keys, self.P)
        return inh & ~there

    def resolve(self, a, lo, hi, root=False) -> bool:
        """``pi_range``: the range's pending queries listed in batch order,
        its halo's counted, the greedy over both; False when more than
        ``cap`` queries are listed (the block's first pass, ``root``, lists
        every masked query and proves presence after)."""
        c, P = self.c, self.P
        off = self._off(a)
        tgt = (off >= lo) & (off < hi)
        there = present_before(self.tk, self.ts, self.h0, self.keys, P)
        self.present[tgt] = self.mask[tgt] & there[tgt]
        self.slot[tgt & (~self.mask | there)] = -1
        cand = np.flatnonzero(tgt & self.mask & ~there)   # batch order
        listed = int((tgt & self.mask).sum()) if root else len(cand)
        if listed > self.cap:
            return False
        self.ranges.append((a, lo, hi))
        halo = self.halo_taken(a, hi, off, self.halo_pending(a, hi, off))
        groups: dict[int, list[int]] = {}
        for i in sorted(cand, key=lambda i: (off[i], i)):
            groups.setdefault(int(off[i]), []).append(int(i))
        offs = sorted(groups)
        full = (1 << P) - 1
        take = {}
        for k, o in enumerate(offs):               # each cluster top, down
            if k + 1 < len(offs) and offs[k + 1] - o < P:
                continue
            taken, cur = (halo << (hi - o) if hi - o < WINDOW else 0), k
            while True:
                g = offs[cur]
                t = lowest(free_mask(self.ts, (a + g) % c, P) & ~taken & full,
                           min(len(groups[g]), P))
                take[g] = t
                taken |= t
                if cur == 0 or g - offs[cur - 1] >= P:
                    break
                taken <<= g - offs[cur - 1]
                cur -= 1
        for g in offs:
            t = take[g]
            for r, i in enumerate(groups[g]):
                self.slot[i] = ((a + g + nth_bit(t, r)) % c
                                if r < bin(t).count("1") else -1)
        return True

    def hot_slot(self, a, o):
        """``pi_hot_slot``: o's pending queries and the halo's counted, o's
        ranked in batch order."""
        c, P = self.c, self.P
        self.hot.append((a, o))
        off = self._off(a)
        mine = off == o
        there = present_before(self.tk, self.ts, self.h0, self.keys, P)
        self.present[mine] = self.mask[mine] & there[mine]
        pend = mine & self.mask & ~there
        self.slot[mine] = -1
        halo = self.halo_taken(a, o + 1, off, self.halo_pending(a, o + 1, off))
        t_o = lowest(free_mask(self.ts, (a + o) % c, P) & ~(halo << 1)
                     & ((1 << P) - 1), min(int(pend.sum()), P))
        n_t = bin(t_o).count("1")
        for r, i in enumerate(np.flatnonzero(pend)):       # batch order
            self.slot[i] = (a + o + nth_bit(t_o, r)) % c if r < n_t else -1

    def lockstep(self):
        """``probe_insert_lockstep``: presence first, then the rounds, the
        claims of a round resolved a chunk of the batch at a time (the
        winners write at once)."""
        c, P = self.c, self.P
        there = present_before(self.tk, self.ts, self.h0, self.keys, P)
        self.present = self.mask & there
        self.slot = np.where(self.mask & ~there, -2, -1)
        for p in range(P):
            for base in range(0, self.q, self.chunk):
                idx = [i for i in range(base, min(base + self.chunk, self.q))
                       if self.slot[i] == -2]
                won = {}
                for i in idx:
                    s = int((self.h0[i] + p) % c)
                    if self.ts[s] != LIVE and s not in won:
                        won[s] = i                 # idx ascends: lowest wins
                for s, i in won.items():
                    self.tk[s], self.tv[s] = self.keys[i], self.vals[i]
                    self.ts[s], self.slot[i] = LIVE, s
            if not (self.slot == -2).any():
                break
        self.slot[self.slot == -2] = -1


def model_insert(*args, **kw):
    return Model(*args, **kw).run()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def seeded_table(c: int, seed: int, live: float = 0.45, dead: float = 0.2):
    """Slots LIVE, TOMB or MIGRATED (with keys) or EMPTY, at random."""
    rng = np.random.default_rng(seed)
    ts = rng.choice([EMPTY, LIVE, TOMB, MIGRATED], c,
                    p=[1 - live - dead, live, dead / 2, dead / 2]).astype(
                        np.int32)
    tk = rng.choice(np.arange(1, 40 * c + 1), c, replace=False).astype(
        np.int32)
    tv = (tk * 3 + 1).astype(np.int32)
    return tk, tv, ts


def clustered_batch(tk, ts, q: int, seed: int, n_centres: int = 4,
                    spread: int = 6):
    """``q`` distinct keys (a share LIVE in the table, a share dead there,
    the rest fresh) whose start slots cluster around a few centres (one of
    them one slot below C, so runs wrap), and a random mask."""
    c = len(ts)
    rng = np.random.default_rng(seed)
    live_keys = tk[ts == LIVE]
    dead_keys = tk[(ts == TOMB) | (ts == MIGRATED)]
    fresh = -rng.choice(np.arange(1, 40 * c + 10 * q), q, replace=False)
    keys = fresh.astype(np.int32)
    n_live = min(q // 5, len(live_keys))
    n_dead = min(q // 10, len(dead_keys))
    keys[:n_live] = rng.choice(live_keys, n_live, replace=False)
    keys[n_live:n_live + n_dead] = rng.choice(dead_keys, n_dead, replace=False)
    keys = rng.permutation(keys)
    centres = np.append(rng.integers(0, c, n_centres - 1), c - 1)
    h0 = (rng.choice(centres, q) + rng.integers(0, spread + 1, q)) % c
    # the live keys start where they are, or before: a presence probe can
    # find them
    where = {int(k): s for s, k in enumerate(tk) if ts[s] == LIVE}
    for j, k in enumerate(keys):
        if int(k) in where and rng.random() < 0.8:
            h0[j] = (where[int(k)] - rng.integers(0, 4)) % c
    mask = rng.random(q) < 0.85
    return h0.astype(np.int32), keys, (keys * 5 + 2).astype(np.int32), mask


def references(tk, tv, ts, h0, keys, vals, mask, P):
    """(key, val, state, ok) of the JAX and the port's probe_insert_ref and
    of probe_insert_plain, and the port's presence."""
    j = jref.probe_insert_ref(*(jnp.asarray(x) for x in
                                (tk, tv, ts, h0, keys, vals, mask)), P)
    T = [torch.as_tensor(np.array(x)) for x in (tk, tv, ts, h0, keys, vals,
                                                 mask)]
    t = tref.probe_insert_ref(*T, P)
    a = [x.clone() for x in T[:3]]
    ok, present = tprobe.probe_insert_plain(*a, *T[3:], P)
    return ([np.asarray(x) for x in j], [x.numpy() for x in t],
            [x.numpy() for x in (*a, ok)], present.numpy())


def assert_model_is_reference(tk, tv, ts, h0, keys, vals, mask, P, **kw):
    m = Model(tk, tv, ts, h0, keys, vals, mask, P, **kw)
    got = m.run()
    jax_out, port_out, plain_out, present = references(
        tk, tv, ts, h0, keys, vals, mask, P)
    for want in (jax_out, port_out, plain_out):
        for x, y, name in zip(got[:4], want, ("key", "val", "state", "ok")):
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
    assert np.array_equal(got[4], present), "present"
    return m


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

# (C, max_probes, Q): windows narrower than, equal to and wider than the
# table; more queries than slots; max_probes > 64 (the lock-step path)
CASES = [(7, 1, 9), (7, 5, 12), (7, 7, 20), (7, 9, 10), (64, 8, 40),
         (64, 64, 150), (64, 70, 90), (100, 16, 120), (100, 64, 300),
         (100, 100, 80), (1024, 32, 700), (1024, 64, 1500), (1024, 80, 400),
         (4096, 64, 3000), (4096, 16, 2000)]


@pytest.mark.parametrize("c,p,q", CASES)
def test_model_equals_the_reference_slot_for_slot(c, p, q):
    tk, tv, ts = seeded_table(c, seed=c + p)
    h0, keys, vals, mask = clustered_batch(tk, ts, q, seed=c * p + q)
    m = assert_model_is_reference(tk, tv, ts, h0, keys, vals, mask, p)
    if 1 <= p <= WINDOW and p <= c:
        assert m.ranges, "the greedy path must have run"


@pytest.mark.parametrize("c,p,q,sms,cap", [
    (100, 64, 300, 1, 40), (1024, 32, 900, 3, 50), (1024, 64, 1500, 132, 8),
    (4096, 64, 3000, 7, 100), (4096, 8, 2500, 1, 2), (64, 64, 200, 5, 3)])
def test_range_widths_and_halving_do_not_change_the_result(c, p, q, sms,
                                                           cap):
    """Fewer blocks (wider ranges) and a small capacity (ranges halved down
    to single start slots, hot start slots counted): the same placement."""
    tk, tv, ts = seeded_table(c, seed=3 * c + p)
    h0, keys, vals, mask = clustered_batch(tk, ts, q, seed=c + q + cap,
                                           n_centres=3, spread=3)
    m = assert_model_is_reference(tk, tv, ts, h0, keys, vals, mask, p,
                                  sms=sms, cap=cap)
    w = -(-c // blocks_for(c, q, p, sms))
    assert m.hot or any(hi - lo < min(w, c - a) for a, lo, hi in m.ranges), \
        "no range was halved"


def test_hot_start_slot_beyond_the_capacity():
    """One start slot holds more queries than a block lists (the phase-2
    case of chip_smoke.py, scaled down), with hot neighbours in its halo
    and a range boundary inside its window."""
    c, p = 1024, 64
    tk, tv, ts = seeded_table(c, seed=5, live=0.3)
    rng = np.random.default_rng(6)
    q = 900
    keys = -rng.choice(np.arange(1, 10**6), q, replace=False).astype(np.int32)
    h0 = rng.integers(0, c, q)
    h0[100:500] = c - 5                        # wraps
    h0[500:600] = 37                           # the last start slot of a range
    h0[600:650] = 40
    mask = rng.random(q) < 0.9
    m = assert_model_is_reference(tk, tv, ts, h0.astype(np.int32), keys,
                                  keys * 5 + 2, mask, p, sms=27, cap=64)
    assert m.hot, "the hot start slot must overflow a single-slot range"


@pytest.mark.parametrize("chunk", [1, 3, 64, 1024])
def test_lockstep_chunks_equal_the_rounds(chunk):
    """The lock-step path's claims resolved a chunk of the batch at a time
    (the winners writing at once) give the rounds' placement."""
    c, p, q = 50, 70, 160
    tk, tv, ts = seeded_table(c, seed=chunk)
    h0, keys, vals, mask = clustered_batch(tk, ts, q, seed=chunk + 1)
    assert_model_is_reference(tk, tv, ts, h0, keys, vals, mask, p,
                              chunk=chunk)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_shorter_halo_departs_from_the_reference(seed):
    """The halo is what makes a range's result its own: with the range's
    own groups only (no halo) the greedy departs from the reference on a
    crowded table, with max_probes - 1 slots it does not."""
    c, p, q = 512, 16, 400
    tk, tv, ts = seeded_table(c, seed=seed, live=0.5)
    h0, keys, vals, mask = clustered_batch(tk, ts, q, seed=seed + 9,
                                           n_centres=12, spread=20)
    want = references(tk, tv, ts, h0, keys, vals, mask, p)[1]
    try:
        short = model_insert(tk, tv, ts, h0, keys, vals, mask, p, halo=0,
                             sms=40)
        departed = not all(np.array_equal(x, y)
                           for x, y in zip(short[:4], want))
    except AssertionError:          # two ranges gave one slot away twice
        departed = True
    assert departed
    full = model_insert(tk, tv, ts, h0, keys, vals, mask, p, sms=40)
    assert all(np.array_equal(x, y) for x, y in zip(full[:4], want))


@pytest.mark.parametrize("c,p,kind", [(64, 8, "mix32"), (1000, 16, "mix32"),
                                      (4096, 64, "multiply_shift")])
def test_model_equals_jax_linear_insert(c, p, kind):
    """Hashed start slots through the JAX ``buckets.linear_insert`` (its
    own winner filter and hash): the model places slot for slot."""
    tk, tv, ts = seeded_table(c, seed=c)
    hfn = jh.fresh(kind, c + 1)
    rng = np.random.default_rng(c)
    q = c // 2
    keys = rng.choice(np.arange(-10**6, 10**6), q, replace=False).astype(
        np.int32)
    keys[: q // 8] = tk[ts == LIVE][: q // 8]
    mask = rng.random(q) < 0.9
    t = dataclasses.replace(jb.linear_make(c, hfn, max_probes=p),
                            key=jnp.asarray(tk), val=jnp.asarray(tv),
                            state=jnp.asarray(ts))
    vals = (keys * 5 + 2).astype(np.int32)
    t2, ok = jb.linear_insert(t, jnp.asarray(keys), jnp.asarray(vals),
                              jnp.asarray(mask))
    h0 = np.asarray(jh.bucket_of(hfn, jnp.asarray(keys), c))
    got = model_insert(tk, tv, ts, h0, keys, vals, mask, p)
    for x, y in zip(got[:4], (t2.key, t2.val, t2.state, ok)):
        assert np.array_equal(x, np.asarray(y))


def test_every_target_is_written_once_and_inside_its_window():
    """No query is left without an answer, no slot gets two queries, and a
    placed key lies in [h0, h0 + max_probes) mod C."""
    c, p, q = 4096, 64, 3500
    tk, tv, ts = seeded_table(c, seed=77, live=0.6)
    h0, keys, vals, mask = clustered_batch(tk, ts, q, seed=78, n_centres=6,
                                           spread=40)
    m = Model(tk, tv, ts, h0, keys, vals, mask, p, cap=128)
    _, _, _, ok, _ = m.run()
    assert ok.any() and (mask & ~ok).any()
    d = (m.slot[ok] - h0[ok]) % c
    assert (d < p).all()
