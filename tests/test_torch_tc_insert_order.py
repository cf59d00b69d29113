"""The ordering the ``tc_insert`` kernel relies on, pinned on the CPU.

The kernel (``src/repro_torch/kernels/csrc/tc_insert.cu``) has no grid-wide
barrier.  Round 0 is a bid launch over the grid (presence in both rows on
the table before the batch, then each pending query's atomic min on the
claim word of its row a, at the row's first free lane) and a resolve launch
(the lowest bidder of a row writes and restores the word; the other pending
queries go to a list in no particular order); rounds 1 .. max_rounds-1 run
in one block over the list (the resolve launch's last block to finish),
with barriers between a round's bids, its reads of the claim words and its
writes, and end when nothing is pending or two rounds in a row found no
free lane.  ``model_tc_insert`` below is that resolution in numpy, step
for step, with the resolve's list in a shuffled order; it must equal the
reference's ``tc_insert_ref`` (JAX and port) and ``tc_insert_plain`` slot
for slot on seeded tables with TOMB and MIGRATED lanes: a hot row pair, rows
a == b, widths 4 and 8, two and eight rounds, 2048 keys on one row, a full
table, one query.  A model that took round 1's lanes from the table before round 0
(no barrier between the two) departs from it.  Tolerance 0.  The card holds
the kernel to ``tc_insert_plain`` on the same kinds of input
(``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
FREE = 2**31 - 1              # a claim word between launches
IDLE, NO_LANE = -2, -1        # a query's round-0 slot: not pending, no lane


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def first_free(ts, row: int) -> int:
    lanes = np.flatnonzero(ts[row] != LIVE)
    return int(lanes[0]) if lanes.size else -1


def model_tc_insert(tk, tv, ts, ra, rb, keys, vals, mask, R: int, *,
                    rng=None, stale_round1: bool = False):
    """The kernel's resolution in numpy.  Returns (key, val, state, ok,
    present).  ``rng`` shuffles the order in which the resolve appends to
    the list; ``stale_round1`` makes the tail's round 1 read the table as it
    was before round 0 (a departure kept to show that the barrier matters)."""
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    before = ts.copy()
    B, W = ts.shape
    Q = len(keys)

    def found(row, key):
        return bool(((ts[row] == LIVE) & (tk[row] == key)).any())

    present = np.array([bool(mask[i]) and (found(ra[i], keys[i])
                                           or found(rb[i], keys[i]))
                        for i in range(Q)], bool)
    ok = np.zeros(Q, bool)
    claim = np.full(B, FREE, np.int64)

    def write(s, i):
        tk.flat[s], tv.flat[s], ts.flat[s] = keys[i], vals[i], LIVE
        ok[i] = True

    # bid launch: the table before the batch
    slot = np.full(Q, IDLE, np.int64)
    for i in range(Q):
        if mask[i] and not present[i] and R > 0:
            lane = first_free(ts, ra[i])
            slot[i] = NO_LANE if lane < 0 else ra[i] * W + lane
            if lane >= 0:
                claim[ra[i]] = min(claim[ra[i]], i)
    # resolve launch, in an order of its own
    order = rng.permutation(Q) if rng is not None else np.arange(Q)
    pending = []
    for i in order:
        s = slot[i]
        if s >= 0 and claim[s // W] == i:
            write(s, i)
            claim[s // W] = FREE
        elif s != IDLE and R > 1:
            pending.append(i)
    # the tail block
    placed = np.zeros(len(pending), bool)
    dry = 0
    for r in range(1, R):
        view = before if (stale_round1 and r == 1) else ts
        bid = np.full(len(pending), -1, np.int64)
        for j, i in enumerate(pending):
            if placed[j]:
                continue
            row = rb[i] if r & 1 else ra[i]
            lane = first_free(view, row)
            if lane >= 0:
                bid[j] = row * W + lane
                claim[row] = min(claim[row], i)
        win = [bid[j] >= 0 and claim[bid[j] // W] == i
               for j, i in enumerate(pending)]
        for j, i in enumerate(pending):
            if bid[j] < 0:
                continue
            claim[bid[j] // W] = FREE
            if win[j]:
                write(bid[j], i)
                placed[j] = True
        dry = 0 if (bid >= 0).any() else dry + 1
        if placed.all() or dry >= 2:
            break
    assert (claim == FREE).all(), "a claim word was left behind"
    return tk, tv, ts, ok, present


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def table(B: int, W: int, live: float, rng):
    """A [B, W] table: ``live`` of the lanes LIVE, the rest EMPTY, TOMB or
    MIGRATED."""
    tk = rng.integers(-(1 << 30), 1 << 30, (B, W)).astype(np.int32)
    tv = (tk * 3).astype(np.int32)
    ts = np.where(rng.random((B, W)) < live, LIVE,
                  rng.choice([EMPTY, TOMB, MIGRATED], (B, W))).astype(np.int32)
    return tk, tv, ts


def batch(case: str, B: int, W: int, tk, ts, rng):
    """(rows_a, rows_b, keys, vals, mask) of one case; masked keys are
    distinct (the caller contract: winner-filtered)."""
    Q = {"one_query": 1, "flood": 2048}.get(case, 600)
    keys = rng.choice(np.arange(1 << 30, (1 << 30) + 10 * Q + 10), Q,
                      replace=False).astype(np.int32)
    ra = rng.integers(0, B, Q).astype(np.int32)
    rb = rng.integers(0, B, Q).astype(np.int32)
    mask = rng.random(Q) < 0.9
    if case == "mixed":
        hot = slice(Q // 2, Q // 2 + 120)
        ra[hot], rb[hot] = 7, 11                      # one hot row pair
        rb[: Q // 8] = ra[: Q // 8]                   # rows a == b
        live = np.argwhere(ts == LIVE)[: Q // 10]     # keys already live
        keys[Q // 8: Q // 8 + len(live)] = tk[live[:, 0], live[:, 1]]
        ra[Q // 8: Q // 8 + len(live)] = live[:, 0]
        mask[Q // 8: Q // 8 + len(live)] = True
    elif case == "flood":
        ra[:] = 3                                     # 2048 keys on one row
        rb[: Q // 4] = 3
    elif case == "one_query":
        mask[:] = True
    return ra, rb, keys, (keys * 5 + 1).astype(np.int32), mask


CASES = [("mixed", 8, 0.6), ("mixed", 4, 0.6), ("flood", 8, 0.3),
         ("full", 8, 1.0), ("one_query", 8, 0.9), ("one_query", 4, 1.0)]


def references(tk, tv, ts, ra, rb, keys, vals, mask, R):
    """``tc_insert_ref`` of both packages and ``tc_insert_plain``, each as
    numpy (key, val, state, ok)."""
    j = [np.asarray(x) for x in jref.tc_insert_ref(
        *(jnp.asarray(x) for x in (tk, tv, ts, ra, rb, keys, vals, mask)),
        R)]
    t = [x.numpy() for x in tref.tc_insert_ref(
        *(torch.as_tensor(x) for x in (tk, tv, ts, ra, rb, keys, vals, mask)),
        R)]
    arrs = [torch.as_tensor(np.array(x)) for x in (tk, tv, ts)]
    ok, present = tprobe.tc_insert_plain(
        *arrs, *(torch.as_tensor(x) for x in (ra, rb, keys, vals, mask)), R)
    p = [x.numpy() for x in arrs] + [ok.numpy()]
    return j, t, p, present.numpy()


@pytest.mark.parametrize("rounds", [2, 8])
@pytest.mark.parametrize("case,W,live", CASES,
                         ids=[f"{c}-W{w}-live{lv}" for c, w, lv in CASES])
def test_model_equals_the_references_slot_for_slot(case, W, live, rounds):
    rng = np.random.default_rng([sum(map(ord, case)), W, rounds])
    B = 64
    tk, tv, ts = table(B, W, live, rng)
    ra, rb, keys, vals, mask = batch(case, B, W, tk, ts, rng)
    j, t, p, present = references(tk, tv, ts, ra, rb, keys, vals, mask,
                                  rounds)
    got = model_tc_insert(tk, tv, ts, ra, rb, keys, vals, mask, rounds,
                          rng=rng)
    for name, want in (("jax", j), ("port", t), ("plain", p)):
        for a, b, n in zip(got[:4], want, ("key", "val", "state", "ok")):
            assert np.array_equal(a, b), (name, n)
    assert np.array_equal(got[4], present)
    if case == "full":
        assert not got[3].any()
    elif case != "one_query" or live < 1:
        assert got[3].any()
    if case == "flood":
        assert got[3].sum() > 50 and not got[3][mask].all()


def test_round_one_from_the_table_before_round_zero_departs():
    """The barrier between round 0 (the grid's launches) and round 1 (the
    block) matters: a query whose rows a and b are one row, losing that row
    in round 0, must bid in round 1 for the lane after the one round 0
    filled.  Read from the table before round 0 it bids for the filled lane
    and overwrites its winner."""
    rng = np.random.default_rng(3)
    B, W = 16, 8
    tk, tv, ts = table(B, W, 0.5, rng)
    keys = np.array([101, 102, 103], np.int32)
    ra = np.array([5, 5, 9], np.int32)
    rb = np.array([12, 5, 2], np.int32)              # query 1: a == b
    mask = np.ones(3, bool)
    vals = keys * 5
    want = tref.tc_insert_ref(*(torch.as_tensor(x) for x in (
        tk, tv, ts, ra, rb, keys, vals, mask)), 2)
    right = model_tc_insert(tk, tv, ts, ra, rb, keys, vals, mask, 2)
    stale = model_tc_insert(tk, tv, ts, ra, rb, keys, vals, mask, 2,
                            stale_round1=True)
    for a, b in zip(right[:4], want):
        assert np.array_equal(a, b.numpy())
    assert not all(np.array_equal(a, b.numpy())
                   for a, b in zip(stale[:4], want))
    # the departure: query 0's key is gone, overwritten by query 1
    assert not (stale[0] == 101).any() and (right[0] == 101).any()
