"""The rebuild step's transition (``probe.transition``, one ``extract``
launch on the card): the landing's bookkeeping, the guarded chunk scan and
the epoch decision.

On the CPU the wrapper takes its plain version.  It is held, field for field
and ``go`` for ``go``, tolerance 0, to the sequence the engine step ran
before the transition took it over — the snapshot ``hazard_live.any()``,
the landing's keep mask ``hl & ~ok & ~present``, the guarded
``extract_plain`` (hold = the snapshot) and ``_epoch_flags`` — and to a
numpy statement of the same rules, through the backend adapters, on a flat
slot table and on a chain arena.  ``rebuild_step_`` on a fused state
touches the hazard flags only through the landing insert (its mask) and the
transition wrapper.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402

CHUNK = 96              # not a divisor of the tables' sizes: a partial chunk
LIVE, MIGRATED = tprobe.LIVE, tprobe.MIGRATED


def _table(kind: str, rng):
    """A flat slot table (linear, 1024 slots) or a chain arena (600 nodes),
    every slot in a random state, and its flat (key, val, state) arrays."""
    if kind == "slots":
        t = tbe.get("linear").make(700, 0, device="cpu")
        arrays = (t.key, t.val, t.state)
    else:
        t = tbe.get("chain").make(600, 0, device="cpu")
        arrays = (t.akey, t.aval, t.astate)
    n = arrays[0].numel()
    arrays[0].copy_(torch.as_tensor(rng.integers(-2**31, 2**31 - 1, n,
                                                 dtype=np.int64)
                                    .astype(np.int32)))
    arrays[1].copy_(torch.as_tensor(rng.integers(0, 1 << 20, n)
                                    .astype(np.int32)))
    arrays[2].copy_(torch.as_tensor(rng.choice(4, n, p=[.3, .45, .15, .1])
                                    .astype(np.int32)))
    return t, arrays


def _cursor(where: str, c: int) -> int:
    return {"first": 0, "middle": 5 * CHUNK + 7, "last": c - CHUNK // 2,
            "end": c}[where]


def _flags(pattern: str, rng) -> np.ndarray:
    return {"empty": np.zeros(CHUNK, bool), "full": np.ones(CHUNK, bool),
            "partial": rng.random(CHUNK) < 0.5,
            "all": np.ones(CHUNK, bool), "none": np.zeros(CHUNK, bool),
            "random": rng.random(CHUNK) < 0.5}[pattern]


def _sequence(arrays, cursor, hazard, rebuilding, ok, present, swap, start):
    """What the engine step ran before the transition launch took it over
    (``dhash.rebuild_step_`` after its landing, then ``epoch_swap``'s
    decision)."""
    hl = hazard[2]
    pending = hl.any()
    hl.copy_(hl & ~ok & ~present)
    tprobe.extract_plain(*arrays, cursor, CHUNK, out=hazard, run=rebuilding,
                         hold=pending)
    return torch.stack(tprobe._epoch_flags(hl, cursor, rebuilding,
                                           arrays[0].numel(), swap, start))


def _numpy(arrays, cur, hz, rb, ok, present, swap, start):
    """The transition's rules in numpy: (key, val, state, hkeys, hvals,
    hlive, cursor, go)."""
    key, val, st = (a.numpy().copy() for a in arrays)
    hk, hv, hl = (np.asarray(x).copy() for x in hz)
    c = st.size
    pending = hl.any()
    hl &= ~ok & ~present
    if rb and not pending:
        pos = np.arange(cur, min(cur + CHUNK, c))
        live = pos[st[pos] == LIVE]
        n = live.size
        hk[:] = 0
        hv[:] = 0
        hk[:n], hv[:n] = key[live], val[live]
        hl[:] = np.arange(CHUNK) < n
        st[live] = MIGRATED
        cur = min(cur + CHUNK, c)
    go_swap = swap and rb and cur >= c and not hl.any()
    go_start = start and (go_swap or not rb)
    return key, val, st, hk, hv, hl, cur, [go_swap, go_start]


@pytest.mark.parametrize("hl_case", ["empty", "partial", "full"])
@pytest.mark.parametrize("where", ["first", "middle", "last", "end"])
@pytest.mark.parametrize("kind", ["slots", "chain"])
def test_transition_equals_the_sequence_it_replaces(kind, where, hl_case):
    """For each ok / present pattern (all landed, none, random), rebuilding
    on and off, and swap_on x start_on: the transition through the
    backend's adapter equals the replaced sequence on every tensor it
    writes (the table's state, the hazard buffer, the cursor) and on go,
    and both equal the numpy rules."""
    rng = np.random.default_rng([("slots", "chain").index(kind),
                                 ("first", "middle", "last",
                                  "end").index(where),
                                 ("empty", "partial", "full").index(hl_case)])
    backend = "linear" if kind == "slots" else "chain"
    t0, arrays0 = _table(kind, rng)
    c = arrays0[0].numel()
    cur0 = _cursor(where, c)
    hz0 = (torch.as_tensor(rng.integers(-9, 1 << 20, CHUNK).astype(np.int32)),
           torch.as_tensor(rng.integers(-9, 1 << 20, CHUNK).astype(np.int32)),
           torch.as_tensor(_flags(hl_case, rng)))
    seen = set()
    for okp, rb, swap, start in itertools.product(
            ("all", "none", "random"), (True, False), (False, True),
            (False, True)):
        ok = _flags(okp, rng)
        present = np.zeros(CHUNK, bool) if okp != "random" \
            else rng.random(CHUNK) < 0.3
        outs = []
        for run in ("transition", "sequence"):
            t = dataclasses.replace(
                t0, **{f.name: getattr(t0, f.name).clone()
                       for f in dataclasses.fields(t0)
                       if isinstance(getattr(t0, f.name), torch.Tensor)})
            arrays = (t.key, t.val, t.state) if kind == "slots" \
                else (t.akey, t.aval, t.astate)
            cursor = torch.tensor(cur0, dtype=torch.int32)
            hz = tuple(x.clone() for x in hz0)
            rbt = torch.tensor(rb)
            args = (torch.as_tensor(ok), torch.as_tensor(present), swap,
                    start)
            if run == "transition":
                go = tbe.get(backend).transition_fused(t, cursor, CHUNK, hz,
                                                       rbt, *args)
            else:
                go = _sequence(arrays, cursor, hz, rbt, *args)
            assert bool(rbt) == rb, "rebuilding was written"
            outs.append((*arrays, *hz, cursor, go))
        what = ("key", "val", "state", "hkey", "hval", "hlive", "cursor",
                "go")
        case = (okp, rb, swap, start)
        for x, y, n in zip(*outs, what):
            assert x.dtype == y.dtype and torch.equal(x, y), (case, n)
        want = _numpy(arrays0, cur0, hz0, rb, ok, present, swap, start)
        for x, y, n in zip(outs[0], want, what):
            assert np.array_equal(np.asarray(x), np.asarray(y)), (case, n)
        seen.add(tuple(outs[0][-1].tolist()))
    # the decision takes every value it can take here: a swap needs the
    # cursor at the end and nothing left live
    if where == "end" and hl_case != "full":
        assert seen == {(False, False), (False, True), (True, False),
                        (True, True)}, seen
    elif where != "end":
        assert seen == {(False, False), (False, True)}, seen


@pytest.mark.parametrize("backend", ["linear", "twochoice", "cuckoo", "chain"])
def test_rebuild_step_touches_the_hazard_flags_only_through_the_transition(
        backend):
    """On a fused CPU state, through a rebuild epoch (landings and scans
    alternate): outside the landing insert and the transition wrapper, no
    operation of ``rebuild_step_`` takes the hazard flags (no ``any``, no
    bitwise op, no copy into them); the transition runs once a call on the
    state's own hazard buffer; and its go equals the replaced decision,
    ``_epoch_flags`` read after the step."""
    from unittest import mock

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    d = tdhash.make(backend, capacity=256, chunk=64, fused=True, seed=3,
                    device="cpu")
    keys = np.random.default_rng(1).choice(1 << 20, 150, replace=False) \
        .astype(np.int32)
    k = torch.as_tensor(keys)
    d, _ = tdhash.insert(d, k, k * 3)
    d = tdhash.rebuild_start(d, seed=11)
    hl = d.hazard_live
    hl_storage = hl.untyped_storage().data_ptr()

    class Touches(TorchDispatchMode):
        paused, seen = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.paused and any(
                    isinstance(x, torch.Tensor)
                    and x.untyped_storage().data_ptr() == hl_storage
                    for x in tree_leaves((args, kwargs, out))):
                self.seen.append(func.__name__)
            return out

    mode = Touches()
    mode.seen = []
    calls = []

    def pausing(fn, record=False):
        def run(*a, **kw):
            if record:
                calls.append(a[5][2])
            mode.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                mode.paused -= 1
        return run

    be = tbe.get(backend)
    patched = dataclasses.replace(be, insert_fused=pausing(be.insert_fused))
    cap = be.capacity_of(d.old)
    gos = []
    with mock.patch.dict(tbe.REGISTRY, {backend: patched}), \
            mock.patch.object(tprobe, "transition",
                              pausing(tprobe.transition, record=True)):
        for _ in range(2 * (-(-cap // d.chunk)) + 2):
            with mode:
                go = tdhash.rebuild_step_(d, swap=True, start=True)
            gos.append(go.tolist())
            want = torch.stack(tprobe._epoch_flags(
                d.hazard_live, d.cursor, d.rebuilding, cap, True, True))
            assert go.tolist() == want.tolist()
    assert mode.seen == [], mode.seen
    assert len(calls) == len(gos) and all(h is hl for h in calls)
    assert gos[-1] == [True, True], gos      # the epoch's end was decided
