"""Port vs reference: ``DHashEngine`` with an elastic policy, in lock step.

Both engines start from one converted table and one converted policy and
take the same numpy op stream (fixed widths, masked).  After every step the
four outputs are equal (values where found on a two-row table, whose
plain lookup's value of a miss is unspecified) and right by a dict oracle;
the policy's device state, the table's ``lookups``, ``expensive``,
``rebuilding``, ``epoch`` and ``cursor``, the engines' ``grows`` and
``shrinks`` and the two states' key -> value maps are equal.  The cases: a
drain that shrinks the table (the reference's ``test_engine_shrinks_after_
drain``), crowded keys whose expensive lookups grow it, and a tombstone
reclaim that the policy starts on the device between two polls (the port's
step routes its ops by the device flag, so the steps before the next poll
stay in lock step).  All four backends on the fused path, linear on the
plain path too.  Tolerance 0.  (The port's fused cuckoo insert is a
linearisation of its own: where a batch contends, its lane depths differ
from the reference's, and ``expensive`` is not compared there, nor the
published ``target_capacity`` mid-epoch, which counts the old table's
entries not yet extracted.)
"""
from __future__ import annotations

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import backend as jbe  # noqa: E402
from repro.core import dhash as jdhash  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core.engine import DHashEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core.engine import DHashEngine as TEngine  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402
from test_torch_policy import (POLICY_STATE, REF_FUSED,  # noqa: E402
                               _colliding_keys, jax_policy_tree)

NL, NU = 32, 16          # lookups / updates a step (fixed widths, masked)
CASES = [("linear", False), ("cuckoo", False)] + [
    (b, True) for b in ("linear", "twochoice", "cuckoo", "chain")]


class Lockstep:
    """A port policy engine beside the reference's, one op stream, a dict
    oracle; ``step`` checks everything the module docstring lists."""

    def __init__(self, backend: str, fused: bool, *, poll_every: int,
                 capacity: int = 256, chunk: int = 32, seed: int = 1,
                 **pol):
        d0 = jdhash.make(backend, capacity=capacity, chunk=chunk, seed=seed,
                         fused=fused and REF_FUSED[backend])
        tree = jax_state_tree(d0)
        jp = jpol.make(**pol)
        self.port = TEngine(
            convert.state_from_numpy({**tree, "fused": fused}, device="cpu"),
            policy=convert.policy_from_numpy(jax_policy_tree(jp),
                                             device="cpu"),
            poll_every=poll_every)
        self.ref = JEngine(d0, policy=jp, poll_every=poll_every)
        self.backend = backend
        self.be = jbe.get(backend)
        self.oracle: dict[int, int] = {}
        self.n = 0
        self.fires_at: list[int] = []
        # the port's fused cuckoo insert linearises a contended batch its
        # own way: its lane depths (the probe cost, ``expensive``), and
        # which of the scan's windows hold entries (a rebuild epoch's
        # length, so the steps its decisions fall on), follow the
        # reference's only where no batch contends
        self.same_lanes = not (backend == "cuckoo" and fused)

    def slots(self) -> int:
        return int(self.be.capacity_of(self.ref.state.old))

    def step(self, look=(), ins=(), dels=()):
        def pad(ks, n):
            k = np.zeros(n, np.int32)
            m = np.zeros(n, bool)
            k[:len(ks)] = ks
            m[:len(ks)] = True
            return k, m
        lk, _ = pad(look, NL)
        ik, im = pad(ins, NU)
        dk, dm = pad(dels, NU)
        iv = (ik * 5 + self.n).astype(np.int32)
        pre = dict(self.oracle)
        out = [x.numpy() for x in self.port.step(lk, ik, iv, dk,
                                                 ins_mask=im, del_mask=dm)]
        ref = [np.asarray(x) for x in self.ref.step(lk, ik, iv, dk,
                                                    ins_mask=im,
                                                    del_mask=dm)]
        self.n += 1
        where = (self.backend, self.n)
        assert np.array_equal(out[0], ref[0]), where
        assert np.array_equal(np.where(out[0], out[1], 0),
                              np.where(ref[0], ref[1], 0)), where
        assert np.array_equal(out[2], ref[2]), where
        assert np.array_equal(out[3], ref[3]), where
        for i, k in enumerate(lk.tolist()):
            assert out[0][i] == (k in pre), (where, k)
            if k in pre:
                assert out[1][i] == pre[k], (where, k)
        for k, v, ok in zip(ik.tolist(), iv.tolist(), out[2].tolist()):
            if ok:
                self.oracle[k] = v
        for k, ok in zip(dk.tolist(), out[3].tolist()):
            if ok:
                del self.oracle[k]
        self.check(where)

    def check(self, where):
        p, r = self.port, self.ref
        pp, rp = convert.policy_to_numpy(p.policy), jax_policy_tree(r.policy)
        if pp["fires"] > len(self.fires_at):
            self.fires_at.append(self.n)
        assert _content(convert.state_to_numpy(p.state)) == \
            _content(jax_state_tree(r.state)) == self.oracle, where
        if not self.same_lanes:
            return
        for f in POLICY_STATE:
            assert pp[f] == rp[f], (where, f, pp[f], rp[f])
        for f in ("lookups", "expensive", "rebuilding", "epoch", "cursor"):
            a = getattr(p.state, f).item()
            b = np.asarray(getattr(r.state, f)).item()
            assert a == b, (where, f, a, b)
        assert (p._stats.grows, p._stats.shrinks) == \
            (r._stats.grows, r._stats.shrinks), where
        assert p.state.nres_cap == r.state.nres_cap, where

    def decisions(self) -> tuple:
        """(grows, shrinks, fires) of both engines, equal (checked)."""
        p, r = self.port, self.ref
        got = (p._stats.grows, p._stats.shrinks, int(p.policy.fires))
        assert got == (r._stats.grows, r._stats.shrinks,
                       int(np.asarray(r.policy.fires)))
        return got

    def live_keys(self) -> list:
        return sorted(self.oracle)

    def settle(self, max_steps: int, until):
        """Quiet steps (lookups of live keys) until ``until()``."""
        rng = np.random.default_rng(self.n)
        for _ in range(max_steps):
            if until():
                return
            keys = self.live_keys() or [0]
            self.step(look=rng.choice(keys, NL))
        raise AssertionError(f"{self.backend}: not settled in {max_steps}")

    def idle(self) -> bool:
        return not bool(self.port.state.rebuilding) and \
            self.n % self.port.poll_every == 0


@pytest.mark.parametrize("backend,fused", CASES)
def test_drain_shrinks_in_lock_step(backend, fused):
    """The reference's engine-level shrink: fill inside the band, drain
    below the low watermark, the poll applies the shrink, the migration
    runs across two table sizes, and the new size holds (no flapping)."""
    ls = Lockstep(backend, fused, poll_every=4, tomb_load=1.0)
    slots0 = ls.slots()
    first = weakref.ref(tbe.epoch_leaves(ls.port.state.old)[0][0])
    high, low = jpol.watermarks(ls.ref.policy, slots0)
    nxt = 1
    while len(ls.oracle) < int(0.55 * slots0):
        ls.step(look=ls.live_keys()[:NL], ins=range(nxt, nxt + NU))
        nxt += NU
    assert ls.port._stats.grows == 0 and len(ls.oracle) < high
    while len(ls.oracle) >= low:
        ls.step(dels=ls.live_keys()[:NU])
    ls.settle(400, lambda: ls.port._stats.shrinks == 1 and ls.idle())
    assert ls.slots() < slots0 and ls.port._stats.grows == 0
    # the resized-away table is gone (its successor took the standby's
    # place), and with it every step the engine captured on it
    assert first() is None
    ls.step()
    assert ls.port._step_cache_size() == 1
    resizes = ls.port._stats.shrinks
    for _ in range(24):
        ls.step(look=ls.live_keys()[:NL])
    assert ls.decisions() == (0, resizes, 0) and resizes == 1


@pytest.mark.parametrize("backend,fused", CASES)
def test_expensive_lookups_grow_in_lock_step(backend, fused):
    """Keys crowded into one bucket, then looked up: the probe telemetry
    (sampled only in the steady state, on the device) publishes the grow
    plan below the watermark on linear; the poll applies it and the
    migration runs to the larger table.  Every backend in lock step."""
    ls = Lockstep(backend, fused, poll_every=8, min_lookups=32)
    slots0 = ls.slots()
    _, low = jpol.watermarks(ls.ref.policy, slots0)
    nxt = 100_000               # inside the band first: no shrink plan
    while len(ls.oracle) <= low:
        ls.step(ins=range(nxt, nxt + NU))
        nxt += NU
    keys = _colliding_keys(ls.port.state.old, 12).tolist()
    ls.same_lanes = True
    for k in keys:              # one a step: no contended batch
        ls.step(ins=[k])
    # the sample window holds the fill's lookups (all misses) too: the
    # expensive share crosses 2/10 after ~15 steps, the poll applies it
    for _ in range(6 * ls.port.poll_every):
        if ls.port._stats.grows:
            break
        ls.step(look=(keys * 3)[:NL])
    if backend == "linear":
        assert ls.port._stats.grows == 1
    ls.settle(400, lambda: ls.idle())
    ls.decisions()
    if backend == "linear":
        assert ls.slots() > slots0
        assert ls.port.state.nres_cap == ls.ref.state.nres_cap


@pytest.mark.parametrize("backend,fused", CASES)
def test_reclaim_started_between_polls_in_lock_step(backend, fused):
    """Deletes push the tombstones past ``tomb_load`` with the live load
    inside the band: the policy starts the reclaim rehash on the device
    at a step that is not a poll, so the port's host flag says steady for
    the steps up to the next poll.  Its step routes lookups, inserts and
    deletes by the device flag and runs the transition every step: the two
    engines stay in lock step through the reclaim epoch, with fresh
    inserts, deletes and lookups every step."""
    K = 8
    ls = Lockstep(backend, fused, poll_every=K, tomb_load=0.15)
    slots = ls.slots()
    nxt = 1
    while len(ls.oracle) < slots // 2:
        ls.step(look=ls.live_keys()[:NL], ins=range(nxt, nxt + NU))
        nxt += NU
    rng = np.random.default_rng(3)
    # five deletes a step: the step whose deletes cross the threshold must
    # not be a poll's, so a quiet step goes first where it would be
    need = int(slots * 0.15) + 1 - int(ls.be.count_tomb(ls.ref.state.old))
    if (ls.n + -(-need // 5)) % K == 0:
        ls.step(look=rng.choice(ls.live_keys(), NL))
    while not ls.fires_at:
        ls.step(look=rng.choice(ls.live_keys(), NL), dels=ls.live_keys()[:5])
    fire = ls.fires_at[0]
    assert fire % K, "the fire must fall between two polls"
    assert ls.port.rebuilding is False and bool(ls.port.state.rebuilding)
    epoch = int(ls.port.state.epoch)
    while int(ls.port.state.epoch) == epoch or ls.n % K:
        live = ls.live_keys()
        ls.step(look=rng.choice(live + [10**6 + ls.n], NL),
                ins=range(nxt, nxt + 4), dels=live[:3])
        nxt += 4
    grows, shrinks, fires = ls.decisions()
    assert grows == shrinks == 0 and fires >= 1
    found, vals = ls.port.lookup(np.asarray(ls.live_keys(), np.int32))
    assert bool(found.all())
    assert vals.tolist() == [ls.oracle[k] for k in ls.live_keys()]
