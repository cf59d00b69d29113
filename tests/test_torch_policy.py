"""Port vs reference: the elastic policy (``core/policy.py``), step for step.

Both packages start from one table and one policy (converted through
``repro_torch.convert``) and take the same operations; after every
``policy_step`` the policy's device state (``armed``, ``want_grow``,
``want_shrink``, ``target_capacity``, ``fires``) and the table's
``lookups``, ``expensive``, ``rebuilding`` and ``epoch`` are equal, and so
are the two states' key -> value maps.  The single-table cases of the
reference's ``tests/test_policy.py`` run on all four backends, the port's
``fused`` off and on (a fused port state beside the reference path whose
placement it follows: the fused one on linear, chain and cuckoo, the plain
one on twochoice); the placement-headroom case on the two bounded-placement
backends, its unbounded counterpart on the other two.  The host helpers
(``watermarks``, ``resolve_slots``, ``adapt_nres_cap``,
``RouteCapController``) are held to the reference's on the same inputs.
Tolerance 0.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import backend as jbe  # noqa: E402
from repro.core import dhash as jdhash  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.core import hashing as thashing  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402

BACKENDS = ("linear", "twochoice", "cuckoo", "chain")
AXIS = [(b, f) for b in BACKENDS for f in (False, True)]
# the reference path whose placement a fused port state follows
REF_FUSED = {"linear": True, "twochoice": False, "cuckoo": True,
             "chain": True}
POLICY_STATE = ("armed", "want_grow", "want_shrink", "target_capacity",
                "fires")
TABLE_SCALARS = ("lookups", "expensive", "rebuilding", "epoch")


def jax_policy_tree(p) -> dict:
    """Flatten a reference ``ElasticPolicy`` to ``convert``'s layout."""
    return {f: (np.asarray(getattr(p, f)) if f in POLICY_STATE
                else getattr(p, f))
            for f in p.__dataclass_fields__}


_JSTEP = {a: jax.jit(partial(jpol.policy_step, allow_autostart=a))
          for a in (False, True)}
_JREBUILD = jax.jit(lambda d: jdhash.finish_same_shape(jdhash.rebuild_step(d)))
_JINSERT = jax.jit(jdhash.insert)
_JDELETE = jax.jit(jdhash.delete)
_JLOOKUP = jax.jit(jdhash.lookup_counted, static_argnames=("probe_hi",))
W = 64              # the width of every insert and delete batch (masked)


class Twin:
    """One table and one policy in each package, driven together."""

    def __init__(self, backend: str, fused: bool, *, capacity: int = 64,
                 chunk: int = 32, seed: int = 0, **pol):
        self.j = jdhash.make(backend, capacity=capacity, chunk=chunk,
                             seed=seed, fused=fused and REF_FUSED[backend])
        self.t = convert.state_from_numpy(
            {**jax_state_tree(self.j), "fused": fused}, device="cpu")
        self.jp = jpol.make(**pol)
        self.tp = convert.policy_from_numpy(jax_policy_tree(self.jp),
                                            device="cpu")
        self.jbe, self.tbe = jbe.get(backend), tbe.get(backend)
        self.slots = int(self.jbe.capacity_of(self.j.old))
        assert self.slots == self.tbe.capacity_of(self.t.old)
        self.steps = 0

    def live(self) -> int:
        n = int(self.jbe.count_live(self.j.old))
        assert n == int(self.tbe.count_live(self.t.old))
        return n

    def _batches(self, keys):
        """``keys`` in masked batches of one width (one compile of each
        reference op)."""
        k = np.asarray(keys, np.int32).reshape(-1)
        for i in range(0, max(k.size, 1), W):
            b = np.zeros(W, np.int32)
            m = np.zeros(W, bool)
            n = min(W, k.size - i)
            b[:n], m[:n] = k[i:i + n], True
            yield b, m, n

    def insert(self, keys) -> np.ndarray:
        oks = []
        for k, m, n in self._batches(keys):
            self.j, ok_j = _JINSERT(self.j, jnp.asarray(k), jnp.asarray(k),
                                    jnp.asarray(m))
            kt, mt = torch.as_tensor(k), torch.as_tensor(m)
            self.t, ok_t = tdhash.insert(self.t, kt, kt, mt)
            assert np.array_equal(np.asarray(ok_j), ok_t.numpy())
            oks.append(ok_t.numpy()[:n])
        return np.concatenate(oks)

    def delete(self, keys) -> np.ndarray:
        oks = []
        for k, m, n in self._batches(keys):
            self.j, ok_j = _JDELETE(self.j, jnp.asarray(k), jnp.asarray(m))
            self.t, ok_t = tdhash.delete(self.t, torch.as_tensor(k),
                                         torch.as_tensor(m))
            assert np.array_equal(np.asarray(ok_j), ok_t.numpy())
            oks.append(ok_t.numpy()[:n])
        return np.concatenate(oks)

    def lookup_counted(self, keys, probe_hi: int):
        k = np.asarray(keys, np.int32)
        self.j, (f_j, v_j) = _JLOOKUP(self.j, jnp.asarray(k),
                                      probe_hi=probe_hi)
        f_t, v_t = tdhash.lookup_counted_(self.t, torch.as_tensor(k),
                                          probe_hi=probe_hi)
        assert np.array_equal(np.asarray(f_j), f_t.numpy())
        f = f_t.numpy()
        assert np.array_equal(np.asarray(v_j)[f], v_t.numpy()[f])
        self.check("lookup_counted")
        return f, v_t.numpy()

    def fill_to(self, n: int, start: int = 1) -> list:
        """Sequential keys until the old table holds ``n`` live entries (a
        refused key is not retried: the next batch takes fresh ones)."""
        held, nxt = [], start
        for _ in range(50):
            need = n - self.live()
            if need == 0:
                break
            ks = np.arange(nxt, nxt + need, dtype=np.int32)
            nxt += need
            held += ks[self.insert(ks)].tolist()
        assert self.live() == n, f"could not reach {n} live entries"
        return held

    def policy_step(self, allow_autostart: bool = True):
        self.jp, self.j = _JSTEP[allow_autostart](self.jp, self.j)
        tpol.policy_step(self.tp, self.t, allow_autostart=allow_autostart)
        self.steps += 1
        self.check(f"policy step {self.steps}")

    def rebuild_step(self):
        self.j = _JREBUILD(self.j)
        go = tdhash.rebuild_step_(self.t, swap=True)
        tdhash.finish_same_shape_(self.t, go=go)

    def complete_rebuild(self, max_steps: int = 400):
        for _ in range(max_steps):
            if not bool(self.j.rebuilding):
                assert not bool(self.t.rebuilding)
                return
            self.rebuild_step()
            self.check("rebuild")
        raise AssertionError("same-shape rebuild did not finish")

    def check(self, where: str):
        p, r = convert.policy_to_numpy(self.tp), jax_policy_tree(self.jp)
        for f in POLICY_STATE:
            assert p[f] == r[f], (where, f, p[f], r[f])
        for f in TABLE_SCALARS:
            a, b = getattr(self.t, f).item(), np.asarray(getattr(self.j, f))
            assert a == b.item(), (where, f, a, b)
        assert _content(convert.state_to_numpy(self.t)) == \
            _content(jax_state_tree(self.j)), where

    def field(self, name: str):
        """A policy field, equal in both packages (checked)."""
        a = getattr(self.tp, name).item()
        assert a == np.asarray(getattr(self.jp, name)).item()
        return a


# ---------------------------------------------------------------------------
# the trigger set (the reference's tests/test_policy.py, single tables)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fused", AXIS)
def test_no_flap_at_watermark_boundary(backend, fused):
    """live == high: never fires; high + 1: fires once, the latch holds
    while the load holds, and re-arms (without firing) below
    high / headroom."""
    tw = Twin(backend, fused, in_place=True, tomb_load=1.0)
    high, low = tpol.watermarks(tw.tp, tw.slots)
    assert (high, low) == jpol.watermarks(tw.jp, tw.slots)
    assert 0 < low < high < tw.slots
    keys = tw.fill_to(high)
    for _ in range(5):
        tw.policy_step()
    assert tw.field("fires") == 0 and tw.field("armed")
    keys += tw.fill_to(high + 1, start=1_000_000)
    tw.policy_step()
    assert tw.field("fires") == 1 and bool(tw.t.rebuilding)
    tw.complete_rebuild()
    for _ in range(10):
        tw.policy_step()
    assert tw.field("fires") == 1 and not tw.field("armed")
    rearm_at = int(high / tw.tp.expand_headroom)
    assert tw.delete(keys[:len(keys) - rearm_at]).all()
    assert tw.live() == rearm_at
    tw.policy_step()
    assert tw.field("armed") and tw.field("fires") == 1


@pytest.mark.parametrize("backend,fused", AXIS)
def test_latch_holds_across_epoch_under_sustained_load(backend, fused):
    """policy_step interleaved with the rehash: the transient low count of
    the draining old table must not re-arm the latch."""
    tw = Twin(backend, fused, in_place=True, tomb_load=1.0)
    high, _ = tpol.watermarks(tw.tp, tw.slots)
    tw.fill_to(high + 1)
    for _ in range(120):
        tw.rebuild_step()
        tw.policy_step()
    assert int(tw.t.epoch) == 1 and tw.field("fires") == 1
    assert not tw.field("armed")


@pytest.mark.parametrize("backend,fused", AXIS)
def test_tombstone_pressure_fires_reclaim_inside_band(backend, fused):
    """Resize mode: tombstones past ``tomb_load`` with the live load inside
    the band fire a same-shape reclaim, once; the rehash scrubs them."""
    tw = Twin(backend, fused, capacity=128, chunk=64, seed=1)
    keys = tw.fill_to(int(0.6 * tw.slots))
    assert tw.delete(keys[:len(keys) * 2 // 3]).all()
    tw.policy_step()
    assert tw.field("fires") == 1 and bool(tw.t.rebuilding)
    assert not tw.field("want_grow") and not tw.field("want_shrink")
    tw.complete_rebuild()
    assert int(tw.tbe.count_tomb(tw.t.old)) == 0
    for _ in range(5):
        tw.policy_step()
    assert tw.field("fires") == 1


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("backend", ("twochoice", "cuckoo"))
def test_in_place_rehash_deferred_past_placement_headroom(backend, fused):
    """A bounded-placement table above ``place_headroom`` holds the
    same-shape rehash (still publishing the grow plan) until the load
    drains below it; the epoch then completes with an empty hazard
    buffer."""
    tw = Twin(backend, fused, capacity=600, chunk=128, seed=2,
              grow_load=0.3, in_place=True, tomb_load=1.0)
    assert tw.tbe.bounded_placement
    headroom = int(tw.slots * tw.tp.place_headroom)
    high, _ = tpol.watermarks(tw.tp, tw.slots)
    target = headroom + 30
    keys = tw.fill_to(target)
    for _ in range(5):
        tw.policy_step()
    assert tw.field("fires") == 0 and not bool(tw.t.rebuilding)
    assert tw.field("want_grow")
    safe = high + 33
    assert tw.delete(keys[:target - safe]).all()
    tw.policy_step()
    assert tw.field("fires") == 1 and bool(tw.t.rebuilding)
    tw.complete_rebuild()
    assert int(tw.t.epoch) == 1 and not bool(tw.t.hazard_live.any())


@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("backend", ("linear", "chain"))
def test_unbounded_backend_unaffected_by_placement_guard(backend, fused):
    tw = Twin(backend, fused, grow_load=0.5, in_place=True, tomb_load=1.0)
    assert not tw.tbe.bounded_placement
    tw.fill_to(int(tw.slots * tw.tp.place_headroom) + 5)
    tw.policy_step()
    assert tw.field("fires") == 1 and bool(tw.t.rebuilding)
    tw.complete_rebuild()
    assert not bool(tw.t.hazard_live.any())


def _colliding_keys(t, want: int) -> np.ndarray:
    """``want`` keys that share one bucket (row a on a two-row table) of
    the port table ``t``."""
    hfn = t.hfn_a if hasattr(t, "hfn_a") else t.hfn
    n = t.nbuckets if hasattr(t, "nbuckets") else t.capacity
    cand = np.arange(1, 20_001, dtype=np.int32)
    h = thashing.bucket_of(hfn, torch.as_tensor(cand), n).numpy()
    vals, counts = np.unique(h, return_counts=True)
    assert counts.max() >= want
    return cand[h == vals[np.argmax(counts)]][:want]


@pytest.mark.parametrize("backend,fused", AXIS)
def test_expensive_lookups_against_the_reference(backend, fused):
    """The probe-length telemetry and its trigger: keys crowded into one
    bucket, looked up through ``lookup_counted`` (the port's in-place,
    device-decided form), then one evaluation in resize mode and one in
    place.  On linear (the reference's case) the trigger fires below the
    watermark."""
    for in_place in (False, True):
        tw = Twin(backend, fused, capacity=256, chunk=64, seed=3,
                  min_lookups=32, in_place=in_place)
        keys = _colliding_keys(tw.t.old, 12)
        # one key a call: the port's fused cuckoo insert linearises a
        # contended batch its own way (its placement would differ)
        for k in keys:
            assert tw.insert([k]).all()
        high, _ = tpol.watermarks(tw.tp, tw.slots)
        assert tw.live() == 12 < high
        tw.lookup_counted(np.tile(keys, 3), tw.tp.probe_hi)
        assert int(tw.t.lookups) == 36
        tw.policy_step()
        if backend == "linear":
            assert int(tw.field("fires")) == in_place
            if in_place:
                assert int(tw.t.lookups) == 0 and bool(tw.t.rebuilding)
            else:
                assert tw.field("want_grow") and not tw.field("want_shrink")


@pytest.mark.parametrize("backend,fused", AXIS)
def test_counted_lookup_mid_rebuild_answers_and_does_not_sample(backend,
                                                                 fused):
    """The device-decided counted lookup during a rebuild epoch: the
    ordered check's answers, no sample (the reference's other branch)."""
    tw = Twin(backend, fused, capacity=128, chunk=32, seed=5,
              in_place=True, tomb_load=1.0)
    high, _ = tpol.watermarks(tw.tp, tw.slots)
    keys = tw.fill_to(high + 1)
    tw.policy_step()
    assert bool(tw.t.rebuilding)
    for _ in range(3):
        tw.rebuild_step()
        f, v = tw.lookup_counted(keys, tw.tp.probe_hi)
        assert f.all() and np.array_equal(v, np.asarray(keys))
    assert int(tw.t.lookups) == 0


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_target_lands_inside_band(backend):
    be_j, be_t = jbe.get(backend), tbe.get(backend)
    pj, pt = jpol.make(), tpol.make(device="cpu")
    for live in (64, 100, 200, 500, 1000, 5000, 20000):
        target = int(np.clip(int(np.ceil(live * pt.expand_headroom)),
                             pt.min_capacity, pt.max_capacity))
        slots = tpol.resolve_slots(be_t, target)
        assert slots == jpol.resolve_slots(be_j, target)
        high, low = tpol.watermarks(pt, slots)
        assert (high, low) == jpol.watermarks(pj, slots)
        assert low < live < high, (backend, live, slots, low, high)


def test_adapt_nres_cap_equals_the_reference():
    pj, pt = jpol.make(), tpol.make(device="cpu")
    for old, new, base in ((1024, 1024, 16), (1024, 4096, 16),
                           (1024, 32 * 1024, 16), (1000, 32 * 1024, 16),
                           (64, 1 << 20, 16), (4096, 512, 16), (7, 100, 4)):
        got = tpol.adapt_nres_cap(pt, old, new, base=base)
        assert got == jpol.adapt_nres_cap(pj, old, new, base=base)
    assert tpol.adapt_nres_cap(pt, 1024, 32 * 1024, base=16) == 33
    assert tpol.adapt_nres_cap(pt, 64, 1 << 20, base=16) == pt.nres_cap_max


def _spill_drops_for(cap_factor, q, s, slack, owner_counts):
    cap = tpol.route_cap(cap_factor, q, s)
    slab = tpol.route_spill_cap(q, cap, slack)
    spill = sum(max(c - cap, 0) for c in owner_counts)
    return spill, max(spill - slab, 0)


def _controllers(**kw):
    return jpol.RouteCapController(**kw), tpol.RouteCapController(**kw)


def _same(cj, ct):
    for f in ("cap_factor", "occ", "grows", "shrinks", "flaps"):
        assert getattr(cj, f) == getattr(ct, f), f
    assert cj.in_band() == ct.in_band()


def test_route_cap_controller_burst_converges_like_the_reference():
    s, q, slack = 8, 1024, 0.5
    cj, ct = _controllers(n_shards=s, q_ref=q, cap_factor=2.0,
                          spill_slack=slack)
    counts = [900, 24, 20, 20, 20, 20, 10, 10]
    spill = drop = 0
    for _ in range(40):
        dsp, ddr = _spill_drops_for(ct.cap_factor, q, s, slack, counts)
        spill, drop = spill + dsp, drop + ddr
        assert cj.update(spill, drop) == ct.update(spill, drop)
        _same(cj, ct)
    assert ct.in_band() and ct.flaps == 0 and ct.grows >= 1
    grown = ct.cap_factor
    for _ in range(60):
        assert cj.update(spill, drop) == ct.update(spill, drop)
        _same(cj, ct)
    assert ct.cap_factor < grown and ct.flaps == 0 and ct.shrinks >= 1


def test_route_cap_controller_drops_grow_immediately_like_the_reference():
    cj, ct = _controllers(n_shards=8, q_ref=64, cap_factor=2.0,
                          spill_slack=0.25, cooldown=10)
    seq = [(10, 0), (20, 4)] + [(20 + 10 * i, 4 + i) for i in range(1, 21)]
    for n, (spill, drops) in enumerate(seq):
        assert cj.update(spill, drops) == ct.update(spill, drops)
        _same(cj, ct)
        if n == 1:
            assert ct.cap_factor == 3.0 and ct.grows == 1
    assert ct.cap_factor == ct.cap_max == 8.0


def test_route_cap_controller_ladder_is_clamped_like_the_reference():
    cj, ct = _controllers(n_shards=4, q_ref=64, cap_factor=1.0,
                          cap_min=1.0, cooldown=0)
    for _ in range(30):
        assert cj.update(0, 0) == ct.update(0, 0)
        _same(cj, ct)
    assert ct.cap_factor == 1.0 and ct.shrinks == 0
    for bad in (dict(occ_hi=0.5, occ_lo=0.4), dict(step=0.9)):
        for mod in (jpol, tpol):
            with pytest.raises(ValueError):
                mod.RouteCapController(n_shards=4, q_ref=64, **bad)


def test_rehash_wanted_equals_the_reference():
    rng = np.random.default_rng(0)
    live, tomb = rng.random(64), rng.random(64) * 0.5
    armed, rb = rng.random(64) < 0.5, rng.random(64) < 0.2
    for a, b in zip(jpol.rehash_wanted(live, tomb, armed, rb, grow_load=0.7),
                    tpol.rehash_wanted(live, tomb, armed, rb, grow_load=0.7)):
        assert np.array_equal(a, b)


def test_make_checks_and_policy_round_trip():
    for bad in (dict(grow_load=0.0), dict(expand_headroom=1.0),
                dict(place_headroom=1.5)):
        with pytest.raises(ValueError):
            tpol.make(device="cpu", **bad)
    pj = jpol.make(tomb_load=0.1, in_place=True)
    tree = jax_policy_tree(pj)
    pt = convert.policy_from_numpy(tree, device="cpu")
    assert pt.device == torch.device("cpu") and pt.fires.dtype == torch.int32
    back = convert.policy_to_numpy(pt)
    assert back.keys() == tree.keys()
    for k in tree:
        assert np.array_equal(back[k], tree[k]), k
    assert convert.policy_to_numpy(tpol.make(tomb_load=0.1, in_place=True,
                                             device="cpu")).keys() == \
        tree.keys()
    # a stacked policy: one latch and plan a table, as the reference's
    ps, js = tpol.stack(pt, 4), jpol.stack(pj, 4)
    for f in POLICY_STATE:
        assert getattr(ps, f).shape == (4,), f
        assert np.array_equal(getattr(ps, f).numpy(),
                              np.asarray(getattr(js, f))), f
    ps.fires.add_(1)
    assert pt.fires.item() == 0
    back = convert.policy_from_numpy(convert.policy_to_numpy(ps),
                                     device="cpu")
    assert back.armed.shape == (4,) and back.fires.tolist() == [1] * 4


# ---------------------------------------------------------------------------
# table stacks: per-tenant policies (the reference's stack cases)
# ---------------------------------------------------------------------------

def test_stack_engine_latch_holds_across_epoch():
    """A tenant held past the watermark rebuilds exactly once over a long
    idle drive, through both packages' DHashStackEngine in lock step."""
    from repro.core.engine import DHashStackEngine as JStackEngine
    from repro_torch.core.engine import DHashStackEngine
    jstk = jdhash.make_stack(4, "linear", 64, chunk=32, fused=True)
    kw = dict(grow_load=0.5, in_place=True, tomb_load=1.0)
    ref = JStackEngine(jstk, policy=jpol.make(**kw))
    eng = DHashStackEngine(
        convert.state_from_numpy(jax_state_tree(jstk), device="cpu"),
        policy=tpol.make(device="cpu", **kw))
    T, Q = 4, 65   # linear cap 64 -> 128 slots, high = 64 at grow_load 0.5
    kq = np.zeros((T, Q), np.int32)
    nomask = np.zeros((T, Q), bool)
    ins = kq.copy()
    ins[2] = np.arange(1, Q + 1)
    im = nomask.copy()
    im[2] = True
    steps = [(kq, ins, ins * 2, kq, im)] + [(kq, kq, kq, kq, nomask)] * 60
    for lk, ik, iv, dk, m in steps:
        got = eng.step(lk, ik, iv, dk, ins_mask=m, del_mask=nomask)
        want = ref.step(lk, ik, iv, dk, ins_mask=m, del_mask=nomask)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(eng.state.epoch.numpy(),
                              np.asarray(ref.state.epoch))
        assert np.array_equal(eng.policy.fires.numpy(),
                              np.asarray(ref.policy.fires))
    assert eng.state.epoch.tolist() == [0, 0, 1, 0]
    found, vals = eng.lookup(ins)
    assert found[2].all() and not found[[0, 1, 3]].any()
    assert (vals[2].numpy() == np.arange(1, Q + 1) * 2).all()


@pytest.mark.parametrize("backend,fused", AXIS)
def test_stack_tenants_fire_independently(backend, fused):
    """8 tenants, two loaded past the watermark: exactly those fire on the
    device, each under its own latch, and every tenant's keys survive its
    rehash — the port's ``stack_policy_step`` against the reference's."""
    T, cap = 8, 64
    jd = jdhash.make_stack(T, backend, capacity=cap, chunk=32, seed=0,
                           fused=fused and REF_FUSED[backend])
    td = convert.state_from_numpy({**jax_state_tree(jd), "fused": fused},
                                  device="cpu")
    slots = int(tbe.get(backend).capacity_of(td.old))
    cfg = dict(grow_load=0.5, in_place=True, tomb_load=1.0)
    jp = jpol.stack(jpol.make(**cfg), T)
    tp = tpol.stack(tpol.make(device="cpu", **cfg), T)
    high, low = tpol.watermarks(tp, slots)
    hot = np.array([False, True, False, False, False, True, False, False])
    target = np.where(hot, high + 1, max(low + 2, 8))
    held: list[list[int]] = [[] for _ in range(T)]
    nxt = 1
    _jins = jax.jit(jdhash.stack_insert)
    for _ in range(12):
        live = tbe.get(backend).count_live(td.old).numpy()
        assert np.array_equal(live, np.asarray(
            jax.vmap(jbe.get(backend).count_live)(jd.old)))
        need = target - live
        if (need <= 0).all():
            break
        q = int(need.max())
        keys = np.zeros((T, q), np.int32)
        mask = np.zeros((T, q), bool)
        for t in range(T):
            if need[t] > 0:
                keys[t, :need[t]] = np.arange(nxt, nxt + need[t]) + 100_000 * t
                mask[t, :need[t]] = True
        nxt += q
        jd, ok_j = _jins(jd, jnp.asarray(keys), jnp.asarray(keys),
                         jnp.asarray(mask))
        _, ok = tdhash.stack_insert(td, torch.as_tensor(keys),
                                    torch.as_tensor(keys),
                                    torch.as_tensor(mask))
        assert np.array_equal(ok.numpy(), np.asarray(ok_j))
        okn = ok.numpy() & mask
        for t in range(T):
            held[t].extend(keys[t][okn[t]].tolist())
    assert (tbe.get(backend).count_live(td.old).numpy() == target).all()

    jp, jd = jax.jit(jpol.stack_policy_step)(jp, jd)
    tpol.stack_policy_step(tp, td)
    for f in POLICY_STATE:
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    assert tp.fires.tolist() == hot.astype(int).tolist()
    assert td.rebuilding.numpy().tolist() == hot.tolist()
    assert np.array_equal(td.rebuilding.numpy(), np.asarray(jd.rebuilding))
    for side in ("old", "new"):     # the fired tables' standby, reseeded
        for h in tbe.get(backend).hash_fns(getattr(td, side)):
            assert len({tuple(r) for r in h.seeds.tolist()}) == T

    _jstep = jax.jit(lambda d: jdhash.stack_finish_same_shape(
        jdhash.stack_rebuild_step(d)))
    for _ in range(50):
        if not bool(td.rebuilding.any()) and not bool(jd.rebuilding.any()):
            break
        tdhash.stack_finish_same_shape(tdhash.stack_rebuild_step(td))
        jd = _jstep(jd)
    assert not bool(td.rebuilding.any())
    assert td.epoch.tolist() == hot.astype(int).tolist()
    assert np.array_equal(td.epoch.numpy(), np.asarray(jd.epoch))
    width = max(len(h) for h in held)
    keys = np.zeros((T, width), np.int32)
    for t in range(T):
        keys[t, :len(held[t])] = held[t]
    found, vals = tdhash.stack_lookup(td, torch.as_tensor(keys))
    for t in range(T):
        n = len(held[t])
        assert found[t, :n].all(), t
        assert (vals[t, :n].numpy() == keys[t, :n]).all(), t
    p, r = convert.state_to_numpy(td), jax_state_tree(jd)
    for t in range(T):
        row = {k: (v[t] if isinstance(v, np.ndarray) and v.ndim else v)
               for k, v in p.items() if k not in ("old", "new")}
        rrow = {k: (v[t] if isinstance(v, np.ndarray) and v.ndim else v)
                for k, v in r.items() if k not in ("old", "new")}
        for side in ("old", "new"):
            row[side] = {k: (v[t] if isinstance(v, np.ndarray) else v)
                         for k, v in p[side].items() if not k.startswith("h")}
            rrow[side] = {k: (v[t] if isinstance(v, np.ndarray) else v)
                          for k, v in r[side].items()
                          if not k.startswith("h")}
        assert _content(row) == _content(rrow), t
