"""Port vs reference: the DHash protocol, op for op.

The pinned regression corpus of ``test_differential.py`` is replayed through
``repro.core.dhash`` (fused off — the oracle's linearisation — and fused on)
and through ``repro_torch.core.dhash`` on the CPU, on the linear, twochoice,
cuckoo and chain backends, the port's ``fused`` on and off, rebuild targets
of 1x and 4x the base capacity.

After EVERY op: the op's results are equal across all three (a lookup's
value exactly against both reference paths on linear; on a two-row backend
exactly against the reference path of the same ``fused`` setting, and where
found against the other: the plain two-row lookup's value of a miss is
unspecified); hash seeds, cursor, epoch and flags are equal.  Where the
port's insert is the reference plain path's linearisation (every backend but
the port's fused cuckoo and fused chain), the two tables are equal slot for
slot to the reference's plain ones and the hazard buffer is equal as a set
of live (key, value) pairs (the fused extract compacts, the plain one is
position-aligned).  The port's fused chain (its arena compacted at a
rebuild's start and past the dirty window) is held so to the reference's
fused chain instead, every arena array slot for slot.  Against every other path — the reference's fused one,
whose placement may differ under contention, and for the port's fused cuckoo
(claim kernel, then kick-out) the plain one too — the live key -> value map
is equal: per table on linear, of the whole state (old > hazard > new)
otherwise, and of each table at quiescence.  ``count_items`` is compared
only at quiescence.  Tolerance 0.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from test_differential import (CAPACITY, CHUNK, CORPUS, KEYS,  # noqa: E402
                               OP_DELETE, OP_INSERT, OP_LOOKUP, OP_START,
                               OP_STEP, Q, _FNS)
from test_torch_convert import jax_state_tree  # noqa: E402

LIVE = 1


def _pad(keys):
    ks = np.zeros(Q, np.int32)
    mask = np.zeros(Q, bool)
    ks[: len(keys)] = keys[:Q]
    mask[: len(keys)] = True
    return ks, mask


def _slots(t: dict):
    """(key, val, state) of a table tree: a slot table's, a chain arena's."""
    if "astate" in t:
        return t["akey"], t["aval"], t["astate"]
    return t["key"], t["val"], t["state"]


def _live_map(t: dict) -> dict:
    k, v, st = _slots(t)
    s = st == LIVE
    return dict(zip(k[s].tolist(), v[s].tolist()))


def _hazard_set(tree: dict) -> set:
    hl = tree["hazard_live"]
    return set(zip(tree["hazard_key"][hl].tolist(),
                   tree["hazard_val"][hl].tolist()))


def _content(tree: dict) -> dict:
    """The state's key -> value map as a lookup sees it: old > hazard >
    new."""
    hl = tree["hazard_live"]
    out = _live_map(tree["new"])
    out.update(zip(tree["hazard_key"][hl].tolist(),
                   tree["hazard_val"][hl].tolist()))
    out.update(_live_map(tree["old"]))
    return out


def compare_states(port, ref_exact, ref_other, where, exact=True,
                   in_step=True):
    """``ref_exact`` is the reference path whose linearisation the port
    follows (the plain one, the fused one for a fused chain), ``ref_other``
    the other.  ``exact``: the port follows ``ref_exact``'s placement (and
    so its rebuild timing); ``in_step``: all three are also in step with
    ``ref_other`` (linear, where its placement agrees)."""
    p = convert.state_to_numpy(port)
    a, b = jax_state_tree(ref_exact), jax_state_tree(ref_other)
    for f in ("cursor", "rebuilding", "epoch"):
        if exact:
            assert p[f] == a[f], (where, f, p[f], a[f])
        if in_step:
            assert p[f] == b[f], (where, f, p[f], b[f])
    quiescent = not (bool(p["rebuilding"]) or bool(a["rebuilding"])
                     or bool(b["rebuilding"]))
    for side in ("old", "new"):
        if exact:
            for k in p[side]:
                if k.startswith("hfn"):
                    assert np.array_equal(p[side][k]["seeds"],
                                          a[side][k]["seeds"]), \
                        (where, side, k)
                else:
                    assert np.array_equal(p[side][k], a[side][k]), \
                        (where, side, k)
        if in_step or quiescent:
            assert _live_map(p[side]) == _live_map(b[side]), (where, side)
            assert _live_map(p[side]) == _live_map(a[side]), (where, side)
    if exact:
        assert _hazard_set(p) == _hazard_set(a), where
    if in_step:
        assert _hazard_set(p) == _hazard_set(b), where
    assert _content(p) == _content(a) == _content(b), where


class Trio:
    """The port and both reference paths driven by one script."""

    def __init__(self, backend: str, port_fused: bool, seed: int):
        kw = dict(capacity=CAPACITY, chunk=CHUNK, seed=seed % 7)
        self.backend, self.port_fused = backend, port_fused
        self.port = tdhash.make(backend, fused=port_fused, device="cpu", **kw)
        self.plain = jdhash.make(backend, fused=False, **kw)
        self.fused = jdhash.make(backend, fused=True, **kw)
        # the port's fused cuckoo insert (claim kernel, then kick-out) is a
        # linearisation of its own; the port's fused chain is the reference
        # fused chain's (both compact the arena); every other port path is
        # the reference plain path's.  Only on linear does the other
        # reference path place (and so rebuild) in step at these loads.
        self.exact = not (backend == "cuckoo" and port_fused)
        self.exact_ref = "fused" if backend == "chain" and port_fused \
            else "plain"
        self.in_step = backend == "linear"
        self.rebuilding = dict.fromkeys(("port", "plain", "fused"), False)

    def insert(self, ks, vals, mask):
        self.port, ok = tdhash.insert(self.port, torch.as_tensor(ks),
                                      torch.as_tensor(vals),
                                      torch.as_tensor(mask))
        outs = []
        for name in ("plain", "fused"):
            d, o = _FNS["insert"](getattr(self, name), jnp.asarray(ks),
                                  jnp.asarray(vals), jnp.asarray(mask))
            setattr(self, name, d)
            outs.append(np.asarray(o))
        return ok.numpy(), outs

    def delete(self, ks, mask):
        self.port, ok = tdhash.delete(self.port, torch.as_tensor(ks),
                                      torch.as_tensor(mask))
        outs = []
        for name in ("plain", "fused"):
            d, o = _FNS["delete"](getattr(self, name), jnp.asarray(ks),
                                  jnp.asarray(mask))
            setattr(self, name, d)
            outs.append(np.asarray(o))
        return ok.numpy(), outs

    def lookup(self, ks):
        """The port's (found, vals) and each reference's.  On a two-row
        backend a reference path of the other ``fused`` setting has its
        values shown only where found (the plain two-row lookup's value of a
        miss is unspecified); linear's are compared whole on both paths."""
        f, v = tdhash.lookup(self.port, torch.as_tensor(ks))
        f, v = f.numpy(), v.numpy()
        outs = []
        for n in ("plain", "fused"):
            rf, rv = (np.asarray(x) for x in
                      _FNS["lookup"](getattr(self, n), jnp.asarray(ks)))
            if self.backend in ("twochoice", "cuckoo") and \
                    (n == "fused") != self.port_fused:
                rv = np.where(rf, rv, v)
            outs.append((rf, rv))
        return (f, v), outs

    def start(self, growth: int, rb_seed: int):
        """Begin a rebuild on each path that has none in flight (a second
        start is the paper's trylock -EBUSY, a no-op)."""
        cap = CAPACITY * growth
        if not self.rebuilding["port"]:
            self.port = tdhash.rebuild_start(
                self.port, new_table=tdhash._make_table(
                    self.backend, cap, rb_seed, device="cpu"), seed=rb_seed)
        for n in ("plain", "fused"):
            if not self.rebuilding[n]:
                setattr(self, n, jdhash.rebuild_start(
                    getattr(self, n),
                    new_table=jdhash._make_table(self.backend, cap, rb_seed),
                    seed=rb_seed))
        self.rebuilding = dict.fromkeys(self.rebuilding, True)

    def step(self):
        """One rebuild transition everywhere; finish where done."""
        self.port = tdhash.rebuild_step(self.port)
        done = {"port": bool(tdhash.rebuild_done(self.port))}
        if done["port"]:
            self.port = tdhash.rebuild_finish(self.port)
        for n in ("plain", "fused"):
            d = _FNS["step"](getattr(self, n))
            done[n] = bool(_FNS["done"](d))
            if done[n]:
                d = jdhash.rebuild_finish(d)
            setattr(self, n, d)
        if self.exact:
            assert done["port"] == done[self.exact_ref], done
        if self.in_step:
            assert done["port"] == done["fused"], done
        for n, fin in done.items():
            self.rebuilding[n] &= not fin

    def check(self, where):
        refs = (self.plain, self.fused)
        if self.exact_ref == "fused":
            refs = refs[::-1]
        compare_states(self.port, *refs, where, self.exact, self.in_step)


def replay(script, backend: str, port_fused: bool, growth: int, seed: int):
    t = Trio(backend, port_fused, seed)
    oracle: dict[int, int] = {}
    rb_seed = seed
    for step_no, (opcode, payload) in enumerate(script):
        where = (backend, port_fused, growth, step_no, opcode)
        if opcode == OP_INSERT:
            ks, mask = _pad(payload)
            mask = mask & np.array([k not in oracle for k in ks.tolist()])
            vals = (ks * 1000 + step_no).astype(np.int32)
            ok, refs = t.insert(ks, vals, mask)
            for r in refs:
                assert np.array_equal(ok, r), where
            for i in np.flatnonzero(ok):
                oracle[int(ks[i])] = int(vals[i])
        elif opcode == OP_DELETE:
            ks, mask = _pad(payload)
            ok, refs = t.delete(ks, mask)
            for r in refs:
                assert np.array_equal(ok, r), where
            for i in np.flatnonzero(ok):
                del oracle[int(ks[i])]
        elif opcode == OP_LOOKUP:
            ks, mask = _pad(payload)
            (f, v), refs = t.lookup(ks)
            for rf, rv in refs:
                assert np.array_equal(f, rf) and np.array_equal(v, rv), where
            for i in np.flatnonzero(mask):
                assert f[i] == (int(ks[i]) in oracle), where
                if f[i]:
                    assert v[i] == oracle[int(ks[i])], where
        elif opcode == OP_START:
            if not all(t.rebuilding.values()):
                rb_seed += 1
                t.start(growth, rb_seed)
        elif opcode == OP_STEP:
            t.step()
        t.check(where)

    be = tdhash._be(t.port)
    slots = max(be.capacity_of(t.port.old), be.capacity_of(t.port.new))
    for _ in range(2 * (slots // CHUNK) + 6):
        if not any(t.rebuilding.values()):
            break
        t.step()
        t.check((backend, port_fused, growth, "drain"))
    assert not any(t.rebuilding.values()), "rebuild never drained"

    ks = np.asarray(KEYS, np.int32)
    (f, v), refs = t.lookup(ks)
    for rf, rv in refs:
        assert np.array_equal(f, rf) and np.array_equal(v, rv)
    for i, k in enumerate(KEYS):
        assert f[i] == (k in oracle)
        if k in oracle:
            assert v[i] == oracle[k]
    n = int(tdhash.count_items(t.port))
    assert n == len(oracle) == int(jdhash.count_items(t.plain)) \
        == int(jdhash.count_items(t.fused))


def _replay_cases():
    """(backend, port_fused, growth, script_no); a linear case keeps the id
    it had before the other backends were ported."""
    for backend in ("linear", "twochoice", "cuckoo", "chain"):
        for port_fused in (False, True):
            for growth in (1, 4):
                for script_no in range(len(CORPUS)):
                    cid = f"{port_fused}-{growth}-{script_no}"
                    yield pytest.param(
                        backend, port_fused, growth, script_no,
                        id=cid if backend == "linear" else f"{backend}-{cid}")


@pytest.mark.parametrize("backend,port_fused,growth,script_no",
                         _replay_cases())
def test_corpus_replayed_through_both_packages(backend, port_fused, growth,
                                               script_no):
    replay(CORPUS[script_no], backend, port_fused, growth,
           seed=1000 + script_no)


def test_make_fused_default_follows_env(monkeypatch):
    monkeypatch.setenv("DHASH_FUSED", "on")
    assert tdhash.make("linear", capacity=8, chunk=4, device="cpu").fused
    assert not tdhash.make("linear", capacity=8, chunk=4, device="cpu",
                           fwd_hazard=True).fused
    monkeypatch.setenv("DHASH_FUSED", "off")
    assert not tdhash.make("linear", capacity=8, chunk=4, device="cpu").fused


def test_all_four_backends_registered_and_unknown_names_raise():
    from repro.core import backend as jbackend
    from repro_torch.core import backend
    assert set(backend.names()) == set(jbackend.names()) == {
        "linear", "twochoice", "cuckoo", "chain"}
    assert all(backend.get(n).fused for n in backend.names())
    for n in backend.names():
        assert backend.get(n).bounded_placement == \
            jbackend.get(n).bounded_placement
        assert backend.get(n).dirty_cap == jbackend.get(n).dirty_cap
    assert backend.get("chain").freeze_old is not None
    with pytest.raises(ValueError, match="unknown backend 'skiplist'"):
        backend.get("skiplist")
    with pytest.raises(ValueError):
        tdhash.make("skiplist", device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_rebuild_all_fwd_hazard_and_counted(fused):
    """rebuild_all, lookup_counted and the fwd_hazard lookup against the
    reference on one populated table."""
    keys = np.arange(-30, 30, dtype=np.int32)
    out = []
    for mod, mk, arr in ((jdhash, {}, jnp.asarray),
                         (tdhash, {"device": "cpu"}, torch.as_tensor)):
        d = mod.make("linear", capacity=96, chunk=32, seed=2, fused=fused,
                     fwd_hazard=not fused, **mk)
        d, _ = mod.insert(d, arr(keys), arr(keys * 3))
        d, (f0, v0) = mod.lookup_counted(d, arr(keys), probe_hi=1)
        d = mod.rebuild_start(d, seed=9)
        d = mod.rebuild_extract(d)
        f1, v1 = mod.lookup(d, arr(keys))        # hazard window open
        d = mod.rebuild_all(d)
        f2, v2 = mod.lookup(d, arr(keys))
        out.append([np.asarray(x) for x in (
            f0, v0, f1, v1, f2, v2, d.lookups, d.expensive, d.epoch,
            mod.count_items(d))])
    for a, b in zip(*out):
        assert np.array_equal(a, b)
    assert out[1][0].all() and out[1][2].all() and out[1][4].all()
