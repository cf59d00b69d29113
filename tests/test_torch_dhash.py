"""Port vs reference: the DHash protocol, op for op.

The pinned regression corpus of ``test_differential.py`` is replayed through
``repro.core.dhash`` (fused off — the oracle's linearisation — and fused on)
and through ``repro_torch.core.dhash`` on the CPU, on the linear backend, the
port's ``fused`` on and off, rebuild targets of 1x and 4x the base capacity.

After EVERY op: the op's results are equal across all three; against the
reference's plain path the two tables are equal slot for slot, hash seeds,
cursor, epoch and flags are equal, and the hazard buffer is equal as a set of
live (key, value) pairs (the fused extract compacts, the plain one is
position-aligned); against the reference's fused path the live key -> value
maps and the scalars are equal (its slot placement may differ).
``count_items`` is compared only at quiescence.  Tolerance 0.
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


def _live_map(t: dict) -> dict:
    s = t["state"] == LIVE
    return dict(zip(t["key"][s].tolist(), t["val"][s].tolist()))


def _hazard_set(tree: dict) -> set:
    hl = tree["hazard_live"]
    return set(zip(tree["hazard_key"][hl].tolist(),
                   tree["hazard_val"][hl].tolist()))


def compare_states(port, ref_plain, ref_fused, where):
    p = convert.state_to_numpy(port)
    a, b = jax_state_tree(ref_plain), jax_state_tree(ref_fused)
    for f in ("cursor", "rebuilding", "epoch"):
        assert p[f] == a[f] == b[f], (where, f, p[f], a[f], b[f])
    assert _hazard_set(p) == _hazard_set(a) == _hazard_set(b), where
    for side in ("old", "new"):
        assert p[side]["capacity"] == a[side]["capacity"], (where, side)
        assert np.array_equal(p[side]["hfn"]["seeds"],
                              a[side]["hfn"]["seeds"]), (where, side)
        for f in ("key", "val", "state"):
            assert np.array_equal(p[side][f], a[side][f]), (where, side, f)
        assert _live_map(p[side]) == _live_map(b[side]), (where, side)


class Trio:
    """The port and both reference paths driven by one script."""

    def __init__(self, port_fused: bool, seed: int):
        kw = dict(capacity=CAPACITY, chunk=CHUNK, seed=seed % 7)
        self.port = tdhash.make("linear", fused=port_fused, device="cpu", **kw)
        self.plain = jdhash.make("linear", fused=False, **kw)
        self.fused = jdhash.make("linear", fused=True, **kw)

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
        f, v = tdhash.lookup(self.port, torch.as_tensor(ks))
        outs = [tuple(np.asarray(x) for x in
                      _FNS["lookup"](getattr(self, n), jnp.asarray(ks)))
                for n in ("plain", "fused")]
        return (f.numpy(), v.numpy()), outs

    def start(self, growth: int, rb_seed: int):
        cap = CAPACITY * growth
        self.port = tdhash.rebuild_start(
            self.port, new_table=tdhash._make_table("linear", cap, rb_seed,
                                                    device="cpu"),
            seed=rb_seed)
        for n in ("plain", "fused"):
            setattr(self, n, jdhash.rebuild_start(
                getattr(self, n),
                new_table=jdhash._make_table("linear", cap, rb_seed),
                seed=rb_seed))

    def step(self) -> bool:
        """One rebuild transition everywhere; finish where done.  Returns
        whether the rebuild finished (the same in all three)."""
        self.port = tdhash.rebuild_step(self.port)
        done = [bool(tdhash.rebuild_done(self.port))]
        if done[0]:
            self.port = tdhash.rebuild_finish(self.port)
        for n in ("plain", "fused"):
            d = _FNS["step"](getattr(self, n))
            done.append(bool(_FNS["done"](d)))
            if done[-1]:
                d = jdhash.rebuild_finish(d)
            setattr(self, n, d)
        assert done[0] == done[1] == done[2], done
        return done[0]

    def check(self, where):
        compare_states(self.port, self.plain, self.fused, where)


def replay(script, port_fused: bool, growth: int, seed: int):
    t = Trio(port_fused, seed)
    oracle: dict[int, int] = {}
    rebuilding = False
    rb_seed = seed
    for step_no, (opcode, payload) in enumerate(script):
        where = (port_fused, growth, step_no, opcode)
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
            if not rebuilding:
                rb_seed += 1
                t.start(growth, rb_seed)
                rebuilding = True
        elif opcode == OP_STEP:
            if t.step():
                rebuilding = False
        t.check(where)

    slots = max(t.port.old.capacity, t.port.new.capacity)
    for _ in range(2 * (slots // CHUNK) + 6):
        if not rebuilding:
            break
        if t.step():
            rebuilding = False
        t.check((port_fused, growth, "drain"))
    assert not rebuilding, "rebuild never drained"

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


@pytest.mark.parametrize("script_no", range(len(CORPUS)))
@pytest.mark.parametrize("growth", [1, 4])
@pytest.mark.parametrize("port_fused", [False, True])
def test_corpus_replayed_through_both_packages(port_fused, growth, script_no):
    replay(CORPUS[script_no], port_fused, growth, seed=1000 + script_no)


def test_make_fused_default_follows_env(monkeypatch):
    monkeypatch.setenv("DHASH_FUSED", "on")
    assert tdhash.make("linear", capacity=8, chunk=4, device="cpu").fused
    assert not tdhash.make("linear", capacity=8, chunk=4, device="cpu",
                           fwd_hazard=True).fused
    monkeypatch.setenv("DHASH_FUSED", "off")
    assert not tdhash.make("linear", capacity=8, chunk=4, device="cpu").fused


def test_unported_backends_raise_the_reference_error():
    from repro_torch.core import backend
    assert backend.names() == ("linear",)
    with pytest.raises(ValueError, match="unknown backend 'twochoice'"):
        backend.get("twochoice")
    with pytest.raises(ValueError):
        tdhash.make("chain", device="cpu")


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
