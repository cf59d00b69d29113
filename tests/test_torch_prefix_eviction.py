"""Port vs reference: the prefix cache and its eviction policy
(``serving/prefix_cache.py``, ``serving/eviction.py``).

Fingerprints bit for bit; ``match_prefix`` / ``publish_prefix`` and their
edge contracts; the eviction order (coldest stamp first, ties to the lowest
page id) on every backend the reference parametrises, fused on and off in
the port; the publish roll-back; and the pinned corpus of
``tests/test_prefix_differential.py`` replayed through both packages, each
op's results, pins, stamps, clock and counters equal and both indexes
equal as live key -> value maps after every op, beside the corpus' dict +
LRU oracle.  The reference runs its plain tables.  Tolerance 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro.serving import eviction as jev  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.serving import eviction as tev  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402
from test_prefix_differential import (CORPUS, FPS, N_PAGES, OP_ACQUIRE,  # noqa: E402
                                      OP_EVICT, OP_MATCH, OP_PUBLISH,
                                      OP_RELEASE, OP_START, OP_STEP, Q,
                                      _Oracle, _pad)
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _content  # noqa: E402

BACKENDS = [(b, f) for b in ("linear", "twochoice", "chain")
            for f in (False, True)]
_JF = {"publish": jax.jit(jev.publish), "touch": jax.jit(jev.touch),
       "acquire": jax.jit(jev.acquire), "release": jax.jit(jev.release),
       "evict": jax.jit(jev.evict, static_argnums=1),
       "lookup": jax.jit(jdhash.lookup),
       "step": jax.jit(lambda t: jdhash.finish_same_shape(
           jdhash.rebuild_step(t)))}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _i(x) -> torch.Tensor:
    return _t(np.asarray(x, np.int32))


def _b(x) -> torch.Tensor:
    return _t(np.asarray(x, bool))


def same_state(j, t, where):
    for f in ("refcnt", "cached", "stamp", "clock", "evictions"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)),
                                      err_msg=f"{where}: {f}")
    for f in ("table", "rev"):
        a = convert.state_to_numpy(getattr(t, f))
        b = jax_state_tree(getattr(j, f))
        assert _content(a) == _content(b), (where, f)
        for s in ("rebuilding", "epoch", "cursor"):
            assert a[s] == b[s], (where, f, s)


def test_prefix_fingerprints_bit_for_bit():
    rng = np.random.default_rng(0)
    toks = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=(3, 70),
                        dtype=np.int64).astype(np.int32)
    toks[1] = rng.integers(1, 100, size=70)
    for ps in (1, 4, 7, 16, 70, 71):
        got = tpc.prefix_fingerprints(_t(toks), ps)
        ref = np.asarray(jpc.prefix_fingerprints(jnp.asarray(toks), ps))
        assert got.dtype == torch.int32 and got.shape == ref.shape, ps
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"ps={ps}")


def test_prefix_cache_chain_semantics_against_the_reference():
    toks = np.random.default_rng(0).integers(1, 100, (2, 64)).astype(np.int32)
    toks2 = toks.copy()
    toks2[0, 20] = 99
    fps, fps2 = (tpc.prefix_fingerprints(_t(x), 16) for x in (toks, toks2))
    assert fps[0, 0] == fps2[0, 0] and fps[0, 1] != fps2[0, 1]
    jt = jdhash.make("linear", capacity=256, chunk=32, seed=0)
    tt = tdhash.make("linear", capacity=256, chunk=32, seed=0, device="cpu")
    pages = np.arange(8, dtype=np.int32).reshape(2, 4)
    ones = np.ones((2, 4), bool)
    jt, jok = jpc.publish_prefix(jt, jnp.asarray(fps.numpy()),
                                 jnp.asarray(pages), jnp.asarray(ones))
    tt, tok = tpc.publish_prefix(tt, fps, _t(pages), _t(ones))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    for f in (fps, fps2):
        jn, jg = jpc.match_prefix(jt, jnp.asarray(f.numpy()))
        tn, tg = tpc.match_prefix(tt, f)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tpc.match_prefix(tt, fps2)[0].tolist() == [1, 4]


def test_match_prefix_edge_contracts_against_the_reference():
    """A first-block miss is a clean miss, ragged tails are never
    fingerprinted, a zero-block batch never touches the table, unknown
    fingerprints all miss."""
    jt = jdhash.make("linear", capacity=64, chunk=32, seed=0)
    tt = tdhash.make("linear", capacity=64, chunk=32, seed=0, device="cpu")
    fps = np.array([[11, 12, 13], [21, 22, 23]], np.int32)
    pages = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    mask = np.array([[False, True, True], [True, True, True]])
    jt, _ = jpc.publish_prefix(jt, *map(jnp.asarray, (fps, pages, mask)))
    tt, _ = tpc.publish_prefix(tt, *map(_t, (fps, pages, mask)))
    for f in (fps, np.array([[91, 92], [93, 94]], np.int32)):
        jn, jg = jpc.match_prefix(jt, jnp.asarray(f))
        tn, tg = tpc.match_prefix(tt, _t(f))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tpc.match_prefix(tt, _t(fps))[0].tolist() == [0, 3]
    toks = np.random.default_rng(0).integers(1, 99, (1, 10)).astype(np.int32)
    t2 = toks.copy()
    t2[0, 9] = 7
    f1, f2 = tpc.prefix_fingerprints(_t(toks), 4), \
        tpc.prefix_fingerprints(_t(t2), 4)
    assert f1.shape == (1, 2) and torch.equal(f1, f2)
    short = tpc.prefix_fingerprints(_t(toks[:, :3]), 4)
    assert short.shape == (1, 0)
    n0, g0 = tpc.match_prefix(tt, short)
    assert n0.tolist() == [0] and g0.shape == (1, 0)


def _pair(backend, fused, n_pages=8, **kw):
    j = jev.make(n_pages, backend=backend, chunk=32, seed=3, fused=False,
                 **kw)
    t = tev.make(n_pages, backend=backend, chunk=32, seed=3, fused=fused,
                 device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("backend,fused", BACKENDS)
def test_eviction_pinning_and_lru_order_against_the_reference(backend, fused):
    """The reference's :152 case through both packages: pinned pages are
    never victims, victims come coldest first, evicted fingerprints miss,
    a duplicate republish keeps the first page."""
    j, t = _pair(backend, fused)
    fps = np.array([100, 200, 300, 400, 500, 600, 700, 800], np.int32)
    pages = np.arange(8, dtype=np.int32)
    for sl in (slice(0, 4), slice(4, 8)):
        ones = np.ones(4, bool)
        j, jok = _JF["publish"](j, *map(jnp.asarray,
                                        (fps[sl], pages[sl], ones)))
        t, tok = tev.publish(t, *map(_t, (fps[sl], pages[sl], ones)))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        same_state(j, t, f"publish {sl}")
    j2, jok = _JF["publish"](j, jnp.asarray(fps[:1]), jnp.asarray([7]),
                             jnp.asarray([True]))
    t, tok = tev.publish(t, _t(fps[:1]), _i([7]), _b([True]))
    assert tok.tolist() == [False] == np.asarray(jok).tolist()
    same_state(j2, t, "duplicate republish")
    j = jev.acquire(j2, jnp.asarray(pages[:2]), jnp.ones((2,), bool))
    t = tev.acquire(t, _t(pages[:2]), _b([True, True]))
    for want, pin in ((3, None), (4, [5, 6, 7]), (4, "release")):
        if pin == "release":
            j = jev.release(j, jnp.asarray([5, 6, 7]), jnp.ones((3,), bool))
            t = tev.release(t, _i([5, 6, 7]), _b([True] * 3))
        elif pin:
            j = jev.acquire(j, jnp.asarray(pin), jnp.ones((3,), bool))
            t = tev.acquire(t, _i(pin), _b([True] * 3))
        j, jv, jok = _JF["evict"](j, 4, jnp.asarray(want, jnp.int32))
        t, tv, tok = tev.evict(t, 4, torch.tensor(want, dtype=torch.int32))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(tv.numpy()[tok.numpy()],
                                      np.asarray(jv)[np.asarray(jok)])
        same_state(j, t, f"evict want={want} pin={pin}")
    assert int(t.evictions) == 6


@pytest.mark.parametrize("backend,fused", BACKENDS)
def test_eviction_ties_go_to_the_lowest_page_id(backend, fused):
    """Equal stamps everywhere (one publish batch), then a second
    generation and pins between: every eviction's victims, in order, are
    the reference's ``lax.top_k`` order."""
    j, t = _pair(backend, fused, n_pages=12)
    fps = np.arange(1000, 1012, dtype=np.int32)
    pages = np.array([7, 3, 11, 0, 5, 9, 1, 10, 2, 8, 4, 6], np.int32)
    for sl in (slice(0, 8), slice(8, 12)):
        m = np.ones(sl.stop - sl.start, bool)
        j, _ = _JF["publish"](j, *map(jnp.asarray, (fps[sl], pages[sl], m)))
        t, _ = tev.publish(t, *map(_t, (fps[sl], pages[sl], m)))
    j = jev.acquire(j, jnp.asarray([0, 5]), jnp.ones((2,), bool))
    t = tev.acquire(t, _i([0, 5]), _b([True, True]))
    order = []
    for want in (3, 2, 4, 5):
        j, jv, jok = _JF["evict"](j, 4, jnp.asarray(want, jnp.int32))
        t, tv, tok = tev.evict(t, 4, torch.tensor(want, dtype=torch.int32))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        order += tv.numpy()[tok.numpy()].tolist()
        same_state(j, t, f"evict {want}")
    # the first generation's unpinned pages by id, then the second's
    assert order == [1, 3, 7, 9, 10, 11, 2, 4, 6, 8], order


@pytest.mark.parametrize("fused", [False, True])
def test_publish_rolls_back_a_failed_reverse_insert(fused):
    """Two fingerprints published onto one page: the second's reverse
    insert finds the page key taken, so its forward entry is rolled back
    (masked delete, the reference's cond), in both packages alike."""
    j, t = _pair("linear", fused)
    fps, pages, m = (np.array([100, 101, 102], np.int32),
                     np.array([3, 3, 4], np.int32), np.ones(3, bool))
    j, jok = _JF["publish"](j, *map(jnp.asarray, (fps, pages, m)))
    t, tok = tev.publish(t, *map(_t, (fps, pages, m)))
    assert tok.tolist() == [True, False, True] == np.asarray(jok).tolist()
    same_state(j, t, "roll-back")
    found, _ = tdhash.lookup_by_flag(t.table, _t(fps))
    assert found.tolist() == [True, False, True]


def replay(backend: str, fused: bool, script, seed: int):
    """One corpus script through both packages and the dict oracle (the
    reference test's ``run_script``), state compared after every op."""
    j = jev.make(N_PAGES, backend=backend, capacity=32, chunk=16,
                 seed=seed % 5, fused=False)
    t = tev.make(N_PAGES, backend=backend, capacity=32, chunk=16,
                 seed=seed % 5, fused=fused, device="cpu")
    oracle = _Oracle()
    free = list(range(N_PAGES))
    rb_seed = seed
    for step_no, (opcode, payload) in enumerate(script):
        ctx = (backend, fused, step_no, opcode, payload)
        if opcode == OP_PUBLISH:
            payload = payload[: len(free)]
            if not payload:
                continue
            ks, mask = _pad(payload)
            pages = np.zeros(Q, np.int32)
            pages[: len(payload)] = free[: len(payload)]
            j, jok = _JF["publish"](j, *map(jnp.asarray, (ks, pages, mask)))
            t, tok = tev.publish(t, *map(_t, (ks, pages, mask)))
            exp = oracle.publish(ks.tolist(), pages.tolist(), mask.tolist())
            assert tok.tolist() == exp == np.asarray(jok).tolist(), ctx
            free = [p for p in free
                    if p not in {pg for pg, o in zip(pages, exp) if o}]
        elif opcode == OP_MATCH:
            ks, mask = _pad(payload)
            fj, pj = _JF["lookup"](j.table, jnp.asarray(ks))
            ft, pt = tdhash.lookup_by_flag(t.table, _t(ks))
            np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
            hit = [p for f, m, fn, p in zip(ks.tolist(), mask.tolist(),
                                            ft.tolist(), pt.tolist())
                   if m and fn]
            for f, m, fn, p in zip(ks.tolist(), mask.tolist(), ft.tolist(),
                                   pt.tolist()):
                if m:
                    assert fn == (f in oracle.mapping), ctx
                    assert not fn or p == oracle.mapping[f], ctx
            pg = np.zeros(Q, np.int32)
            pm = np.zeros(Q, bool)
            pg[: len(hit)] = hit
            pm[: len(hit)] = True
            j = _JF["touch"](j, jnp.asarray(pg), jnp.asarray(pm))
            t = tev.touch(t, _t(pg), _t(pm))
            oracle.touch(pg.tolist(), pm.tolist())
        elif opcode in (OP_ACQUIRE, OP_RELEASE):
            pgs = []
            for f in payload:
                p = oracle.mapping.get(f)
                if p is None:
                    continue
                if opcode == OP_RELEASE and oracle.refcnt[p] - \
                        pgs.count(p) <= 0:
                    continue
                pgs.append(p)
            pg = np.zeros(Q, np.int32)
            pm = np.zeros(Q, bool)
            pg[: len(pgs)] = pgs
            pm[: len(pgs)] = True
            name = "acquire" if opcode == OP_ACQUIRE else "release"
            j = _JF[name](j, jnp.asarray(pg), jnp.asarray(pm))
            t = getattr(tev, name)(t, _t(pg), _t(pm))
            for p in pgs:
                oracle.refcnt[p] += 1 if opcode == OP_ACQUIRE else -1
        elif opcode == OP_EVICT:
            want = len(payload)
            j, jv, jok = _JF["evict"](j, Q, jnp.asarray(want, jnp.int32))
            t, tv, tok = tev.evict(t, Q, torch.tensor(want,
                                                      dtype=torch.int32))
            got = tv.numpy()[tok.numpy()].tolist()
            assert got == oracle.evict(min(want, Q)) == \
                np.asarray(jv)[np.asarray(jok)].tolist(), ctx
            free += got
        elif opcode == OP_START:
            if not bool(t.table.rebuilding):
                rb_seed += 1
                j = jev.replace(j, table=jdhash.rebuild_start(j.table,
                                                              seed=rb_seed))
                t = tev.replace(t, table=tdhash.rebuild_start(t.table,
                                                              seed=rb_seed))
        elif opcode == OP_STEP:
            j = jev.replace(j, table=_JF["step"](j.table))
            tkv._finish_step_(t.table)
        same_state(j, t, ctx)
        assert set(np.where(t.cached.numpy())[0].tolist()) == oracle.cached
    for _ in range(2 * (32 // 16) + 8):
        if not bool(t.table.rebuilding):
            break
        j = jev.replace(j, table=_JF["step"](j.table))
        tkv._finish_step_(t.table)
    assert not bool(t.table.rebuilding) and not bool(j.table.rebuilding)
    same_state(j, t, (backend, fused, "drained"))
    found, pages = tdhash.lookup_by_flag(t.table, _i(FPS))
    for i, f in enumerate(FPS):
        assert bool(found[i]) == (f in oracle.mapping), (backend, fused, f)
        if f in oracle.mapping:
            assert int(pages[i]) == oracle.mapping[f], (backend, fused, f)


@pytest.mark.parametrize("backend,fused", BACKENDS)
def test_prefix_differential_corpus_through_both_packages(backend, fused):
    for i, script in enumerate(CORPUS):
        replay(backend, fused, script, seed=500 + i)
