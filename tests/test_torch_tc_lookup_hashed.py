"""The two-row lookup that hashes its keys in the kernel, held to the
reference on the CPU.

The port's twochoice and cuckoo steady-state lookup and delete hand the
``tc_lookup`` kernel the table's two hash functions instead of rows
(``probe.tc_lookup_hashed``: row a = ``bucket_of(hfn_a)``, row b = ``b_offset
+ bucket_of(hfn_b)``, the offset 0 on twochoice and the bucket count on
cuckoo's [2B, W] array).  Pinned here, on the CPU, where the wrapper takes
its plain version:

* ``probe.tc_lookup_hashed`` and ``ops.twochoice_lookup`` / ``ops.
  twochoice_delete`` given the hash functions equal to the JAX
  ``buckets._tc_rows`` / ``_ck_rows`` followed by the JAX
  ``ops.twochoice_lookup`` / ``twochoice_delete`` (their Pallas kernel in
  interpret mode), for the three hash kinds, power-of-two and other bucket
  counts, widths 8, 4 and 6 (not a multiple of the kernel's 16-byte loads),
  both offsets, one hash function for both rows (every ra == rb), hits in
  row b and keys whose lane is TOMB or MIGRATED;
* that the lookup and the delete take exactly one of rows and hash
  functions, and that the hashed wrapper refuses rows outside the table;
* that the fused steady lookup and delete of both backends call
  ``hashing.bucket_of`` nowhere outside the kernel's wrapper;
* a steady-state engine replay (no rebuild) of twochoice and cuckoo
  against the reference's engines.

Tolerance 0 on ``found`` and ``loc``, and on ``val`` where found (the
reference's value of a miss is unspecified; the port's is 0).  The card
holds the kernel to the same plain version (``chip_smoke.py`` phase 2).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import buckets as jb  # noqa: E402
from repro.core import dhash as jdhash  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro.core.engine import DHashEngine as JEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core.engine import DHashEngine as TEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import compare_states  # noqa: E402

EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
J = jnp.asarray
NQ = 97                 # queries a batch: one length, one interpret compile


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def N(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def two_row_table(layout: str, nb: int, w: int, kind: str, seed: int,
                  one_fn: bool = False):
    """A JAX twochoice or cuckoo table of ``nb`` buckets (a side) and width
    ``w``, half its slots placed by the reference's insert oracle on its
    own rows, a share of the placed lanes then TOMB and a share MIGRATED
    (their keys kept); with ``one_fn`` hash function b is hash function a.
    Returns (JAX table, (key, val, state) numpy arrays, the live keys, the
    keys of dead lanes, the port's two hash functions)."""
    rng = np.random.default_rng(seed)
    fa = jh.fresh(kind, seed)
    fb = fa if one_fn else jh.fresh(kind, seed + 100)
    rows = nb if layout == "twochoice" else 2 * nb
    z = jnp.zeros((rows, w), jnp.int32)

    def table(k, v, st):
        if layout == "twochoice":
            return jb.TwoChoiceTable(nbuckets=nb, width=w, max_rounds=8,
                                     hfn_a=fa, hfn_b=fb, key=k, val=v,
                                     state=st)
        return jb.CuckooTable(nbuckets=nb, width=w, max_kick=8, hfn_a=fa,
                              hfn_b=fb, key=k, val=v, state=st)
    rows_of = jb._tc_rows if layout == "twochoice" else jb._ck_rows
    jt = table(z, z, z)
    keys = rng.choice(np.arange(-50_000, 50_000), rows * w // 2,
                      replace=False).astype(np.int32)
    ra, rb = rows_of(jt, J(keys))
    tk, tv, ts, _ = jref.tc_insert_ref(z, z, z, ra, rb, J(keys), J(keys * 7),
                                       jnp.ones(keys.shape, bool), 8)
    tk, tv, ts = (np.array(x) for x in (tk, tv, ts))
    live = rng.permutation(np.flatnonzero(ts.reshape(-1) == LIVE))
    n = len(live) // 8
    ts.reshape(-1)[live[:n]] = TOMB
    ts.reshape(-1)[live[n:2 * n]] = MIGRATED
    flat_s, flat_k = ts.reshape(-1), tk.reshape(-1)
    dead = flat_k[(flat_s == TOMB) | (flat_s == MIGRATED)]
    live_keys = flat_k[flat_s == LIVE]
    pfa = th.fresh(kind, seed, "cpu")
    pfb = pfa if one_fn else th.fresh(kind, seed + 100, "cpu")
    assert np.array_equal(np.asarray(fa.seeds).astype(np.int64),
                          N(pfa.seeds))
    return (table(J(tk), J(tv), J(ts)), (tk, tv, ts), live_keys, dead,
            (pfa, pfb), rows_of)


def batch(live, dead, seed: int, q: int = NQ) -> np.ndarray:
    """Hits, keys of dead lanes and misses, shuffled."""
    rng = np.random.default_rng(seed)
    n_dead = min(len(dead), q // 5)
    hit = rng.choice(live, q // 2)
    miss = rng.integers(100_000, 1 << 30, q - q // 2 - n_dead).astype(np.int32)
    return rng.permutation(np.concatenate(
        [hit, rng.permutation(dead)[:n_dead], miss])).astype(np.int32)


def offset(layout: str, nb: int) -> int:
    return 0 if layout == "twochoice" else nb


# (buckets a side, width): a power of two at width 8, not one at width 4,
# a power of two at width 6 (lane by lane in the kernel)
SHAPES = [(64, 8), (61, 4), (32, 6)]
KINDS = ("mix32", "multiply_shift", "tabulation")
CASES = [(layout, kind, nb, w) for layout in ("twochoice", "cuckoo")
         for kind in KINDS for nb, w in SHAPES]


def check_lookup(jt, tab, rows_of, fns, layout, qk):
    """The JAX rows + fused lookup against the port's hashed wrapper and
    op; returns the port's (found, val, loc) and the reference's rows."""
    nb = jt.nbuckets
    ra, rb = rows_of(jt, J(qk))
    jf, jv, jl = (np.asarray(x) for x in jops.twochoice_lookup(
        *map(J, tab), ra, rb, J(qk)))
    off = offset(layout, nb)
    pf, pv, pl = tprobe.tc_lookup_hashed(*map(T, tab), *fns, nb, off, T(qk))
    of, ov, ol = tops.twochoice_lookup(*map(T, tab), None, None, T(qk),
                                       hfn_a=fns[0], hfn_b=fns[1],
                                       nbuckets=nb, b_offset=off)
    for f, v, lc in ((pf, pv, pl), (of, ov, ol)):
        assert np.array_equal(jf, N(f))
        assert np.array_equal(jl, N(lc))
        assert np.array_equal(np.where(jf, jv, 0), N(v))
    return (N(pf), N(pv), N(pl)), (np.asarray(ra), np.asarray(rb))


@pytest.mark.parametrize("layout,kind,nb,w", CASES)
def test_hashed_lookup_equals_jax_rows_then_lookup(layout, kind, nb, w):
    jt, tab, live, dead, fns, rows_of = two_row_table(
        layout, nb, w, kind, seed=nb * w + len(kind))
    qk = batch(live, dead, seed=w)
    (f, v, loc), (ra, rb) = check_lookup(jt, tab, rows_of, fns, layout, qk)
    assert f.any() and not f.all()
    assert (f & (loc // w == rb) & (ra != rb)).any(), "some hits in row b"
    if layout == "cuckoo":
        assert (rb >= nb).all() and (ra < nb).all()
    # the keys of dead lanes are found only where a LIVE lane holds them
    dead_q = np.isin(qk, dead) & ~np.isin(qk, live)
    assert dead_q.any() and not f[dead_q].any()
    # the hashed form is the rows-given form on the reference's rows
    got = tprobe.tc_lookup(*map(T, tab), T(ra), T(rb), T(qk))
    assert all(np.array_equal(N(a), b) for a, b in zip(got, (f, v, loc)))


@pytest.mark.parametrize("kind", KINDS)
def test_one_hash_function_for_both_rows(kind):
    """hfn_b = hfn_a on twochoice: every query has ra == rb."""
    jt, tab, live, dead, fns, rows_of = two_row_table(
        "twochoice", 61, 8, kind, seed=7, one_fn=True)
    qk = batch(live, dead, seed=3)
    (f, _, _), (ra, rb) = check_lookup(jt, tab, rows_of, fns, "twochoice",
                                       qk)
    assert (ra == rb).all() and f.any() and not f.all()


@pytest.mark.parametrize("layout", ["twochoice", "cuckoo"])
@pytest.mark.parametrize("nb,w", [(64, 8), (45, 6)])
def test_hashed_delete_equals_jax_rows_then_delete(layout, nb, w):
    jt, tab, live, dead, fns, rows_of = two_row_table(
        layout, nb, w, "mix32", seed=nb + w)
    qk = batch(live, dead, seed=5)
    qk[:10] = qk[10:20]                                   # duplicates
    mask = np.random.default_rng(6).random(qk.size) < 0.8
    win = np.asarray(jb.batch_winners(J(qk), J(mask)))
    ra, rb = rows_of(jt, J(qk))
    js, jok = jops.twochoice_delete(*map(J, tab), ra, rb, J(qk), J(win))
    tt = [T(x) for x in tab]
    ts, tok = tops.twochoice_delete(*tt, None, None, T(qk), T(win),
                                    hfn_a=fns[0], hfn_b=fns[1], nbuckets=nb,
                                    b_offset=offset(layout, nb))
    assert ts is tt[2], "the state array is written in place"
    assert np.array_equal(np.asarray(jok), N(tok)) and N(tok).any()
    assert np.array_equal(np.asarray(js), N(ts))


def _op(name):
    def lookup(tab, rows, fns, kw):
        return tops.twochoice_lookup(*tab, *rows, T(np.arange(5)), **fns,
                                     **kw)

    def delete(tab, rows, fns, kw):
        return tops.twochoice_delete(*tab, *rows, T(np.arange(5)),
                                     torch.ones(5, dtype=torch.bool), **fns,
                                     **kw)
    return {"lookup": lookup, "delete": delete}[name]


@pytest.mark.parametrize("op", ["lookup", "delete"])
@pytest.mark.parametrize("give", ["both", "neither", "rows_a and hfns",
                                  "one hash function"])
def test_lookup_and_delete_take_exactly_one_of_rows_and_hash_functions(
        op, give):
    _, tab, _, _, (fa, fb), _ = two_row_table("twochoice", 16, 4, "mix32",
                                              seed=9)
    rows = (T(np.zeros(5, np.int32)), T(np.ones(5, np.int32)))
    rows, fns = {
        "both": (rows, dict(hfn_a=fa, hfn_b=fb)),
        "neither": ((None, None), {}),
        "rows_a and hfns": ((rows[0], None), dict(hfn_a=fa, hfn_b=fb)),
        "one hash function": ((None, None), dict(hfn_a=fa))}[give]
    with pytest.raises(ValueError, match="exactly one"):
        _op(op)([T(x) for x in tab], rows, fns, dict(nbuckets=16))


@pytest.mark.parametrize("nb,off", [(0, 0), (17, 0), (8, 9), (8, -1)])
def test_hashed_lookup_refuses_rows_outside_the_table(nb, off):
    _, tab, _, _, fns, _ = two_row_table("twochoice", 16, 4, "mix32", seed=9)
    with pytest.raises(ValueError, match="do not lie in a table of 16"):
        tprobe.tc_lookup_hashed(*map(T, tab), *fns, nb, off,
                                T(np.arange(3, dtype=np.int32)))


@pytest.mark.parametrize("backend", ["twochoice", "cuckoo"])
def test_fused_steady_lookup_and_delete_hash_in_the_kernel(backend,
                                                           monkeypatch):
    """No ``hashing.bucket_of`` outside the kernel's wrapper (whose plain
    version, taken here on the CPU, hashes in its stead): one
    ``tc_lookup_hashed`` call an op, and the answers of the rows-given
    form on the table's own rows."""
    from repro_torch.core import buckets as tb
    from repro_torch.core import dhash as tdhash
    be = tbe.get(backend)
    d = tdhash.make(backend, capacity=256, chunk=32, seed=3, fused=True,
                    device="cpu")
    keys = T(np.arange(-150, 150, dtype=np.int32))
    t, _ = be.insert_fused(d.old, keys, keys * 3,
                           torch.ones_like(keys, dtype=torch.bool))
    rows = (tb._tc_rows if backend == "twochoice" else tb._ck_rows)(t, keys)
    want = tprobe.tc_lookup(t.key, t.val, t.state, *rows, keys)
    outside, inside = [], [0]
    real_bucket_of, real_hashed = th.bucket_of, tprobe.tc_lookup_hashed

    def bucket_of(*a, **k):
        if not inside[0]:
            outside.append(1)
        return real_bucket_of(*a, **k)

    def hashed(*a, **k):
        inside[0] += 1
        try:
            return real_hashed(*a, **k)
        finally:
            inside[0] -= 1
    calls = []
    monkeypatch.setattr(th, "bucket_of", bucket_of)
    monkeypatch.setattr(tprobe, "tc_lookup_hashed",
                        lambda *a, **k: (calls.append(1), hashed(*a, **k))[1])
    f, v = be.lookup_fused(t, keys)
    f2, v2, loc = be.lookup_fused_loc(t, keys)
    state = t.state.clone()
    t, ok = be.delete_fused(t, keys[:50], torch.ones(50, dtype=torch.bool))
    assert not outside and len(calls) == 3
    for a, b in ((f, want[0]), (v, want[1]), (f2, want[0]), (v2, want[1]),
                 (loc, want[2])):
        assert torch.equal(a, b)
    assert torch.equal(ok, want[0][:50]) and bool(ok.any())
    dead = want[2][:50][ok].long()
    assert (t.state.view(-1)[dead] == TOMB).all()
    assert int((t.state != state).sum()) == int(ok.sum())


def steady_stream(seed: int, steps: int, nl: int = 32, nu: int = 8):
    """The dict oracle before a step and the step's (look, ins, vals,
    ins_mask, dels, del_mask); never re-inserts a live key.  Last the final
    oracle and None."""
    rng = np.random.default_rng(seed)
    oracle: dict[int, int] = {}
    keys = np.arange(-120, 120)
    for step in range(steps):
        ins = rng.choice(keys, nu).astype(np.int32)
        ins_mask = np.array([int(k) not in oracle for k in ins])
        dels = rng.choice(list(oracle) or [0], nu).astype(np.int32)
        del_mask = rng.random(nu) < 0.5
        look = rng.choice(keys, nl).astype(np.int32)
        vals = (ins * 3 + step).astype(np.int32)
        yield dict(oracle), (look, ins, vals, ins_mask, dels, del_mask)
        seen = set()
        for k, v, m in zip(ins.tolist(), vals.tolist(), ins_mask.tolist()):
            if m and k not in seen:
                oracle[k] = v
                seen.add(k)
        seen = set()
        for k, m in zip(dels.tolist(), del_mask.tolist()):
            if m and k not in seen:
                oracle.pop(k, None)
                seen.add(k)
    yield oracle, None


@pytest.mark.parametrize("backend", ["twochoice", "cuckoo"])
def test_steady_engine_replay_against_the_reference(backend):
    """The port's fused engine and the reference's plain and fused engines
    take one op stream with no rebuild: every step's answers equal (values
    where found) and right by a dict oracle; the twochoice state is the
    reference plain engine's slot for slot after every step, the cuckoo
    state its key -> value map (the fused cuckoo insert is a linearisation
    of its own)."""
    kw = dict(capacity=128, chunk=32, seed=5)
    tree = jax_state_tree(jdhash.make(backend, **kw))
    port = TEngine(convert.state_from_numpy({**tree, "fused": True},
                                            device="cpu"),
                   continuous_rebuild=False, poll_every=8)
    refs = [JEngine(jdhash.make(backend, fused=f, **kw),
                    continuous_rebuild=False, poll_every=8)
            for f in (False, True)]
    exact = backend == "twochoice"
    for step, (pre, ops) in enumerate(steady_stream(13, 30)):
        if ops is None:
            break
        look, ins, vals, im, dels, dm = ops
        out = [x.numpy() for x in port.step(look, ins, vals, dels,
                                            ins_mask=im, del_mask=dm)]
        for ref in refs:
            rout = [np.asarray(x) for x in ref.step(look, ins, vals, dels,
                                                    ins_mask=im, del_mask=dm)]
            assert np.array_equal(out[0], rout[0]), step
            assert np.array_equal(np.where(out[0], out[1], 0),
                                  np.where(rout[0], rout[1], 0)), step
            assert np.array_equal(out[2], rout[2]), step
            assert np.array_equal(out[3], rout[3]), step
        for i, k in enumerate(look.tolist()):
            assert out[0][i] == (k in pre), (step, k)
            if k in pre:
                assert out[1][i] == pre[k], (step, k)
        assert not port.rebuilding
        compare_states(port.state, refs[0].state, refs[1].state, step,
                       exact=exact, in_step=False)
    assert port.count() == refs[0].count() == refs[1].count() == len(pre)
