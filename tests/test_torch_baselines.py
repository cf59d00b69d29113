"""Port vs reference: the paper's comparison tables (``core/baselines.py``:
HT-Xu, HT-RHT, HT-Split), their lock model and the two walks they run on
the card (``chain_walk``, ``chain_tail``).

The same numpy-seeded batches go through the JAX functions and through
``repro_torch`` on the CPU, where the walk wrappers take their plain
versions.  Tolerance 0 on every output (found, values, ok, lock rounds) and
on every state array after every op: each chain table's ``akey``, ``aval``,
``anext``, ``astate``, ``heads``, ``free_stack``, ``free_top`` (and the
rest of the table, its hash function and configuration), and ``active``,
``rebuilding``, ``cursor``, ``bcursor``, ``nactive``.

The cases: duplicate keys and masked-out ops in a batch, every key in one
bucket below and past ``max_chain``, an exhausted arena, Xu and RHT updates
mid-rebuild, a full Xu rebuild to ``finish`` (``active`` flips), a full RHT
rebuild to ``done`` with lookups between chunks and a bucket cursor that
wraps, Split growth and shrinking at its clamps, the Split attack keys, a
seeded replay of 40 steps a contender, and the host reads: one a
``lock_serialized`` call, none in any other op.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbl  # noqa: E402
from repro.core import buckets as jb  # noqa: E402
from repro.core import hashing as jh  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbl  # noqa: E402
from repro_torch.core import buckets as tb  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.kernels import probe as tprobe  # noqa: E402
from test_torch_convert import assert_tree_equal, jax_table_tree  # noqa: E402

J = jnp.asarray
Q = 64          # one batch size for every op: one XLA compile a function


def T(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def same(a, b, what=""):
    a, b = np.asarray(a), (b.numpy() if isinstance(b, torch.Tensor)
                           else np.asarray(b))
    assert a.shape == b.shape and np.array_equal(a, b), (what, a, b)


def tables_equal(jt, pt, what=""):
    assert_tree_equal(jax_table_tree(jt), convert.table_to_numpy(pt), what)


def state_equal(js, ps, what=""):
    """Every table and every flag and cursor of two contenders' states."""
    if isinstance(ps, tbl.HTXu):
        tables_equal(js.t0, ps.t0, what + " t0")
        tables_equal(js.t1, ps.t1, what + " t1")
        assert (int(js.active), bool(js.rebuilding), int(js.cursor)) == \
            (ps.active, ps.rebuilding, int(ps.cursor)), what
        assert js.chunk == ps.chunk
    elif isinstance(ps, tbl.HTRHT):
        tables_equal(js.old, ps.old, what + " old")
        tables_equal(js.new, ps.new, what + " new")
        assert (bool(js.rebuilding), int(js.bcursor)) == \
            (ps.rebuilding, int(ps.bcursor)), what
        assert js.bchunk == ps.bchunk
    else:
        tables_equal(js.t, ps.t, what + " t")
        assert (int(js.nactive), js.max_buckets) == \
            (ps.nactive, ps.max_buckets), what


def _jit_all():
    def locked(op):
        def run(t, k, v, m):
            return jbl.lock_serialized(
                op, t, k, v, m, t.nbuckets,
                lambda t, k: jh.bucket_of(t.hfn, k, t.nbuckets))
        return jax.jit(run)

    names = ("xu_lookup", "xu_insert", "xu_delete", "xu_rebuild_chunk",
             "xu_rebuild_done", "xu_rebuild_finish", "rht_lookup",
             "rht_insert", "rht_delete", "rht_rebuild_chunk",
             "rht_rebuild_done", "rht_rebuild_finish", "split_lookup",
             "split_insert", "split_delete")
    out = {n: jax.jit(getattr(jbl, n)) for n in names}
    out["split_resize"] = jax.jit(jbl.split_resize, static_argnums=1)
    out["lock_insert"] = locked(jb.chain_insert)
    out["lock_delete"] = locked(lambda t, k, v, m: jb.chain_delete(t, k, m))
    out["chain_lookup"] = jax.jit(jb.chain_lookup)
    out["chain_insert"] = jax.jit(jb.chain_insert)
    return out


JX = _jit_all()


def batch(rng, pool: np.ndarray, fresh: int = 0, dup: int = 8,
          masked: float = 0.1):
    """Q keys: drawn from ``pool`` (with repeats), ``fresh`` of them new,
    ``dup`` copies of earlier entries; a mask with a share off."""
    k = rng.choice(pool, Q).astype(np.int32)
    if fresh:
        k[:fresh] = rng.integers(4_000_000, 5_000_000, fresh)
    k[Q - dup:] = k[:dup]
    rng.shuffle(k)
    m = rng.random(Q) >= masked
    return k, m


def keys_in_bucket(hfn, nbuckets: int, b: int, n: int,
                   lo: int = 1) -> np.ndarray:
    """``n`` distinct keys from ``lo`` up that the hash function ``hfn`` (a
    reference or port ``HashFn``, or the seed of a mix32 one) sends to
    bucket ``b``, hashed by the port (bit for bit the reference's)."""
    if isinstance(hfn, int):
        hfn = th.fresh("mix32", hfn, "cpu")
    elif not isinstance(hfn.seeds, torch.Tensor):
        hfn = th.HashFn(kind=hfn.kind, seeds=torch.as_tensor(
            np.asarray(hfn.seeds).astype(np.int64)))
    out = np.empty(0, np.int32)
    start = lo
    while out.size < n:
        cand = torch.arange(start, start + 200_000, dtype=torch.int32)
        out = np.concatenate([out, cand[th.bucket_of(hfn, cand, nbuckets)
                                        == b].numpy()])
        start += 200_000
    return out[:n]


# one geometry a contender, so that each jitted reference function compiles
# once for the whole file: buckets (Split: its head capacity), arena, and
# the static fields
GEOMETRY = {"xu": (128, 1024, dict(chunk=128, max_chain=48)),
            "rht": (128, 1024, dict(bchunk=48, max_chain=48)),
            "split": (256, 1024, dict(max_chain=48))}


def pair(kind: str, seed: int, **kw):
    """A reference and a port contender of the kind's geometry, made from
    the same seed."""
    nb, arena, static = GEOMETRY[kind]
    kw = dict(static, seed=seed, **kw)
    make_j, make_t = getattr(jbl, f"{kind}_make"), getattr(tbl, f"{kind}_make")
    return make_j(nb, arena, **kw), make_t(nb, arena, device="cpu", **kw)


def op(kind: str, name: str, js, ps, *args):
    """One op through both packages; the outputs and states held equal.
    Returns the two new states."""
    jout = JX[f"{kind}_{name}"](js, *[J(a) for a in args])
    pout = getattr(tbl, f"{kind}_{name}")(ps, *[T(a) for a in args])
    if name == "lookup":
        for i, (a, b) in enumerate(zip(jout, pout)):
            same(a, b, f"{kind} lookup {i}")
        return js, ps
    (js, jok), (ps, pok) = jout, pout
    same(jok, pok, f"{kind} {name} ok")
    state_equal(js, ps, f"{kind} {name}")
    return js, ps


# ---------------------------------------------------------------------------
# the two walks against the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _flooded(nb=64, arena=1024, n=400, hot=90, seed=3):
    """A chain table, built by the port and carried to the reference:
    ``n`` random keys, ``hot`` more in bucket 5 (past ``max_chain``),
    buckets 1-3 left empty, a tenth tombstoned."""
    rng = np.random.default_rng(seed)
    t = tb.chain_make(nb, arena, th.fresh("mix32", seed, "cpu"), 48)
    k = rng.choice(1_000_000, 4 * n, replace=False).astype(np.int32)
    b = th.bucket_of(t.hfn, T(k), nb).numpy()
    k = k[(b < 1) | (b > 3)][:n]
    keys = np.concatenate([k, keys_in_bucket(seed, nb, 5, hot, lo=2_000_000)])
    t, ok = tb.chain_insert(t, T(keys), T(keys * 3),
                            torch.ones(keys.size, dtype=torch.bool))
    assert bool(ok.all())
    t.astate[T(rng.choice(keys.size, keys.size // 10, replace=False))] = \
        tb.TOMB
    tree = convert.table_to_numpy(t)
    hfn = jh.HashFn(kind="mix32", seeds=J(tree["hfn"]["seeds"]))
    return jb.ChainTable(
        **{f: tree[f] for f in ("nbuckets", "arena", "max_chain",
                                "dirty_cap")}, hfn=hfn,
        **{f: J(x) for f, x in tree.items() if isinstance(x, np.ndarray)}), \
        keys


def _flooded_table(max_chain: int):
    t, keys = _flooded()
    return jb.replace(t, max_chain=max_chain), keys


def _port(t):
    return convert.table_from_numpy(jax_table_tree(t), device="cpu")


@pytest.mark.parametrize("max_chain", [0, 48, 200])
def test_chain_walk_plain_is_the_reference_walk(max_chain):
    """``chain_walk_plain`` (the walk of every plain chain op) against the
    reference's ``buckets.chain_lookup``: hits, tombstoned keys, misses,
    empty buckets, and a bucket of 90+ nodes walked past ``max_chain``,
    where both give up and report the key absent."""
    jt, keys = _flooded_table(max_chain)
    pt = _port(jt)
    rng = np.random.default_rng(max_chain)
    miss = rng.integers(5_000_000, 6_000_000, 40).astype(np.int32)
    empty = keys_in_bucket(3, 64, 2, 8, lo=7_000_000)
    qs = np.concatenate([keys, miss, empty])
    jf, jv, jl = JX["chain_lookup"](jt, J(qs))
    b = th.bucket_of(pt.hfn, T(qs), pt.nbuckets)
    pf, pv, pl = tprobe.chain_walk_plain(
        (pt.akey, pt.aval, pt.astate), (pt.anext, pt.heads), b, T(qs),
        max_chain)
    for a, c, n in ((jf, pf, "found"), (jv, pv, "val"), (jl, pl, "loc")):
        same(a, c, n)
    # a batch links its keys in batch order from the head: the hot keys
    # after the first max_chain lie past the bound
    hot = keys[400:]
    if max_chain < hot.size:
        assert not np.asarray(jf)[400 + max_chain:400 + hot.size].any()
    same(jf, tb.chain_lookup(pt, T(qs))[0], "buckets.chain_lookup")


@functools.partial(jax.jit, static_argnums=2)
def _reference_tail(old, bcursor, bchunk: int):
    """The reference's tail loop, as ``baselines.rht_rebuild_chunk`` runs
    it (``src/repro/core/baselines.py``)."""
    nb = old.nbuckets
    b = (bcursor + jnp.arange(bchunk, dtype=jnp.int32)) % nb
    cur0 = old.heads[b]

    def body(_, carry):
        cur, prev = carry
        valid = cur >= 0
        c = jnp.where(valid, cur, 0)
        nxt = old.anext[c]
        stop = valid & (nxt < 0)
        prev = jnp.where(valid & ~stop, cur, prev)
        cur = jnp.where(valid & ~stop, nxt, cur)
        return cur, prev

    return jax.lax.fori_loop(0, old.max_chain, body,
                             (cur0, jnp.full_like(cur0, -1)))


@pytest.mark.parametrize("max_chain,cursor,bchunk", [
    (48, 0, 64), (48, 40, 40), (0, 3, 8)])
def test_chain_tail_plain_is_the_reference_tail_loop(max_chain, cursor,
                                                     bchunk):
    """``chain_tail_plain`` against the reference's ``fori_loop``: empty
    buckets (1-3), one-node and longer chains, the flooded bucket 5 past
    ``max_chain``, a window that wraps at the bucket count."""
    jt, _ = _flooded_table(max_chain)
    pt = _port(jt)
    jtail, jprev = _reference_tail(jt, jnp.int32(cursor), bchunk)
    ptail, pprev = tprobe.chain_tail_plain(
        pt.heads, pt.anext, torch.tensor(cursor, dtype=torch.int32), bchunk,
        max_chain)
    same(jtail, ptail, "tail")
    same(jprev, pprev, "prev")
    assert (np.asarray(jtail) == -1).any() or cursor + bchunk <= 1 or \
        bchunk < 4


# ---------------------------------------------------------------------------
# lock serialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("one_bucket", [False, True])
def test_lock_serialized_equals_the_reference(one_bucket):
    """Inserts then deletes under per-bucket locks: duplicates, masked-out
    ops, keys already present, and (``one_bucket``) every key in one bucket
    (as many rounds as masked ops).  ok, rounds and the table equal."""
    rng = np.random.default_rng(11 + one_bucket)
    jt = jb.chain_make(64, 1024, jh.fresh("mix32", 4), 48)
    pt = _port(jt)
    if one_bucket:
        pool = keys_in_bucket(4, 64, 7, 70)
    else:
        pool = rng.choice(1_000_000, 300, replace=False).astype(np.int32)
    for name in ("insert", "delete") if one_bucket else \
            ("insert", "insert", "delete", "insert", "delete"):
        k, m = batch(rng, pool, fresh=6 if name == "insert" else 0)
        jt, jok, jr = JX[f"lock_{name}"](jt, J(k), J(k * 5), J(m))
        pop = tb.chain_insert if name == "insert" else \
            (lambda t, k, v, m: tb.chain_delete(t, k, m))
        pt, pok, pr = tbl.lock_serialized(pop, pt, T(k), T(k * 5), T(m),
                                          pt.nbuckets, tbl._bucket)
        same(jok, pok, name)
        assert int(jr) == pr, (name, int(jr), pr)
        tables_equal(jt, pt, name)
        if one_bucket:           # every masked op aimed at bucket 7
            hot = (tbl._bucket(pt, T(k)) == 7).numpy()
            assert pr == int((m & hot).sum())
    nothing = np.zeros(Q, bool)
    _, ok, r = tbl.lock_serialized(tb.chain_insert, pt, T(k), T(k), T(nothing),
                                   pt.nbuckets, tbl._bucket)
    assert r == 0 and not bool(ok.any())


# ---------------------------------------------------------------------------
# HT-Xu
# ---------------------------------------------------------------------------

def test_xu_full_rebuild_with_updates_mid_rebuild():
    """make, steady inserts and deletes, a rebuild start, inserts and
    deletes mid-rebuild (the passive set kept with the full mask), chunks
    to ``done`` with lookups between them, ``finish`` (active flips; the
    replay below flips it back and forth)."""
    rng = np.random.default_rng(21)
    js, ps = pair("xu", 2)
    state_equal(js, ps, "make")
    pool = rng.choice(1_000_000, 500, replace=False).astype(np.int32)
    for _ in range(4):
        k, m = batch(rng, pool, fresh=4)
        js, ps = op("xu", "insert", js, ps, k, k * 7, m)
    k, m = batch(rng, pool)
    js, ps = op("xu", "delete", js, ps, k, m)
    for seed, active in ((40, 1),):
        js, ps = jbl.xu_rebuild_start(js, seed=seed), \
            tbl.xu_rebuild_start(ps, seed=seed)
        state_equal(js, ps, "start")
        chunks = 0
        while not bool(JX["xu_rebuild_done"](js)):
            assert not bool(tbl.xu_rebuild_done(ps))
            k, m = batch(rng, pool, fresh=4)
            js, ps = op("xu", "insert", js, ps, k, k * 7, m)
            k, m = batch(rng, pool)
            js, ps = op("xu", "delete", js, ps, k, m)
            js, ps = JX["xu_rebuild_chunk"](js), tbl.xu_rebuild_chunk(ps)
            state_equal(js, ps, f"chunk {chunks}")
            js, ps = op("xu", "lookup", js, ps, batch(rng, pool)[0])
            chunks += 1
        assert bool(tbl.xu_rebuild_done(ps)) and chunks == 8
        js, ps = JX["xu_rebuild_finish"](js), tbl.xu_rebuild_finish(ps)
        state_equal(js, ps, "finish")
        assert ps.active == active and not ps.rebuilding
        js, ps = op("xu", "lookup", js, ps, pool[:Q])


def test_xu_exhausted_arena_and_one_bucket():
    """An arena that runs out (refusals), then mid-rebuild a batch of keys
    all in one bucket of the active set: refused there (full), linked into
    the passive set past its ``max_chain``; chunks, lookups, deletes."""
    rng = np.random.default_rng(22)
    js, ps = pair("xu", 5)
    pool = rng.choice(1_000_000, 400, replace=False).astype(np.int32)
    for _ in range(18):
        k, m = batch(rng, pool, fresh=Q, dup=4, masked=0.0)
        js, ps = op("xu", "insert", js, ps, k, k, m)
    assert int(ps.t0.free_top) == 0
    js, ps = jbl.xu_rebuild_start(js, seed=9), tbl.xu_rebuild_start(ps, seed=9)
    hot = keys_in_bucket(js.t0.hfn, ps.t0.nbuckets, 0, Q, lo=2_000_000)
    js, ps = op("xu", "insert", js, ps, hot, hot, np.ones(Q, bool))
    for _ in range(2):
        js, ps = JX["xu_rebuild_chunk"](js), tbl.xu_rebuild_chunk(ps)
        state_equal(js, ps, "chunk")
    js, ps = op("xu", "lookup", js, ps, np.concatenate([hot, pool])[:Q])
    js, ps = op("xu", "delete", js, ps, hot[::-1].copy(), np.ones(Q, bool))
    js, ps = op("xu", "delete", js, ps, pool[:Q], np.ones(Q, bool))


# ---------------------------------------------------------------------------
# HT-RHT
# ---------------------------------------------------------------------------

def test_rht_full_rebuild_to_done():
    """Steady inserts and deletes, a rebuild start, chunks to ``done`` (a
    bucket cursor that wraps: 128 buckets, 48 a chunk) with lookups, inserts
    and deletes (two locked passes: old, then new for the keys still
    absent) between chunks, then ``finish``."""
    rng = np.random.default_rng(31)
    js, ps = pair("rht", 3)
    state_equal(js, ps, "make")
    pool = rng.choice(1_000_000, 500, replace=False).astype(np.int32)
    for _ in range(4):
        k, m = batch(rng, pool, fresh=4)
        js, ps = op("rht", "insert", js, ps, k, k * 3, m)
    js, ps = jbl.rht_rebuild_start(js, seed=50), \
        tbl.rht_rebuild_start(ps, seed=50)
    state_equal(js, ps, "start")
    chunks = 0
    while not bool(JX["rht_rebuild_done"](js)):
        assert not bool(tbl.rht_rebuild_done(ps))
        js, ps = JX["rht_rebuild_chunk"](js), tbl.rht_rebuild_chunk(ps)
        state_equal(js, ps, f"chunk {chunks}")
        js, ps = op("rht", "lookup", js, ps, batch(rng, pool)[0])
        if chunks % 5 == 0:
            k, m = batch(rng, pool, fresh=4)
            js, ps = op("rht", "insert", js, ps, k, k * 3, m)
            k, m = batch(rng, pool)
            js, ps = op("rht", "delete", js, ps, k, m)
        chunks += 1
    assert bool(tbl.rht_rebuild_done(ps)) and chunks > 8
    js, ps = JX["rht_rebuild_finish"](js), tbl.rht_rebuild_finish(ps)
    state_equal(js, ps, "finish")
    js, ps = op("rht", "lookup", js, ps, pool[:Q])


def test_rht_one_bucket_past_max_chain_and_full_arena():
    """A bucket flooded past ``max_chain`` (its tail out of the walk's
    reach: the chunk moves the node at the bound) and a new arena that
    runs out mid-rebuild."""
    rng = np.random.default_rng(32)
    js, ps = pair("rht", 4)
    hot = keys_in_bucket(js.old.hfn, ps.old.nbuckets, 0, Q, lo=3_000_000)
    js, ps = op("rht", "insert", js, ps, hot, hot, np.ones(Q, bool))
    k = rng.choice(1_000_000, Q, replace=False).astype(np.int32)
    js, ps = op("rht", "insert", js, ps, k, k, np.ones(Q, bool))
    js, ps = op("rht", "lookup", js, ps, hot)
    js, ps = jbl.rht_rebuild_start(js, seed=8), \
        tbl.rht_rebuild_start(ps, seed=8)
    for _ in range(3):
        js, ps = JX["rht_rebuild_chunk"](js), tbl.rht_rebuild_chunk(ps)
        state_equal(js, ps, "chunk")
    pool = np.arange(10, 10_000, dtype=np.int32)
    for _ in range(17):
        k, m = batch(rng, pool, fresh=Q, dup=0, masked=0.0)
        js, ps = op("rht", "insert", js, ps, k, k, m)
    assert int(ps.new.free_top) == 0
    js, ps = op("rht", "delete", js, ps, hot, np.ones(Q, bool))


# ---------------------------------------------------------------------------
# HT-Split
# ---------------------------------------------------------------------------

def test_split_resizes_at_the_clamps_and_the_attack_keys():
    """Growth and shrinking, past both clamps (1 and ``max_buckets``), with
    ops between; the attack keys ``m * buckets * 4`` (all in bucket 0 at
    every size, past ``max_chain``)."""
    rng = np.random.default_rng(41)
    js, ps = pair("split", 6, init_buckets=16)
    state_equal(js, ps, "make")
    pool = rng.choice(1_000_000, 400, replace=False).astype(np.int32)
    attack = (np.arange(1, Q + 1, dtype=np.int32) * 16 * 4)
    js, ps = op("split", "insert", js, ps, attack, attack, np.ones(Q, bool))
    for _ in range(3):
        k, m = batch(rng, pool, fresh=4)
        js, ps = op("split", "insert", js, ps, k, k * 9, m)
    for grow in (True,) * 5 + (False,) * 9 + (True,):
        js, ps = JX["split_resize"](js, grow), tbl.split_resize(ps, grow)
        state_equal(js, ps, f"resize {grow}")
        js, ps = op("split", "lookup", js, ps, attack)
        k, m = batch(rng, np.concatenate([pool, attack]), fresh=2)
        js, ps = op("split", "lookup", js, ps, k)
        js, ps = op("split", "delete", js, ps, k, m)
    assert ps.nactive == 2
    f, _ = tbl.split_lookup(ps, T(attack))
    assert int(f.sum()) < Q          # the deepest lie past max_chain


# ---------------------------------------------------------------------------
# seeded replays
# ---------------------------------------------------------------------------

def _drive(kind: str, js, ps, seed: int):
    """The benchmark drivers' continuous rebuild or resize
    (``benchmarks/common.py``): poll ``done``, finish and start again."""
    if kind == "split":
        grow = seed % 2 == 0
        return JX["split_resize"](js, grow), tbl.split_resize(ps, grow)
    done_j = bool(JX[f"{kind}_rebuild_done"](js))
    assert done_j == bool(getattr(tbl, f"{kind}_rebuild_done")(ps))
    if done_j:
        js = JX[f"{kind}_rebuild_finish"](js)
        ps = getattr(tbl, f"{kind}_rebuild_finish")(ps)
    if done_j or not ps.rebuilding:
        js = getattr(jbl, f"{kind}_rebuild_start")(js, seed=seed)
        ps = getattr(tbl, f"{kind}_rebuild_start")(ps, seed=seed)
    return js, ps


@pytest.mark.parametrize("kind", ["xu", "rht", "split"])
def test_seeded_replay(kind):
    """40 steps of the benchmark's step (lookup, insert, delete, the
    rebuild chunk while one runs) with the driver's continuous rebuild or
    resize, every output and the whole state equal after every step."""
    rng = np.random.default_rng({"xu": 1, "rht": 2, "split": 3}[kind])
    js, ps = pair(kind, 7, **({"init_buckets": 64} if kind == "split"
                              else {}))
    pool = rng.choice(1_000_000, 700, replace=False).astype(np.int32)
    for i in range(0, 700, Q):
        k = pool[i:i + Q]
        k = np.resize(k, Q)
        js, ps = op(kind, "insert", js, ps, k, k, np.ones(Q, bool))
    state_equal(js, ps, "populated")
    for s in range(40):
        js, ps = _drive(kind, js, ps, 100 + s)
        js, ps = op(kind, "lookup", js, ps, batch(rng, pool)[0])
        k, m = batch(rng, pool, fresh=12)
        js, ps = op(kind, "insert", js, ps, k, k, m)
        k, m = batch(rng, pool)
        js, ps = op(kind, "delete", js, ps, k, m)
        if kind != "split" and ps.rebuilding:
            js = JX[f"{kind}_rebuild_chunk"](js)
            ps = getattr(tbl, f"{kind}_rebuild_chunk")(ps)
        state_equal(js, ps, f"step {s}")


# ---------------------------------------------------------------------------
# host reads
# ---------------------------------------------------------------------------

def test_only_lock_serialized_reads_the_host_once_a_call():
    """Outside the walk wrappers (which on the CPU run their plain
    versions), a ``lock_serialized`` call dispatches exactly one scalar
    read (``aten::_local_scalar_dense``) and no ``nonzero``; every other op
    of the module — lookups, Split's updates and resizes, the rebuild
    starts, chunks, polls and finishes — dispatches none."""
    from unittest import mock

    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        paused, seen = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if not self.paused and ("_local_scalar_dense" in name
                                    or name.startswith("nonzero")):
                self.seen.append(name)
            return func(*args, **(kwargs or {}))

    mode = Reads()

    def pausing(fn):
        def run(*a, **k):
            mode.paused += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return run

    calls = {"n": 0}
    locked = tbl.lock_serialized

    def counting(*a, **k):
        calls["n"] += 1
        return locked(*a, **k)

    rng = np.random.default_rng(61)
    pool = rng.choice(1_000_000, 400, replace=False).astype(np.int32)
    k, m = T(pool[:Q]), T(np.ones(Q, bool))
    x, r, s = (pair(kind, 1)[1] for kind in ("xu", "rht", "split"))
    patches = [mock.patch.object(tprobe, n, pausing(getattr(tprobe, n)))
               for n in ("chain_walk", "chain_tail")]
    patches.append(mock.patch.object(tbl, "lock_serialized", counting))
    for p in patches:
        p.start()
    try:
        with mode:
            x, _ = tbl.xu_insert(x, k, k)
            r, _ = tbl.rht_insert(r, k, k)
            s, _ = tbl.split_insert(s, k, k)
            assert (len(mode.seen), calls["n"]) == (2, 2)
            x = tbl.xu_rebuild_start(x, seed=3)
            r = tbl.rht_rebuild_start(r, seed=3)
            tbl.xu_lookup(x, k)
            tbl.rht_lookup(r, k)
            tbl.split_lookup(s, k)
            s, _ = tbl.split_delete(s, k[:8], m[:8])
            s = tbl.split_resize(s, True)
            x = tbl.xu_rebuild_chunk(x)
            r = tbl.rht_rebuild_chunk(r)
            tbl.xu_rebuild_done(x)
            tbl.rht_rebuild_done(r)
            assert len(mode.seen) == 2
            x, _ = tbl.xu_delete(x, k, m)           # one locked pass
            r, _ = tbl.rht_delete(r, k, m)          # two: old, then new
            assert (len(mode.seen), calls["n"]) == (5, 5)
            x = tbl.xu_rebuild_finish(x)
            r = tbl.rht_rebuild_finish(r)
        assert mode.seen == ["_local_scalar_dense.default"] * 5
    finally:
        for p in patches:
            p.stop()
