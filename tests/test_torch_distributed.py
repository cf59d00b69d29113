"""Port vs reference: the routed ops of ``core/distributed.py``.

The reference runs its routed ops inside ``shard_map`` on S = 2 fake CPU
devices, in a subprocess (``--xla_force_host_platform_device_count``, as
``tests/test_distributed.py`` does), on every backend, fused and not:

* one table a shard: ``routed_service_step`` (then the epoch swap and a
  capped ``routed_lookup``) a step, through a rebuild of every shard;
* the grid of 2 shards x 3 tenants: a full-width routed stack insert,
  staggered rebuilds (two tables of six), 16 transitions, each followed by
  a routed stack lookup;
* the capped cases of the reference's grid script on linear: a
  100%-one-tenant batch through the overflow-proof slab and through a
  compact slab that drops.

The port replays the same numpy inputs in both of its forms — in-process
(``InProcess(2)``: the shards' tables one stack) and one process a shard
(two gloo processes on the CPU, their group set up through a file in
``tmp_path``) — and must equal the reference in ``found``, ``vals``,
``ok``, ``stats``, ``overflow`` and ``dropped`` and in the final tables
(through ``convert``), tolerance 0, against the reference path whose
placement the port follows (``test_torch_table_stack._ref_path``; the
port's fused cuckoo insert is a linearisation of its own: its tables are
compared as key -> value maps).  Also held: four ``all_to_all`` calls a
routed op; one routed stack lookup is one launch on linear, twochoice and
cuckoo whatever the S·T tables, and S·T on chain (counted in the
wrappers); the service step reads nothing on the host; a wrong axis
raises, no form falls back to the other.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.core import distributed as tdd  # noqa: E402
from repro_torch.core import hashing as thash  # noqa: E402
from repro_torch.core.struct_utils import map_tensors  # noqa: E402

S, T = 2, 3
CAP, CHUNK, STEPS, START = 256, 64, 24, 2      # the service step
QL, QI, QD = 32, 8, 8                           # a shard's batches a step
GCAP, GQ, GSTEPS = 128, 48, 16                  # the grid
CF, SLACK = 2.0, 0.125                          # the capped grid cases
BACKENDS = ("linear", "twochoice", "cuckoo", "chain")
AXIS = [(b, f) for b in BACKENDS for f in (False, True)]
TWO_ROW = ("twochoice", "cuckoo")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_path(name: str, port_fused: bool) -> bool:
    """The reference path (its ``fused``) the port's placement follows (as
    ``test_torch_table_stack._ref_path``)."""
    return port_fused and name in ("chain", "cuckoo")


JAX_RUNS = sorted({(b, _ref_path(b, f)) for b, f in AXIS})


def workload() -> dict:
    """Every input of both sides, from one seed."""
    rng = np.random.default_rng(2024)
    pool = rng.choice(1 << 24, 4000, replace=False).astype(np.int32) + 1
    ins = pool[:STEPS * S * QI].reshape(STEPS, S * QI)
    w = {"ins": ins, "ins_vals": ins * 3 + 1}
    lk, dk = [], []
    for step in range(STEPS):
        seen = ins[:max(step, 1)].reshape(-1)
        lk.append(np.concatenate([rng.choice(seen, S * QL // 2),
                                  rng.choice(pool[-500:], S * QL // 2)]))
        dk.append(rng.choice(seen, S * QD, replace=False))
        rng.shuffle(lk[-1])
    w["look"] = np.stack(lk).astype(np.int32)
    w["dels"] = np.stack(dk).astype(np.int32)
    w["gkeys"] = (rng.choice(100_000, S * GQ, replace=False) + 1).astype(
        np.int32)
    w["gtenant"] = rng.integers(0, T, S * GQ).astype(np.int32)
    w["started"] = np.array([[True, False, False], [False, False, True]])
    w["akeys"] = (rng.choice(100_000, S * GQ, replace=False)
                  + 200_000).astype(np.int32)
    w["atenant"] = np.ones(S * GQ, np.int32)          # 100% one tenant
    return w


# ---------------------------------------------------------------------------
# the reference, inside shard_map on S fake devices (run in a subprocess)
# ---------------------------------------------------------------------------

def jax_run(out: str, part: int = 0, parts: int = 1) -> None:
    """The cases of ``JAX_RUNS[part::parts]`` through the reference, and the
    capped cases in part 0; pickles the results to ``out``.  (The parts run
    in processes of their own, side by side: XLA's compiles of the routed
    steps are most of the time.)"""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.core import dhash, hashing
    from repro.core import distributed as dd
    from test_torch_convert import jax_state_tree

    if hasattr(jax, "shard_map"):
        shard_map, kw = jax.shard_map, {"check_vma": False}
    else:
        from jax.experimental.shard_map import shard_map
        kw = {"check_rep": False}
    w = workload()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:S]), ("x",))
    owner = hashing.fresh("tabulation", 7)

    def sh(tree):
        return jtu.tree_map(lambda x: jax.device_put(
            x, NamedSharding(mesh, P("x"))), tree)

    def smap(ins, outs):
        return partial(shard_map, mesh=mesh, in_specs=ins, out_specs=outs,
                       **kw)

    def grid_of(name, fused, seed):
        full = dhash.make_stack(S * T, name, GCAP, chunk=CHUNK, seed=seed,
                                fused=fused)
        return sh(jtu.tree_map(lambda x: x.reshape((S, T) + x.shape[1:]),
                               full))

    def flat(g):
        return jax_state_tree(jtu.tree_map(
            lambda x: np.asarray(x).reshape((-1,) + x.shape[2:]), g))

    res = {}
    for name, fused in JAX_RUNS[part::parts]:
        r = res[(name, fused)] = {}
        st = sh(dd.make_stacked(S, name, CAP, chunk=CHUNK, seed=0,
                                fused=fused))
        spec = jtu.tree_map(lambda _: P("x"), st)
        x = P("x")

        @jax.jit
        @smap((spec, x, x, x, x, x), (spec, x, x, x, x, x))
        def service(g, start, lk, ik, iv, dk):
            # a start where asked, the step, the swap, a capped lookup
            d = jax.lax.cond(start[0], dhash.rebuild_autostart,
                             lambda d: d, dd.peel(g))
            d, (f, v, stats) = dd.routed_service_step(d, lk, ik, iv, dk,
                                                      "x", owner)
            d = dhash.finish_same_shape(d)
            cf, cv = dd.routed_lookup(d, lk, "x", owner, cap=QL // 2)
            return dd.unpeel(d), f, v, stats[None], cf, cv

        for step in range(STEPS):
            start = np.full(S, step == START)
            st, *res_ = service(st, start, w["look"][step], w["ins"][step],
                               w["ins_vals"][step], w["dels"][step])
            r[("service", step)] = tuple(np.asarray(a) for a in res_[:3])
            r[("capped", step)] = tuple(np.asarray(a) for a in res_[3:])
        r["service_state"] = jax_state_tree(jtu.tree_map(np.asarray, st))

        g = grid_of(name, fused, 5)
        gspec = jtu.tree_map(lambda _: P("x"), g)

        @jax.jit
        @smap((gspec, x, x, x), (gspec, x, x))
        def g_insert(g, k, v, tn):
            d, ok, ov = dd.routed_stack_update(
                dd.peel(g), k, v, jnp.ones(k.shape, bool), tn, "x", owner,
                op=dhash.stack_insert, cap_factor=0.0)
            return dd.unpeel(d), ok, ov[None]

        @jax.jit
        @smap((gspec, x, x, x), (gspec, x, x, x))
        def g_step(g, m, k, tn):
            # a start where asked, one transition, the swap, a lookup
            d = dhash.stack_finish_same_shape(dhash.stack_rebuild_step(
                dhash.stack_autostart(dd.peel(g), m[0])))
            f, v, ov = dd.routed_stack_lookup(d, k, tn, "x", owner,
                                              cap_factor=0.0)
            return dd.unpeel(d), f, v, ov[None]

        g, ok, ov = g_insert(g, w["gkeys"], w["gkeys"] * 5, w["gtenant"])
        r["grid_insert"] = (np.asarray(ok), np.asarray(ov))
        none = np.zeros_like(w["started"])
        for step in range(GSTEPS):
            g, *res_ = g_step(g, w["started"] if step == 0 else none,
                             w["gkeys"], w["gtenant"])
            r[("grid", step)] = tuple(np.asarray(a) for a in res_)
        r["grid_state"] = flat(g)

    # the capped cases on linear (the plain reference: the placement the
    # port's linear stacks follow, fused or not)
    r = res["capped"] = {}
    for slack, seed in ((None, 9), (SLACK, 11)) if part == 0 else ():
        g = grid_of("linear", False, seed)
        gspec = jtu.tree_map(lambda _: P("x"), g)

        @jax.jit
        @smap((gspec, x, x, x), (gspec, x, x))
        def c_insert(g, k, v, tn):
            d, ok, ov = dd.routed_stack_update(
                dd.peel(g), k, v, jnp.ones(k.shape, bool), tn, "x", owner,
                op=dhash.stack_insert, cap_factor=CF, spill_slack=slack)
            return dd.unpeel(d), ok, ov[None]

        @jax.jit
        @smap((gspec, x, x), (x, x, x))
        def c_lookup(g, k, tn):
            f, v, ov = dd.routed_stack_lookup(dd.peel(g), k, tn, "x", owner,
                                              cap_factor=CF,
                                              spill_slack=slack)
            return f, v, ov[None]

        @jax.jit
        @smap((gspec, x), gspec)
        def c_delete(g, k):
            tn = jnp.ones(k.shape, jnp.int32)
            d, ok, ov = dd.routed_stack_update(
                dd.peel(g), k, k, jnp.ones(k.shape, bool), tn, "x", owner,
                op=dhash.stack_delete, cap_factor=CF, spill_slack=slack)
            return dd.unpeel(d)

        g, ok, ov = c_insert(g, w["akeys"], w["akeys"] * 5, w["atenant"])
        r[(slack, "insert")] = (np.asarray(ok), np.asarray(ov))
        r[(slack, "lookup")] = tuple(np.asarray(a) for a in c_lookup(
            g, w["akeys"], w["atenant"]))
        g = c_delete(g, w["akeys"][::3])
        r[(slack, "state")] = flat(g)
    with open(out, "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the port, in either form
# ---------------------------------------------------------------------------

def _own(x: np.ndarray, rank: int | None) -> np.ndarray:
    """The whole [S * n] batch (in-process: [S, n]) or rank ``rank``'s
    share of it."""
    x = x.reshape(S, -1)
    return x if rank is None else x[rank]


def _tt(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x))


def _np(*xs) -> tuple:
    return tuple(x.numpy().reshape(-1) if x.dim() else x.numpy()
                 for x in xs)


def port_run(axis, rank: int | None = None) -> dict:
    """Every case through the port: ``axis`` is ``InProcess(S)`` (``rank``
    None) or rank ``rank``'s process group.  Results as ``jax_run``'s, each
    rank's share of a batch (and of the tables) for a process group."""
    w = workload()
    owner = thash.fresh("tabulation", 7, device="cpu")
    grp = rank is not None

    def shard_view(st, per: int):
        """The table(s) this form steps: the whole stack in-process, rank
        ``rank``'s ``per`` rows of it (a view) for a process group."""
        if not grp:
            return st
        if per == 1:
            return map_tensors(lambda x: x[rank], st)
        return map_tensors(lambda x: x[rank * per:(rank + 1) * per], st)

    def own_state(st, per: int):
        return convert.state_to_numpy(map_tensors(
            lambda x: x[rank * per:(rank + 1) * per].clone(), st)
            if grp else st)

    res = {}
    for name, fused in AXIS:
        r = res[(name, fused)] = {}
        st = tdd.make_stacked(S, name, CAP, chunk=CHUNK, seed=0, fused=fused,
                              device="cpu")
        d = shard_view(st, 1)
        for step in range(STEPS):
            if step == START:
                if grp:
                    tdhash.rebuild_autostart_(d)
                else:
                    tdhash.stack_autostart(d)
            lk, ik, iv, dk = (_tt(_own(w[k][step], rank)) for k in
                              ("look", "ins", "ins_vals", "dels"))
            _, (f, v, stats) = tdd.routed_service_step(d, lk, ik, iv, dk,
                                                       axis, owner)
            if grp:
                tdhash.finish_same_shape_(d)
            else:
                tdhash.stack_finish_same_shape_(d)
            r[("service", step)] = _np(f, v, stats)
            r[("capped", step)] = _np(*tdd.routed_lookup(
                d, lk, axis, owner, cap=QL // 2))
        r["service_state"] = own_state(st, 1)

        g = tdhash.make_stack(S * T, name, GCAP, chunk=CHUNK, seed=5,
                              fused=fused, device="cpu")
        d = shard_view(g, T)
        k, tn = _tt(_own(w["gkeys"], rank)), _tt(_own(w["gtenant"], rank))
        _, ok, ov = tdd.routed_stack_update(
            d, k, k * 5, torch.ones(k.shape, dtype=torch.bool), tn, axis,
            owner, op=tdhash.stack_insert, cap_factor=0.0)
        r["grid_insert"] = _np(ok, ov)
        started = _tt(w["started"] if grp else w["started"].reshape(-1))
        tdhash.stack_autostart(d, started[rank] if grp else started)
        for step in range(GSTEPS):
            tdhash.stack_finish_same_shape(tdhash.stack_rebuild_step(d))
            r[("grid", step)] = _np(*tdd.routed_stack_lookup(
                d, k, tn, axis, owner, cap_factor=0.0))
        r["grid_state"] = own_state(g, T)

    r = res["capped"] = {}
    for slack, seed in ((None, 9), (SLACK, 11)):
        g = tdhash.make_stack(S * T, "linear", GCAP, chunk=CHUNK, seed=seed,
                              fused=True, device="cpu")
        d = shard_view(g, T)
        k, tn = _tt(_own(w["akeys"], rank)), _tt(_own(w["atenant"], rank))
        ones = torch.ones(k.shape, dtype=torch.bool)
        _, ok, ov = tdd.routed_stack_update(
            d, k, k * 5, ones, tn, axis, owner, op=tdhash.stack_insert,
            cap_factor=CF, spill_slack=slack)
        r[(slack, "insert")] = _np(ok, ov)
        r[(slack, "lookup")] = _np(*tdd.routed_stack_lookup(
            d, k, tn, axis, owner, cap_factor=CF, spill_slack=slack))
        kd = k[..., ::3].contiguous()
        tdd.routed_stack_update(d, kd, kd, ones[..., ::3], torch.ones_like(kd),
                                axis, owner, op=tdhash.stack_delete,
                                cap_factor=CF, spill_slack=slack)
        r[(slack, "state")] = own_state(g, T)
    return res


GLOO_WORKER = r"""
import os, pickle, sys
import torch
import torch.distributed as dist
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import test_torch_distributed as m
rank, store, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=m.S)
res = m.port_run(dist.group.WORLD, rank)
res["wire"] = m.tdd.all_to_all.calls
dist.barrier()
dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

JAX_DRIVER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import test_torch_distributed as m
m.jax_run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
"""
JAX_PARTS = 3


def _env() -> dict:
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                              else ""),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, the port's in-process ones and the two gloo
    ranks' (the subprocesses run while the in-process form does)."""
    tmp = tmp_path_factory.mktemp("routed")
    procs = {("jax", i): subprocess.Popen(
        [sys.executable, "-c", JAX_DRIVER, ROOT, str(tmp / f"jax{i}.pkl"),
         str(i), str(JAX_PARTS)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(JAX_PARTS)}
    for rank in range(S):
        procs[rank] = subprocess.Popen(
            [sys.executable, "-c", GLOO_WORKER, ROOT, str(rank),
             str(tmp / "store"), str(tmp / f"rank{rank}.pkl")],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    before = tdd.all_to_all.calls
    local = port_run(tdd.InProcess(S))
    local["wire"] = tdd.all_to_all.calls - before
    for key, p in procs.items():
        text, _ = p.communicate(timeout=600)
        assert p.returncode == 0, (key, text[-4000:])
    out = {"in_process": local, "jax": {}}
    for i in range(JAX_PARTS):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            part = pickle.load(f)
        out["jax"].update({k: v for k, v in part.items() if v})
    ranks = []
    for rank in range(S):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    out["group"] = _merge(ranks)
    return out


def _merge(ranks: list) -> dict:
    """The ranks' results as one run's: each batch result and each table
    joined along the shard axis (stats and overflow a row a rank)."""
    def join(xs):
        if isinstance(xs[0], dict):
            return {k: join([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], tuple):
            return tuple(join(list(z)) for z in zip(*xs))
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs) if xs[0].ndim else np.stack(xs)
        assert all(x == xs[0] for x in xs)
        return xs[0]
    out = join(ranks)
    out["wire"] = [r["wire"] for r in ranks]
    return out


def _answers(name, got, want, where, two_row_vals=True):
    """(found, vals, ...) equal; a two-row miss's value is the reference
    plain path's unspecified lane: compare values where found."""
    got = [np.asarray(x).reshape(np.asarray(y).shape) for x, y in
           zip(got, want)]
    f, fw = got[0], np.asarray(want[0])
    assert np.array_equal(f, fw), where
    v, vw = got[1], np.asarray(want[1])
    if name in TWO_ROW and two_row_vals:
        v, vw = np.where(f, v, 0), np.where(fw, vw, 0)
    assert np.array_equal(v, vw), where
    for i, (a, b) in enumerate(zip(got[2:], want[2:])):
        assert np.array_equal(a, np.asarray(b)), (where, i)


def _live(tree: dict, side: str) -> list:
    """Each table's key -> value map of LIVE slots on ``side``."""
    t = tree[side]
    key = t["key" if "key" in t else "akey"]
    val = t["val" if "val" in t else "aval"]
    st = t["state" if "state" in t else "astate"]
    n = key.shape[0]
    key, val, st = (a.reshape(n, -1) for a in (key, val, st))
    return [dict(zip(k[s == 1].tolist(), v[s == 1].tolist()))
            for k, v, s in zip(key, val, st)]


def _hazard(tree: dict) -> list:
    """Each table's live hazard entries as a set of (key, value) pairs (a
    fused scan compacts them, a plain one keeps their positions)."""
    hk, hv, hl = (np.asarray(tree[k]).reshape(len(tree["epoch"]), -1)
                  for k in ("hazard_key", "hazard_val", "hazard_live"))
    return [set(zip(k[m].tolist(), v[m].tolist()))
            for k, v, m in zip(hk, hv, hl)]


def _tables(got: dict, want: dict, exact: bool, where):
    """Two state trees equal: both tables slot for slot, the hazard buffers
    as sets, every scalar; or (a linearisation of its own) the epochs and
    the live maps."""
    assert _hazard(got) == _hazard(want), where
    if not exact:
        for k in ("epoch", "rebuilding"):
            assert np.array_equal(got[k], want[k]), (where, k)
        for side in ("old", "new"):
            assert _live(got, side) == _live(want, side), (where, side)
        return
    for k, b in want.items():
        a = got[k]
        if isinstance(b, dict):
            for f, y in b.items():
                x = a[f]
                if isinstance(y, dict):
                    x, y = x["seeds"], y["seeds"]
                assert np.array_equal(np.asarray(x), np.asarray(y)), \
                    (where, k, f)
        elif isinstance(b, np.ndarray) and not k.startswith("hazard"):
            assert np.array_equal(a, b), (where, k)


def _check_run(port: dict, ref: dict, name: str, fused: bool):
    mine = port[(name, fused)]
    theirs = ref[(name, _ref_path(name, fused))]
    exact = not (name == "cuckoo" and fused)
    for step in range(STEPS):
        for what in ("service", "capped"):
            _answers(name, mine[(what, step)], theirs[(what, step)],
                     (name, fused, what, step))
    _tables(mine["service_state"], theirs["service_state"], exact,
            (name, fused, "service tables"))
    for a, b in zip(mine["grid_insert"], theirs["grid_insert"]):
        assert np.array_equal(a.reshape(b.shape), b), (name, fused)
    for step in range(GSTEPS):
        _answers(name, mine[("grid", step)], theirs[("grid", step)],
                 (name, fused, "grid", step))
    _tables(mine["grid_state"], theirs["grid_state"], exact,
            (name, fused, "grid tables"))
    # the started tables swapped, the others stayed
    ep = mine["grid_state"]["epoch"]
    assert np.array_equal(ep, workload()["started"].reshape(-1)), ep


@pytest.mark.parametrize("name,fused", AXIS)
def test_in_process_routing_equals_the_shard_map_runs(runs, name, fused):
    _check_run(runs["in_process"], runs["jax"], name, fused)


@pytest.mark.parametrize("name,fused", AXIS)
def test_process_group_routing_over_gloo_equals_the_shard_map_runs(
        runs, name, fused):
    _check_run(runs["group"], runs["jax"], name, fused)


@pytest.mark.parametrize("form", ("in_process", "group"))
def test_capped_slab_and_compact_drop_cases(runs, form):
    """A 100%-one-tenant batch at cap_factor 2: the overflow-proof slab
    serves every key, a compact slab drops exactly what ``dropped``
    counts; ``overflow`` and the tables equal the reference's."""
    mine, theirs = runs[form]["capped"], runs["jax"]["capped"]
    w = workload()
    for slack in (None, SLACK):
        for what in ("insert", "lookup"):
            got, want = mine[(slack, what)], theirs[(slack, what)]
            for a, b in zip(got, want):
                assert np.array_equal(np.asarray(a).reshape(b.shape), b), \
                    (form, slack, what)
        _tables(mine[(slack, "state")], theirs[(slack, "state")], True,
                (form, slack))
        ok = np.asarray(mine[(slack, "insert")][0]).reshape(S, GQ)
        # overflow is a host histogram of each shard's batch, minus the cap
        own = (tdd.grid_owner(_tt(w["akeys"]), _tt(w["atenant"]), S, T,
                              thash.fresh("tabulation", 7, device="cpu"))
               .numpy().reshape(S, GQ))
        cap = tdd.route_cap(CF, GQ, S * T)
        hist = np.stack([np.bincount(o, minlength=S * T) for o in own])
        ov = np.asarray(mine[(slack, "insert")][1]).reshape(S, S * T)
        assert np.array_equal(ov, np.maximum(hist - cap, 0))
        spill = tdd.route_spill_cap(GQ, cap, slack)
        served = GQ - np.maximum(ov.sum(1) - spill, 0)
        assert np.array_equal(ok.sum(1), served), (form, slack)
        assert (served < GQ).any() == (slack is not None)


def test_four_all_to_all_calls_a_routed_op(runs):
    """Keys and mask out, found and vals back (a lookup); keys, values and
    mask out, ok back (an update): four exchanges a routed op, in both
    forms (the whole run's count, and one op at a time).  A routed stack
    delete ships no values: three, as the reference's."""
    per_backend = 4 * (4 * STEPS + 1 + GSTEPS)
    want = (4 + 4 + 3) * 2 + len(AXIS) * per_backend
    assert runs["in_process"]["wire"] == want
    assert runs["group"]["wire"] == [want] * S
    st = tdd.make_stacked(S, "linear", 64, chunk=32, device="cpu")
    owner = thash.fresh("tabulation", 7, device="cpu")
    keys = torch.arange(1, 2 * 16 + 1, dtype=torch.int32).view(S, 16)
    ones = torch.ones(keys.shape, dtype=torch.bool)
    axis = tdd.InProcess(S)
    for run in (lambda: tdd.routed_lookup(st, keys, axis, owner),
                lambda: tdd.routed_update(st, keys, keys, ones, axis, owner),
                lambda: tdd.routed_update(st, keys, keys, ones, axis, owner,
                                          op=tdhash.delete)):
        before = tdd.all_to_all.calls
        run()
        assert tdd.all_to_all.calls - before == 4


def _counting(monkeypatch) -> dict:
    from test_torch_table_stack import _counting as counting
    return counting(monkeypatch)


@pytest.mark.parametrize("name", BACKENDS)
def test_routed_stack_lookup_launch_budget_counted_in_the_wrappers(
        name, monkeypatch):
    """One routed stack lookup of the in-process grid: ONE ``probe2``
    launch on linear, ONE ``tc_probe2`` on twochoice and cuckoo, whatever
    S·T, mid-rebuild or not; chain loops: S·T ``chain_probe2``."""
    from repro_torch.kernels import probe
    calls = _counting(monkeypatch)
    owner = thash.fresh("tabulation", 7, device="cpu")
    rng = np.random.default_rng(4)
    for s, t in ((1, 1), (2, 3), (2, 8)):
        g = tdhash.make_stack(s * t, name, 128, chunk=32, seed=1, fused=True,
                              device="cpu")
        tdhash.stack_autostart(g, torch.arange(s * t) % 2 == 0)
        tdhash.stack_rebuild_step(g)
        keys = _tt(rng.integers(1, 1 << 20, (s, 40)).astype(np.int32))
        tn = _tt(rng.integers(0, t, (s, 40)).astype(np.int32))
        for slack in (None, 0.125):
            before = dict(calls)
            tdd.routed_stack_lookup(g, keys, tn, tdd.InProcess(s), owner,
                                    spill_slack=slack)
            got = {k: calls[k] - before[k] for k in calls
                   if calls[k] > before[k]}
            # (a chain stack runs each table's lookup_by_flag: both of the
            # reference's branches, a chain_probe and a chain_probe2 each)
            want = {"linear": {"probe2": 1}, "twochoice": {"tc_probe2": 1},
                    "cuckoo": {"tc_probe2": 1},
                    "chain": {"chain_probe": s * t,
                              "chain_probe2": s * t}}[name]
            assert got == want, (name, s, t, got)
    assert probe.KERNELS   # the counted names are the kernels'


def test_service_step_reads_nothing_on_the_host():
    """The in-process routed service step, mid-rebuild, capped and not,
    dispatches no scalar read (``aten::_local_scalar_dense``: ``item``,
    ``bool``, ``int``, indexing with a 0-dim tensor) and no ``nonzero``
    outside the kernel wrappers (on the CPU those run their plain versions,
    which may read; on the card they launch and read nothing), so the whole
    step can be captured in a CUDA graph."""
    from unittest import mock

    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import probe

    class Reads(TorchDispatchMode):
        paused, seen = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if not self.paused and ("_local_scalar_dense" in name
                                    or name.startswith("nonzero")):
                self.seen.append(name)
            return func(*args, **(kwargs or {}))

    mode = Reads()
    mode.seen = []

    def pausing(fn):
        def run(*a, **k):
            mode.paused += 1
            try:
                return fn(*a, **k)
            finally:
                mode.paused -= 1
        return run

    owner = thash.fresh("tabulation", 7, device="cpu")
    w = workload()
    wrappers = [k for k in dir(probe) if hasattr(probe, f"{k}_plain")]
    for name in ("linear", "cuckoo"):
        st = tdd.make_stacked(S, name, CAP, chunk=CHUNK, fused=True,
                              device="cpu")
        tdhash.stack_autostart(st)
        for cf in (0.0, 1.0):
            with mock.patch.multiple(probe, **{
                    k: pausing(getattr(probe, k)) for k in wrappers}):
                with mode:
                    tdd.routed_service_step(
                        st, *(_tt(w[k][3]).view(S, -1) for k in
                              ("look", "ins", "ins_vals", "dels")),
                        tdd.InProcess(S), owner, cap_factor=cf)
            assert mode.seen == [], (name, cf, mode.seen)


def test_a_wrong_axis_raises_and_no_form_falls_back():
    import torch.distributed as dist
    st = tdd.make_stacked(S, "linear", 64, chunk=32, device="cpu")
    one = map_tensors(lambda x: x[0], st)
    owner = thash.fresh("tabulation", 7, device="cpu")
    keys = torch.arange(1, 33, dtype=torch.int32)
    for axis in (None, "x", S):
        with pytest.raises(TypeError):
            tdd.routed_lookup(st, keys.view(S, -1), axis, owner)
    # in-process: a stack of S tables and [S, Q] batches, nothing else
    with pytest.raises(ValueError):
        tdd.routed_lookup(st, keys, tdd.InProcess(S), owner)
    with pytest.raises(ValueError):
        tdd.routed_lookup(one, keys.view(S, -1), tdd.InProcess(S), owner)
    with pytest.raises(ValueError):
        tdd.routed_lookup(st, keys.view(4, -1), tdd.InProcess(4), owner)
    with pytest.raises(ValueError):
        tdd.routed_update(st, keys.view(S, -1), keys.view(S, -1),
                          torch.ones(S, 16, dtype=torch.bool),
                          tdd.InProcess(S), owner, op=tdhash.lookup)
    with pytest.raises(ValueError):
        tdd.InProcess(0)
    # no process group was set up in this process: its form raises, it
    # does not run the in-process exchange instead
    assert not dist.is_initialized()
    with pytest.raises((TypeError, RuntimeError, ValueError)):
        tdd.routed_lookup(one, keys, dist.group.WORLD, owner)
