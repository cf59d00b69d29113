"""Port vs reference: table stacks (``dhash.make_stack``, the ``stack_*``
ops, ``DHashStackEngine``).

The reference's ``tests/test_table_stack.py`` on the CPU, against the JAX
package: both packages start from one stack (converted through
``repro_torch.convert``) and take the same numpy inputs.  The contract is
the reference's: a stack of T tables behaves exactly like T independent
tables, each on its own rebuild epoch.  Held here: the shape, ``unstack``
and the seeds (distinct across tables, also after an epoch); the parity
walk on all four backends, the port's ``fused`` off and on (each step's
``found``, ``vals``, ``ok``, ``epoch``, ``rebuilding``, and the counts,
against the reference path whose placement the port follows; a fused
linear stack's insert also against the reference's fused one, ``ok`` and
the live map); the stack against T independent port tables, every state
tensor slot for slot; the launch budget counted in the kernel wrappers
(linear, twochoice and cuckoo fused: as many calls at T = 8 as at T = 1;
every other stack: T times one table's); the stack engine.  Tolerance 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro.core.engine import DHashStackEngine as JStackEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.engine import DHashStackEngine  # noqa: E402
from repro_torch.core.struct_utils import map_tensors  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import _live_map  # noqa: E402

T = 8
CAP = 384
Q = 64
BACKENDS = ("linear", "twochoice", "cuckoo", "chain")
AXIS = [(b, f) for b in BACKENDS for f in (False, True)]
TWO_ROW = ("twochoice", "cuckoo")
# the backends whose fused stacks run an op as one launch of each kernel:
# the insert's kernel and the ordered check's
ONE_LAUNCH = {"linear": ("probe_insert", "probe2"),
              "twochoice": ("tc_insert", "tc_probe2"),
              "cuckoo": ("tc_insert", "tc_probe2")}

_J = dict(insert=jax.jit(jdhash.stack_insert),
          delete=jax.jit(jdhash.stack_delete),
          lookup=jax.jit(jdhash.stack_lookup),
          start=jax.jit(jdhash.stack_autostart),
          step=jax.jit(lambda d: jdhash.stack_finish_same_shape(
              jdhash.stack_rebuild_step(d))),
          count=jax.jit(jdhash.stack_count_items))


def _keys(rng, t=T, n=CAP) -> np.ndarray:
    return rng.choice(1_000_000, (t, n), replace=False).astype(np.int32) + 1


def _port_of(jstack, fused: bool):
    """The port's stack on the CPU from the reference's."""
    return convert.state_from_numpy({**jax_state_tree(jstack),
                                     "fused": fused}, device="cpu")


def _ref_path(name: str, port_fused: bool) -> bool:
    """The reference path (its ``fused``) whose placement the port follows:
    the fused one for a fused chain and a fused cuckoo (answers only: the
    port's fused cuckoo insert is a linearisation of its own), else the
    plain one."""
    return port_fused and name in ("chain", "cuckoo")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x))


def _same_answers(name, found_p, vals_p, found_j, vals_j, where):
    fj, vj = np.asarray(found_j), np.asarray(vals_j)
    fp, vp = found_p.numpy(), vals_p.numpy()
    assert np.array_equal(fp, fj), where
    if name in TWO_ROW:     # a plain two-row miss's value is unspecified
        vp, vj = np.where(fp, vp, 0), np.where(fj, vj, 0)
    assert np.array_equal(vp, vj), where


def _tables_equal(a, b, where):
    """Every tensor of two port states (or stacks) equal."""
    bad = []
    map_tensors(lambda x, y: bad.append(not torch.equal(x, y)), a, b)
    assert not any(bad), where


def test_make_stack_shape_unstack_and_seeds():
    st = tdhash.make_stack(T, "linear", CAP, chunk=64, seed=0, device="cpu")
    assert tdhash.stack_size(st) == T
    assert st.hazard_key.shape == (T, 64) and st.old.key.shape[0] == T
    singles = tdhash.unstack(st)
    assert len(singles) == T
    seeds = {tuple(s.old.hfn.seeds.tolist()) for s in singles}
    assert len(seeds) == T
    # unstack gives independent copies that restack to the stack
    _tables_equal(map_tensors(lambda *xs: torch.stack(xs), *singles), st,
                  "restack")
    singles[0].old.key.fill_(7)
    assert not bool((st.old.key[0] == 7).all())
    # the same seeds as the reference's stack, table by table
    jst = jdhash.make_stack(T, "linear", CAP, chunk=64, seed=0)
    assert np.array_equal(st.old.hfn.seeds.numpy().astype(np.uint32),
                          np.asarray(jst.old.hfn.seeds))
    with pytest.raises(ValueError):
        tdhash.make_stack(0, "linear", CAP, device="cpu")
    # one epoch on every table (of a smaller stack): the reseeded functions
    # stay distinct across tables, and equal the reference's
    jst = jdhash.make_stack(T, "linear", 96, chunk=64, seed=0)
    st = _port_of(jst, True)
    tdhash.stack_autostart(st)
    jst = _J["start"](jst, jnp.ones(T, bool))
    for _ in range(6):
        tdhash.stack_finish_same_shape(tdhash.stack_rebuild_step(st))
        jst = _J["step"](jst)
    assert st.epoch.tolist() == [1] * T
    assert np.array_equal(np.asarray(jst.epoch), np.ones(T))
    for side in ("old", "new"):
        s = getattr(st, side).hfn.seeds.numpy().astype(np.uint32)
        assert len({tuple(r) for r in s.tolist()}) == T, side
        assert np.array_equal(s, np.asarray(getattr(jst, side).hfn.seeds))


def test_peel_and_unpeel_are_views_of_a_one_table_stack():
    st = distributed.make_stacked(1, "linear", 64, chunk=32, device="cpu")
    one = distributed.peel(st)
    assert one.cursor.dim() == 0 and one.old.key.shape == (128,)
    tdhash.rebuild_autostart_(one)
    assert bool(st.rebuilding[0])
    back = distributed.unpeel(one)
    assert back.old.key.shape == (1, 128) and \
        back.old.key.data_ptr() == st.old.key.data_ptr()


@pytest.mark.parametrize("name,fused", AXIS)
def test_stack_parity_walk_against_the_reference_and_independent_tables(
        name, fused):
    """Insert, staggered starts (even tables at step 0, tables 1 and 3 at
    step 3), a delete at step 5, 24 steps: the port's stack against the
    reference's stack and against T independent port tables."""
    rng = np.random.default_rng(7)
    ref_fused = _ref_path(name, fused)
    exact = not (name == "cuckoo" and fused)
    # (a linear table's plain ops run every probe round: 16 keep it quick)
    kw = dict(max_probes=16) if name == "linear" else {}
    j = jdhash.make_stack(T, name, CAP, chunk=128, seed=0, fused=ref_fused,
                          **kw)
    st = _port_of(j, fused)
    singles = [map_tensors(lambda x: x[i].clone(), st) for i in range(T)]
    keys = _keys(rng)
    vals = keys * 5
    h = CAP // 2

    def ins_singles(i, k, v, m=None):
        return tdhash.insert_by_flag(singles[i], _t(k), _t(v),
                                     None if m is None else _t(m))[1]

    st, ok = tdhash.stack_insert(st, _t(keys[:, :h]), _t(vals[:, :h]))
    j, ok_j = _J["insert"](j, jnp.asarray(keys[:, :h]),
                           jnp.asarray(vals[:, :h]))
    assert np.array_equal(ok.numpy(), np.asarray(ok_j))
    for i in range(T):
        assert torch.equal(ok[i], ins_singles(i, keys[i, :h], vals[i, :h]))
    if name == "linear" and fused:
        # the reference's fused insert: another linearisation, the same ok
        # and the same live map
        jf = jdhash.make_stack(T, name, CAP, chunk=128, seed=0, fused=True,
                               **kw)
        jf, ok_f = _J["insert"](jf, jnp.asarray(keys[:, :h]),
                                jnp.asarray(vals[:, :h]))
        assert np.array_equal(ok.numpy(), np.asarray(ok_f))
        p, r = convert.state_to_numpy(st), jax_state_tree(jf)
        for i in range(T):
            row = {f: r["old"][f][i] for f in ("key", "val", "state")}
            mine = {f: p["old"][f][i] for f in ("key", "val", "state")}
            assert _live_map(mine) == _live_map(row), i

    mask0 = np.array([i % 2 == 0 for i in range(T)])
    tdhash.stack_autostart(st, _t(mask0))
    j = _J["start"](j, jnp.asarray(mask0))
    for i in np.flatnonzero(mask0):
        tdhash.rebuild_autostart_(singles[i])
    dels = keys[:, :Q]
    ep_trace = []
    for step in range(24):
        if step == 3:
            mask1 = np.array([i in (1, 3) for i in range(T)])
            tdhash.stack_autostart(st, _t(mask1))
            j = _J["start"](j, jnp.asarray(mask1))
            for i in (1, 3):
                tdhash.rebuild_autostart_(singles[i])
        tdhash.stack_finish_same_shape(tdhash.stack_rebuild_step(st))
        j = _J["step"](j)
        f, v = tdhash.stack_lookup(st, _t(keys[:, :Q]))
        fj, vj = _J["lookup"](j, jnp.asarray(keys[:, :Q]))
        _same_answers(name, f, v, fj, vj, (name, fused, step))
        if step == 5:
            _, okd = tdhash.stack_delete(st, _t(dels))
            j, okd_j = _J["delete"](j, jnp.asarray(dels))
            assert np.array_equal(okd.numpy(), np.asarray(okd_j)), step
        for i in range(T):
            s = singles[i]
            tdhash.finish_same_shape_(s, go=tdhash.rebuild_step_(s,
                                                                 swap=True))
            if step in (5, 23):
                f1, v1 = tdhash.lookup_by_flag(s, _t(keys[i, :Q]))
                assert torch.equal(f[i], f1) and torch.equal(v[i], v1)
            if step == 5:
                d2, okd1 = tdhash.delete(s, _t(dels[i]), rebuilding=True)
                map_tensors(lambda a, b: a.copy_(b), s, d2)
                assert torch.equal(okd[i], okd1)
        if exact:
            assert np.array_equal(st.epoch.numpy(), np.asarray(j.epoch))
            assert np.array_equal(st.rebuilding.numpy(),
                                  np.asarray(j.rebuilding))
        ep_trace.append(st.epoch.numpy().copy())

    ep = st.epoch.numpy()
    assert np.array_equal(ep, np.asarray(j.epoch))
    assert np.array_equal(st.rebuilding.numpy(), np.asarray(j.rebuilding))
    started = [i for i in range(T) if i % 2 == 0 or i in (1, 3)]
    idle = [i for i in range(T) if i not in started]
    assert (ep[idle] == 0).all() and (ep[started] >= 1).all()
    assert any(len(set(e[started])) > 1 for e in ep_trace), \
        "staggered starts should spread epochs across the stack mid-run"
    assert np.array_equal(tdhash.stack_count_items(st).numpy(),
                          np.asarray(_J["count"](j)))
    # the stack IS T independent tables, slot for slot
    for i in range(T):
        _tables_equal(tdhash._table(st, i), singles[i], (name, fused, i))
    if exact:       # and the reference's tables, slot for slot
        p, r = convert.state_to_numpy(st), jax_state_tree(j)
        for side in ("old", "new"):
            for k in p[side]:
                a, b = p[side][k], r[side][k]
                if k.startswith("hfn"):
                    a, b = a["seeds"], b["seeds"]
                assert np.array_equal(a, b), (side, k)


def test_stacked_cuckoo_insert_kicks_out_each_table_with_its_own_functions():
    """A fused cuckoo stack's insert (one ``tc_insert`` call for T tables)
    on crowded tables, two of four mid-rebuild (they insert into their new
    tables, under their new hash functions): each table equals its
    single-table twin slot for slot, and the reference's composed oracles
    (``tc_insert_ref`` with two rounds, then ``cuckoo_kick_ref`` with the
    target's hash functions) slot for slot, ``ok`` for ``ok``; the
    kick-out placed keys in every table."""
    from repro.core import buckets as jbuckets
    from repro.core import hashing as jhash
    from repro.kernels import ref as jref
    from repro_torch.core import backend as tbe
    n, rng = 4, np.random.default_rng(12)
    st = tdhash.make_stack(n, "cuckoo", 48, chunk=32, seed=3, fused=True,
                           device="cpu")
    rb = torch.tensor([False, True, False, True])
    tdhash.stack_autostart(st, rb)
    slots = st.old.key[0].numel()
    # crowd every target: 85 % of its slots LIVE through plain inserts
    m = int(0.85 * slots)
    fill = _keys(rng, n, m)
    for i in range(n):
        view = tdhash._table(st, i)
        tgt = view.new if bool(rb[i]) else view.old
        t2, ok = tbe.get("cuckoo").insert(tgt, _t(fill[i]), _t(fill[i] * 3),
                                          torch.ones(m, dtype=torch.bool))
        assert int(ok.sum()) > 0.8 * slots
        for f in ("key", "val", "state"):
            getattr(tgt, f).copy_(getattr(t2, f))
    keys = _keys(rng, n, 24) + (1 << 24)
    keys[:, :3] = keys[:, 3:6]                          # duplicates
    vals = keys * 7
    mask = torch.as_tensor(rng.random((n, 24)) < 0.9)
    singles = [map_tensors(lambda x: x[i].clone(), st) for i in range(n)]
    targets = [(s.new if bool(rb[i]) else s.old) for i, s in
               enumerate(singles)]
    before = [[getattr(t, f).clone() for f in ("key", "val", "state")]
              for t in targets]
    _, ok = tdhash.stack_insert(st, _t(keys), _t(vals), mask)
    placed_by_kick = 0
    for i in range(n):
        _, ok1 = tdhash.insert_by_flag(singles[i], _t(keys[i]), _t(vals[i]),
                                       mask[i])
        assert torch.equal(ok[i], ok1), i
        _tables_equal(tdhash._table(st, i), singles[i], i)
        t = targets[i]
        win = np.asarray(jbuckets.batch_winners(jnp.asarray(keys[i]),
                                                jnp.asarray(mask[i].numpy())))
        fa, fb = (jhash.HashFn(kind=f.kind, seeds=jnp.asarray(
            f.seeds.numpy().astype(np.uint32))) for f in (t.hfn_a, t.hfn_b))
        nb = t.nbuckets
        ra = jhash.bucket_of(fa, jnp.asarray(keys[i]), nb)
        rb_ = nb + jhash.bucket_of(fb, jnp.asarray(keys[i]), nb)
        tk, tv, ts = (jnp.asarray(x.numpy()) for x in before[i])
        k1, v1, s1, ok1 = jref.tc_insert_ref(tk, tv, ts, ra, rb_,
                                             jnp.asarray(keys[i]),
                                             jnp.asarray(vals[i]),
                                             jnp.asarray(win), 2)
        f_a, _, _ = jref.tc_row_lookup_ref(tk, tv, ts, ra,
                                           jnp.asarray(keys[i]))
        f_b, _, _ = jref.tc_row_lookup_ref(tk, tv, ts, rb_,
                                           jnp.asarray(keys[i]))
        pend = jnp.asarray(win) & ~ok1 & ~(f_a | f_b)
        k2, v2, s2, done = jref.cuckoo_kick_ref(
            k1, v1, s1, ra, rb_, fa, fb, nb, jnp.asarray(keys[i]),
            jnp.asarray(vals[i]), pend, t.max_kick)
        got = tdhash._table(st, i).new if bool(rb[i]) else \
            tdhash._table(st, i).old
        for a, b in zip((got.key, got.val, got.state), (k2, v2, s2)):
            assert np.array_equal(a.numpy(), np.asarray(b)), i
        assert np.array_equal(ok[i].numpy(), np.asarray(ok1 | done)), i
        placed_by_kick += int((np.asarray(done) & np.asarray(pend)).sum())
        assert np.asarray(pend).any(), (i, "nothing left for the kick-out")
    assert placed_by_kick > 0


def _counting(monkeypatch) -> dict:
    """Count the calls of every kernel wrapper by the kernel it launches."""
    calls = dict.fromkeys(probe.KERNELS, 0)
    names = {**{k: k for k in probe.KERNELS},
             "probe_lookup_hashed": "probe_lookup",
             "tc_lookup_hashed": "tc_lookup", "cuckoo_insert": "tc_insert",
             "transition": "extract"}
    for fn, kernel in names.items():
        orig = getattr(probe, fn)

        def wrapped(*a, _orig=orig, _k=kernel, **k):
            calls[_k] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(probe, fn, wrapped)
    return calls


def _stack_ops(st, keys):
    k, m = _t(keys), torch.ones(keys.shape, dtype=torch.bool)
    n = keys.shape[0]
    yield "start", lambda: tdhash.stack_autostart(
        st, torch.arange(n) % 2 == 0)
    yield "insert", lambda: tdhash.stack_insert(st, k, k, m)
    yield "lookup", lambda: tdhash.stack_lookup(st, k)
    yield "counted", lambda: tdhash.stack_lookup_counted_(st, k)
    yield "delete", lambda: tdhash.stack_delete(st, k, m)
    yield "step", lambda: tdhash.stack_rebuild_step(st)
    yield "finish", lambda: tdhash.stack_finish_same_shape(st)


@pytest.mark.parametrize("name,fused", AXIS)
def test_stack_launch_budget_counted_in_the_wrappers(name, fused,
                                                     monkeypatch):
    """Linear, twochoice and cuckoo fused: each stack op calls each kernel
    wrapper as often for T = 8 tables as for one (the table axis is the
    kernels'); every other stack loops over its tables: T times one table's
    calls."""
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(3)
    per = {}
    for n in (1, T):
        st = tdhash.make_stack(n, name, CAP, chunk=64, seed=0, fused=fused,
                               device="cpu")
        keys = _keys(rng, n, Q)
        per[n] = {}
        for op, run in _stack_ops(st, keys):
            before = dict(calls)
            run()
            per[n][op] = {k: calls[k] - before[k] for k in calls
                          if calls[k] > before[k]}
    one_launch = name in ONE_LAUNCH and fused
    for op, c1 in per[1].items():
        want = c1 if one_launch else {k: T * v for k, v in c1.items()}
        assert per[T][op] == want, (op, per[1][op], per[T][op])
    if one_launch:
        ins, probe2 = ONE_LAUNCH[name]
        assert per[T] == {"start": {"epoch_swap": 1},
                          "insert": {ins: 1},
                          "lookup": {probe2: 1}, "counted": {probe2: 1},
                          "delete": {probe2: 1},
                          "step": {ins: 1, "extract": 1},
                          "finish": {"epoch_swap": 1}}, per[T]


def test_stack_engine_continuous_rebuild_against_the_reference():
    """DHashStackEngine of both packages in lock step: inserts then lookups
    through continuous independent rebuilds (the reference's
    ``test_stack_engine_continuous_rebuild``)."""
    rng = np.random.default_rng(0)
    j0 = jdhash.make_stack(T, "linear", 128, chunk=32, seed=0)
    ref = JStackEngine(j0, continuous_rebuild=True, poll_every=4)
    eng = DHashStackEngine(_port_of(j0, True), continuous_rebuild=True,
                           poll_every=4)
    keys = _keys(rng, n=128)
    none_i = np.zeros((T, 1), np.int32)
    off = np.zeros((T, 1), bool)
    batches = [(keys[:, j:j + 32], keys[:, j:j + 32], keys[:, j:j + 32] * 3,
                none_i, None, off) for j in range(0, 128, 32)]
    batches += [(keys[:, :32], none_i, none_i, none_i, off, off)] * 30
    for lk, ik, iv, dk, im, dm in batches:
        got = eng.step(lk, ik, iv, dk, ins_mask=im, del_mask=dm)
        want = ref.step(lk, ik, iv, dk, ins_mask=im, del_mask=dm)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(eng.state.epoch.numpy(),
                              np.asarray(ref.state.epoch))
    f, v, _, _ = got
    assert bool(f.all()) and np.array_equal(v.numpy(), keys[:, :32] * 3)
    assert np.array_equal(eng.counts(), np.full(T, 128))
    assert np.array_equal(eng.counts(), ref.counts())
    assert eng.stats.rebuilds_completed >= T
    assert eng.stats.rebuilds_completed == ref.stats.rebuilds_completed
    # the poll is one read of epoch[T]: one a poll, and one each for the
    # two counts and the stats refresh
    assert eng._stats.host_syncs == len(batches) // 4 + 2 + (
        len(batches) % 4 != 0)


def test_stack_engine_masked_request_rebuild():
    j0 = jdhash.make_stack(4, "twochoice", 256, chunk=32, seed=0)
    eng = DHashStackEngine(_port_of(j0, True))
    ref = JStackEngine(j0)
    mask = np.array([True, False, True, False])
    eng.request_rebuild(mask)
    ref.request_rebuild(mask)
    assert eng.state.rebuilding.tolist() == mask.tolist()
    assert np.array_equal(eng.state.rebuilding.numpy(),
                          np.asarray(ref.state.rebuilding))
    assert eng._stats.host_syncs == 0
    p, r = convert.state_to_numpy(eng.state), jax_state_tree(ref.state)
    for k in ("hfn_a", "hfn_b"):
        assert np.array_equal(p["new"][k]["seeds"], r["new"][k]["seeds"])


def test_stack_engine_one_key_across_staggered_swaps_and_outputs_survive():
    """Every decision is a device flag: the step keeps one key while the
    tables start and swap at different steps; a step's outputs are the
    caller's (step n's survive step n + 1)."""
    rng = np.random.default_rng(1)
    st = tdhash.make_stack(4, "linear", 64, chunk=32, seed=2, fused=True,
                           device="cpu")
    eng = DHashStackEngine(st, poll_every=3)
    keys = _keys(rng, 4, 96)
    q = 16
    prev = None
    for step in range(30):
        if step in (0, 7):
            eng.request_rebuild(np.arange(4) % 2 == (step == 7))
        k = keys[:, (step % 6) * q:(step % 6 + 1) * q]
        out = eng.step(k, k, k * 2, k[:, ::-1].copy())
        if prev is not None:
            for a, b in zip(prev[0], prev[1]):
                assert torch.equal(a, b)
        prev = (out, tuple(o.clone() for o in out))
    ep = eng.state.epoch.tolist()
    assert ep[0] >= 1 and ep[1] >= 1, ep
    assert len(eng._step_keys) == 1 and eng._step_cache_size() == 1


def test_stack_engine_checks_its_operands_and_policy():
    st = tdhash.make_stack(2, "linear", 64, chunk=32, device="cpu")
    eng = DHashStackEngine(st)
    with pytest.raises(ValueError):
        eng.step(np.zeros(4, np.int32), np.zeros(4, np.int32),
                 np.zeros(4, np.int32), np.zeros(4, np.int32))
    from repro_torch.core import policy
    with pytest.raises(ValueError):
        DHashStackEngine(st, policy=policy.make(device="cpu"))
    with pytest.raises(ValueError):
        DHashStackEngine(st, continuous_rebuild=True,
                         policy=policy.make(in_place=True, device="cpu"))
    eng = DHashStackEngine(st, policy=policy.make(in_place=True,
                                                  device="cpu"))
    assert eng.policy.armed.shape == (2,) and eng.policy.fires.shape == (2,)


# ---------------------------------------------------------------------------
# the glue's row axis, conversion, the eager mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("multiply_shift", "mix32", "tabulation"))
@pytest.mark.parametrize("nbuckets", (1 << 12, 3001))
def test_bucket_of_hashes_each_row_by_its_own_function(kind, nbuckets):
    """Stacked seeds [T, ...] against keys [T, Q]: row t by function t,
    bit for bit the reference's (tables whose seeds differ)."""
    from repro.core import hashing as jhash
    from repro_torch.core import hashing as thash
    rng = np.random.default_rng(5)
    fns = [jhash.fresh(kind, 11 + t) for t in range(4)]
    keys = rng.integers(-(1 << 31), (1 << 31) - 1, (4, 200)).astype(np.int32)
    stacked = thash.HashFn(kind=kind, seeds=torch.as_tensor(
        np.stack([np.asarray(f.seeds) for f in fns]).astype(np.int64)))
    got = thash.bucket_of(stacked, torch.as_tensor(keys), nbuckets).numpy()
    want = np.stack([np.asarray(jhash.bucket_of(f, jnp.asarray(k), nbuckets))
                     for f, k in zip(fns, keys)])
    assert np.array_equal(got, want)
    assert thash.lead_shape(stacked) == (4,)


def test_batch_winners_dedups_within_each_row_only():
    """[T, Q]: one sort for the stack; the same key in two rows wins in
    both; each row equals the reference's ``batch_winners`` of that row."""
    from repro.core import buckets as jbuckets
    from repro_torch.core import buckets as tbuckets
    rng = np.random.default_rng(6)
    keys = rng.integers(-5, 5, (6, 40)).astype(np.int32)
    keys[1] = keys[0]
    mask = rng.random((6, 40)) < 0.7
    mask[1] = mask[0]
    got = tbuckets.batch_winners(torch.as_tensor(keys),
                                 torch.as_tensor(mask)).numpy()
    want = np.stack([np.asarray(jbuckets.batch_winners(jnp.asarray(k),
                                                       jnp.asarray(m)))
                     for k, m in zip(keys, mask)])
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], got[1]) and got[0].any()


@pytest.mark.parametrize("name", BACKENDS)
def test_counts_reduce_each_table(name):
    """``count_live`` / ``count_tomb`` on a stack give [T], each table's
    own count."""
    from repro_torch.core import backend as tbe
    st = tdhash.make_stack(3, name, 128, chunk=32, seed=4, device="cpu")
    be = tbe.get(name)
    for t in range(3):
        k = torch.arange(1, 20 * (t + 1) + 1, dtype=torch.int32) + 1000 * t
        tdhash.insert_by_flag(tdhash._table(st, t), k, k)
        tdhash._ordered_delete_(tdhash._table(st, t), k[:t + 1],
                                torch.ones(t + 1, dtype=torch.bool))
    live, tomb = be.count_live(st.old), be.count_tomb(st.old)
    assert live.shape == tomb.shape == (3,)
    for t in range(3):
        view = tdhash._table(st, t)
        assert int(live[t]) == int(be.count_live(view.old)) == 19 * (t + 1)
        assert int(tomb[t]) == int(be.count_tomb(view.old))
    assert tdhash.stack_count_items(st).tolist() == [19, 38, 57]


def test_stacked_state_round_trips_through_convert_mid_rebuild():
    j = jdhash.make_stack(4, "twochoice", 128, chunk=32, seed=1)
    keys = _keys(np.random.default_rng(2), 4, 64)
    j, _ = _J["insert"](j, jnp.asarray(keys), jnp.asarray(keys))
    j = _J["start"](j, jnp.asarray([True, False, True, False]))
    j = _J["step"](j)
    tree = jax_state_tree(j)
    back = convert.state_to_numpy(convert.state_from_numpy(tree,
                                                           device="cpu"))
    for k, v in tree.items():
        if k in ("old", "new"):
            for f, x in v.items():
                a = x["seeds"] if isinstance(x, dict) else x
                b = back[k][f]["seeds"] if isinstance(x, dict) else back[k][f]
                assert np.array_equal(a, b), (k, f)
        else:
            assert np.array_equal(np.asarray(v), np.asarray(back[k])), k
    assert back["cursor"].shape == (4,) and back["hazard_live"].any()


def test_stack_engine_eager_mode_runs_the_step_without_a_key():
    from repro_torch.core import engine as eng_mod
    st = tdhash.make_stack(2, "linear", 64, chunk=32, fused=True,
                           device="cpu")
    a, b = DHashStackEngine(st), DHashStackEngine(st)
    keys = _keys(np.random.default_rng(8), 2, 16)
    with eng_mod._eager():
        got = a.step(keys, keys, keys, keys[:, :4])
    want = b.step(keys, keys, keys, keys[:, :4])
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert a._step_keys == [] and len(b._step_keys) == 1
