"""Port vs reference: the ported main path as a whole — ``DHashEngine`` of
both packages in lock step.

Both engines start from the same converted initial state and take the same
numpy op stream in continuous-rebuild mode for at least three rebuild epochs
on a small table.  Every step's four outputs are equal; ``epoch``,
``rebuilding`` and the cursor are equal after every step; at the end the
state is equal slot for slot against the reference's ``fused=False`` engine
and as live key -> value maps plus scalars against its ``fused=True`` engine.
A dict oracle checks the answers themselves.  Tolerance 0.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import dhash as jdhash  # noqa: E402
from repro.core.engine import DHashEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402
from repro_torch.core import struct_utils  # noqa: E402
from repro_torch.core.engine import DHashEngine as TEngine  # noqa: E402
from test_torch_convert import jax_state_tree  # noqa: E402
from test_torch_dhash import compare_states  # noqa: E402

NL, NU = 32, 8          # lookups / updates a step (fixed widths, masked)


def stream(seed: int, steps: int, universe: int = 200):
    """Yields (look, ins, ins_vals, ins_mask, dels, del_mask) and keeps the
    dict oracle; never re-inserts a live key (as the reference's own fuzz)."""
    rng = np.random.default_rng(seed)
    oracle: dict[int, int] = {}
    keys = np.arange(-universe // 2, universe // 2)
    for step in range(steps):
        ins = rng.choice(keys, NU).astype(np.int32)          # may repeat
        ins_mask = np.array([int(k) not in oracle for k in ins])
        live = list(oracle) or [0]
        dels = rng.choice(live, NU).astype(np.int32)
        del_mask = rng.random(NU) < 0.6
        look = rng.choice(keys, NL).astype(np.int32)
        vals = (ins * 3 + step).astype(np.int32)
        yield step, dict(oracle), (look, ins, vals, ins_mask, dels, del_mask)
        seen = set()
        for k, v, m in zip(ins.tolist(), vals.tolist(), ins_mask.tolist()):
            if m and k not in seen:     # first MASKED occurrence wins
                oracle[k] = v
                seen.add(k)
        seen = set()
        for k, m in zip(dels.tolist(), del_mask.tolist()):
            if m and k not in seen:
                oracle.pop(k, None)
                seen.add(k)
    yield None, oracle, None


def scalars_equal(port, *refs):
    for f in ("epoch", "rebuilding", "cursor"):
        got = getattr(port.state, f).item()
        for r in refs:
            assert got == np.asarray(getattr(r.state, f)).item(), f


@pytest.mark.parametrize("port_fused", [False, True])
def test_engines_in_lock_step_three_epochs(port_fused):
    d0 = jdhash.make("linear", capacity=96, chunk=32, seed=4)
    tree = jax_state_tree(d0)
    port_state = convert.state_from_numpy({**tree, "fused": port_fused},
                                          device="cpu")
    port = TEngine(port_state, continuous_rebuild=True, poll_every=8)
    plain = JEngine(jdhash.make("linear", capacity=96, chunk=32, seed=4,
                                fused=False),
                    continuous_rebuild=True, poll_every=8)
    fused = JEngine(jdhash.make("linear", capacity=96, chunk=32, seed=4,
                                fused=True),
                    continuous_rebuild=True, poll_every=8)
    seeds0 = port.state.old.hfn.seeds.clone()
    steps = 60
    for step, pre, batch in stream(7, steps):
        if step is None:
            final = pre
            break
        look, ins, vals, im, dels, dm = batch
        out = port.step(look, ins, vals, dels, ins_mask=im, del_mask=dm)
        for ref in (plain, fused):
            rout = ref.step(look, ins, vals, dels, ins_mask=im, del_mask=dm)
            for a, b, n in zip(out, rout, ("found", "vals", "ok_i", "ok_d")):
                assert np.array_equal(a.numpy(), np.asarray(b)), (step, n)
        scalars_equal(port, plain, fused)
        f, v = out[0].numpy(), out[1].numpy()
        for i, k in enumerate(look.tolist()):
            assert f[i] == (k in pre), (step, k)
            if k in pre:
                assert v[i] == pre[k], (step, k)
    # host reads: the polls only (the raw counter: reading ``stats``
    # refreshes it with one more read, as the reference's does)
    assert port._stats.host_syncs == steps // 8
    assert port.stats.rebuilds_completed >= 3
    assert port.stats.rebuilds_completed == plain.stats.rebuilds_completed \
        == fused.stats.rebuilds_completed
    compare_states(port.state, plain.state, fused.state, "end")
    assert not torch.equal(seeds0, port.state.old.hfn.seeds), "no reseed"
    # counts at quiescence only: drain the epoch in flight without traffic
    z, off = np.zeros(1, np.int32), np.zeros(1, bool)
    epoch = port.stats.rebuilds_completed
    for _ in range(40):
        if port.stats.rebuilds_completed > epoch:
            break
        for e in (port, plain, fused):
            e.step(z, z, z, z, ins_mask=off, del_mask=off)
    assert port.count() == plain.count() == fused.count() == len(final)


@pytest.mark.parametrize("backend", ["twochoice", "cuckoo"])
def test_fused_two_row_engine_matches_dict_oracle_and_reference(backend):
    """The two-row backends on the fused path end to end, as the reference's
    ``test_fused_twochoice_engine_matches_dict_oracle``: the port's fused
    engine and the reference's fused and plain engines take one op stream in
    continuous-rebuild mode.  Every step's answers are equal (values where
    found: the plain two-row lookup's value of a miss is unspecified) and
    right by a dict oracle; the twochoice state is the reference plain
    engine's slot for slot after every step (the fused cuckoo insert is a
    linearisation of its own: its whole key -> value map is compared)."""
    _fused_engine_against_references(
        backend, exact_to="plain" if backend == "twochoice" else None)


def test_fused_chain_engine_matches_dict_oracle_and_reference():
    """The chain backend on the fused path end to end: the same lock step,
    the port's fused chain engine held slot for slot to the reference's
    fused one after every step (both compact the arena at each epoch's start
    and past the dirty window, which the plain path never does: against the
    reference's plain engine the key -> value maps are compared), through
    at least three live hash-function swaps."""
    _fused_engine_against_references("chain", exact_to="fused")


def _fused_engine_against_references(backend: str, exact_to: str | None):
    kw = dict(capacity=96, chunk=32, seed=4)
    tree = jax_state_tree(jdhash.make(backend, **kw))
    port = TEngine(convert.state_from_numpy({**tree, "fused": True},
                                            device="cpu"),
                   continuous_rebuild=True, poll_every=8)
    refs = [JEngine(jdhash.make(backend, fused=f, **kw),
                    continuous_rebuild=True, poll_every=8)
            for f in (False, True)]
    if exact_to == "fused":
        refs = refs[::-1]            # the reference the port follows first
    hash_fns = tbe.get(backend).hash_fns
    seeds0 = [h.seeds.clone() for h in hash_fns(port.state.old)]
    for step, pre, batch in stream(11, 60):
        if step is None:
            final = pre
            break
        look, ins, vals, im, dels, dm = batch
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
        if exact_to:
            scalars_equal(port, refs[0])
        compare_states(port.state, refs[0].state, refs[1].state, step,
                       exact=exact_to is not None, in_step=False)
    assert port.stats.rebuilds_completed >= 3
    assert all(not torch.equal(a, b.seeds) for a, b in zip(
        seeds0, hash_fns(port.state.old)))
    z, off = np.zeros(1, np.int32), np.zeros(1, bool)
    for e in (port, *refs):
        epoch = e.stats.rebuilds_completed
        for _ in range(40):
            if e.stats.rebuilds_completed > epoch:
                break
            e.step(z, z, z, z, ins_mask=off, del_mask=off)
    assert port.count() == refs[0].count() == refs[1].count() == len(final)


def test_growing_rebuild_finishes_at_the_poll_like_the_reference():
    """A shape-changing rebuild (new table 4x) is swapped by the K-step poll,
    on the same step in both packages; then the engine keeps working."""
    kw = dict(capacity=48, chunk=16, seed=2)
    port = TEngine(tdhash.make("linear", fused=True, device="cpu", **kw),
                   poll_every=4)
    ref = JEngine(jdhash.make("linear", fused=False, **kw), poll_every=4)
    keys = np.arange(1, 41, dtype=np.int32)
    z, off = np.zeros(1, np.int32), np.zeros(1, bool)
    for e in (port, ref):
        e.step(keys, keys, keys * 2, z, del_mask=off)
    assert port.request_rebuild(
        new_table=tdhash._make_table("linear", 192, 9, device="cpu"))
    assert ref.request_rebuild(new_table=jdhash._make_table("linear", 192, 9))
    assert port.request_rebuild() is False          # -EBUSY
    for step in range(24):
        outs = [e.step(keys, z, z, keys[step:step + 1], ins_mask=off)
                for e in (port, ref)]
        for a, b in zip(*outs):
            assert np.array_equal(a.numpy(), np.asarray(b)), step
        scalars_equal(port, ref)
    assert port.stats.rebuilds_completed == ref.stats.rebuilds_completed == 1
    assert port.state.old.capacity == 512 and not port.rebuilding
    compare_states(port.state, ref.state, ref.state, "after growth")
    assert port.count() == ref.count() == 40 - 24


def test_steady_state_steps_read_nothing_and_engine_owns_its_state():
    d = tdhash.make("linear", capacity=64, chunk=16, seed=1, fused=True,
                    device="cpu")
    eng = TEngine(d)
    keys = np.arange(1, 33, dtype=np.int32)
    z, off = np.zeros(1, np.int32), np.zeros(1, bool)
    for _ in range(5):
        eng.step(keys, keys, keys * 2, z, del_mask=off)
    # the raw counter: reading ``stats`` refreshes it with one counted read
    assert eng._stats.host_syncs == 0 and eng._stats.steps == 5
    assert eng.stats.ops == 5 * (32 + 32 + 1)
    # the engine cloned the state: the caller's tensors are untouched
    assert int((d.old.state != 0).sum()) == 0
    assert int((eng.state.old.state == 1).sum()) == 32
    f, v = eng.lookup(keys)
    assert f.all() and torch.equal(v, torch.as_tensor(keys * 2))


def _quiet(eng, look, n_upd: int = 1):
    z, off = np.zeros(n_upd, np.int32), np.zeros(n_upd, bool)
    return eng.step(look, z, z, z, ins_mask=off, del_mask=off)


def test_step_cache_holds_one_key_across_continuous_swaps():
    """The counterpart of the reference's ``test_donation_no_retrace``: an
    engine in continuous rebuild keeps ONE key across steps and live swaps
    (the swap exchanges the tables' contents in place: no field is
    rebound), and a steady engine one across steps."""
    eng = TEngine(tdhash.make("linear", capacity=64, chunk=16, seed=1,
                              fused=True, device="cpu"),
                  continuous_rebuild=True, poll_every=4)
    keys = np.arange(1, 33, dtype=np.int32)
    eng.step(keys, keys, keys * 2, keys[:1], del_mask=np.zeros(1, bool))
    assert eng.rebuilding
    epoch = int(eng.state.epoch)
    for _ in range(40):
        _quiet(eng, keys)
    assert int(eng.state.epoch) >= epoch + 2
    # the first step ran with the host flag down, every later one up
    assert eng._step_cache_size() == 2 and len(eng._step_keys) == 2
    steady = TEngine(tdhash.make("linear", capacity=64, chunk=16, seed=1,
                                 device="cpu"))
    for _ in range(12):
        steady.step(keys, keys, keys * 2, keys[:8])
    assert steady._step_cache_size() == 1


def test_step_cache_gains_a_key_for_each_new_one_and_drops_dead_ones():
    """A new key for a new batch size, for a rebinding by
    ``request_rebuild`` (a fresh standby and fresh scalars) and for a
    resize; a key whose tensors are gone (the resized-away table) is
    dropped, and none is captured twice."""
    eng = TEngine(tdhash.make("linear", capacity=64, chunk=16, seed=1,
                              fused=True, device="cpu"), poll_every=4)
    keys = np.arange(1, 33, dtype=np.int32)
    _quiet(eng, keys)
    _quiet(eng, keys)
    assert eng._step_cache_size() == 1
    _quiet(eng, keys[:7])                          # a new batch size
    assert eng._step_cache_size() == 2
    assert eng.request_rebuild(seed=3)             # fresh standby, scalars
    _quiet(eng, keys)
    # the old standby is gone: the two steady keys named it
    assert eng._step_cache_size() == 1 and len(eng._step_keys) == 3
    for _ in range(40):
        _quiet(eng, keys)
        if not eng.rebuilding:
            break
    assert not eng.rebuilding
    n = len(eng._step_keys)
    assert eng.request_rebuild(
        new_table=tdhash._make_table("linear", 192, 9, device="cpu"))
    _quiet(eng, keys)                              # a resize: a new key
    assert len(eng._step_keys) == n + 1
    for _ in range(80):
        _quiet(eng, keys)
        if not eng.rebuilding:
            break
    assert eng.state.old.capacity == 512 and not eng.rebuilding
    _quiet(eng, keys)
    # the poll's swap to the grown table rebound the scalars: every key
    # that named the old ones is dropped
    assert eng._step_cache_size() == 1
    assert len(set(eng._step_keys)) == len(eng._step_keys)
    f, v = eng.lookup(keys)
    assert not f.any()


def test_outputs_of_a_step_survive_the_next():
    """A caller's results of step n are its own: step n+1 changes none of
    them (the reference returns fresh arrays; a replayed graph's outputs
    are cloned)."""
    eng = TEngine(tdhash.make("linear", capacity=64, chunk=16, seed=1,
                              fused=True, device="cpu"))
    keys = np.arange(1, 33, dtype=np.int32)
    z, off = np.zeros(1, np.int32), np.zeros(1, bool)
    first = eng.step(keys, keys, keys * 2, z, del_mask=off)
    kept = [x.clone() for x in first]
    second = eng.step(keys, keys + 100, keys, keys[:1])
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert second[0].all() and not kept[0].any()
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(first, second))


def test_policy_engine_refuses_continuous_rebuild_and_clones_its_policy():
    from repro_torch.core import policy as tpol
    d = tdhash.make("linear", capacity=16, chunk=4, device="cpu")
    pol = tpol.make(device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        TEngine(d, policy=pol, continuous_rebuild=True)
    eng = TEngine(d, policy=pol)
    assert eng.policy is not pol and eng.policy.fires is not pol.fires
    assert TEngine(d, policy=None).policy is None


def test_request_rebuild_declines_while_rebuilding():
    eng = TEngine(tdhash.make("linear", capacity=64, chunk=16, seed=1,
                              device="cpu"))
    assert eng.request_rebuild(seed=5) is True
    assert eng.rebuilding and bool(eng.state.rebuilding)
    assert eng.request_rebuild(seed=6) is False
    # same seed -> the reference's new hash function
    ref = jdhash.rebuild_start(jdhash.make("linear", capacity=64, chunk=16,
                                           seed=1), seed=5)
    assert np.array_equal(np.asarray(ref.new.hfn.seeds),
                          eng.state.new.hfn.seeds.numpy().astype(np.uint32))
    assert jax.device_get(ref.rebuilding)


def _ptrs(d) -> list:
    """The storage of every tensor of a state, in field order."""
    from repro_torch.core import backend as be
    out = [t.data_ptr() for t in (d.hazard_key, d.hazard_val, d.hazard_live,
                                  d.cursor, d.rebuilding, d.epoch)]
    for t in (d.old, d.new):
        out += [x.data_ptr() for x, _ in be.epoch_leaves(t)]
    return out


@pytest.mark.parametrize("done", [True, False], ids=["done", "mid_epoch"])
@pytest.mark.parametrize("backend", ["linear", "twochoice", "cuckoo", "chain"])
def test_device_flag_finish_and_autostart_equal_the_reference(backend, done):
    """``finish_same_shape_`` and ``rebuild_autostart_`` (the forms an engine
    step runs: decided on the device, written in place) equal the
    reference's ``finish_same_shape`` and ``rebuild_autostart`` on a fused
    state whose rebuild is done, and on one mid-epoch (then both are no-ops
    but for the autostart's own cond), on all four backends: every leaf of
    both tables, the seeds, the hazard buffer and the scalars.  Chain's
    freeze of the old arena is the reference's fused one."""
    from test_torch_convert import assert_tree_equal
    kw = dict(capacity=96, chunk=32, seed=4, fused=True)
    d = jdhash.make(backend, **kw)
    keys = np.arange(1, 61, dtype=np.int32) * 7
    d, _ = jax.jit(jdhash.insert)(d, keys, keys * 3, np.ones(60, bool))
    d = jdhash.rebuild_start(d, seed=9)
    if done:
        d = jdhash.rebuild_all(d, finish=False)
    else:
        d = jax.jit(jdhash.rebuild_chunk)(d)
    assert bool(jdhash.rebuild_done(d)) == done
    fin = jax.jit(jdhash.finish_same_shape)(d)
    auto = jax.jit(jdhash.rebuild_autostart)(fin)

    def port():
        return convert.state_from_numpy(jax_state_tree(d), device="cpu")

    p = port()
    ptrs = _ptrs(p)
    go = tdhash.finish_same_shape_(p)
    assert go.tolist() == [done, False]
    assert_tree_equal(convert.state_to_numpy(p), jax_state_tree(fin))
    go = tdhash.rebuild_autostart_(p)
    assert go.tolist() == [False, done]
    assert_tree_equal(convert.state_to_numpy(p), jax_state_tree(auto))
    assert _ptrs(p) == ptrs, "a field was rebound"
    # the continuous engine's one launch: swap and start together
    p = port()
    go = tdhash.finish_same_shape_(p, autostart=True)
    assert go.tolist() == [done, done]
    assert_tree_equal(convert.state_to_numpy(p), jax_state_tree(auto))


def test_requested_epoch_ends_between_polls_against_oracle_and_reference():
    """A non-continuous engine whose rebuild epoch ends on the device between
    two polls: the host flag stays stale until the poll, the inserts of
    those steps go to the old table (picked on the device), and every step's
    answers are right by the dict oracle and equal to the reference
    engine's, in lock step through the epoch end; afterwards every key the
    oracle holds is read back with its value, and the state equals the
    reference's."""
    kw = dict(capacity=96, chunk=32, seed=4)
    tree = jax_state_tree(jdhash.make("linear", **kw))
    port = TEngine(convert.state_from_numpy({**tree, "fused": True},
                                            device="cpu"), poll_every=8)
    plain = JEngine(jdhash.make("linear", fused=False, **kw), poll_every=8)
    fused = JEngine(jdhash.make("linear", fused=True, **kw), poll_every=8)
    epochs, stale = [], 0
    for step, pre, batch in stream(13, 48):
        if step is None:
            final = pre
            break
        if step == 3:
            for e in (port, plain, fused):
                assert e.request_rebuild(seed=77)
        look, ins, vals, im, dels, dm = batch
        out = port.step(look, ins, vals, dels, ins_mask=im, del_mask=dm)
        for ref in (plain, fused):
            rout = ref.step(look, ins, vals, dels, ins_mask=im, del_mask=dm)
            for a, b, n in zip(out, rout, ("found", "vals", "ok_i", "ok_d")):
                assert np.array_equal(a.numpy(), np.asarray(b)), (step, n)
        scalars_equal(port, plain, fused)
        f, v = out[0].numpy(), out[1].numpy()
        for i, k in enumerate(look.tolist()):
            assert f[i] == (k in pre), (step, k)
            if k in pre:
                assert v[i] == pre[k], (step, k)
        epochs.append(int(port.state.epoch))
        stale += port.rebuilding and not bool(port.state.rebuilding)
    swap_step = epochs.index(1)
    assert (swap_step + 1) % 8, "the epoch must end between polls"
    assert stale > 0, "the host flag must have been stale on some steps"
    assert port._stats.host_syncs == 48 // 8
    assert port.stats.rebuilds_completed == 1 and not port.rebuilding
    live = np.array(sorted(final), np.int32)
    f, v = port.lookup(live)
    assert bool(f.all()) and v.tolist() == [final[k] for k in live.tolist()]
    compare_states(port.state, plain.state, fused.state, "end")


@pytest.mark.parametrize("backend", ["linear", "twochoice", "cuckoo", "chain"])
def test_epoch_leaves_specs_reproduce_clear_and_reseed(backend):
    """What the epoch swap writes into the standby at a rebuild start, read
    from ``epoch_leaves``' specs (the descriptor's ``clear_fill`` and
    ``salt_offsets``), equals the descriptor's own ``clear`` after
    ``reseed`` from the new epoch + 1, on a table holding keys."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import probe
    desc = be.get(backend)
    d = tdhash.make(backend, capacity=96, chunk=32, seed=4, fused=True,
                    device="cpu")
    keys = torch.arange(1, 61, dtype=torch.int32) * 7
    for t in (d.old, d.new):
        t2, _ = desc.insert(t, keys, keys * 3,
                            torch.ones(60, dtype=torch.bool))
        struct_utils.assign_(t, t2)
    epoch = torch.tensor(6, dtype=torch.int32)
    want = desc.clear(desc.reseed(d.new, epoch + 1))
    assert int(desc.count_live(d.new)) > 0
    lo, ln = be.epoch_leaves(d.old), be.epoch_leaves(d.new)
    go = probe.epoch_swap_plain(
        [x for x, _ in lo], [x for x, _ in ln], [s for _, s in lo],
        torch.zeros_like(d.hazard_live), torch.tensor(0, dtype=torch.int32),
        torch.tensor(False), epoch, torch.tensor(0, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32), desc.capacity_of(d.old),
        False, True)
    assert go.tolist() == [False, True]
    got = [x for x, _ in be.epoch_leaves(d.new)]
    exp = [x for x, _ in be.epoch_leaves(want)]
    assert len(got) == len(exp)
    for i, (a, b) in enumerate(zip(got, exp)):
        assert torch.equal(a, b), (backend, i)
