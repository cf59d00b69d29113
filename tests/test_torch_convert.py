"""State carried across: JAX state -> numpy tree -> port -> numpy tree is the
identity (mid-rebuild, with a non-empty hazard buffer, included), and the
helpers the other port tests use to flatten a reference state."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import dhash as jdhash  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dhash as tdhash  # noqa: E402

SCALARS = ("cursor", "rebuilding", "epoch", "lookups", "expensive")
STATIC = ("backend", "chunk", "fwd_hazard", "fused", "nres_cap")


def _hfn_tree(fn) -> dict:
    return {"kind": fn.kind, "seeds": np.asarray(fn.seeds)}


CHAIN_ARRAYS = ("akey", "aval", "anext", "astate", "heads", "free_stack",
                "free_top", "bstart", "blen", "sorted_upto")


def jax_table_tree(t) -> dict:
    """Flatten a reference table (linear, twochoice, cuckoo or chain)."""
    if hasattr(t, "arena"):
        tree = {"nbuckets": t.nbuckets, "arena": t.arena,
                "max_chain": t.max_chain, "dirty_cap": t.dirty_cap,
                "hfn": _hfn_tree(t.hfn)}
        tree.update({f: np.asarray(getattr(t, f)) for f in CHAIN_ARRAYS})
        return tree
    if hasattr(t, "hfn"):
        tree = {"capacity": t.capacity, "max_probes": t.max_probes,
                "hfn": _hfn_tree(t.hfn)}
    else:
        last = "max_rounds" if hasattr(t, "max_rounds") else "max_kick"
        tree = {"nbuckets": t.nbuckets, "width": t.width,
                last: getattr(t, last), "hfn_a": _hfn_tree(t.hfn_a),
                "hfn_b": _hfn_tree(t.hfn_b)}
    tree.update(key=np.asarray(t.key), val=np.asarray(t.val),
                state=np.asarray(t.state))
    return tree


def jax_state_tree(d) -> dict:
    """Flatten a reference ``DHashState`` (any backend) to the tree layout
    of ``repro_torch.convert``."""
    tree = {k: getattr(d, k) for k in STATIC}
    tree["old"], tree["new"] = jax_table_tree(d.old), jax_table_tree(d.new)
    for k in ("hazard_key", "hazard_val", "hazard_live") + SCALARS:
        tree[k] = np.asarray(getattr(d, k))
    return tree


def assert_tree_equal(a, b, path=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)) or (
        isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


def _mid_rebuild_state(fused: bool, backend: str = "linear"):
    d = jdhash.make(backend, capacity=96, chunk=32, seed=3, fused=fused)
    keys = jnp.arange(-40, 40, dtype=jnp.int32)
    d, _ = jdhash.insert(d, keys, keys * 11)
    d = jdhash.rebuild_start(d, seed=77)
    d = jdhash.rebuild_extract(d)
    d, _ = jdhash.delete(d, keys[:10])
    assert bool(d.hazard_live.any()) and bool(d.rebuilding)
    return d


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mid_rebuild", [False, True])
def test_jax_to_port_and_back_is_identity(fused, mid_rebuild):
    d = _mid_rebuild_state(fused) if mid_rebuild else jdhash.make(
        "linear", capacity=50, chunk=16, seed=1, fused=fused)
    tree = jax_state_tree(d)
    port = convert.state_from_numpy(tree, device="cpu")
    assert isinstance(port, tdhash.DHashState)
    assert port.device.type == "cpu" and port.fused == fused
    assert port.old.key.dtype == torch.int32
    assert port.hazard_live.dtype == torch.bool
    assert port.cursor.dtype == torch.int32 and port.cursor.dim() == 0
    assert port.old.hfn.seeds.dtype == torch.int64
    assert not hasattr(port.old, "claim")  # a linear table keeps no claim
    #                                        scratch (the two-row tables do)
    assert_tree_equal(tree, convert.state_to_numpy(port))


def test_port_make_equals_reference_make():
    """The same arguments build the same bytes in both packages."""
    for cap, chunk, seed in ((50, 16, 0), (1000, 64, 9)):
        want = jax_state_tree(jdhash.make("linear", capacity=cap, chunk=chunk,
                                          seed=seed))
        got = convert.state_to_numpy(tdhash.make(
            "linear", capacity=cap, chunk=chunk, seed=seed, device="cpu"))
        assert_tree_equal(want, got)


def test_table_round_trip_and_independence():
    d = _mid_rebuild_state(False)
    tree = jax_table_tree(d.old)
    t = convert.table_from_numpy(tree, device="cpu")
    assert_tree_equal(tree, convert.table_to_numpy(t))
    t.state.zero_()                        # the port owns its copy
    assert tree["state"].any()


def test_converted_state_answers_like_the_reference():
    d = _mid_rebuild_state(True)
    port = convert.state_from_numpy(jax_state_tree(d), device="cpu")
    q = np.arange(-60, 60, dtype=np.int32)
    jf, jv = jdhash.lookup(d, jnp.asarray(q))
    tf, tv = tdhash.lookup(port, torch.as_tensor(q))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert int(jdhash.count_items(d)) == int(tdhash.count_items(port))


@pytest.mark.parametrize("backend", ["twochoice", "cuckoo"])
def test_two_row_tables_round_trip(backend):
    """A twochoice / cuckoo state mid-rebuild: JAX -> tree -> port -> tree
    is the identity, the port's tables are [R, W] of the reference's type
    and field names, and the converted state answers like the reference."""
    from repro_torch.core import buckets as tb
    d = _mid_rebuild_state(False, backend)
    tree = jax_state_tree(d)
    port = convert.state_from_numpy(tree, device="cpu")
    cls = {"twochoice": tb.TwoChoiceTable, "cuckoo": tb.CuckooTable}[backend]
    assert isinstance(port.old, cls) and isinstance(port.new, cls)
    rows = port.old.nbuckets * (2 if backend == "cuckoo" else 1)
    assert port.old.key.shape == (rows, port.old.width)
    assert port.old.claim is None
    assert_tree_equal(tree, convert.state_to_numpy(port))
    t = convert.table_from_numpy(tree["new"], device="cpu")
    assert isinstance(t, cls)
    assert_tree_equal(tree["new"], convert.table_to_numpy(t))
    q = np.arange(-60, 60, dtype=np.int32)
    jf, jv = jdhash.lookup(d, jnp.asarray(q))
    tf, tv = tdhash.lookup(port, torch.as_tensor(q))
    assert np.array_equal(np.asarray(jf), tf.numpy()) and tf.any()
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert int(jdhash.count_items(d)) == int(tdhash.count_items(port))


@pytest.mark.parametrize("fused", [False, True])
def test_chain_tables_round_trip(fused):
    """A chain state mid-rebuild (hazard buffer open, tombstones, a
    compacted old arena when fused): JAX -> tree -> port -> tree is the
    identity with every arena array (free stack, free_top, bstart, blen,
    sorted_upto included), the port's tables are ``ChainTable``s with the
    reference's field types, and the converted state answers like the
    reference.  ``dhash.make`` builds the reference's bytes."""
    from repro_torch.core import buckets as tb
    d = _mid_rebuild_state(fused, "chain")
    tree = jax_state_tree(d)
    port = convert.state_from_numpy(tree, device="cpu")
    assert isinstance(port.old, tb.ChainTable)
    assert port.old.free_top.dim() == 0 and port.old.sorted_upto.dim() == 0
    assert port.old.heads.shape == (port.old.nbuckets,)
    assert port.old.akey.dtype == torch.int32
    assert_tree_equal(tree, convert.state_to_numpy(port))
    if fused:
        assert int(tree["old"]["sorted_upto"]) > 0, "compacted at the start"
    t = convert.table_from_numpy(tree["new"], device="cpu")
    assert isinstance(t, tb.ChainTable)
    assert_tree_equal(tree["new"], convert.table_to_numpy(t))
    q = np.arange(-60, 60, dtype=np.int32)
    jf, jv = jdhash.lookup(d, jnp.asarray(q))
    tf, tv = tdhash.lookup(port, torch.as_tensor(q))
    assert np.array_equal(np.asarray(jf), tf.numpy()) and tf.any()
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert int(jdhash.count_items(d)) == int(tdhash.count_items(port))
    want = jax_state_tree(jdhash.make("chain", capacity=300, chunk=64,
                                      seed=8))
    got = convert.state_to_numpy(tdhash.make("chain", capacity=300,
                                             chunk=64, seed=8, device="cpu"))
    assert_tree_equal(want, got)
