"""Port vs reference: the router of ``core/distributed.py``.

The same seeded numpy inputs go through the JAX ``_route`` and the port's,
and every one of the twelve ``Route`` fields must be equal (tolerance 0):
S in {1, 3, 8, 64} shards, no skew, zipf skew and 100% on one owner, the
full-width cap and caps below it, the overflow-proof, a compact and no
spill slab; a [S_src, Q] batch routes each source row as the reference
routes that row alone (the in-process form).  Also held: the reference's
``route_cap`` / ``route_spill_cap`` cases, ``_route_payload`` and
``_unroute`` (a dropped float comes back NaN), ``shard_of`` and
``grid_owner`` bit for bit on the three hash kinds, and that ``_route``
issues no ``aten.sort`` and reads nothing on the host (a
``TorchDispatchMode`` counts the ops).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import distributed as jdd  # noqa: E402
from repro.core import hashing as jhash  # noqa: E402
from repro_torch.core import distributed as tdd  # noqa: E402
from repro_torch.core import hashing as thash  # noqa: E402

FIELDS = ("send", "smask", "owner", "rank", "kept", "overflow", "cap",
          "spill_cap", "spill_rank", "served", "slab_owner", "dropped")
Q = 96


def _owners(skew: str, rng, q: int, s: int) -> np.ndarray:
    if skew == "none":
        return rng.integers(0, s, q).astype(np.int32)
    if skew == "zipf":
        return np.minimum(rng.zipf(1.3, q) - 1, s - 1).astype(np.int32)
    return np.full(q, s - 1, np.int32)                 # 100% one owner


def _caps(q: int, s: int) -> list:
    """The full width and caps below it (one key an owner at least)."""
    return sorted({q, tdd.route_cap(2.0, q, s), tdd.route_cap(1.0, q, s),
                   max(1, q // (2 * s))}, reverse=True)


def _slabs(q: int, cap: int) -> list:
    """Overflow-proof, compact and no slab."""
    return [tdd.route_spill_cap(q, cap), tdd.route_spill_cap(q, cap, 0.1),
            0]


def _same_route(port, ref, where):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(b, int):
            assert a == b, (where, f)
            continue
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (where, f, a.shape, b.shape)
        assert np.array_equal(a, b), (where, f)


@pytest.mark.parametrize("s", (1, 3, 8, 64))
@pytest.mark.parametrize("skew", ("none", "zipf", "one"))
def test_route_equals_the_reference_field_for_field(s, skew):
    rng = np.random.default_rng(100 * s + len(skew))
    keys = rng.choice(1 << 20, Q, replace=False).astype(np.int32) - (1 << 19)
    owner = _owners(skew, rng, Q, s)
    for cap in _caps(Q, s):
        for spill in _slabs(Q, cap):
            ref = jdd._route(jnp.asarray(keys), jnp.asarray(owner), s, cap,
                             spill)
            port = tdd._route(torch.as_tensor(keys), torch.as_tensor(owner),
                              s, cap, spill)
            _same_route(port, ref, (s, skew, cap, spill))
            # exact accounting closes, as the reference's tests state it
            assert int(port.served.sum()) + int(port.dropped.sum()) == Q
    # cap None is the full width, as the reference's
    _same_route(tdd._route(torch.as_tensor(keys), torch.as_tensor(owner), s),
                jdd._route(jnp.asarray(keys), jnp.asarray(owner), s),
                (s, skew, None))


@pytest.mark.parametrize("skew", ("none", "zipf", "one"))
def test_route_of_source_rows_is_each_row_routed_alone(skew):
    """The in-process form: [S_src, Q] batches, one Route with a leading
    source axis, each row the reference's route of that row."""
    s, rows = 8, 3
    rng = np.random.default_rng(7 + len(skew))
    keys = rng.integers(-(1 << 30), 1 << 30, (rows, Q)).astype(np.int32)
    owner = np.stack([_owners(skew, rng, Q, s) for _ in range(rows)])
    cap = tdd.route_cap(1.0, Q, s)
    for spill in _slabs(Q, cap):
        port = tdd._route(torch.as_tensor(keys), torch.as_tensor(owner), s,
                          cap, spill)
        for r in range(rows):
            ref = jdd._route(jnp.asarray(keys[r]), jnp.asarray(owner[r]), s,
                             cap, spill)
            row = tdd.Route(*(x[r] if isinstance(x, torch.Tensor) else x
                              for x in port))
            _same_route(row, ref, (skew, spill, r))


def test_route_cap_and_spill_cap_are_the_references():
    cases = [(2.0, 64, 8), (1.0, 64, 8), (1.0, 65, 8), (2.0, 128, 64),
             (0.0, 64, 8), (-1.0, 64, 8), (0.01, 4, 64), (100.0, 8, 2),
             (1.1, 9, 1), (1.25, 10, 4), (1.5, 3, 2), (2.0, 1024, 8),
             (2.0, 1024, 64), (2.0, 48, 6), (2.0, 16, 8)]
    for c in cases:
        assert tdd.route_cap(*c) == jdd.route_cap(*c), c
    spills = [(64, 16), (64, 64), (64, 100), (64, 16, 0.25), (64, 16, 1.0),
              (64, 16, 5.0), (64, 16, 0.001), (64, 16, 0.0), (64, 16, -1.0),
              (1024, 640, 0.375)]
    for c in spills:
        assert tdd.route_spill_cap(*c) == jdd.route_spill_cap(*c), c
    # the policy's controller sizes its slab with the same functions
    from repro_torch.core import policy
    assert policy.route_cap is tdd.route_cap
    assert policy.route_spill_cap is tdd.route_spill_cap


def test_payload_and_unroute_equal_the_references_and_fill_nan():
    rng = np.random.default_rng(5)
    s = 4
    keys = rng.choice(10_000, Q, replace=False).astype(np.int32)
    owner = np.where(rng.random(Q) < 0.6, 0, keys * 7 % s).astype(np.int32)
    cap = tdd.route_cap(1.0, Q, s)
    spill = tdd.route_spill_cap(Q, cap, 0.1)        # a compact slab: drops
    ref = jdd._route(jnp.asarray(keys), jnp.asarray(owner), s, cap, spill)
    port = tdd._route(torch.as_tensor(keys), torch.as_tensor(owner), s, cap,
                      spill)
    assert int(port.dropped.sum()) > 0
    pay = keys * 3 + 1
    assert np.array_equal(
        tdd._route_payload(torch.as_tensor(pay), port).numpy(),
        np.asarray(jdd._route_payload(jnp.asarray(pay), ref)))
    assert np.array_equal(tdd._route_col(port).numpy(),
                          np.asarray(jdd._route_col(ref)))
    resp = np.asarray(ref.send) * 5 - 2
    for fill in (None, -1):
        assert np.array_equal(
            tdd._unroute(torch.as_tensor(resp), port, fill=fill).numpy(),
            np.asarray(jdd._unroute(jnp.asarray(resp), ref, fill=fill)))
    # a dropped float never reads as a real 0.0
    fresp = resp.astype(np.float32) * 0.5
    back = tdd._unroute(torch.as_tensor(fresp), port).numpy()
    want = np.asarray(jdd._unroute(jnp.asarray(fresp), ref))
    served = port.served.numpy()
    assert np.isnan(back[~served]).all() and np.isnan(want[~served]).all()
    assert np.array_equal(back[served], want[served])
    boolr = tdd._unroute(port.smask, port, fill=False)
    assert boolr.dtype == torch.bool and np.array_equal(
        boolr.numpy(), np.asarray(jdd._unroute(ref.smask, ref, fill=False)))


@pytest.mark.parametrize("kind", ("multiply_shift", "mix32", "tabulation"))
def test_shard_of_and_grid_owner_bit_for_bit(kind):
    rng = np.random.default_rng(11)
    keys = rng.integers(-(1 << 31), (1 << 31) - 1, 500).astype(np.int32)
    tenant = rng.integers(0, 3, 500).astype(np.int32)
    jf = jhash.fresh(kind, 7)
    tf = thash.fresh(kind, 7, device="cpu")
    for s in (1, 2, 3, 8):
        assert np.array_equal(
            tdd.shard_of(torch.as_tensor(keys), s, tf).numpy(),
            np.asarray(jdd.shard_of(jnp.asarray(keys), s, jf)))
        assert np.array_equal(
            tdd.grid_owner(torch.as_tensor(keys), torch.as_tensor(tenant), s,
                           3, tf).numpy(),
            np.asarray(jdd.grid_owner(jnp.asarray(keys), jnp.asarray(tenant),
                                      s, 3, jf)))
    # a [S_src, Q] batch hashes row by row with the one owner function
    two = torch.as_tensor(keys.reshape(2, 250))
    assert torch.equal(tdd.shard_of(two, 8, tf).view(-1),
                       tdd.shard_of(torch.as_tensor(keys), 8, tf))


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("spill", (None, 0.1, 0.0))
def test_route_issues_no_sort_and_no_host_read(spill):
    rng = np.random.default_rng(3)
    keys = torch.as_tensor(rng.integers(0, 1 << 30, (4, 256)).astype(
        np.int32))
    owner = torch.as_tensor(rng.integers(0, 8, (4, 256)).astype(np.int32))
    cap = tdd.route_cap(1.0, 256, 8)
    with _Ops() as ops:
        rt = tdd._route(keys, owner, 8, cap,
                        tdd.route_spill_cap(256, cap, spill))
        tdd._unroute(rt.send, rt)
        tdd._route_payload(keys, rt)
    assert ops.names, "nothing was counted"
    assert not [n for n in ops.names if "sort" in n], ops.names
    # a host read is aten._local_scalar_dense (item, bool, int)
    assert not [n for n in ops.names if "local_scalar" in n], ops.names
