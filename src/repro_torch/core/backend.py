"""BucketBackend descriptor protocol: ONE registry entry per backend.

The paper's headline modularity claim ("DHash ... allows programmers to
select a variety of lock-free/wait-free set algorithms as the implementation
of hash table buckets") lives here.  A backend is a frozen ``BucketBackend``
descriptor bundling everything the DHash layer needs to drive it:

* its table constructor and sizing policy (``make``), the same-geometry
  rebuild-target constructor (``fresh_like``), and the on-device hash
  refresh (``reseed``);
* the plain PyTorch op set (``lookup``/``insert``/``delete``/
  ``extract_chunk``/``count_live``/``clear`` — the oracle surface, always
  present, functional);
* the kernel-backed op set (``*_fused`` + the rebuild-epoch
  ``ordered_lookup_fused``/``ordered_delete_fused`` — ``None`` when the
  backend has no kernel path).  These UPDATE THE TABLE'S TENSORS IN PLACE
  and return a container over the same tensors;
* layout metadata kept for API parity with the reference (``nres_cap``,
  ``dirty_cap``), unused by the Hopper linear kernels;
* the optional ``lookup_fwd`` hook (MIGRATED-slot hazard forwarding).

``core/dhash.py`` contains ZERO per-backend branches: every public op
dispatches through the descriptor looked up by ``DHashState.backend``.
Only ``linear`` is registered so far; ``get`` of any other name raises the
reference's ``ValueError``.

The ``*_fused`` adapters in this module are the thin descriptor-bound glue
over ``kernels/ops.py``: hash the keys (``hashing.bucket_of``, outside the
kernels as in the reference), call the op, hand back the table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import buckets, hashing
from repro_torch.core.buckets import LinearTable, batch_winners
from repro_torch.core.struct_utils import replace
from repro_torch.kernels.ops import NRES_CAP


# ---------------------------------------------------------------------------
# the descriptor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketBackend:
    """Registry entry: everything DHash needs to drive one bucket backend.

    Uniform call surface (``t`` is the backend's table container):

      make(capacity, seed, device=..., **kw) -> t   empty table sized for
                                               capacity
      fresh_like(t, seed) -> t'                empty same-geometry table with
                                               a fresh hash function (host)
      reseed(t, salt) -> t'                    on-device hash refresh
      capacity_of(t) -> int                    scan-order capacity
      with_state(t, state') -> t'              reattach a slot state array
      lookup(t, keys) -> (found, vals, loc)
      insert(t, keys, vals, mask) -> (t', ok)
      delete(t, keys, mask) -> (t', ok)
      extract_chunk(t, cursor, n) -> (t', hkeys, hvals, hlive, cursor')
      count_live(t) -> scalar tensor
      count_tomb(t) -> scalar tensor
      clear(t) -> t'
      probe_cost(t, keys, found, loc) -> i32[Q]  probe-length cost of each hit
      slots_for(capacity) -> int               slot count make(capacity)
                                               would allocate

    Fused set (``None`` = no kernel path; all-or-none per backend; each
    writes the table's tensors in place):

      lookup_fused(t, keys) -> (found, vals)
      lookup_fused_loc(t, keys) -> (found, vals, loc)
      insert_fused(t, keys, vals, mask, with_present=False) -> (t, ok[, present])
      delete_fused(t, keys, mask) -> (t, ok)
      extract_chunk_fused(t, cursor, n) -> like extract_chunk
      ordered_lookup_fused(t_old, t_new, hk, hv, hl, keys, *, nres_cap)
          -> (found, vals)                     whole Lemma-4.1 ordered check
      ordered_delete_fused(t_old, t_new, hk, hv, hl, keys, mask, *, nres_cap)
          -> (old_state, new_state, hl', ok)
    """

    name: str
    table_cls: type
    nres_cap: int
    dirty_cap: int
    # construction & maintenance
    make: Callable[..., Any]
    fresh_like: Callable[..., Any]
    reseed: Callable[..., Any]
    capacity_of: Callable[[Any], int]
    with_state: Callable[..., Any]
    # plain ops (the oracle surface)
    lookup: Callable[..., Any]
    insert: Callable[..., Any]
    delete: Callable[..., Any]
    extract_chunk: Callable[..., Any]
    count_live: Callable[..., Any]
    clear: Callable[..., Any]
    # occupancy / probe telemetry
    count_tomb: Callable[..., Any] = None
    probe_cost: Callable[..., Any] = None
    slots_for: Callable[[int], int] | None = None
    bounded_placement: bool = False
    # kernel-backed ops
    lookup_fused: Callable[..., Any] | None = None
    lookup_fused_loc: Callable[..., Any] | None = None
    insert_fused: Callable[..., Any] | None = None
    delete_fused: Callable[..., Any] | None = None
    extract_chunk_fused: Callable[..., Any] | None = None
    ordered_lookup_fused: Callable[..., Any] | None = None
    ordered_delete_fused: Callable[..., Any] | None = None
    # optional hooks
    freeze_old: Callable[..., Any] | None = None
    lookup_fwd: Callable[..., Any] | None = None

    @property
    def fused(self) -> bool:
        """True iff this backend has the full kernel-backed op set."""
        return self.lookup_fused is not None

    def __post_init__(self):
        fused_set = (self.lookup_fused, self.lookup_fused_loc,
                     self.insert_fused, self.delete_fused,
                     self.extract_chunk_fused, self.ordered_lookup_fused,
                     self.ordered_delete_fused)
        have = [f is not None for f in fused_set]
        if any(have) and not all(have):
            raise ValueError(f"backend {self.name!r}: fused ops must be "
                             f"all-or-none, got {have}")


REGISTRY: dict[str, BucketBackend] = {}


def register(be: BucketBackend) -> BucketBackend:
    """Add a descriptor to the registry (last registration wins, so a user
    backend may shadow a built-in)."""
    REGISTRY[be.name] = be
    return be


def get(name: str) -> BucketBackend:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{tuple(REGISTRY)}") from None


def names() -> tuple[str, ...]:
    return tuple(REGISTRY)


def of_table(t) -> BucketBackend:
    """Descriptor for a table instance (type-keyed reverse lookup)."""
    for be in REGISTRY.values():
        if isinstance(t, be.table_cls):
            return be
    raise TypeError(f"no registered backend for table type {type(t)!r}")


# ---------------------------------------------------------------------------
# linear: fused adapters (kernels/ops.py probe/claim/extract kernels)
# ---------------------------------------------------------------------------

def linear_lookup_fused(t: LinearTable, keys: torch.Tensor):
    """Kernel-backed lookup.  Returns (found, vals)."""
    from repro_torch.kernels import ops
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    return ops.probe_lookup(t.key, t.val, t.state, h0, keys,
                            max_probes=t.max_probes)


def linear_lookup_fused_loc(t: LinearTable, keys: torch.Tensor):
    """Kernel-backed lookup keeping the kernel's loc output: the SAME single
    launch as ``linear_lookup_fused``, returning (found, vals, loc)."""
    from repro_torch.kernels import ops
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    return ops.probe_lookup(t.key, t.val, t.state, h0, keys,
                            max_probes=t.max_probes, with_loc=True)


def linear_insert_fused(t: LinearTable, keys: torch.Tensor,
                        vals: torch.Tensor, mask: torch.Tensor, *,
                        with_present: bool = False):
    """Kernel-backed insert: batch_winners dedup (the kernel's caller
    contract), then one claim launch.  Writes ``t``'s tensors in place.
    Returns (t, ok), or (t, ok, present) when ``with_present``."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    *_, ok, present = ops.probe_insert(
        t.key, t.val, t.state, h0, keys, vals, winner,
        max_probes=t.max_probes, claim=t.claim, with_present=True)
    return (t, ok, present) if with_present else (t, ok)


def linear_delete_fused(t: LinearTable, keys: torch.Tensor,
                        mask: torch.Tensor):
    """Kernel-backed delete: the location-emitting probe kernel tombstones
    in ONE pass (one launch + one scatter).  Writes ``t.state`` in place."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    _, ok = ops.probe_delete(t.key, t.val, t.state, h0, keys, winner,
                             max_probes=t.max_probes)
    return t, ok


def linear_extract_chunk_fused(t: LinearTable, cursor: torch.Tensor, n: int):
    """Kernel-backed rebuild chunk scan: one launch; hazard entries come back
    COMPACTED (live entries first) — identical as a set, which is all the
    hazard protocol observes.  Writes ``t.state`` in place.

    Contract: ``n <= ops.EXTRACT_MAX_CHUNK`` for a table on a CUDA device —
    the kernels (``extract``, ``probe2``) take no larger chunk and a larger
    one raises.  A table on the CPU, where no kernel runs anyway, takes the
    plain position-aligned scan above that size, as the reference does."""
    from repro_torch.kernels import ops
    if n > ops.EXTRACT_MAX_CHUNK:
        if t.key.is_cuda:
            raise ValueError(
                f"fused linear rebuild takes chunk <= {ops.EXTRACT_MAX_CHUNK}"
                f" on a CUDA device, got {n}; use a smaller chunk or "
                f"fused=False")
        return buckets.linear_extract_chunk(t, cursor, n)
    _, hk, hv, hl, cur = ops.extract_chunk_fused(
        t.key, t.val, t.state, cursor, chunk=n)
    return t, hk, hv, hl, cur


def linear_ordered_lookup_fused(t_old: LinearTable, t_new: LinearTable,
                                hazard_key: torch.Tensor,
                                hazard_val: torch.Tensor,
                                hazard_live: torch.Tensor,
                                keys: torch.Tensor, *,
                                nres_cap: int = NRES_CAP):
    """Kernel-backed rebuild-epoch lookup: the whole ordered check
    (old -> hazard -> new, Lemma 4.1) in ONE probe2 launch.
    Returns (found, vals)."""
    from repro_torch.kernels import ops
    h0_old = hashing.bucket_of(t_old.hfn, keys, t_old.capacity)
    h0_new = hashing.bucket_of(t_new.hfn, keys, t_new.capacity)
    return ops.ordered_lookup_fused(
        (t_old.key, t_old.val, t_old.state),
        (t_new.key, t_new.val, t_new.state),
        hazard_key, hazard_val, hazard_live, h0_old, h0_new, keys,
        max_probes=t_old.max_probes, nres_cap=nres_cap)


def linear_ordered_delete_fused(t_old: LinearTable, t_new: LinearTable,
                                hazard_key: torch.Tensor,
                                hazard_val: torch.Tensor,
                                hazard_live: torch.Tensor,
                                keys: torch.Tensor, mask: torch.Tensor, *,
                                nres_cap: int = NRES_CAP):
    """Kernel-backed rebuild-epoch delete (paper Alg. 5): the SAME single
    probe2 launch resolves old-slot / hazard-index / new-slot; three scatters
    land the result.  Writes both state arrays in place.
    Returns (old_state, new_state, hazard_live', ok)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    h0_old = hashing.bucket_of(t_old.hfn, keys, t_old.capacity)
    h0_new = hashing.bucket_of(t_new.hfn, keys, t_new.capacity)
    return ops.ordered_delete_fused(
        (t_old.key, t_old.val, t_old.state),
        (t_new.key, t_new.val, t_new.state),
        hazard_key, hazard_val, hazard_live, h0_old, h0_new, keys, winner,
        max_probes=t_old.max_probes, nres_cap=nres_cap)


# ---------------------------------------------------------------------------
# construction / maintenance adapters
# ---------------------------------------------------------------------------

def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _make_linear(capacity: int, seed, *, load_factor: float = 0.75,
                 max_probes: int = 64,
                 device: torch.device | str = "cuda") -> LinearTable:
    rng = np.random.default_rng(seed)
    slots = _next_pow2(int(capacity / load_factor) + 1)
    return buckets.linear_make(slots, hashing.fresh("mix32", rng, device),
                               max_probes=max_probes, device=device)


def _fresh_linear(t: LinearTable, seed) -> LinearTable:
    dev = t.key.device
    return buckets.linear_make(t.capacity, hashing.fresh("mix32", seed, dev),
                               t.max_probes, device=dev)


def _reseed_one(t, salt):
    return replace(t, hfn=hashing.reseed(t.hfn, salt))


# ---------------------------------------------------------------------------
# occupancy / probe telemetry
# ---------------------------------------------------------------------------

def _linear_count_tomb(t: LinearTable) -> torch.Tensor:
    return (t.state == buckets.TOMB).sum().to(torch.int32)


def _linear_probe_cost(t: LinearTable, keys, found, loc) -> torch.Tensor:
    """Probe distance of each hit: the mod folds the hit's slot back to the
    probe index whether or not the probe wrapped."""
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    dist = torch.remainder(loc - h0, t.capacity)
    return torch.where(found & (loc >= 0), dist, 0).to(torch.int32)


def _linear_slots_for(capacity: int) -> int:
    return _next_pow2(int(capacity / 0.75) + 1)          # mirrors _make_linear


# ---------------------------------------------------------------------------
# the built-in registry
# ---------------------------------------------------------------------------

LINEAR = register(BucketBackend(
    name="linear",
    table_cls=LinearTable,
    nres_cap=NRES_CAP,
    dirty_cap=0,                       # no deferred-maintenance tail
    make=_make_linear,
    fresh_like=_fresh_linear,
    reseed=_reseed_one,
    capacity_of=lambda t: t.capacity,
    with_state=lambda t, s: replace(t, state=s),
    lookup=buckets.linear_lookup,
    insert=buckets.linear_insert,
    delete=buckets.linear_delete,
    extract_chunk=buckets.linear_extract_chunk,
    count_live=buckets.linear_count_live,
    clear=buckets.linear_clear,
    count_tomb=_linear_count_tomb,
    probe_cost=_linear_probe_cost,
    slots_for=_linear_slots_for,
    lookup_fused=linear_lookup_fused,
    lookup_fused_loc=linear_lookup_fused_loc,
    insert_fused=linear_insert_fused,
    delete_fused=linear_delete_fused,
    extract_chunk_fused=linear_extract_chunk_fused,
    ordered_lookup_fused=linear_ordered_lookup_fused,
    ordered_delete_fused=linear_ordered_delete_fused,
    lookup_fwd=buckets.linear_lookup_fwd,
))
