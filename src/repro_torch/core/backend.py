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
* layout metadata: ``nres_cap``, kept for API parity with the reference and
  unused by the Hopper kernels, and ``dirty_cap``, the chain arena's
  dirty-tail window (the compaction threshold and the window the chain
  kernels stage);
* the optional ``lookup_fwd`` hook (MIGRATED-slot hazard forwarding) and
  ``freeze_old`` hook (chain: compact the old arena at a rebuild's start,
  or, given a device flag, compute the compaction and select it);
* ``hash_fns``: the table's hash functions (one for linear and chain, a and
  b for the two-row backends), so that a caller can see every seed change at
  a swap.

``core/dhash.py`` contains ZERO per-backend branches: every public op
dispatches through the descriptor looked up by ``DHashState.backend``.
``linear``, ``twochoice``, ``chain`` and ``cuckoo`` are registered; ``get``
of any other name raises the reference's ``ValueError``.

The ``*_fused`` adapters in this module are the thin descriptor-bound glue
over ``kernels/ops.py``: hash the keys (``hashing.bucket_of``, outside the
kernels as in the reference, but for the linear steady state's lookup and
delete, whose kernel hashes them itself), call the op, hand back the table.
Cuckoo drives the twochoice kernels with side-offset rows; only its insert
adds the bounded kick-out, run by the insert kernel's resolve.  Chain's
insert adds the compaction, a kernel that reads its trigger on the device
and returns at once below it (no host read).
The linear, twochoice and cuckoo descriptors also carry the stack set:
the forms of their ordered lookup and delete, their insert and the
transition on a table stack (``dhash.make_stack``), one kernel launch for
all T tables (chain's stacks loop over their tables).  ``epoch_leaves``
lists a table's tensor leaves (a stack's: [T, ...]) with what a rebuild start
clears each to, for the epoch-swap kernel, from the descriptor's
``clear_fill`` and ``salt_offsets`` (stated next to ``clear`` and
``reseed``, which they must reproduce).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import buckets, hashing
from repro_torch.core.buckets import (ChainTable, CuckooTable, LinearTable,
                                     TwoChoiceTable, _chain_parts, _ck_rows,
                                     _tc_rows, batch_winners)
from repro_torch.core.struct_utils import replace
from repro_torch.kernels.ops import DIRTY_CAP, NRES_CAP


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
      hash_fns(t) -> tuple[HashFn, ...]        the table's hash functions

    Fused set (``None`` = no kernel path; all-or-none per backend; each
    writes the table's tensors in place):

      lookup_fused(t, keys) -> (found, vals)
      lookup_fused_loc(t, keys) -> (found, vals, loc)
      insert_fused(t, keys, vals, mask, with_present=False, dedup=True)
          -> (t, ok[, present])      dedup=False: mask already distinct
      delete_fused(t, keys, mask) -> (t, ok)
      extract_chunk_fused(t, cursor, n, *, out=None, run=None, hold=None)
          -> like extract_chunk; with ``out`` (the hazard buffer) IN PLACE,
             behind the device flags run & ~hold (``probe.extract``)
      transition_fused(t, cursor, n, hazard, rebuilding, ok, present,
                       swap, start) -> go[2]
          the rebuild step's transition after its landing, IN PLACE: the
          landing's bookkeeping, the guarded scan of ``t`` and the epoch
          decision in one launch (``probe.transition``)
      ordered_lookup_fused(t_old, t_new, hk, hv, hl, keys, *, nres_cap)
          -> (found, vals)                     whole Lemma-4.1 ordered check
      ordered_delete_fused(t_old, t_new, hk, hv, hl, keys, mask, *, nres_cap)
          -> (old_state, new_state, hl', ok)

    Stack set (``None`` = a table stack's ops loop over its tables' views;
    all-or-none; on stacked tables, every tensor leading with [T], keys
    [T, Q], one kernel launch for the T tables, each table's branch picked
    on the device by its flag in ``rebuilding`` [T]):

      stack_ordered_lookup_fused(t_old, t_new, hk, hv, hl, keys, rebuilding)
          -> (found, vals, loc_old)     idle tables: their old table alone
      stack_ordered_delete_fused(t_old, t_new, hk, hv, hl, keys, mask,
                                 rebuilding) -> (old_state, new_state, hl', ok)
      stack_insert_fused(t, keys, vals, mask, *, alt=None, use_alt=None,
                         with_present=False, dedup=True) -> (t, ok[, present])
          into ``t``, or ``alt`` where ``use_alt`` [T] is set
      stack_transition_fused(t, cursor, n, hazard, rebuilding, ok, present,
                             swap, start) -> go[T, 2]
    """

    name: str
    table_cls: type
    nres_cap: int
    dirty_cap: int
    # construction & maintenance
    make: Callable[..., Any]
    fresh_like: Callable[..., Any]
    reseed: Callable[..., Any]
    # the salt offset each hash-function field takes at a ``reseed``
    salt_offsets: dict = dataclasses.field(default_factory=dict,
                                           kw_only=True)
    capacity_of: Callable[[Any], int]
    with_state: Callable[..., Any]
    # plain ops (the oracle surface)
    lookup: Callable[..., Any]
    insert: Callable[..., Any]
    delete: Callable[..., Any]
    extract_chunk: Callable[..., Any]
    count_live: Callable[..., Any]
    clear: Callable[..., Any]
    # what ``clear`` writes into a tensor field where it is not 0: "desc" is
    # n - 1 - i (the chain free stack), "arena" the arena's size
    clear_fill: dict = dataclasses.field(default_factory=dict,
                                         kw_only=True)
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
    transition_fused: Callable[..., Any] | None = None
    ordered_lookup_fused: Callable[..., Any] | None = None
    ordered_delete_fused: Callable[..., Any] | None = None
    # a table stack's kernel-backed ops
    stack_ordered_lookup_fused: Callable[..., Any] | None = None
    stack_ordered_delete_fused: Callable[..., Any] | None = None
    stack_insert_fused: Callable[..., Any] | None = None
    stack_transition_fused: Callable[..., Any] | None = None
    # optional hooks
    freeze_old: Callable[..., Any] | None = None
    lookup_fwd: Callable[..., Any] | None = None
    hash_fns: Callable[[Any], tuple] | None = None

    @property
    def fused(self) -> bool:
        """True iff this backend has the full kernel-backed op set."""
        return self.lookup_fused is not None

    @property
    def stack_fused(self) -> bool:
        """True iff a fused stack of this backend runs each op as one
        launch for all its tables (the stack set)."""
        return self.stack_insert_fused is not None

    def __post_init__(self):
        fused_set = (self.lookup_fused, self.lookup_fused_loc,
                     self.insert_fused, self.delete_fused,
                     self.extract_chunk_fused, self.transition_fused,
                     self.ordered_lookup_fused,
                     self.ordered_delete_fused)
        have = [f is not None for f in fused_set]
        if any(have) and not all(have):
            raise ValueError(f"backend {self.name!r}: fused ops must be "
                             f"all-or-none, got {have}")
        stack_set = (self.stack_ordered_lookup_fused,
                     self.stack_ordered_delete_fused,
                     self.stack_insert_fused, self.stack_transition_fused)
        have = [f is not None for f in stack_set]
        if any(have) and not (all(have) and self.fused):
            raise ValueError(f"backend {self.name!r}: stack ops must be "
                             f"all-or-none, on a fused backend, got {have}")


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
    """Kernel-backed lookup: one launch that hashes the keys itself.
    Returns (found, vals)."""
    from repro_torch.kernels import ops
    return ops.probe_lookup(t.key, t.val, t.state, None, keys, hfn=t.hfn,
                            max_probes=t.max_probes)


def linear_lookup_fused_loc(t: LinearTable, keys: torch.Tensor):
    """Kernel-backed lookup keeping the kernel's loc output: the SAME single
    launch as ``linear_lookup_fused``, returning (found, vals, loc)."""
    from repro_torch.kernels import ops
    return ops.probe_lookup(t.key, t.val, t.state, None, keys, hfn=t.hfn,
                            max_probes=t.max_probes, with_loc=True)


def linear_insert_fused(t: LinearTable, keys: torch.Tensor,
                        vals: torch.Tensor, mask: torch.Tensor, *,
                        with_present: bool = False, dedup: bool = True):
    """Kernel-backed insert: batch_winners dedup (the kernel's caller
    contract; ``dedup=False`` when the masked keys are already distinct),
    then one claim launch.  Writes ``t``'s tensors in place.
    Returns (t, ok), or (t, ok, present) when ``with_present``."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask) if dedup else mask
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    *_, ok, present = ops.probe_insert(
        t.key, t.val, t.state, h0, keys, vals, winner,
        max_probes=t.max_probes, with_present=True)
    return (t, ok, present) if with_present else (t, ok)


def linear_delete_fused(t: LinearTable, keys: torch.Tensor,
                        mask: torch.Tensor):
    """Kernel-backed delete: the location-emitting probe kernel (hashing
    the keys itself) tombstones in ONE pass (one launch + one scatter).
    Writes ``t.state`` in place."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    _, ok = ops.probe_delete(t.key, t.val, t.state, None, keys, winner,
                             hfn=t.hfn, max_probes=t.max_probes)
    return t, ok


def _extract_fused(t, arrays, cursor: torch.Tensor, n: int, plain, *,
                   out=None, run=None, hold=None):
    """One ``extract`` launch on flat (key, val, state) ``arrays`` of ``t``;
    above the kernel's chunk a CUDA table raises and a CPU table takes the
    ``plain`` scan (with ``out``, the extract's plain version, which takes
    any chunk and the flags)."""
    from repro_torch.kernels import ops, probe
    if n > ops.EXTRACT_MAX_CHUNK:
        if arrays[0].is_cuda:
            raise ValueError(
                f"fused rebuild takes chunk <= {ops.EXTRACT_MAX_CHUNK} on a "
                f"CUDA device, got {n}; use a smaller chunk or fused=False")
        if out is None:
            return plain(t, cursor, n)
        return (t, *probe.extract_plain(*arrays, cursor, n, out=out, run=run,
                                        hold=hold))
    _, hk, hv, hl, cur = ops.extract_chunk_fused(*arrays, cursor, chunk=n,
                                                 out=out, run=run, hold=hold)
    return t, hk, hv, hl, cur


def extract_chunk_fused(t, cursor: torch.Tensor, n: int, *, out=None,
                        run=None, hold=None):
    """Kernel-backed rebuild chunk scan of a slot table: one ``extract``
    launch on the row-major flattened slot arrays (the scan order of the
    plain scan); hazard entries come back COMPACTED (live entries first) —
    identical as a set, which is all the hazard protocol observes.  Writes
    ``t.state`` in place.

    Contract: ``n <= ops.EXTRACT_MAX_CHUNK`` for a table on a CUDA device —
    the kernels (``extract`` and the probe2 kernels) take no larger chunk
    and a larger one raises.  A table on the CPU, where no kernel runs
    anyway, takes the plain position-aligned scan above that size, as the
    reference does."""
    return _extract_fused(
        t, (t.key.view(-1), t.val.view(-1), t.state.view(-1)), cursor, n,
        buckets.extract_chunk, out=out, run=run, hold=hold)


def transition_fused(t, cursor: torch.Tensor, n: int, hazard, rebuilding,
                     ok, present, swap: bool, start: bool) -> torch.Tensor:
    """The rebuild step's transition on a slot table (``probe.transition``
    on the row-major flattened slot arrays, the scan order of
    ``extract_chunk_fused``, with its chunk contract); on a table stack
    (``cursor`` [T]) each table's arrays flattened on its row, one launch.
    Returns go[2] (go[T, 2])."""
    from repro_torch.kernels import probe
    lead = tuple(cursor.shape)
    return probe.transition(t.key.view(*lead, -1), t.val.view(*lead, -1),
                            t.state.view(*lead, -1), cursor, n, hazard,
                            rebuilding, ok, present, swap, start)


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


def linear_stack_ordered_lookup_fused(t_old: LinearTable, t_new: LinearTable,
                                      hazard_key, hazard_val, hazard_live,
                                      keys: torch.Tensor,
                                      rebuilding: torch.Tensor):
    """A linear table stack's lookup: ONE probe2 launch for its T tables,
    the ordered check on the tables mid-rebuild and the old table alone on
    the others (the reference's ``cond(rebuilding)`` between
    ``ordered_lookup_fused`` and ``lookup_fused(old)``).  Returns (found,
    vals, loc_old): the old-table hit slots are the steady branch's probe
    telemetry."""
    from repro_torch.kernels import ops
    h0_old = hashing.bucket_of(t_old.hfn, keys, t_old.capacity)
    h0_new = hashing.bucket_of(t_new.hfn, keys, t_new.capacity)
    return ops.ordered_lookup_fused(
        (t_old.key, t_old.val, t_old.state),
        (t_new.key, t_new.val, t_new.state),
        hazard_key, hazard_val, hazard_live, h0_old, h0_new, keys,
        max_probes=t_old.max_probes, rebuilding=rebuilding, with_loc=True)


def linear_stack_ordered_delete_fused(t_old: LinearTable, t_new: LinearTable,
                                      hazard_key, hazard_val, hazard_live,
                                      keys: torch.Tensor, mask: torch.Tensor,
                                      rebuilding: torch.Tensor):
    """A linear table stack's delete: ONE probe2 launch for its T tables
    (the ordered check mid-rebuild, the old table alone elsewhere: the
    steady delete) and the three landing scatters over the stacked arrays.
    Writes both state arrays in place.  Returns (old_state, new_state,
    hazard_live', ok)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    h0_old = hashing.bucket_of(t_old.hfn, keys, t_old.capacity)
    h0_new = hashing.bucket_of(t_new.hfn, keys, t_new.capacity)
    return ops.ordered_delete_fused(
        (t_old.key, t_old.val, t_old.state),
        (t_new.key, t_new.val, t_new.state),
        hazard_key, hazard_val, hazard_live, h0_old, h0_new, keys, winner,
        max_probes=t_old.max_probes, rebuilding=rebuilding)


def linear_stack_insert_fused(t: LinearTable, keys: torch.Tensor,
                              vals: torch.Tensor, mask: torch.Tensor, *,
                              alt: LinearTable | None = None,
                              use_alt: torch.Tensor | None = None,
                              with_present: bool = False,
                              dedup: bool = True):
    """A linear table stack's insert: one row-wise ``batch_winners`` sort
    and ONE ``probe_insert`` launch for its T tables, each into ``t`` or,
    where ``use_alt`` is set, into ``alt`` (a table of ``t``'s shape): the
    reference's ``cond(rebuilding)`` between the new and the old table,
    decided in the kernel.  Writes the targets in place.  Returns (t, ok),
    or (t, ok, present)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask) if dedup else mask
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    if alt is not None:
        h0 = torch.where(use_alt[:, None],
                         hashing.bucket_of(alt.hfn, keys, alt.capacity), h0)
        alt = (alt.key, alt.val, alt.state)
    *_, ok, present = ops.probe_insert(
        t.key, t.val, t.state, h0, keys, vals, winner,
        max_probes=t.max_probes, with_present=True, alt=alt, use_alt=use_alt)
    return (t, ok, present) if with_present else (t, ok)


# ---------------------------------------------------------------------------
# twochoice and cuckoo: fused adapters (the tc_* kernels; cuckoo feeds them
# side-offset rows of its [2B, W] table).  One kernel launch an op; the
# cuckoo insert's kick-out runs inside its insert launch.
# ---------------------------------------------------------------------------

def _two_row_fused(rows) -> dict:
    """The descriptor's fused ops, but the insert, of a two-row backend;
    ``rows(t, keys)`` gives each key's two candidate rows.  Each op is ONE
    ``tc_lookup`` or ``tc_probe2`` launch (a delete adds its scatters); the
    lookup and the delete hand the kernel the table's hash functions, which
    it applies itself, so they issue no hashing ops.  The chunk scan is the
    shared ``extract_chunk_fused``."""
    from repro_torch.kernels import ops

    def hashed(t):
        # row b's offset is the rows past the bucket count: 0 on a
        # twochoice table, the bucket count on a cuckoo table's [2B, W]
        return dict(hfn_a=t.hfn_a, hfn_b=t.hfn_b, nbuckets=t.nbuckets,
                    b_offset=t.key.shape[0] - t.nbuckets)

    def lookup_fused_loc(t, keys):
        """Returns (found, vals, loc)."""
        return ops.twochoice_lookup(t.key, t.val, t.state, None, None, keys,
                                    **hashed(t))

    def lookup_fused(t, keys):
        """The same launch.  Returns (found, vals)."""
        return lookup_fused_loc(t, keys)[:2]

    def delete_fused(t, keys, mask):
        winner = batch_winners(keys, mask)
        _, ok = ops.twochoice_delete(t.key, t.val, t.state, None, None, keys,
                                     winner, **hashed(t))
        return t, ok

    def ordered(op, t_old, t_new, hazard, keys, *extra, nres_cap, **kw):
        return op((t_old.key, t_old.val, t_old.state),
                  (t_new.key, t_new.val, t_new.state), *hazard,
                  *rows(t_old, keys), *rows(t_new, keys), keys, *extra,
                  nres_cap=nres_cap, **kw)

    def ordered_lookup_fused(t_old, t_new, hazard_key, hazard_val,
                             hazard_live, keys, *, nres_cap=NRES_CAP):
        return ordered(ops.twochoice_ordered_lookup, t_old, t_new,
                       (hazard_key, hazard_val, hazard_live), keys,
                       nres_cap=nres_cap)

    def ordered_delete_fused(t_old, t_new, hazard_key, hazard_val,
                             hazard_live, keys, mask, *, nres_cap=NRES_CAP):
        return ordered(ops.twochoice_ordered_delete, t_old, t_new,
                       (hazard_key, hazard_val, hazard_live), keys,
                       batch_winners(keys, mask), nres_cap=nres_cap)

    def stack_ordered_lookup_fused(t_old, t_new, hazard_key, hazard_val,
                                   hazard_live, keys, rebuilding):
        """A table stack's lookup: ONE ``tc_probe2`` launch for its T
        tables, the idle ones on their old rows alone.  Returns (found,
        vals, loc_old)."""
        return ordered(ops.twochoice_ordered_lookup, t_old, t_new,
                       (hazard_key, hazard_val, hazard_live), keys,
                       nres_cap=NRES_CAP, rebuilding=rebuilding,
                       with_loc=True)

    def stack_ordered_delete_fused(t_old, t_new, hazard_key, hazard_val,
                                   hazard_live, keys, mask, rebuilding):
        """A table stack's delete: ONE ``tc_probe2`` launch and the three
        landing scatters over the stacked arrays."""
        return ordered(ops.twochoice_ordered_delete, t_old, t_new,
                       (hazard_key, hazard_val, hazard_live), keys,
                       batch_winners(keys, mask), nres_cap=NRES_CAP,
                       rebuilding=rebuilding)

    return dict(lookup_fused=lookup_fused, lookup_fused_loc=lookup_fused_loc,
                delete_fused=delete_fused,
                extract_chunk_fused=extract_chunk_fused,
                transition_fused=transition_fused,
                ordered_lookup_fused=ordered_lookup_fused,
                ordered_delete_fused=ordered_delete_fused,
                stack_ordered_lookup_fused=stack_ordered_lookup_fused,
                stack_ordered_delete_fused=stack_ordered_delete_fused,
                stack_transition_fused=transition_fused)


def _target(t, keys, rows, alt, use_alt):
    """The rows of an insert's target: ``t``'s, or on a table stack with
    ``alt``, each table's own: the ``alt`` table's where ``use_alt`` is
    set, else ``t``'s; and the (key, val, state) triple of ``alt`` (None
    without one)."""
    ra, rb = rows(t, keys)
    if alt is None:
        return ra, rb, None
    aa, ab = rows(alt, keys)
    flag = use_alt[:, None]
    return (torch.where(flag, aa, ra), torch.where(flag, ab, rb),
            (alt.key, alt.val, alt.state))


def _pick_fn(use_alt, fa: hashing.HashFn, fb: hashing.HashFn):
    """A stack of hash functions: ``fa``'s row where ``use_alt`` is set,
    else ``fb``'s."""
    flag = use_alt.view(-1, *[1] * (fa.seeds.dim() - 1))
    return replace(fa, seeds=torch.where(flag, fa.seeds, fb.seeds))


def twochoice_insert_fused(t: TwoChoiceTable, keys: torch.Tensor,
                           vals: torch.Tensor, mask: torch.Tensor, *,
                           alt: TwoChoiceTable | None = None,
                           use_alt: torch.Tensor | None = None,
                           with_present: bool = False, dedup: bool = True):
    """Kernel-backed two-choice insert: batch_winners dedup, then ONE
    ``tc_insert`` launch (``max_rounds`` alternating rounds).  Writes ``t``'s
    tensors in place.  On a table stack ([T, Q] operands; the descriptor's
    ``stack_insert_fused``) one row-wise sort and ONE launch for the T
    tables, each into ``t`` or, where ``use_alt`` is set, into ``alt`` (the
    reference's ``cond(rebuilding)`` decided in the kernel; ``t``'s claim
    words serve either target).  Returns (t, ok), or (t, ok, present)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask) if dedup else mask
    ra, rb, alt3 = _target(t, keys, _tc_rows, alt, use_alt)
    *_, ok, present = ops.twochoice_insert(
        t.key, t.val, t.state, ra, rb, keys, vals, winner,
        max_rounds=t.max_rounds, claim=t.claim, with_present=True, alt=alt3,
        use_alt=use_alt)
    return (t, ok, present) if with_present else (t, ok)


def cuckoo_insert_fused(t: CuckooTable, keys: torch.Tensor,
                        vals: torch.Tensor, mask: torch.Tensor, *,
                        alt: CuckooTable | None = None,
                        use_alt: torch.Tensor | None = None,
                        with_present: bool = False, dedup: bool = True):
    """Kernel-backed cuckoo insert: ONE ``tc_insert`` launch places every
    key whose candidate rows have room (two rounds — one try a side) and,
    in its resolve's last block, runs the bounded kick-out for the winners
    left unplaced and absent from both rows (the reference's ``lax.cond``
    is the kernel's own test: with nothing left it does nothing).  Writes
    ``t``'s tensors in place, no host read.  On a table stack as
    ``twochoice_insert_fused``, each table's kick-out in its own last block
    with its target's hash functions.  Returns (t, ok), or (t, ok,
    present)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask) if dedup else mask
    ra, rb, alt3 = _target(t, keys, _ck_rows, alt, use_alt)
    fa, fb = t.hfn_a, t.hfn_b
    if alt is not None:
        fa, fb = (_pick_fn(use_alt, alt.hfn_a, t.hfn_a),
                  _pick_fn(use_alt, alt.hfn_b, t.hfn_b))
    *_, ok, present = ops.cuckoo_insert(
        t.key, t.val, t.state, ra, rb, fa, fb, t.nbuckets, keys, vals,
        winner, max_kick=t.max_kick, claim=t.claim, with_present=True,
        alt=alt3, use_alt=use_alt)
    return (t, ok, present) if with_present else (t, ok)


# ---------------------------------------------------------------------------
# chain: fused adapters over the arena-sorted node layout (the chain_probe
# and chain_probe2 kernels; the chunk scan is extract on the flat arena)
# ---------------------------------------------------------------------------

def _chain_bq(t: ChainTable, keys: torch.Tensor) -> torch.Tensor:
    return hashing.bucket_of(t.hfn, keys, t.nbuckets)


def chain_lookup_fused_loc(t: ChainTable, keys: torch.Tensor):
    """Kernel-backed chain lookup: ONE ``chain_probe`` launch.  Returns
    (found, vals, loc) — ``loc`` is the node index (-1 if absent)."""
    from repro_torch.kernels import ops
    return ops.chain_lookup_fused(*_chain_parts(t), _chain_bq(t, keys), keys,
                                  max_chain=t.max_chain,
                                  dirty_cap=t.dirty_cap)


def chain_lookup_fused(t: ChainTable, keys: torch.Tensor):
    """The same launch.  Returns (found, vals)."""
    return chain_lookup_fused_loc(t, keys)[:2]


def chain_insert_fused(t: ChainTable, keys: torch.Tensor, vals: torch.Tensor,
                       mask: torch.Tensor, *, with_present: bool = False,
                       dedup: bool = True):
    """Kernel-backed chain insert: batch_winners dedup, the presence launch,
    then allocation from the free-stack tail and the head relink, written
    into ``t``'s tensors in place.  New nodes extend the dirty tail;
    ``chain_maybe_compact`` restores the sorted layout.  Returns (t, ok), or
    (t, ok, present)."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask) if dedup else mask
    *_, ok, present = ops.chain_insert_fused(
        *_chain_parts(t), t.free_stack, t.free_top, _chain_bq(t, keys), keys,
        vals, winner, max_chain=t.max_chain, dirty_cap=t.dirty_cap,
        with_present=True)
    return (t, ok, present) if with_present else (t, ok)


def chain_delete_fused(t: ChainTable, keys: torch.Tensor,
                       mask: torch.Tensor):
    """Kernel-backed chain delete: the ``chain_probe`` launch's location +
    ONE tombstone scatter.  Writes ``t.astate`` in place."""
    from repro_torch.kernels import ops
    winner = batch_winners(keys, mask)
    _, ok = ops.chain_delete_fused(*_chain_parts(t), _chain_bq(t, keys),
                                   keys, winner, max_chain=t.max_chain,
                                   dirty_cap=t.dirty_cap)
    return t, ok


def _chain_ordered(op, t_old: ChainTable, t_new: ChainTable, hazard, keys,
                   *extra, nres_cap: int):
    """An ordered ``ops.chain_*`` op over two chain tables."""
    return op(*_chain_parts(t_old), *_chain_parts(t_new), *hazard,
              _chain_bq(t_old, keys), _chain_bq(t_new, keys), keys, *extra,
              max_chain=max(t_old.max_chain, t_new.max_chain),
              nres_cap=nres_cap,
              dirty_cap=max(t_old.dirty_cap, t_new.dirty_cap))


def chain_ordered_lookup_fused(t_old: ChainTable, t_new: ChainTable,
                               hazard_key: torch.Tensor,
                               hazard_val: torch.Tensor,
                               hazard_live: torch.Tensor, keys: torch.Tensor,
                               *, nres_cap: int = NRES_CAP):
    """Kernel-backed chain rebuild-epoch lookup: the whole ordered check in
    ONE ``chain_probe2`` launch.  Returns (found, vals)."""
    from repro_torch.kernels import ops
    return _chain_ordered(ops.chain_ordered_lookup, t_old, t_new,
                          (hazard_key, hazard_val, hazard_live), keys,
                          nres_cap=nres_cap)


def chain_ordered_delete_fused(t_old: ChainTable, t_new: ChainTable,
                               hazard_key: torch.Tensor,
                               hazard_val: torch.Tensor,
                               hazard_live: torch.Tensor, keys: torch.Tensor,
                               mask: torch.Tensor, *,
                               nres_cap: int = NRES_CAP):
    """Kernel-backed chain rebuild-epoch delete (paper Alg. 5): the same
    single launch and the three landing scatters.  Writes both state arrays
    in place.  Returns (old_astate, new_astate, hazard_live', ok)."""
    from repro_torch.kernels import ops
    return _chain_ordered(ops.chain_ordered_delete, t_old, t_new,
                          (hazard_key, hazard_val, hazard_live), keys,
                          batch_winners(keys, mask), nres_cap=nres_cap)


def chain_extract_chunk_fused(t: ChainTable, cursor: torch.Tensor, n: int,
                              *, out=None, run=None, hold=None):
    """Kernel-backed rebuild chunk scan: the arena is a flat array, so the
    ``extract`` kernel runs on it unchanged (positions are scan order), with
    the chunk contract of ``extract_chunk_fused``.  Writes ``t.astate`` in
    place."""
    return _extract_fused(t, (t.akey, t.aval, t.astate), cursor, n,
                          buckets.chain_extract_chunk, out=out, run=run,
                          hold=hold)


def chain_transition_fused(t: ChainTable, cursor: torch.Tensor, n: int,
                           hazard, rebuilding, ok, present, swap: bool,
                           start: bool) -> torch.Tensor:
    """The rebuild step's transition on the flat arena (``probe.transition``;
    positions are scan order, as in ``chain_extract_chunk_fused``).  Returns
    go[2]."""
    from repro_torch.kernels import probe
    return probe.transition(t.akey, t.aval, t.astate, cursor, n, hazard,
                            rebuilding, ok, present, swap, start)


def _chain_fields(t: ChainTable) -> tuple:
    """The tensors a compaction rewrites, in ``ops.chain_compact_fused``'s
    output order."""
    return (t.akey, t.aval, t.astate, t.anext, t.heads, t.free_stack,
            t.free_top, t.bstart, t.blen, t.sorted_upto)


def chain_compact_fused(t: ChainTable,
                        where: torch.Tensor | None = None) -> ChainTable:
    """Restore the arena-sorted layout (``ops.chain_compact_fused``) IN
    PLACE: tombstones and migrated nodes are reclaimed, the dirty count
    drops to 0.  With ``where`` (a 0-dim bool device flag) only where the
    flag is set: one ``chain_compact`` launch, which returns at once
    elsewhere (no host read).  The ``freeze_old`` hook: run at a rebuild's
    start."""
    from repro_torch.kernels import probe
    probe.chain_compact(_chain_fields(t), t.hfn, t.nbuckets, where)
    return t


def chain_maybe_compact(t: ChainTable) -> ChainTable:
    """Compaction trigger: re-sort the arena iff the dirty tail has outgrown
    the window (the table's ``dirty_cap``).  The reference gates with
    ``lax.cond``; here the ``chain_compact`` launch reads the dirty count on
    the device and returns at once below the window, IN PLACE, so the
    trigger costs no host read."""
    from repro_torch.kernels import probe
    probe.chain_compact(_chain_fields(t), t.hfn, t.nbuckets,
                        dirty_cap=t.dirty_cap)
    return t


def _chain_insert_fused_compacting(t: ChainTable, keys, vals, mask, *,
                                   with_present: bool = False,
                                   dedup: bool = True):
    """The descriptor-bound chain insert: the fused insert plus the
    compaction trigger that keeps the next probes on the sorted segments —
    what the DHash layer (user inserts AND hazard landings) runs."""
    out = chain_insert_fused(t, keys, vals, mask, with_present=with_present,
                             dedup=dedup)
    chain_maybe_compact(t)
    return out


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


def _make_twochoice(capacity: int, seed, *, load_factor: float = 0.75,
                    bucket_width: int = 8,
                    device: torch.device | str = "cuda") -> TwoChoiceTable:
    rng = np.random.default_rng(seed)
    nb = _next_pow2(int(capacity / (load_factor * bucket_width)) + 1)
    return buckets.twochoice_make(nb, hashing.fresh("mix32", rng, device),
                                  hashing.fresh("mix32", rng, device),
                                  width=bucket_width, device=device)


def _make_cuckoo(capacity: int, seed, *, load_factor: float = 0.75,
                 bucket_width: int = 8, max_kick: int = 32,
                 device: torch.device | str = "cuda") -> CuckooTable:
    rng = np.random.default_rng(seed)
    nb = _next_pow2(int(capacity / (load_factor * 2 * bucket_width)) + 1)
    return buckets.cuckoo_make(nb, hashing.fresh("mix32", rng, device),
                               hashing.fresh("mix32", rng, device),
                               width=bucket_width, max_kick=max_kick,
                               device=device)


def _make_chain(capacity: int, seed, *, load_factor: float = 0.75,
                max_chain: int = 64, nbuckets: int | None = None,
                dirty_cap: int | None = None,
                device: torch.device | str = "cuda") -> ChainTable:
    """An arena of ``capacity`` nodes and ``capacity // 16`` buckets
    (rounded up to a power of two).  ``load_factor`` is accepted for the
    common signature and unused: the arena holds ``capacity`` live nodes.
    ``dirty_cap=None`` takes the registered chain descriptor's."""
    rng = np.random.default_rng(seed)
    nb = nbuckets if nbuckets is not None else _next_pow2(
        max(capacity // 16, 1))
    return buckets.chain_make(nb, capacity, hashing.fresh("mix32", rng,
                                                          device),
                              max_chain=max_chain, dirty_cap=dirty_cap,
                              device=device)


def _fresh_linear(t: LinearTable, seed) -> LinearTable:
    dev = t.key.device
    return buckets.linear_make(t.capacity, hashing.fresh("mix32", seed, dev),
                               t.max_probes, device=dev)


def _fresh_twochoice(t: TwoChoiceTable, seed) -> TwoChoiceTable:
    rng, dev = np.random.default_rng(seed), t.key.device
    return buckets.twochoice_make(t.nbuckets, hashing.fresh("mix32", rng, dev),
                                  hashing.fresh("mix32", rng, dev),
                                  width=t.width, max_rounds=t.max_rounds,
                                  device=dev)


def _fresh_cuckoo(t: CuckooTable, seed) -> CuckooTable:
    rng, dev = np.random.default_rng(seed), t.key.device
    return buckets.cuckoo_make(t.nbuckets, hashing.fresh("mix32", rng, dev),
                               hashing.fresh("mix32", rng, dev),
                               width=t.width, max_kick=t.max_kick,
                               device=dev)


def _fresh_chain(t: ChainTable, seed) -> ChainTable:
    dev = t.akey.device
    return buckets.chain_make(t.nbuckets, t.arena,
                              hashing.fresh("mix32", seed, dev),
                              max_chain=t.max_chain, dirty_cap=t.dirty_cap,
                              device=dev)


# the salt offset of each hash function at a reseed (b's as in the
# reference, so the reseeded seeds are the reference's)
ONE_FN_SALTS = {"hfn": 0}
TWO_ROW_SALTS = {"hfn_a": 0, "hfn_b": 0x5851F42}


def _reseed_one(t, salt):
    return replace(t, hfn=hashing.reseed(t.hfn, salt))


def _reseed_two(t, salt):
    """Both functions of a two-row table."""
    return replace(
        t, hfn_a=hashing.reseed(t.hfn_a, salt + TWO_ROW_SALTS["hfn_a"]),
        hfn_b=hashing.reseed(t.hfn_b, salt + TWO_ROW_SALTS["hfn_b"]))


def epoch_leaves(t) -> list:
    """Every tensor leaf of a table (the claim words aside: scratch, equal in
    both tables between launches), each with what its descriptor's
    ``clear`` and ``reseed`` write into it at a rebuild start
    (``probe.epoch_swap``'s specs): the ``clear_fill``, or a hash
    function's seeds with its ``salt_offsets`` entry."""
    be = of_table(t)
    out = []
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if isinstance(v, hashing.HashFn):
            out.append((v.seeds, ("seeds", v.kind, be.salt_offsets[f.name])))
        elif isinstance(v, torch.Tensor) and f.name != "claim":
            fill = be.clear_fill.get(f.name, 0)
            spec = ("desc",) if fill == "desc" else \
                ("fill", t.arena if fill == "arena" else fill)
            out.append((v, spec))
    return out


# ---------------------------------------------------------------------------
# occupancy / probe telemetry
# ---------------------------------------------------------------------------

def _count_tomb(t) -> torch.Tensor:
    return buckets.per_table_sum(t.state == buckets.TOMB, t).to(torch.int32)


def _chain_count_tomb(t: ChainTable) -> torch.Tensor:
    return buckets.per_table_sum(t.astate == buckets.TOMB, t).to(
        torch.int32)


def _linear_probe_cost(t: LinearTable, keys, found, loc) -> torch.Tensor:
    """Probe distance of each hit: the mod folds the hit's slot back to the
    probe index whether or not the probe wrapped."""
    h0 = hashing.bucket_of(t.hfn, keys, t.capacity)
    dist = torch.remainder(loc - h0, t.capacity)
    return torch.where(found & (loc >= 0), dist, 0).to(torch.int32)


def _rows_probe_cost(t, keys, found, loc) -> torch.Tensor:
    """Cost = lane depth within the hit's row (loc = row * width + lane).
    For cuckoo it is also the worst case: a key lives in one of its two
    candidate rows, so no lookup costs more than ``width - 1``."""
    return torch.where(found & (loc >= 0), loc % t.width, 0).to(torch.int32)


def _chain_probe_cost(t: ChainTable, keys, found, loc) -> torch.Tensor:
    """Chain depth of a hit: its offset in the sorted segment; a dirty-tail
    hit (inserted since the last compaction) is charged the segment length
    + 1 — it is at the end of its chain."""
    b = _chain_bq(t, keys).long()
    depth = torch.where(loc < t.sorted_upto, loc - t.bstart[b],
                        t.blen[b] + 1)
    return torch.where(found & (loc >= 0), depth, 0).to(torch.int32)


def _linear_slots_for(capacity: int) -> int:
    return _next_pow2(int(capacity / 0.75) + 1)          # mirrors _make_linear


def _twochoice_slots_for(capacity: int) -> int:
    return _next_pow2(int(capacity / (0.75 * 8)) + 1) * 8   # _make_twochoice


def _cuckoo_slots_for(capacity: int) -> int:
    return 2 * _next_pow2(int(capacity / (0.75 * 2 * 8)) + 1) * 8  # cuckoo


def _chain_slots_for(capacity: int) -> int:
    return int(capacity)                                 # arena = capacity


def _hash_fns_one(t) -> tuple:
    return (t.hfn,)


def _hash_fns_two(t) -> tuple:
    return (t.hfn_a, t.hfn_b)


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
    salt_offsets=ONE_FN_SALTS,
    capacity_of=lambda t: t.capacity,
    with_state=lambda t, s: replace(t, state=s),
    lookup=buckets.linear_lookup,
    insert=buckets.linear_insert,
    delete=buckets.linear_delete,
    extract_chunk=buckets.extract_chunk,
    count_live=buckets.count_live,
    clear=buckets.clear,
    count_tomb=_count_tomb,
    probe_cost=_linear_probe_cost,
    slots_for=_linear_slots_for,
    lookup_fused=linear_lookup_fused,
    lookup_fused_loc=linear_lookup_fused_loc,
    insert_fused=linear_insert_fused,
    delete_fused=linear_delete_fused,
    extract_chunk_fused=extract_chunk_fused,
    transition_fused=transition_fused,
    ordered_lookup_fused=linear_ordered_lookup_fused,
    ordered_delete_fused=linear_ordered_delete_fused,
    stack_ordered_lookup_fused=linear_stack_ordered_lookup_fused,
    stack_ordered_delete_fused=linear_stack_ordered_delete_fused,
    stack_insert_fused=linear_stack_insert_fused,
    stack_transition_fused=transition_fused,
    lookup_fwd=buckets.linear_lookup_fwd,
    hash_fns=_hash_fns_one,
))

TWOCHOICE = register(BucketBackend(
    name="twochoice",
    table_cls=TwoChoiceTable,
    nres_cap=NRES_CAP,
    dirty_cap=0,
    make=_make_twochoice,
    fresh_like=_fresh_twochoice,
    reseed=_reseed_two,
    salt_offsets=TWO_ROW_SALTS,
    capacity_of=lambda t: t.nbuckets * t.width,
    with_state=lambda t, s: replace(t, state=s),
    lookup=buckets.twochoice_lookup,
    insert=buckets.twochoice_insert,
    delete=buckets.twochoice_delete,
    extract_chunk=buckets.extract_chunk,
    count_live=buckets.count_live,
    clear=buckets.clear,
    count_tomb=_count_tomb,
    probe_cost=_rows_probe_cost,
    slots_for=_twochoice_slots_for,
    bounded_placement=True,
    insert_fused=twochoice_insert_fused,
    stack_insert_fused=twochoice_insert_fused,
    **_two_row_fused(_tc_rows),
    hash_fns=_hash_fns_two,
))

CUCKOO = register(BucketBackend(
    name="cuckoo",
    table_cls=CuckooTable,
    nres_cap=NRES_CAP,
    dirty_cap=0,
    make=_make_cuckoo,
    fresh_like=_fresh_cuckoo,
    reseed=_reseed_two,
    salt_offsets=TWO_ROW_SALTS,
    capacity_of=lambda t: 2 * t.nbuckets * t.width,
    with_state=lambda t, s: replace(t, state=s),
    lookup=buckets.cuckoo_lookup,
    insert=buckets.cuckoo_insert,
    delete=buckets.cuckoo_delete,
    extract_chunk=buckets.extract_chunk,
    count_live=buckets.count_live,
    clear=buckets.clear,
    count_tomb=_count_tomb,
    probe_cost=_rows_probe_cost,
    slots_for=_cuckoo_slots_for,
    bounded_placement=True,
    insert_fused=cuckoo_insert_fused,
    stack_insert_fused=cuckoo_insert_fused,
    **_two_row_fused(_ck_rows),
    hash_fns=_hash_fns_two,
))

CHAIN = register(BucketBackend(
    name="chain",
    table_cls=ChainTable,
    nres_cap=NRES_CAP,
    dirty_cap=DIRTY_CAP,
    make=_make_chain,
    fresh_like=_fresh_chain,
    reseed=_reseed_one,
    salt_offsets=ONE_FN_SALTS,
    capacity_of=lambda t: t.arena,
    with_state=lambda t, s: replace(t, astate=s),
    lookup=buckets.chain_lookup,
    insert=buckets.chain_insert,
    delete=buckets.chain_delete,
    extract_chunk=buckets.chain_extract_chunk,
    count_live=buckets.chain_count_live,
    clear=buckets.chain_clear,
    clear_fill={"anext": -1, "heads": -1, "free_stack": "desc",
                "free_top": "arena"},
    count_tomb=_chain_count_tomb,
    probe_cost=_chain_probe_cost,
    slots_for=_chain_slots_for,
    lookup_fused=chain_lookup_fused,
    lookup_fused_loc=chain_lookup_fused_loc,
    insert_fused=_chain_insert_fused_compacting,
    delete_fused=chain_delete_fused,
    extract_chunk_fused=chain_extract_chunk_fused,
    transition_fused=chain_transition_fused,
    ordered_lookup_fused=chain_ordered_lookup_fused,
    ordered_delete_fused=chain_ordered_delete_fused,
    freeze_old=chain_compact_fused,
    hash_fns=_hash_fns_one,
))
