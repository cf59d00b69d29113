"""DHash: a dynamic hash table whose hash function can be rebuilt live.

This is the paper's core contribution (§3-§4) in batched form:

* The table state carries the *old* table, the *new* table (pre-allocated
  with the replacement hash function), and a **hazard buffer** — the batched
  analogue of the paper's ``rebuild_cur`` global pointer.  A rebuild migrates
  a *chunk* of entries per transition instead of one node.

* ``rebuild_extract`` removes a chunk from the old table into the hazard
  buffer (entries are then in *neither* table — the hazard period, Fig 1c);
  ``rebuild_land`` inserts the hazard entries into the new table and clears
  the buffer (Fig 1d).  The engine interleaves full-rate lookup/insert/delete
  batches between these transitions, which is exactly the concurrency
  structure of the paper; stream order plays the role of the paper's
  smp_wmb/smp_rmb pairs.

* Every operation performs the paper's **ordered check** (Lemma 4.1/4.2):
      old table  →  hazard buffer  →  new table.
  Lookup priority is old > hazard > new; delete tries old, then marks hazard
  entries dead (the LOGICALLY_REMOVED bit on an in-flight node, Alg. 5 line
  75 — a killed hazard entry is silently dropped at landing), then tries new.
  Insert targets the new table iff a rebuild is in progress (Lemma 4.3/4.4);
  duplicate keys discovered at landing are dropped in favour of the new
  table's copy (Alg. 3 lines 34-36).

* The epoch swap (Alg. 3 lines 41-46): the host-level forms exchange the two
  table REFERENCES (no table data moves); the device-flag form exchanges the
  tables' CONTENTS in one kernel, so that both containers keep their
  tensors.  The paper's ``synchronize_rcu`` grace periods are step
  boundaries.

* **Backend dispatch is the descriptor registry** (core/backend.py): this
  module contains zero per-backend branches.

Where the reference branches on a device scalar with ``lax.cond``
(``rebuilding``, ``hazard_live.any()``, ``done``), eager PyTorch either
branches on the host or decides on the device.  The functional ops branch on
the host and take the flag as an optional keyword HINT: ``None`` (the
default) reads it from the device — a host synchronisation — and keeps the
reference's semantics whatever the flag is; a caller that already knows the
flag passes it and the function never synchronises.  The DEVICE-FLAG forms
(``lookup_counted_``, ``insert_by_flag``, ``delete_by_flag``,
``rebuild_step_``, ``finish_same_shape_``, ``rebuild_autostart_``) decide
on the device instead: guarded kernel
launches (``extract`` and ``epoch_swap`` skip their work on a device flag;
the rebuild step's transition decides the epoch for the exchange that
follows it) and selects, no host read, and they write every field of the
state IN PLACE (``copy_``, never a rebound field), so that one engine step
can be captured in a CUDA graph and replayed.

Mutation: with ``fused=True`` the ops update the table tensors IN PLACE (the
counterpart of the reference's buffer donation) and return a state container
over the same tensors — a state passed to ``insert``/``delete``/
``rebuild_*`` must not be used again afterwards.  With ``fused=False``
every op is functional.  ``lookup`` never writes.

* **Table stacks** (``make_stack`` + the ``stack_*`` ops): a stack of T
  independent tables is one state whose every tensor leads with [T] (the
  configuration is shared).  The reference ``jax.vmap``s the single-table
  ops, which gives each of its kernels a grid axis over [T]; here the
  descriptor's stack set runs each op as ONE launch of each kernel for the
  T tables, each table's branch (rebuilding or not) picked in the kernel by
  its own device flag (linear, twochoice and cuckoo, ``fused=True``);
  every other stack loops over its tables' views with the single-table
  device-flag forms.  Every
  stack op decides on the device and writes the stack in place; none reads
  the host.  Each table runs its own rebuild epoch (multi-tenant serving).
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import buckets
from repro_torch.core.struct_utils import (assign_, map_tensors, replace,
                                          state_dataclass)

I32 = torch.int32


@state_dataclass
class DHashState:
    backend: str                # registry key (core/backend.py)
    chunk: int                  # hazard buffer capacity (entries per rebuild chunk)
    fwd_hazard: bool            # backends with a lookup_fwd hook (linear):
                                # resolve hazard hits via MIGRATED-slot
                                # forwarding (zero extra passes)
    fused: bool                 # route the FULL op surface (lookup/insert/
                                # delete + rebuild extract and land) through
                                # the descriptor's CUDA-kernel adapters
    nres_cap: int               # kept for parity with the reference's API;
                                # unused by the Hopper linear kernels (they
                                # gather the new table in place, whatever its
                                # size)
    old: Any                    # active table (backend container)
    new: Any                    # target table; meaningful only while rebuilding
    hazard_key: torch.Tensor    # [chunk] i32
    hazard_val: torch.Tensor    # [chunk] i32
    hazard_live: torch.Tensor   # [chunk] bool
    cursor: torch.Tensor        # scalar i32 - scan position in old table
    rebuilding: torch.Tensor    # scalar bool
    epoch: torch.Tensor         # scalar i32
    lookups: torch.Tensor       # scalar i32 - queries sampled by
                                # lookup_counted since the last epoch swap
    expensive: torch.Tensor     # scalar i32 - sampled queries whose probe
                                # cost crossed the threshold

    @property
    def device(self) -> torch.device:
        return self.cursor.device


def _be(d: DHashState) -> backends.BucketBackend:
    """The descriptor every op dispatches through."""
    return backends.get(d.backend)


def _flag(x: torch.Tensor, hint: bool | None) -> bool:
    """A host branch condition: the caller's hint, else a device read."""
    return bool(x) if hint is None else bool(hint)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _make_table(backend: str, capacity: int, seed, **kw):
    """Build an empty backend table sized for ``capacity`` live entries
    (the descriptor's sizing policy)."""
    return backends.get(backend).make(capacity, seed, **kw)


def _fused_default(backend: str) -> bool:
    """Resolve ``fused=None``: the DHASH_FUSED env var (``on``/``1``/``true``)
    turns the kernels on for every backend whose descriptor carries the
    fused op set."""
    flag = os.environ.get("DHASH_FUSED", "off").lower()
    return flag in ("1", "on", "true") and backends.get(backend).fused


def make(backend: str = "linear", capacity: int = 1024, *, chunk: int = 256,
         seed: int = 0, fwd_hazard: bool = False, fused: bool | None = None,
         nres_cap: int | None = None,
         device: torch.device | str = "cuda", **kw) -> DHashState:
    """An empty DHash on ``device`` (the GPU unless the caller asks for the
    CPU).  ``nres_cap`` is accepted for parity with the reference and unused
    by the Hopper linear kernels."""
    be = backends.get(backend)
    if fused is None:
        # fwd_hazard is the alternative (plain) hazard-resolution strategy;
        # the env default must not silently shadow it with the fused branch
        fused = _fused_default(backend) and not fwd_hazard
    if fused and not be.fused:
        raise ValueError(
            f"fused kernels are not implemented for backend {backend!r}; "
            f"fused-capable: "
            f"{tuple(n for n in backends.names() if backends.get(n).fused)}")
    if nres_cap is None:
        nres_cap = be.nres_cap
    old = be.make(capacity, seed, device=device, **kw)
    new = be.make(capacity, seed + 1, device=device, **kw)
    return DHashState(backend=backend, chunk=chunk, fwd_hazard=fwd_hazard,
                      fused=fused, nres_cap=nres_cap, old=old, new=new,
                      hazard_key=torch.zeros(chunk, dtype=I32, device=device),
                      hazard_val=torch.zeros(chunk, dtype=I32, device=device),
                      hazard_live=torch.zeros(chunk, dtype=torch.bool,
                                              device=device),
                      cursor=_scalar(0, I32, device),
                      rebuilding=_scalar(False, torch.bool, device),
                      epoch=_scalar(0, I32, device),
                      lookups=_scalar(0, I32, device),
                      expensive=_scalar(0, I32, device))


# ---------------------------------------------------------------------------
# the ordered check: old -> hazard -> new (Lemma 4.1)
# ---------------------------------------------------------------------------

def _hazard_probe(d: DHashState, keys: torch.Tensor):
    eq = (keys[:, None] == d.hazard_key[None, :]) & d.hazard_live[None, :]
    found = eq.any(-1)
    val, _ = buckets._argpick(eq, d.hazard_val[None, :].expand(eq.shape))
    return found, torch.where(found, val, 0).to(I32)


def _slow_lookup(dd: DHashState, keys: torch.Tensor):
    """Rebuild-epoch lookup body: the full old -> hazard -> new ordered
    check (shared by ``lookup`` and ``lookup_counted``)."""
    be = _be(dd)
    if dd.fused:
        return be.ordered_lookup_fused(
            dd.old, dd.new, dd.hazard_key, dd.hazard_val,
            dd.hazard_live, keys, nres_cap=dd.nres_cap)
    if dd.fwd_hazard and be.lookup_fwd is not None:
        # beyond-paper: the old-table probe already passes over the
        # MIGRATED slots of the in-flight chunk, so the hazard check is
        # a forwarding index, not a second pass
        f_old, v_old, _, mig = be.lookup_fwd(dd.old, keys)
        base = dd.cursor - dd.chunk
        hz_idx = mig - base
        inwin = (mig >= 0) & (hz_idx >= 0) & (hz_idx < dd.chunk)
        safe = torch.clamp(hz_idx, 0, dd.chunk - 1).long()
        f_hz = inwin & dd.hazard_live[safe] & (dd.hazard_key[safe] == keys)
        v_hz = dd.hazard_val[safe]
    else:
        f_old, v_old, _ = be.lookup(dd.old, keys)        # (1) old table
        f_hz, v_hz = _hazard_probe(dd, keys)             # (2) rebuild_cur
    f_new, v_new, _ = be.lookup(dd.new, keys)            # (3) new table
    found = f_old | f_hz | f_new
    val = torch.where(f_old, v_old, torch.where(f_hz, v_hz, v_new))
    return found, val


def _steady_lookup(d: DHashState, keys: torch.Tensor):
    """The steady state's lookup: the old table alone."""
    be = _be(d)
    if d.fused:
        return be.lookup_fused(d.old, keys)
    f, v, _ = be.lookup(d.old, keys)
    return f, v


@torch.no_grad()
def lookup(d: DHashState, keys: torch.Tensor, *,
           rebuilding: bool | None = None):
    """Batched lookup honouring the rebuild protocol. Returns (found, vals).

    With ``fused`` both branches are one kernel launch: ``probe_lookup`` in
    the steady state, ``probe2`` (the whole old -> hazard -> new ordered
    check) during a rebuild epoch.  Never writes ``d``."""
    if _flag(d.rebuilding, rebuilding):
        return _slow_lookup(d, keys)
    return _steady_lookup(d, keys)


@torch.no_grad()
def lookup_counted(d: DHashState, keys: torch.Tensor, *, probe_hi: int = 7,
                   rebuilding: bool | None = None):
    """Lookup that also feeds the probe telemetry.
    Returns ``(state', (found, vals))``.

    The steady-state branch runs the backend's loc-emitting probe (the same
    single kernel launch — ``loc`` is an extra output, not an extra pass),
    converts ``loc`` to a probe cost through the descriptor's
    ``probe_cost``, and bumps ``DHashState.lookups`` / ``.expensive``
    (queries whose cost crossed ``probe_hi``).  The rebuild-epoch branch
    answers through the ordered check WITHOUT sampling."""
    if _flag(d.rebuilding, rebuilding):
        return d, _slow_lookup(d, keys)
    f, v, exp = _counted_sample(d, keys, probe_hi)
    d = replace(d, lookups=d.lookups + keys.numel(),
                expensive=d.expensive + exp)
    return d, (f, v)


def _counted_sample(d: DHashState, keys: torch.Tensor, probe_hi: int):
    """The steady branch of ``lookup_counted``: (found, vals, expensive)."""
    be = _be(d)
    if d.fused and be.lookup_fused_loc is not None:
        f, v, loc = be.lookup_fused_loc(d.old, keys)
    else:
        f, v, loc = be.lookup(d.old, keys)
    cost = be.probe_cost(d.old, keys, f, loc)
    return f, v, (f & (cost >= probe_hi)).sum().to(I32)


def _ins_table(dd: DHashState, t, kk, vv, mm, dedup: bool = True):
    """Descriptor-dispatched insert (shared by user inserts and hazard
    landing, so a fused state's rebuild landing runs the insert kernel).
    ``dedup=False``: the masked keys are already distinct (the fused path
    then skips the kernel's batch_winners; the plain ops always dedup)."""
    be = _be(dd)
    if dd.fused:
        return be.insert_fused(t, kk, vv, mm, dedup=dedup)
    return be.insert(t, kk, vv, mm)


@torch.no_grad()
def insert(d: DHashState, keys: torch.Tensor, vals: torch.Tensor,
           mask: torch.Tensor | None = None, *,
           rebuilding: bool | None = None):
    """Batched insert (set semantics: ok=False if key already present in the
    *target* table — Alg. 6). Returns (state', ok).  A fused state's target
    table is written in place."""
    if mask is None:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    if _flag(d.rebuilding, rebuilding):
        t, ok = _ins_table(d, d.new, keys, vals, mask)
        return replace(d, new=t), ok
    t, ok = _ins_table(d, d.old, keys, vals, mask)
    return replace(d, old=t), ok


@torch.no_grad()
def delete(d: DHashState, keys: torch.Tensor,
           mask: torch.Tensor | None = None, *,
           rebuilding: bool | None = None):
    """Batched delete honouring the ordered check (Alg. 5). Returns (state', ok).

    With ``fused`` the write path is kernel-backed end to end: the steady
    state tombstones via the location-emitting ``probe_lookup`` launch, and
    the rebuild epoch is one ``probe2`` launch whose slot/hazard-index
    outputs drive the old tombstone, the hazard kill, and the new tombstone.
    A fused state's state arrays are written in place."""
    if mask is None:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    be = _be(d)

    def _del(t, kk, mm):
        if d.fused:
            return be.delete_fused(t, kk, mm)
        return be.delete(t, kk, mm)

    if not _flag(d.rebuilding, rebuilding):
        t, ok = _del(d.old, keys, mask)
        return replace(d, old=t), ok

    if d.fused:
        os_, ns_, hl, ok = be.ordered_delete_fused(
            d.old, d.new, d.hazard_key, d.hazard_val, d.hazard_live,
            keys, mask, nres_cap=d.nres_cap)
        return replace(d, old=be.with_state(d.old, os_),
                       new=be.with_state(d.new, ns_), hazard_live=hl), ok

    t_old, ok_old = _del(d.old, keys, mask)                        # (1) old
    pending = mask & ~ok_old
    # (2) hazard buffer: clear the live bit (LOGICALLY_REMOVED on the
    # in-flight node) - landing will drop it.
    eq = (keys[:, None] == d.hazard_key[None, :]) & d.hazard_live[None, :]
    hit_hz = eq.any(-1) & pending
    win_hz = buckets.batch_winners(keys, hit_hz) & hit_hz
    kill = (eq & win_hz[:, None]).any(0)
    hazard_live = d.hazard_live & ~kill
    pending2 = pending & ~hit_hz
    t_new, ok_new = _del(d.new, keys, pending2)                    # (3) new
    ok = ok_old | win_hz | ok_new
    return replace(d, old=t_old, new=t_new, hazard_live=hazard_live), ok


# ---------------------------------------------------------------------------
# rebuild protocol
# ---------------------------------------------------------------------------

def rebuild_start(d: DHashState, new_table=None, *,
                  seed: int | None = None) -> DHashState:
    """Host-level: begin a rebuild into ``new_table`` (fresh hash function).

    Caller contract (paper's rebuild_lock): no rebuild may be in progress.
    """
    be = _be(d)
    if new_table is None:
        if seed is None:
            seed = int(np.random.default_rng().integers(1 << 31))
        new_table = be.fresh_like(d.old, seed)
    if d.fused and be.freeze_old is not None:
        d = replace(d, old=be.freeze_old(d.old))
    return replace(d, new=new_table, cursor=_scalar(0, I32, d.device),
                   rebuilding=_scalar(True, torch.bool, d.device))


@torch.no_grad()
def rebuild_extract(d: DHashState, *, can: bool | None = None) -> DHashState:
    """Pull the next chunk out of the old table into the hazard buffer.

    No-op unless rebuilding with an empty hazard buffer (``can`` is the host
    hint for exactly that condition).  With ``fused`` the scan is ONE launch
    of the extract kernel, which compacts the hazard entries, marks the
    slots MIGRATED in place and advances the cursor on the device."""
    be = _be(d)
    if can is None:
        can = bool(d.rebuilding & ~d.hazard_live.any())
    if not can:
        return d
    if d.fused:
        t, hk, hv, hl, cur = be.extract_chunk_fused(d.old, d.cursor, d.chunk)
    else:
        t, hk, hv, hl, cur = be.extract_chunk(d.old, d.cursor, d.chunk)
    return replace(d, old=t, hazard_key=hk, hazard_val=hv, hazard_live=hl,
                   cursor=cur)


@torch.no_grad()
def rebuild_land(d: DHashState, *,
                 rebuilding: bool | None = None) -> DHashState:
    """Insert hazard entries into the new table; duplicates lose to the copy
    already in the new table (Alg. 3 lines 34-36); entries killed while in
    hazard (delete during the hazard period) are dropped.

    With ``fused`` the landing runs through the SAME insert kernel as user
    inserts.

    A landing insert can fail two ways and they MUST be told apart: the key
    is already in the new table (a user re-inserted it during the hazard
    window — the new copy wins, drop the hazard entry), or the new table
    had no slot within the probe bound (the hazard entry is the ONLY copy of
    an acknowledged insert, so it stays live and the next transition
    retries).  The reference tells them apart with a presence lookup behind
    a ``cond`` on ``failed.any()``; a host branch there would cost a second
    synchronisation, so the check runs unconditionally: the insert kernel
    already proves presence and hands it back (fused), or a chunk-sized
    plain lookup follows the insert (plain)."""
    be = _be(d)
    if not _flag(d.rebuilding, rebuilding):
        return d
    if d.fused:
        t, ok, present = be.insert_fused(d.new, d.hazard_key, d.hazard_val,
                                         d.hazard_live, with_present=True)
    else:
        t, ok = be.insert(d.new, d.hazard_key, d.hazard_val, d.hazard_live)
        present, _, _ = be.lookup(t, d.hazard_key)
    keep = d.hazard_live & ~ok & ~present      # keep only the capacity fails
    return replace(d, new=t, hazard_live=keep)


def rebuild_chunk(d: DHashState) -> DHashState:
    """extract + land in one transition (hazard window not externally visible).
    Engines that want the observable hazard period call the two halves."""
    return rebuild_land(rebuild_extract(d))


def rebuild_done(d: DHashState) -> torch.Tensor:
    """Scalar bool tensor: all chunks migrated and landed."""
    return d.rebuilding & (d.cursor >= _be(d).capacity_of(d.old)) \
        & ~d.hazard_live.any()


def _swap(d: DHashState) -> DHashState:
    # probe telemetry is per-table-generation: a fresh epoch samples afresh
    dev = d.device
    return replace(d, old=d.new, new=d.old, cursor=_scalar(0, I32, dev),
                   rebuilding=_scalar(False, torch.bool, dev),
                   epoch=d.epoch + 1, lookups=_scalar(0, I32, dev),
                   expensive=_scalar(0, I32, dev))


def rebuild_finish(d: DHashState, *, done: bool | None = None) -> DHashState:
    """Host-level epoch swap (Alg. 3 lines 41-46); old/new may differ in
    shape.  O(1): the two table references change places."""
    assert _flag(rebuild_done(d), done), "rebuild not complete"
    return _swap(d)


def finish_same_shape(d: DHashState, *,
                      done: bool | None = None) -> DHashState:
    """Epoch swap if the rebuild is done, else ``d`` unchanged.  The
    reference selects every leaf of both tables on the device; here the two
    table REFERENCES change places on the host, so no table data moves."""
    if not _flag(rebuild_done(d), done):
        return d
    return _swap(d)


def rebuild_step(d: DHashState, *, hazard_pending: bool | None = None,
                 rebuilding: bool | None = None) -> DHashState:
    """One rebuild transition per call: land if hazard pending, else extract.
    Interleave with op batches for concurrent-rebuild execution."""
    if _flag(d.hazard_live.any(), hazard_pending):
        return rebuild_land(d, rebuilding=rebuilding)
    return rebuild_extract(
        d, can=None if rebuilding is None else bool(rebuilding))


@torch.no_grad()
def rebuild_autostart(d: DHashState, *,
                      rebuilding: bool | None = None) -> DHashState:
    """Device-side rebuild start: when NOT rebuilding, clear the (drained)
    standby table (an O(C) memset, once an epoch), reseed its hash function
    on the device from the device-side epoch counter (hashing.reseed — no
    host RNG, no host read), and raise ``rebuilding``.  Valid when old/new
    share shapes (same-capacity rebuilds)."""
    be = _be(d)
    if _flag(d.rebuilding, rebuilding):
        return d
    new = be.clear(d.new)
    new = be.reseed(new, d.epoch + 1)
    old = d.old
    if d.fused and be.freeze_old is not None:
        old = be.freeze_old(old)
    return replace(d, old=old, new=new, cursor=_scalar(0, I32, d.device),
                   rebuilding=_scalar(True, torch.bool, d.device))


# ---------------------------------------------------------------------------
# device-flag forms: every branch decided on the device, every field written
# in place (what an engine step runs; see the module docstring)
# ---------------------------------------------------------------------------

@torch.no_grad()
def lookup_counted_(d: DHashState, keys: torch.Tensor, *,
                    probe_hi: int = 7):
    """``lookup_counted`` decided on the device, IN PLACE: both branches of
    the reference's cond run — the steady state's loc-emitting probe of the
    old table and the rebuild epoch's ordered check — and the DEVICE flag
    ``rebuilding`` picks the answers; ``lookups`` / ``expensive`` are bumped
    (written in place) only where it is clear, as the reference samples only
    in its steady branch.  For a caller whose host copy of the flag may be
    stale in either direction (a policy engine: a rehash can start on the
    device between polls).  Returns (found, vals)."""
    f, v, exp = _counted_sample(d, keys, probe_hi)
    f_rb, v_rb = _slow_lookup(d, keys)
    rb = d.rebuilding
    d.lookups.copy_(torch.where(rb, d.lookups, d.lookups + keys.numel()))
    d.expensive.copy_(torch.where(rb, d.expensive, d.expensive + exp))
    return torch.where(rb, f_rb, f), torch.where(rb, v_rb, v)


@torch.no_grad()
def lookup_by_flag(d: DHashState, keys: torch.Tensor):
    """``lookup`` decided on the device: both of the reference's branches
    run, and the DEVICE flag ``rebuilding`` picks the answers.  Never
    writes ``d``.  Returns (found, vals)."""
    f, v = _steady_lookup(d, keys)
    f_rb, v_rb = _slow_lookup(d, keys)
    rb = d.rebuilding
    return torch.where(rb, f_rb, f), torch.where(rb, v_rb, v)


@torch.no_grad()
def insert_by_flag(d: DHashState, keys: torch.Tensor, vals: torch.Tensor,
                   mask: torch.Tensor | None = None):
    """``insert`` whose target the DEVICE flag ``rebuilding`` picks: the new
    table where it is set, else the old one — two masked calls that share
    one ``batch_winners``, one of which inserts nothing.  For a caller whose
    host copy of the flag may be stale (a rebuild epoch that ended on the
    device).  Writes ``d``'s tensors in place.  Returns (d, ok)."""
    if mask is None:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    win = buckets.batch_winners(keys, mask)
    ok = torch.zeros_like(win)
    for t, m in ((d.new, win & d.rebuilding), (d.old, win & ~d.rebuilding)):
        t2, ok_t = _ins_table(d, t, keys, vals, m, dedup=False)
        assign_(t, t2)
        ok |= ok_t
    return d, ok


@torch.no_grad()
def delete_by_flag(d: DHashState, keys: torch.Tensor,
                   mask: torch.Tensor | None = None):
    """``delete`` whatever the DEVICE flag ``rebuilding`` says: the ordered
    check, which is right either way (an idle table's hazard buffer is dead
    and its standby holds nothing LIVE), IN PLACE.  Returns (d, ok)."""
    return d, _ordered_delete_(d, keys, _ones(keys, mask))


@torch.no_grad()
def rebuild_step_(d: DHashState, *, swap: bool = False,
                  start: bool = False) -> torch.Tensor:
    """``rebuild_step`` decided on the device, IN PLACE: the landing runs
    every call (an insert of the live hazard entries — nothing when none is
    live), then ONE transition launch (``backend.transition_fused``): a
    snapshot of ``hazard_live.any()`` taken before the buffer changes, the
    landing's bookkeeping, the chunk scan where ``rebuilding`` is set and
    nothing was pending (one transition a call, as the reference's
    ``lax.cond(hazard_live.any(), land, extract)``), and the epoch decision
    that ``finish_same_shape_(d, go=...)`` takes: ``swap`` allows the swap,
    ``start`` the next start.  Returns go[2] bool on the device: (swap,
    start).  A plain state (``fused=False``) runs the same sequence as
    plain ops (``_rebuild_step_plain_``)."""
    if not d.fused:
        return _rebuild_step_plain_(d, swap, start)
    be = _be(d)
    hazard = (d.hazard_key, d.hazard_val, d.hazard_live)
    # the hazard keys are distinct: extracted from one table's LIVE slots
    _, ok, present = be.insert_fused(d.new, *hazard, with_present=True,
                                     dedup=False)
    return be.transition_fused(d.old, d.cursor, d.chunk, hazard,
                               d.rebuilding, ok, present, swap, start)


def _rebuild_step_plain_(d: DHashState, swap: bool,
                         start: bool) -> torch.Tensor:
    """``rebuild_step_`` on a plain state: the plain insert and lookup, the
    keep mask, the position-aligned plain scan selected on the device, the
    epoch decision."""
    from repro_torch.kernels import probe
    be = _be(d)
    pending = d.hazard_live.any()
    t, ok = be.insert(d.new, d.hazard_key, d.hazard_val, d.hazard_live)
    present, _, _ = be.lookup(t, d.hazard_key)
    assign_(d.new, t)
    d.hazard_live.copy_(d.hazard_live & ~ok & ~present)
    t, *scan = be.extract_chunk(d.old, d.cursor, d.chunk)
    go = d.rebuilding & ~pending
    assign_(d.old, t, go)
    for dst, src in zip((d.hazard_key, d.hazard_val, d.hazard_live,
                         d.cursor), scan):
        assign_(dst, src, go)
    return torch.stack(probe._epoch_flags(
        d.hazard_live, d.cursor, d.rebuilding, be.capacity_of(d.old), swap,
        start))


def _epoch_(d: DHashState, swap: bool, start: bool,
            go: torch.Tensor | None = None) -> torch.Tensor:
    """One ``epoch_swap`` call over both tables' leaves (the plain version
    on a plain state) — the exchange on ``go`` where the step's transition
    decided, else the decision and the exchange — then chain's freeze of
    the old arena, taken where the start happened.  Returns go[2]:
    (swapped, started)."""
    from repro_torch.kernels import probe
    be = _be(d)
    lo, ln = backends.epoch_leaves(d.old), backends.epoch_leaves(d.new)
    fn = probe.epoch_swap if d.fused else probe.epoch_swap_plain
    go = fn([x for x, _ in lo], [x for x, _ in ln], [s for _, s in lo],
            d.hazard_live, d.cursor, d.rebuilding, d.epoch, d.lookups,
            d.expensive, be.capacity_of(d.old), swap, start, go)
    if start and d.fused and be.freeze_old is not None:
        be.freeze_old(d.old, go[1])
    return go


@torch.no_grad()
def finish_same_shape_(d: DHashState, *, autostart: bool = False,
                       go: torch.Tensor | None = None) -> torch.Tensor:
    """``finish_same_shape`` decided on the device, IN PLACE (old/new must
    share shapes): where the rebuild is done, the two tables' contents change
    places and the scalars reset, as the reference's select does.  With
    ``autostart`` the same launch then runs ``rebuild_autostart_``'s start
    (the continuous-rebuild engine's swap and restart in one step).  ``go``
    is the decision of this step's ``rebuild_step_(d, swap=True,
    start=autostart)``, which leaves the exchange alone to launch; without
    it the call decides from the state.  Returns go[2] bool on the device:
    (swapped, started)."""
    return _epoch_(d, swap=True, start=autostart, go=go)


@torch.no_grad()
def rebuild_autostart_(d: DHashState) -> torch.Tensor:
    """``rebuild_autostart`` decided on the device, IN PLACE: where no
    rebuild runs, clear the standby, reseed its hash functions from
    ``epoch + 1``, raise ``rebuilding`` (cursor 0), and freeze the old
    table (chain).  Returns go[2] as ``finish_same_shape_``."""
    return _epoch_(d, swap=False, start=True)


# ---------------------------------------------------------------------------
# convenience loops
# ---------------------------------------------------------------------------

def rebuild_all(d: DHashState, *, finish: bool = True) -> DHashState:
    """Run a complete rebuild to quiescence (host loop; used by tests that
    don't care about interleaving)."""
    cap = _be(d).capacity_of(d.old)
    steps = -(-cap // d.chunk) + 1  # +1 in case a hazard chunk is already pending
    for _ in range(steps):
        if bool(rebuild_done(d)):
            break
        d = rebuild_chunk(d)
    return rebuild_finish(d) if finish else d


def count_items(d: DHashState) -> torch.Tensor:
    be = _be(d)
    return (be.count_live(d.old) + be.count_live(d.new)
            + d.hazard_live.sum()).to(I32)


# ---------------------------------------------------------------------------
# table stacks: T independent tables on a leading axis
# ---------------------------------------------------------------------------
#
# A stack is an ordinary DHashState whose every tensor leads with [T] (the
# configuration — backend, chunk, fused, the tables' sizes — is shared).
# Where the descriptor has the stack set (linear, twochoice and cuckoo,
# fused=True) each op is one launch of each kernel for all T tables, each
# table's branch picked by its own device flag in the kernel; otherwise each
# op runs the single-table device-flag form on each table's view
# (``_table``), which writes through to the stack.  No stack op reads the
# host.

def make_stack(n_tables: int, backend: str = "linear", capacity: int = 1024,
               *, chunk: int = 256, seed: int = 0,
               device: torch.device | str = "cuda", **kw) -> DHashState:
    """``n_tables`` independent tables (table i seeded ``seed + i``, so
    their hash functions differ) stacked on a leading [T] axis."""
    if n_tables < 1:
        raise ValueError(f"need at least one table, got {n_tables}")
    tables = [make(backend, capacity, chunk=chunk, seed=seed + i,
                   device=device, **kw) for i in range(n_tables)]
    return map_tensors(lambda *xs: torch.stack(xs), *tables)


def stack_size(d: DHashState) -> int:
    """T of a stacked state (the leading axis of its scalars)."""
    return d.cursor.shape[0]


def _table(d: DHashState, i: int) -> DHashState:
    """Table ``i`` of a stack as a VIEW: its writes land in the stack (a
    row of a contiguous [T, ...] tensor is contiguous, as the kernels
    require)."""
    return map_tensors(lambda x: x[i], d)


def unstack(d: DHashState) -> list[DHashState]:
    """The T tables of a stack as independent single-table states
    (copies)."""
    return [map_tensors(lambda x: x[i].clone(), d)
            for i in range(stack_size(d))]


def _one_launch(d: DHashState) -> bool:
    """Whether the stack's ops run as one launch of each kernel for all its
    tables (the descriptor's stack set, on a fused stack)."""
    return d.fused and _be(d).stack_fused


def _each(d: DHashState, fn, *rows) -> tuple:
    """``fn(table i, row i of each of rows)`` for every table, its results
    stacked (the loop over the views)."""
    outs = [fn(_table(d, i), *(r[i] for r in rows))
            for i in range(stack_size(d))]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _ones(keys: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    return mask


@torch.no_grad()
def stack_lookup(d: DHashState, keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Lookup over the stack: keys [T, Q] -> (found, vals) [T, Q], each
    table on its own branch.  ``mask`` squelches ``found`` for padding
    slots (a routed batch's zero padding never reports a hit).  Never
    writes ``d``."""
    if _one_launch(d):
        found, vals, _ = _be(d).stack_ordered_lookup_fused(
            d.old, d.new, d.hazard_key, d.hazard_val, d.hazard_live, keys,
            d.rebuilding)
    else:
        found, vals = _each(d, lookup_by_flag, keys)
    if mask is not None:
        found = found & mask
    return found, vals


@torch.no_grad()
def stack_lookup_counted_(d: DHashState, keys: torch.Tensor, *,
                          probe_hi: int = 7):
    """``lookup_counted`` over the stack, IN PLACE: each table answers on
    its own branch and samples the probe telemetry (``lookups`` /
    ``expensive`` [T]) only where it is not rebuilding.  Returns (found,
    vals) [T, Q]."""
    if not _one_launch(d):
        return _each(d, lambda t, k: lookup_counted_(t, k,
                                                     probe_hi=probe_hi),
                     keys)
    be = _be(d)
    found, vals, loc = be.stack_ordered_lookup_fused(
        d.old, d.new, d.hazard_key, d.hazard_val, d.hazard_live, keys,
        d.rebuilding)
    cost = be.probe_cost(d.old, keys, found, loc)
    exp = (found & (cost >= probe_hi)).sum(-1).to(I32)
    rb = d.rebuilding
    d.lookups.copy_(torch.where(rb, d.lookups, d.lookups + keys.shape[-1]))
    d.expensive.copy_(torch.where(rb, d.expensive, d.expensive + exp))
    return found, vals


@torch.no_grad()
def stack_insert(d: DHashState, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Insert over the stack ([T, Q] operands), each table into its target
    (the new table where it is rebuilding, else the old one), IN PLACE.
    Returns (d, ok)."""
    mask = _ones(keys, mask)
    if _one_launch(d):
        _, ok = _be(d).stack_insert_fused(d.old, keys, vals, mask,
                                          alt=d.new, use_alt=d.rebuilding)
        return d, ok
    return d, _each(d, lambda t, k, v, m: insert_by_flag(t, k, v, m)[1],
                    keys, vals, mask)


def _ordered_delete_(t: DHashState, keys, mask) -> torch.Tensor:
    """One table's delete through the ordered check, IN PLACE: right
    whether or not it is rebuilding (an idle table's hazard buffer is dead
    and its standby holds nothing LIVE).  Returns ok."""
    t2, ok = delete(t, keys, mask, rebuilding=True)
    assign_(t, t2)
    return ok


@torch.no_grad()
def stack_delete(d: DHashState, keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Delete over the stack ([T, Q] operands), each table on its own
    branch, IN PLACE.  Returns (d, ok)."""
    mask = _ones(keys, mask)
    if _one_launch(d):
        _, _, hl, ok = _be(d).stack_ordered_delete_fused(
            d.old, d.new, d.hazard_key, d.hazard_val, d.hazard_live, keys,
            mask, d.rebuilding)
        d.hazard_live.copy_(hl)
        return d, ok
    return d, _each(d, _ordered_delete_, keys, mask)


@torch.no_grad()
def stack_rebuild_step_(d: DHashState, *, swap: bool = False,
                        start: bool = False) -> torch.Tensor:
    """``rebuild_step_`` on every table of the stack, IN PLACE: one
    transition on each rebuilding table (epochs advance independently; idle
    tables are untouched) and each table's epoch decision.  Returns
    go[T, 2] on the device (``finish_same_shape_``'s)."""
    if not _one_launch(d):
        return _each(d, lambda t: rebuild_step_(t, swap=swap, start=start))
    be = _be(d)
    hazard = (d.hazard_key, d.hazard_val, d.hazard_live)
    _, ok, present = be.stack_insert_fused(d.new, *hazard, with_present=True,
                                           dedup=False)
    return be.stack_transition_fused(d.old, d.cursor, d.chunk, hazard,
                                     d.rebuilding, ok, present, swap, start)


def stack_rebuild_step(d: DHashState) -> DHashState:
    """One rebuild transition on every (rebuilding) table of the stack, IN
    PLACE.  Returns ``d``."""
    stack_rebuild_step_(d)
    return d


def _stack_epoch_(d: DHashState, swap: bool, start: bool,
                  go: torch.Tensor | None = None) -> torch.Tensor:
    """``_epoch_`` over the stack: one ``epoch_swap`` call on the stacked
    leaves (each table on its own go row), or each table's view."""
    if _one_launch(d):
        return _epoch_(d, swap, start, go)
    if go is None:
        return _each(d, lambda t: _epoch_(t, swap, start))
    return _each(d, lambda t, g: _epoch_(t, swap, start, g), go)


@torch.no_grad()
def stack_finish_same_shape_(d: DHashState, *, autostart: bool = False,
                             go: torch.Tensor | None = None) -> torch.Tensor:
    """``finish_same_shape_`` on every table: each swaps exactly when ITS
    rebuild is done (staggered epochs across the stack), and with
    ``autostart`` restarts.  ``go`` is ``stack_rebuild_step_``'s decision.
    Returns go[T, 2]."""
    return _stack_epoch_(d, True, autostart, go)


def stack_finish_same_shape(d: DHashState) -> DHashState:
    """Per-table epoch swap, IN PLACE.  Returns ``d``."""
    stack_finish_same_shape_(d)
    return d


@torch.no_grad()
def stack_autostart(d: DHashState, start=None) -> DHashState:
    """Begin a rebuild on the tables selected by ``start`` ([T] bool, all by
    default), IN PLACE, decided on the device: tables already rebuilding
    are untouched.  Returns ``d``."""
    rb = d.rebuilding
    start = torch.ones_like(rb) if start is None else \
        torch.as_tensor(start, dtype=torch.bool).to(rb.device)
    _stack_epoch_(d, False, True, torch.stack(
        [torch.zeros_like(rb), start & ~rb], -1))
    return d


def stack_rebuild_done(d: DHashState) -> torch.Tensor:
    """[T] bool: which tables have a completed-but-unswapped rebuild."""
    return d.rebuilding & (d.cursor >= _be(d).capacity_of(d.old)) \
        & ~d.hazard_live.any(-1)


def stack_count_items(d: DHashState) -> torch.Tensor:
    """[T] i32: live entries a table (old + new + hazard)."""
    be = _be(d)
    return (be.count_live(d.old) + be.count_live(d.new)
            + d.hazard_live.sum(-1)).to(I32)
