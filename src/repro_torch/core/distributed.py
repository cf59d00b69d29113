"""Distributed DHash: the table sharded over S shards, queries routed to
their owners.

Ownership is by a FIXED owner hash (never rebuilt): shard s owns key k iff
``hash_u32(owner_hfn, k) % S == s`` (``shard_of``).  Rebuilds swap each
shard's LOCAL hash functions; every shard runs the same transition stream,
so the epochs stay in step, as in the reference.

Routing is the reference's: a sort-free two-level counting pass
(``_route``) lays a batch out in a ``[S, cap + spill_cap]`` send buffer —
pass 1 a one-hot histogram, a running rank within each owner and a global
rank among the keys past their owner's ``cap``; pass 2 ONE scatter that
puts a key at column ``rank`` of its owner's row, or, past the cap, at the
shared spill-slab column ``cap + spill_rank``.  A key the buffer cannot
carry (a compact slab run out) is counted exactly in ``Route.dropped`` and
written nowhere.  ``route_cap`` / ``route_spill_cap`` size the buffer;
``_route_col``, ``_route_payload`` and ``_unroute`` move per-key payloads
into the layout and responses back to batch order (a dropped float comes
back NaN, anything else 0).  The pass issues no sort and reads nothing on
the host.

The exchange (``all_to_all``: row s of the send buffer to shard s) has two
forms, and every routed op runs either through the same ``_route`` and the
same table ops.  The ``axis`` argument names the form; neither falls back
to the other:

* **One process a shard** (the reference's ``shard_map`` over a mesh
  axis): ``axis`` is a ``torch.distributed`` process group of S ranks,
  ``d`` this rank's table, a batch ``[Q]``, and the exchange is
  ``dist.all_to_all_single`` (NCCL between cards, gloo on the CPU).  The
  shard-local ops are the single-table device-flag forms
  (``dhash.lookup_by_flag``, ``insert_by_flag``, ``delete_by_flag``,
  ``rebuild_step_``).
* **All S shards in one process** (``axis = InProcess(S)``): ``d`` is a
  stack of the S shards' tables (``make_stacked``), every source shard's
  batch comes at once (``[S, Q]``), ``_route`` runs row-wise over the
  leading source axis, and the exchange is the transpose ``[S_src, S_dst,
  ...] -> [S_dst, S_src, ...]``.  The shard-local ops are the stack ops, so
  each is one launch of each kernel for all S shards on a fused linear,
  twochoice or cuckoo stack.  This is how one card holds S shards.

``routed_lookup`` / ``routed_update`` / ``routed_rebuild_step`` run a
routed op on one table a shard (four ``all_to_all`` calls an op: keys and
mask out, two results back; or keys, values and mask out, ok back).
The S x T grid (``grid_owner``, ``routed_stack_lookup``,
``routed_stack_update``) routes to the PAIR (shard, tenant): flat owner
``shard * T + tenant`` goes through one exchange pair into each shard's
T-table tenant stack (``dhash.make_stack``; in-process, one stack of S·T
tables, shard-major), and one stack op serves every (source shard, tenant)
cell.  ``routed_service_step`` is the paper's steady workload as one
routed step — a lookup batch, an insert batch, a delete batch and one
rebuild transition — with no host read, so it can be captured in one CUDA
graph.  ``make_stacked`` / ``peel`` / ``unpeel`` build the shards' stack
and view a shard's table in a one-table stack.  ``all_to_all.calls``
counts exchanges (a harness reads it).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import dhash, hashing
from repro_torch.core.struct_utils import map_tensors

I32 = torch.int32


class InProcess:
    """The in-process form's axis: all ``nshards`` shards in one process,
    their tables one stack, the exchange a transpose."""

    __slots__ = ("nshards",)

    def __init__(self, nshards: int):
        if nshards < 1:
            raise ValueError(f"need at least one shard, got {nshards}")
        self.nshards = int(nshards)

    def __repr__(self) -> str:
        return f"InProcess({self.nshards})"


def _axis_size(axis) -> int:
    """S of an axis: an ``InProcess`` axis's shards, or the world size of a
    ``torch.distributed`` process group; anything else raises."""
    if isinstance(axis, InProcess):
        return axis.nshards
    if dist.is_available() and isinstance(axis, dist.ProcessGroup):
        return dist.get_world_size(axis)
    raise TypeError(f"axis must be a torch.distributed process group or "
                    f"InProcess(S), got {axis!r}")


def all_to_all(buf: torch.Tensor, axis) -> torch.Tensor:
    """The exchange.  One process a shard: ``buf`` [S, ...], row s sent to
    rank s; returns [S, ...], row s received from rank s.  In-process:
    ``buf`` [S_src, S_dst, ...] -> [S_dst, S_src, ...].  A bool buffer
    travels as bytes."""
    all_to_all.calls += 1
    if isinstance(axis, InProcess):
        return buf.transpose(0, 1).contiguous()
    _axis_size(axis)
    wire = buf.contiguous()
    if wire.dtype == torch.bool:
        wire = wire.view(torch.uint8)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=axis)
    return out.view(torch.bool) if buf.dtype == torch.bool else out


all_to_all.calls = 0


class Route(NamedTuple):
    """The routing layout of one batch (of each source row's batch, with a
    leading source axis in the in-process form): the [S, cap + spill_cap]
    send buffer (primary columns, then spill-slab columns shared by spill
    rank), the per-key coordinates that invert it, and exact overflow and
    drop accounting."""
    send: torch.Tensor        # [S, cap + spill_cap] keys
    smask: torch.Tensor       # [S, cap + spill_cap] bool: slot carries a key
    owner: torch.Tensor       # [Q] i32 owner of each key (batch order)
    rank: torch.Tensor        # [Q] i32 arrival rank within its owner
    kept: torch.Tensor        # [Q] bool: rank < cap (primary columns)
    overflow: torch.Tensor    # [S] i32 exact per-owner spill
    cap: int                  # primary width
    spill_cap: int            # slab width
    spill_rank: torch.Tensor  # [Q] i32 global rank among spilled keys
    served: torch.Tensor      # [Q] bool: kept, or spilled within the slab
    slab_owner: torch.Tensor  # [spill_cap] i32 owner of each slab column,
                              # -1 where empty
    dropped: torch.Tensor     # [S] i32 exact per-owner keys past the slab


def route_cap(cap_factor: float, q: int, nshards: int) -> int:
    """The capped-dispatch buffer width ``cap = ceil(c·Q/S)``, clamped to
    [1, Q]; ``cap_factor <= 0`` means the overflow-proof full width.  The
    ceil is taken on the whole product ``c·Q/S``."""
    if cap_factor <= 0:
        return q
    return min(q, max(1, math.ceil(cap_factor * q / nshards)))


def route_spill_cap(q: int, cap: int, slack: float | None = None) -> int:
    """Spill-slab width for a [Q] batch routed at ``cap`` per owner: total
    spill over any batch is at most ``Q - cap``, so the default
    (``slack=None``) is that overflow-proof bound; a ``slack`` in (0, 1)
    sizes a compact slab ``ceil(slack·Q)`` (clamped to the bound), whose
    shortfall ``Route.dropped`` counts exactly; ``slack <= 0`` disables the
    slab."""
    worst = max(q - cap, 0)
    if slack is None:
        return worst
    if slack <= 0:
        return 0
    return min(worst, math.ceil(slack * q))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., n] as [rows, n]: one row a source batch."""
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1])


def _scatter_rows(dst_width: int, idx: torch.Tensor, src: torch.Tensor,
                  ok: torch.Tensor, lead: tuple, fill=0) -> torch.Tensor:
    """Row r's ``src[r, i]`` at column ``idx[r, i]`` of an all-``fill``
    [rows, dst_width] buffer where ``ok[r, i]``; the others write a sink
    past the buffer's end, which is cut off: nothing is written out of
    bounds.  Returns [*lead, dst_width]."""
    r = idx.shape[0]
    base = torch.arange(r, device=idx.device)[:, None] * dst_width
    flat = torch.where(ok, idx.long() + base, r * dst_width)
    out = torch.full((r * dst_width + 1,), fill, dtype=src.dtype,
                     device=src.device)
    out.scatter_(0, flat.view(-1), src.reshape(-1))
    return out[:-1].view(*lead, dst_width)


def _route(keys: torch.Tensor, owner: torch.Tensor, nshards: int,
           cap: int | None = None, spill_cap: int = 0) -> Route:
    """Group keys by owner into a [S, cap + spill_cap] send buffer: the
    reference's two-level single-pass counting layout, no sort, no host
    read.  Pass 1: the one-hot histogram, each key's stable rank within its
    owner (a running count), the global rank among the keys past their
    owner's cap.  Pass 2: ONE scatter of the keys, each at column ``rank``
    of its owner's row, or at slab column ``cap + spill_rank``; a key past
    the slab is masked, never written.  ``smask`` follows from the
    histogram and ``slab_owner``.  Keys [..., Q] route each leading row on
    its own (the in-process form's source shards)."""
    q, lead, dev = keys.shape[-1], tuple(keys.shape[:-1]), keys.device
    cap = q if cap is None else cap
    spill_cap = 0 if cap >= q else min(spill_cap, q - cap)
    width = cap + spill_cap
    owner = _rows(owner.to(I32))
    shards = torch.arange(nshards, dtype=I32, device=dev)
    # the one-hot counts run along the batch, the contiguous last axis: on
    # an H100 a scan along the middle axis of [R, Q, S] is ~18x slower
    # (6.1 against 0.34 ms at R x Q = 4 x 65536, chip_smoke.py 3j)
    onehot = (owner[:, None, :] == shards[:, None]).to(I32)      # [R, S, Q]
    hist = onehot.sum(2, dtype=I32)                              # [R, S]
    rank = (torch.cumsum(onehot, 2, dtype=I32) - 1).gather(
        1, owner.long()[:, None, :])[:, 0, :]                    # [R, Q]
    kept = rank < cap
    spilled = ~kept
    spill_rank = torch.cumsum(spilled.to(I32), 1, dtype=I32) - 1
    served = kept | (spilled & (spill_rank < spill_cap))
    col = torch.where(kept, rank, cap + spill_rank)
    send = _scatter_rows(nshards * width, owner.long() * width + col,
                         _rows(keys), served, lead)
    send = send.view(*lead, nshards, width)
    slab_owner = _scatter_rows(spill_cap, spill_rank, owner,
                               spilled & (spill_rank < spill_cap), lead, -1)
    primary = torch.arange(cap, device=dev) < torch.clamp(
        hist, max=cap)[:, :, None]                               # [R, S, cap]
    slab = _rows(slab_owner)[:, None, :] == shards[:, None]
    smask = torch.cat([primary, slab], 2).view(*lead, nshards, width)
    overflow = torch.clamp(hist - cap, min=0)
    dropped = (onehot * (spilled & ~served).to(I32)[:, None, :]).sum(
        2, dtype=I32)

    def out(x):
        return x.view(*lead, *x.shape[1:])
    return Route(send, smask, out(owner), out(rank), out(kept), out(overflow),
                 cap, spill_cap, out(spill_rank), out(served), slab_owner,
                 out(dropped))


def _route_col(rt: Route) -> torch.Tensor:
    """Per-key column in the [S, cap + spill_cap] layout (past the buffer
    for keys it does not carry: pair with ``served``)."""
    return torch.where(rt.kept, rt.rank, rt.cap + rt.spill_rank)


def _flat_slot(rt: Route) -> torch.Tensor:
    """Per-key slot in its row's flattened [S * width] layout, [R, Q]."""
    width = rt.send.shape[-1]
    q = rt.owner.shape[-1]
    return _rows(rt.owner).long() * width + _rows(_route_col(rt))


def _route_payload(payload: torch.Tensor, rt: Route) -> torch.Tensor:
    """Scatter a per-key payload (values, masks) into the layout of a
    ``Route`` computed for the same batch: primary AND slab slots; a
    dropped key's slot stays zero."""
    nshards, width = rt.send.shape[-2:]
    q = rt.owner.shape[-1]
    out = _scatter_rows(nshards * width, _flat_slot(rt), _rows(payload),
                        _rows(rt.served), tuple(rt.owner.shape[:-1]))
    return out.view(rt.send.shape)


def _unroute(resp: torch.Tensor, rt: Route, fill=None) -> torch.Tensor:
    """Invert a ``Route`` for a [S, cap + spill_cap] response: each key's
    slot gathered back to batch order.  Dropped keys take ``fill``: by
    default NaN for a float response, else 0."""
    if fill is None:
        fill = math.nan if resp.dtype.is_floating_point else 0
    q = rt.owner.shape[-1]
    served = _rows(rt.served)
    flat = resp.reshape(served.shape[0], -1)
    got = flat.gather(1, torch.where(served, _flat_slot(rt), 0))
    out = torch.where(served, got, torch.full((), fill, dtype=resp.dtype,
                                              device=resp.device))
    return out.view(rt.owner.shape)


def shard_of(keys: torch.Tensor, nshards: int,
             owner_hfn: hashing.HashFn) -> torch.Tensor:
    """Owning shard of each key under the FIXED (never-rebuilt) owner
    hash."""
    return torch.remainder(hashing.hash_u32(owner_hfn, keys),
                           nshards).to(I32)


def grid_owner(keys: torch.Tensor, tenant: torch.Tensor, nshards: int,
               ntenants: int, owner_hfn: hashing.HashFn) -> torch.Tensor:
    """Flat [S·T] owner id of each key: ``shard_of(key) * T + tenant``."""
    return shard_of(keys, nshards, owner_hfn) * ntenants + tenant.to(I32)


# ---------------------------------------------------------------------------
# one table a shard
# ---------------------------------------------------------------------------

def _check_batch(d: dhash.DHashState, keys: torch.Tensor, axis) -> int:
    """S of ``axis``, checking the form's operands: one process a shard
    takes a batch [Q]; the in-process form a stack of S tables and [S, Q]
    (one batch a source shard)."""
    s = _axis_size(axis)
    if isinstance(axis, InProcess):
        if keys.dim() != 2 or keys.shape[0] != s or \
                d.cursor.shape != (s,):
            raise ValueError(f"in-process routing over {s} shards takes a "
                             f"stack of {s} tables and [{s}, Q] batches")
    elif keys.dim() != 1 or d.cursor.dim() != 0:
        raise ValueError("routing over a process group takes one table and "
                         "a [Q] batch a rank")
    return s


def _local(rx: torch.Tensor, axis) -> torch.Tensor:
    """A received [S_src, c] buffer (in-process [S_dst, S_src, c]) as the
    shard-local batch: [S * c] (in-process [S_dst, S_src * c])."""
    if isinstance(axis, InProcess):
        return rx.reshape(rx.shape[0], -1)
    return rx.reshape(-1)


@torch.no_grad()
def routed_lookup(d: dhash.DHashState, keys: torch.Tensor, axis,
                  owner_hfn: hashing.HashFn, cap: int | None = None):
    """DHash lookup across shards.  Returns (found, vals), in batch order."""
    s = _check_batch(d, keys, axis)
    rt = _route(keys, shard_of(keys, s, owner_hfn), s, cap)
    rk = all_to_all(rt.send, axis)
    rm = all_to_all(rt.smask, axis)
    k, m = _local(rk, axis), _local(rm, axis)
    if isinstance(axis, InProcess):
        found, vals = dhash.stack_lookup(d, k, m)
    else:
        found, vals = dhash.lookup_by_flag(d, k)
        found = found & m
    rf = all_to_all(found.view(rk.shape), axis)
    rv = all_to_all(vals.view(rk.shape), axis)
    return _unroute(rf, rt, fill=False).bool(), _unroute(rv, rt, fill=0)


@torch.no_grad()
def routed_update(d: dhash.DHashState, keys: torch.Tensor,
                  vals: torch.Tensor, mask: torch.Tensor, axis,
                  owner_hfn: hashing.HashFn, op: Callable = dhash.insert,
                  cap: int | None = None):
    """DHash insert (``op=dhash.insert``) or delete (``dhash.delete``)
    across shards, IN PLACE on each shard's table by its device flag.
    Returns (d, ok)."""
    if op is not dhash.insert and op is not dhash.delete:
        raise ValueError("routed_update: op is dhash.insert or dhash.delete")
    s = _check_batch(d, keys, axis)
    rt = _route(keys, shard_of(keys, s, owner_hfn), s, cap)
    rk = all_to_all(rt.send, axis)
    rv = all_to_all(_route_payload(vals, rt), axis)
    rm = all_to_all(_route_payload(mask, rt), axis)
    k, v, m = (_local(x, axis) for x in (rk, rv, rm))
    if isinstance(axis, InProcess):
        if op is dhash.insert:
            _, ok = dhash.stack_insert(d, k, v, m)
        else:
            _, ok = dhash.stack_delete(d, k, m)
    elif op is dhash.insert:
        _, ok = dhash.insert_by_flag(d, k, v, m)
    else:
        _, ok = dhash.delete_by_flag(d, k, m)
    rok = all_to_all(ok.view(rk.shape), axis)
    return d, _unroute(rok, rt, fill=False).bool()


@torch.no_grad()
def routed_rebuild_step(d: dhash.DHashState, axis) -> dhash.DHashState:
    """One rebuild transition on every shard, IN PLACE (each shard's epoch
    advances on its own device flags).  Returns ``d``."""
    if isinstance(axis, InProcess):
        if d.cursor.shape != (axis.nshards,):
            raise ValueError(f"in-process routing over {axis.nshards} "
                             f"shards takes a stack of that many tables")
        dhash.stack_rebuild_step_(d)
    else:
        _axis_size(axis)
        dhash.rebuild_step_(d)
    return d


# ---------------------------------------------------------------------------
# the [S shards x T tenants] grid
# ---------------------------------------------------------------------------
#
# Owner of a key is the PAIR (shard_of(key), tenant): flat owner id
# ``shard * T + tenant`` routes through one exchange pair into the shards'
# tenant stacks; the received buffer is reshaped tenant-major so that one
# stack op serves every (source shard, tenant) cell at once.  In-process the
# S shards' stacks are one stack of S·T tables (shard-major) and one stack
# op serves the whole grid.

def _grid_size(d: dhash.DHashState, keys: torch.Tensor, axis) -> tuple:
    """(S, T) of a grid op, checking the form's operands."""
    s = _axis_size(axis)
    n = dhash.stack_size(d)
    if isinstance(axis, InProcess):
        if n % s or keys.dim() != 2 or keys.shape[0] != s:
            raise ValueError(f"in-process grid routing over {s} shards takes "
                             f"a stack of S·T tables and [{s}, Q] batches")
        return s, n // s
    if keys.dim() != 1:
        raise ValueError("grid routing over a process group takes a [Q] "
                         "batch a rank")
    return s, n


def _grid_exchange(buf: torch.Tensor, axis, s: int, t: int, cap: int):
    """Exchange an owner-major [S·T, cap] buffer (in-process [S_src, S·T,
    cap]) and return it tenant-major for the stack op: [T, S·cap] (in
    process [S·T, S_src·cap]; each row one tenant's queries from every
    source shard)."""
    if isinstance(axis, InProcess):
        rx = all_to_all(buf.reshape(s, s, t, cap), axis)   # [dst, src, T, c]
        return rx.permute(0, 2, 1, 3).reshape(s * t, s * cap)
    rx = all_to_all(buf.reshape(s, t, cap), axis)           # [src, T, cap]
    return rx.transpose(0, 1).reshape(t, s * cap)


def _grid_return(resp: torch.Tensor, axis, s: int, t: int, cap: int):
    """Inverse of ``_grid_exchange`` for a stack op's response: back to the
    querying shards, owner-major [S·T, cap] (in-process [S_src, S·T,
    cap])."""
    if isinstance(axis, InProcess):
        tx = resp.reshape(s, t, s, cap).permute(0, 2, 1, 3)  # [dst, src, T, c]
        return all_to_all(tx, axis).reshape(s, s * t, cap)
    tx = resp.reshape(t, s, cap).transpose(0, 1)             # [src, T, cap]
    return all_to_all(tx, axis).reshape(s * t, cap)


def _grid_route(d, keys, tenant, axis, owner_hfn, cap_factor, spill_slack):
    s, t = _grid_size(d, keys, axis)
    q = keys.shape[-1]
    cap = route_cap(cap_factor, q, s * t)
    spill_cap = route_spill_cap(q, cap, spill_slack)
    rt = _route(keys, grid_owner(keys, tenant, s, t, owner_hfn), s * t, cap,
                spill_cap)
    return s, t, rt


@torch.no_grad()
def routed_stack_lookup(d: dhash.DHashState, keys: torch.Tensor,
                        tenant: torch.Tensor, axis,
                        owner_hfn: hashing.HashFn, cap_factor: float = 2.0,
                        spill_slack: float | None = None):
    """Lookup a batch against the S×T grid: ``d`` is this shard's T-table
    tenant stack (in-process: the S·T-table stack).  Returns (found, vals,
    overflow[S·T]).  Keys past ``cap = ceil(c·Q/(S·T))`` ride the spill
    slab of the same buffer through the same exchange; with the default
    overflow-proof slab every key is served even under 100% skew, under a
    compact ``spill_slack`` the keys the slab cannot carry come back
    not-found (counted in ``Route.dropped``)."""
    s, t, rt = _grid_route(d, keys, tenant, axis, owner_hfn, cap_factor,
                           spill_slack)
    w = rt.send.shape[-1]
    qk = _grid_exchange(rt.send, axis, s, t, w)
    qm = _grid_exchange(rt.smask, axis, s, t, w)
    f, v = dhash.stack_lookup(d, qk, qm)
    rf = _grid_return(f, axis, s, t, w)
    rv = _grid_return(v, axis, s, t, w)
    return (_unroute(rf, rt, fill=False).bool(), _unroute(rv, rt, fill=0),
            rt.overflow)


@torch.no_grad()
def routed_stack_update(d: dhash.DHashState, keys: torch.Tensor,
                        vals: torch.Tensor, mask: torch.Tensor,
                        tenant: torch.Tensor, axis,
                        owner_hfn: hashing.HashFn,
                        op: Callable = dhash.stack_insert,
                        cap_factor: float = 2.0,
                        spill_slack: float | None = None):
    """Insert (``op=dhash.stack_insert``) or delete (``dhash.stack_delete``)
    a batch into the S×T grid, IN PLACE.  Returns (d, ok, overflow[S·T]);
    under a compact ``spill_slack`` only the keys the slab could not carry
    report ok=False."""
    if op is not dhash.stack_insert and op is not dhash.stack_delete:
        raise ValueError("routed_stack_update: op is dhash.stack_insert or "
                         "dhash.stack_delete")
    s, t, rt = _grid_route(d, keys, tenant, axis, owner_hfn, cap_factor,
                           spill_slack)
    w = rt.send.shape[-1]
    qk = _grid_exchange(rt.send, axis, s, t, w)
    qm = _grid_exchange(_route_payload(mask, rt) & rt.smask, axis, s, t, w)
    if op is dhash.stack_insert:
        qv = _grid_exchange(_route_payload(vals, rt), axis, s, t, w)
        _, ok = op(d, qk, qv, qm)
    else:
        _, ok = op(d, qk, qm)
    rok = _grid_return(ok, axis, s, t, w)
    return d, _unroute(rok, rt, fill=False).bool(), rt.overflow


# ---------------------------------------------------------------------------
# the shards' tables, the service step
# ---------------------------------------------------------------------------

def make_stacked(nshards: int, backend: str = "linear", capacity: int = 1024,
                 *, chunk: int = 256, seed: int = 0,
                 device: torch.device | str = "cuda",
                 **kw) -> dhash.DHashState:
    """``nshards`` independent shard tables stacked on a leading axis
    (``dhash.make_stack``: shard i seeded ``seed + i``)."""
    return dhash.make_stack(nshards, backend, capacity, chunk=chunk,
                            seed=seed, device=device, **kw)


def peel(stacked: dhash.DHashState) -> dhash.DHashState:
    """A shard's table from its one-table stack (leading axis of size 1):
    a VIEW, so writes through it land in ``stacked``."""
    return map_tensors(lambda x: x[0], stacked)


def unpeel(d: dhash.DHashState) -> dhash.DHashState:
    """The inverse of ``peel``: ``d`` as a one-table stack (a view)."""
    return map_tensors(lambda x: x.unsqueeze(0), d)


@torch.no_grad()
def routed_service_step(d: dhash.DHashState, lookup_keys: torch.Tensor,
                        ins_keys: torch.Tensor, ins_vals: torch.Tensor,
                        del_keys: torch.Tensor, axis,
                        owner_hfn: hashing.HashFn, cap_factor: float = 0.0):
    """The paper's steady workload as one routed step, IN PLACE: a lookup
    batch, an insert batch, a delete batch and one rebuild transition on
    every shard.  ``cap_factor > 0`` bounds the send buffers at ``cap =
    ceil(cap_factor·Q/S)`` (no slab: a key past its owner's cap is not
    served).  No step reads the host, so the whole step can be captured in
    one CUDA graph.  Returns (d, (found, vals, stats)), ``stats`` = (hits,
    inserts acknowledged, deletes acknowledged) [3] ([S, 3] in-process, a
    row a source shard)."""
    s = _axis_size(axis)

    def capof(q):
        return route_cap(cap_factor, q, s) if cap_factor > 0 else None
    found, vals = routed_lookup(d, lookup_keys, axis, owner_hfn,
                                cap=capof(lookup_keys.shape[-1]))
    ones = torch.ones(ins_keys.shape, dtype=torch.bool,
                      device=ins_keys.device)
    d, ok_i = routed_update(d, ins_keys, ins_vals, ones, axis, owner_hfn,
                            op=dhash.insert, cap=capof(ins_keys.shape[-1]))
    ones = torch.ones(del_keys.shape, dtype=torch.bool,
                      device=del_keys.device)
    d, ok_d = routed_update(d, del_keys, del_keys, ones, axis, owner_hfn,
                            op=dhash.delete, cap=capof(del_keys.shape[-1]))
    routed_rebuild_step(d, axis)
    stats = torch.stack([found.sum(-1, dtype=I32), ok_i.sum(-1, dtype=I32),
                         ok_d.sum(-1, dtype=I32)], -1)
    return d, (found, vals, stats)
