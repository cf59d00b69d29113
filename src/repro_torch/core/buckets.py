"""The bucket tables and their plain PyTorch ops.

The paper chains nodes in lock-free linked lists; pointer chasing is hostile
to wide SIMT hardware, so each backend here is an *array-native*
reformulation with the same observable set semantics:

* ``linear``    — open addressing, linear probing: bounded vectorised probe
                  sequences, no pointers at all.
* ``twochoice`` — bucketed 2-choice hashing (cuckoo family without
                  eviction): exactly two W-wide row reads per lookup.
* ``cuckoo``    — the twochoice layout split into two hash-function sides
                  ([2B, W]: side A rows [0, B), side B rows [B, 2B)) plus an
                  insert-side kick-out bounded by ``max_kick``: probe depth
                  <= W - 1 whatever the key set.
* ``chain``     — arena-based chained buckets, the paper's Michael-list
                  buckets (insert at the head, logical deletion by state,
                  deferred reclamation): a node arena with ``anext`` links
                  walked in lock step up to ``max_chain`` hops.  The
                  kernel-backed path keeps the arena bucket-sorted and
                  tombstone-free (``ops.chain_compact_fused``), so a probe
                  is a scan of the bucket's segment ``[bstart[b],
                  bstart[b] + blen[b])`` plus the dirty tail of nodes
                  inserted since the last compaction.

Slot states mirror the paper's two flag bits:
  LIVE                ~ reachable node
  TOMB                ~ LOGICALLY_REMOVED      (delete; reclaim deferred)
  MIGRATED            ~ IS_BEING_DISTRIBUTED   (rebuild pulled it into hazard)

All operations are *batched*: a batch of Q independent operations is the SIMT
analogue of Q concurrent threads.  Intra-batch conflicts are resolved
deterministically (lowest original index wins), which is one legal
linearization of the paper's concurrent execution.

Every backend exposes:
  make(...) -> Table
  lookup(t, keys)                -> (found[Q], vals[Q], loc[Q])
  insert(t, keys, vals, mask)    -> (t', ok[Q])     # ok=False if present/full
  delete(t, keys, mask)          -> (t', ok[Q])
  extract_chunk(t, cursor, n)    -> (t', hkeys, hvals, hlive, new_cursor)
  count_live(t) -> scalar tensor
  clear(t) -> t'

The ops in this module are the plain, FUNCTIONAL surface (the oracle): they
never modify the table they are given.  The kernel-backed adapters live in
``core/backend.py`` and update tables in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.core.struct_utils import replace, state_dataclass

I32 = torch.int32
EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3

BACKENDS = ("linear", "twochoice", "chain", "cuckoo")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def batch_winners(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First masked occurrence of each distinct key wins (deterministic
    linearization of intra-batch duplicate ops).  Over the last axis: a
    table stack's [T, Q] batch dedups within each row only.

    One stable sort (along the last axis) on a packed 64-bit word: the key
    (sign-extended, so negative keys keep their order) shifted left once,
    with the low bit set for unmasked entries so masked ones come first
    within a key."""
    packed = (keys.to(torch.int64) << 1) | (~mask).to(torch.int64)
    _, order = torch.sort(packed, dim=-1, stable=True)
    ks, ms = keys.gather(-1, order), mask.gather(-1, order)
    first = torch.ones_like(ms)
    first[..., 1:] = ks[..., 1:] != ks[..., :-1]
    return torch.empty_like(ms).scatter_(-1, order, ms & first)


def table_lead(t) -> tuple:
    """The leading axes of a table's tensors past one table's own: () for
    one table, (T,) for a table stack (read from its hash function)."""
    return hashing.lead_shape(t.hfn if hasattr(t, "hfn") else t.hfn_a)


def per_table_sum(x: torch.Tensor, t) -> torch.Tensor:
    """``x`` (shaped as one of ``t``'s tensor fields) summed over each
    table: a 0-dim tensor, or [T] for a table stack."""
    return x.reshape(*table_lead(t), -1).sum(-1)


def _argpick(hit: torch.Tensor, vals: torch.Tensor, dim: int = -1):
    """Select value at the first True along dim (undefined if none)."""
    i = hit.to(torch.uint8).argmax(dim=dim)
    return torch.gather(vals, dim, i.unsqueeze(dim)).squeeze(dim), i


def _empty(shape: tuple, hfns: dict, device, claim: bool = True) -> dict:
    """The fields of an empty table of ``shape`` on ``device`` (default:
    where the first hash function's seeds live): the hash functions moved
    there, zeroed key / val / state, and with ``claim`` on a CUDA device the
    two-row kernels' claim words, one a row (not part of the table's
    contents, never converted, restored by every launch)."""
    first = next(iter(hfns.values()))
    dev = torch.device(device) if device is not None else first.seeds.device
    out = {n: h if h.seeds.device == dev else replace(h, seeds=h.seeds.to(dev))
           for n, h in hfns.items()}
    for f in ("key", "val", "state"):
        out[f] = torch.zeros(shape, dtype=I32, device=dev)
    if claim and dev.type == "cuda":
        from repro_torch.kernels.probe import new_claim
        out["claim"] = new_claim(shape[0], dev)
    return out


def _delete_via(t, keys: torch.Tensor, mask: torch.Tensor, lookup):
    """Tombstone the LIVE slot of each winning masked key that ``lookup``
    finds (its ``loc`` is a flat slot of the row-major table)."""
    winner = batch_winners(keys, mask)
    found, _, loc = lookup(t, keys)
    ok = winner & found
    # TOMB outranks LIVE, so a max over the hit slots tombstones exactly them
    state = t.state.reshape(-1).scatter_reduce(
        0, torch.where(ok, loc, 0).long(),
        torch.where(ok, TOMB, 0).to(I32), "amax").reshape(t.state.shape)
    return replace(t, state=state), ok


def _scan_chunk(ks, vs, ss, cursor: torch.Tensor, n: int):
    """The rebuild chunk scan on flat (key, val, state) arrays: the ``n``
    positions at ``cursor``, LIVE ones marked MIGRATED in a new state array.
    Returns (state', hkeys, hvals, hlive, new_cursor)."""
    size = ks.shape[0]
    pos = cursor.long() + torch.arange(n, dtype=torch.int64, device=ks.device)
    valid = pos < size
    cpos = torch.where(valid, pos, 0)
    live = valid & (ss[cpos] == LIVE)
    hkeys = torch.where(live, ks[cpos], 0).to(I32)
    hvals = torch.where(live, vs[cpos], 0).to(I32)
    ss = ss.scatter_reduce(0, cpos, torch.where(live, MIGRATED, 0).to(I32),
                           "amax")
    new_cursor = torch.clamp(cursor.long() + n, max=size).to(I32)
    return ss, hkeys, hvals, live, new_cursor


def extract_chunk(t, cursor: torch.Tensor, n: int):
    """The rebuild chunk scan of every slot backend, on the row-major
    flattened slot arrays."""
    ss, *out = _scan_chunk(t.key.reshape(-1), t.val.reshape(-1),
                           t.state.reshape(-1), cursor, n)
    return (replace(t, state=ss.reshape(t.state.shape)), *out)


def count_live(t):
    return per_table_sum(t.state == LIVE, t)


def clear(t):
    def z():
        return torch.zeros_like(t.key)
    return replace(t, key=z(), val=z(), state=z())


# ---------------------------------------------------------------------------
# linear: open addressing with linear probing
# ---------------------------------------------------------------------------

@state_dataclass
class LinearTable:
    capacity: int
    max_probes: int
    hfn: hashing.HashFn
    key: torch.Tensor    # [C] i32
    val: torch.Tensor    # [C] i32
    state: torch.Tensor  # [C] i32 (EMPTY/LIVE/TOMB/MIGRATED)


def linear_make(capacity: int, hfn: hashing.HashFn, max_probes: int = 64,
                device: torch.device | str | None = None) -> LinearTable:
    """Empty table on ``device`` (default: where the hash seeds live)."""
    return LinearTable(capacity=capacity, max_probes=max_probes,
                       **_empty((capacity,), {"hfn": hfn}, device,
                                claim=False))


def linear_lookup(t: LinearTable, keys: torch.Tensor):
    found, val, loc, _ = linear_lookup_fwd(t, keys)
    return found, val, loc


def linear_lookup_fwd(t: LinearTable, keys: torch.Tensor):
    """Lookup that ALSO reports a MIGRATED-slot key match ("tombstone
    forwarding"): a slot whose entry was pulled into the rebuild's hazard
    buffer still holds its key, so the probe that passes over it identifies
    the hazard entry at zero extra cost.
    Returns (found, val, loc, mig_loc) with mig_loc = -1 if none."""
    c, q, dev = t.capacity, keys.shape[0], keys.device
    h0 = hashing.bucket_of(t.hfn, keys, c).long()
    active = torch.ones(q, dtype=torch.bool, device=dev)
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    val = torch.zeros(q, dtype=I32, device=dev)
    loc = torch.full((q,), -1, dtype=I32, device=dev)
    mig = torch.full((q,), -1, dtype=I32, device=dev)
    for i in range(t.max_probes):
        pos = (h0 + i) % c
        st = t.state[pos]
        kmatch = t.key[pos] == keys
        hit = active & (st == LIVE) & kmatch
        mig = torch.where(active & (st == MIGRATED) & kmatch & (mig < 0),
                          pos.to(I32), mig)
        stop = active & (st == EMPTY)
        val = torch.where(hit, t.val[pos], val)
        loc = torch.where(hit, pos.to(I32), loc)
        found = found | hit
        active = active & ~hit & ~stop
    return found, val, loc, mig


def linear_insert(t: LinearTable, keys: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor):
    c, q, dev = t.capacity, keys.shape[0], keys.device
    winner = batch_winners(keys, mask)
    present, _, _ = linear_lookup(t, keys)
    pending = winner & ~present
    h0 = hashing.bucket_of(t.hfn, keys, c).long()
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    # one spare slot at index c takes the writes of queries that do not act
    pad = torch.zeros(1, dtype=I32, device=dev)
    key = torch.cat([t.key, pad])
    val = torch.cat([t.val, pad])
    state = torch.cat([t.state, pad])
    off = torch.zeros(q, dtype=torch.int64, device=dev)
    for _ in range(t.max_probes):
        pos = (h0 + off) % c
        free = pending & (state[pos] != LIVE)
        wpos = torch.where(free, pos, c)
        claim = torch.full((c + 1,), q, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, wpos, idx, "amin")
        won = free & (claim[pos] == idx)
        wp = torch.where(won, pos, c)
        key[wp] = keys
        val[wp] = vals
        state[wp] = torch.where(won, LIVE, 0).to(I32)
        done = done | won
        pending = pending & ~won
        off = torch.where(pending, off + 1, off)
    return replace(t, key=key[:c].contiguous(), val=val[:c].contiguous(),
                   state=state[:c].contiguous()), done


def linear_delete(t: LinearTable, keys: torch.Tensor, mask: torch.Tensor):
    return _delete_via(t, keys, mask, linear_lookup)


linear_extract_chunk = extract_chunk
linear_count_live = count_live
linear_clear = clear


# ---------------------------------------------------------------------------
# twochoice: bucketed 2-choice hashing (W-wide vector buckets)
# ---------------------------------------------------------------------------

@state_dataclass
class TwoChoiceTable:
    nbuckets: int
    width: int
    max_rounds: int
    hfn_a: hashing.HashFn
    hfn_b: hashing.HashFn
    key: torch.Tensor    # [B, W] i32
    val: torch.Tensor    # [B, W] i32
    state: torch.Tensor  # [B, W] i32
    claim: torch.Tensor | None = None   # [B] i32, CUDA tables only


def twochoice_make(nbuckets: int, hfn_a: hashing.HashFn,
                   hfn_b: hashing.HashFn, width: int = 8, max_rounds: int = 8,
                   device: torch.device | str | None = None) -> TwoChoiceTable:
    return TwoChoiceTable(
        nbuckets=nbuckets, width=width, max_rounds=max_rounds,
        **_empty((nbuckets, width), {"hfn_a": hfn_a, "hfn_b": hfn_b}, device))


def _tc_rows(t: TwoChoiceTable, keys: torch.Tensor):
    ba = hashing.bucket_of(t.hfn_a, keys, t.nbuckets)
    bb = hashing.bucket_of(t.hfn_b, keys, t.nbuckets)
    return ba, bb


def _two_row_lookup(t, ra: torch.Tensor, rb: torch.Tensor,
                    keys: torch.Tensor):
    """The reference's plain two-row lookup, a-row priority.  As there, the
    value of a miss is that of lane 0 of row b (unspecified): only the
    kernel-backed lookup reports 0."""
    ra, rb = ra.long(), rb.long()
    hit_a = (t.key[ra] == keys[:, None]) & (t.state[ra] == LIVE)   # [Q, W]
    hit_b = (t.key[rb] == keys[:, None]) & (t.state[rb] == LIVE)
    fa, fb = hit_a.any(-1), hit_b.any(-1)
    va, sa = _argpick(hit_a, t.val[ra])
    vb, sb = _argpick(hit_b, t.val[rb])
    found = fa | fb
    val = torch.where(fa, va, vb)
    loc = torch.where(fa, ra * t.width + sa,
                      torch.where(fb, rb * t.width + sb, -1))
    return found, val, loc.to(I32)


def twochoice_lookup(t: TwoChoiceTable, keys: torch.Tensor):
    return _two_row_lookup(t, *_tc_rows(t, keys), keys)


def twochoice_insert(t: TwoChoiceTable, keys: torch.Tensor,
                     vals: torch.Tensor, mask: torch.Tensor):
    """Alternate the two row choices a round, claim the row's first
    non-LIVE lane, lowest batch index wins (``ref.tc_insert_ref``)."""
    from repro_torch.kernels import ref
    winner = batch_winners(keys, mask)
    ba, bb = _tc_rows(t, keys)
    key, val, state, done = ref.tc_insert_ref(
        t.key, t.val, t.state, ba, bb, keys, vals, winner, t.max_rounds)
    return replace(t, key=key, val=val, state=state), done


def twochoice_delete(t: TwoChoiceTable, keys: torch.Tensor,
                     mask: torch.Tensor):
    return _delete_via(t, keys, mask, twochoice_lookup)


# ---------------------------------------------------------------------------
# cuckoo: two-table multilevel double hashing with bounded kick-out
# ---------------------------------------------------------------------------
#
# One [2B, W] slot array split into side A (rows [0, B), addressed by hfn_a)
# and side B (rows [B, 2B), addressed by hfn_b).  A key lives in exactly one
# of its two candidate rows, so every lookup is two W-wide row reads, however
# adversarial the key set.  The candidate rows are plain row indices, so the
# kernel-backed path drives the twochoice row kernels unchanged with
# side-offset rows.

@state_dataclass
class CuckooTable:
    nbuckets: int     # rows PER SIDE: the slot arrays are [2 * nbuckets, W]
    width: int
    max_kick: int     # bounded kick-out iterations (insert relocation)
    hfn_a: hashing.HashFn
    hfn_b: hashing.HashFn
    key: torch.Tensor    # [2B, W] i32
    val: torch.Tensor    # [2B, W] i32
    state: torch.Tensor  # [2B, W] i32
    claim: torch.Tensor | None = None   # [2B] i32, CUDA tables only


def cuckoo_make(nbuckets: int, hfn_a: hashing.HashFn, hfn_b: hashing.HashFn,
                width: int = 8, max_kick: int = 32,
                device: torch.device | str | None = None) -> CuckooTable:
    return CuckooTable(
        nbuckets=nbuckets, width=width, max_kick=max_kick,
        **_empty((2 * nbuckets, width), {"hfn_a": hfn_a, "hfn_b": hfn_b},
                 device))


def _ck_rows(t: CuckooTable, keys: torch.Tensor):
    """The two candidate rows of each key, side-offset into the [2B, W]
    array: a-rows in [0, B), b-rows in [B, 2B)."""
    ra = hashing.bucket_of(t.hfn_a, keys, t.nbuckets)
    rb = t.nbuckets + hashing.bucket_of(t.hfn_b, keys, t.nbuckets)
    return ra, rb


def cuckoo_lookup(t: CuckooTable, keys: torch.Tensor):
    return _two_row_lookup(t, *_ck_rows(t, keys), keys)


def cuckoo_insert(t: CuckooTable, keys: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor):
    """Set-semantic insert: the bounded kick-out loop IS the whole placement
    (``ref.cuckoo_kick_ref``), run only when some key is pending, as the
    reference's ``lax.cond``.  ok=False iff present or the kick budget
    exhausts."""
    from repro_torch.kernels import ref
    winner = batch_winners(keys, mask)
    present, _, _ = cuckoo_lookup(t, keys)
    pending = winner & ~present
    if not bool(pending.any()):
        return t, torch.zeros_like(pending)
    ra, rb = _ck_rows(t, keys)
    key, val, state, done = ref.cuckoo_kick_ref(
        t.key, t.val, t.state, ra, rb, t.hfn_a, t.hfn_b, t.nbuckets,
        keys, vals, pending, t.max_kick)
    return replace(t, key=key, val=val, state=state), done


def cuckoo_delete(t: CuckooTable, keys: torch.Tensor, mask: torch.Tensor):
    return _delete_via(t, keys, mask, cuckoo_lookup)


# ---------------------------------------------------------------------------
# chain: arena-based chained buckets (paper-faithful Michael-list analogue)
# ---------------------------------------------------------------------------

@state_dataclass
class ChainTable:
    nbuckets: int
    arena: int        # node capacity N
    max_chain: int    # traversal bound (>= max expected chain incl. tombstones)
    dirty_cap: int    # dense-window budget for the post-compaction dirty tail
    hfn: hashing.HashFn
    akey: torch.Tensor    # [N] i32
    aval: torch.Tensor    # [N] i32
    anext: torch.Tensor   # [N] i32 (-1 terminates)
    astate: torch.Tensor  # [N] i32
    heads: torch.Tensor   # [B] i32 (-1 empty)
    free_stack: torch.Tensor  # [N] i32 - free node indices live at [0, free_top)
    free_top: torch.Tensor    # 0-dim i32
    # the bucket-sorted layout of the kernel-backed path: [0, sorted_upto)
    # holds the compacted segments (bucket b's nodes at [bstart[b],
    # bstart[b] + blen[b])); nodes allocated since the last compaction are
    # the "dirty" tail [sorted_upto, arena - free_top)
    bstart: torch.Tensor      # [B] i32
    blen: torch.Tensor        # [B] i32
    sorted_upto: torch.Tensor # 0-dim i32


def _chain_arrays(nbuckets: int, n: int, dev) -> dict:
    """The array fields of an empty arena: the free stack DESCENDS, so pops
    allocate ascending positions and the allocated region is always the
    prefix [0, n - free_top) (which keeps the dirty tail one window)."""
    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)
    return dict(akey=full((n,), 0), aval=full((n,), 0), anext=full((n,), -1),
                astate=full((n,), EMPTY), heads=full((nbuckets,), -1),
                free_stack=n - 1 - torch.arange(n, dtype=I32, device=dev),
                free_top=full((), n), bstart=full((nbuckets,), 0),
                blen=full((nbuckets,), 0), sorted_upto=full((), 0))


def chain_make(nbuckets: int, arena: int, hfn: hashing.HashFn,
               max_chain: int = 64, dirty_cap: int | None = None,
               device: torch.device | str | None = None) -> ChainTable:
    """Empty arena table on ``device`` (default: where the hash seeds live).
    ``dirty_cap=None`` takes the registered chain backend's value."""
    if dirty_cap is None:
        from repro_torch.core import backend
        dirty_cap = backend.get("chain").dirty_cap
    dev = torch.device(device) if device is not None else hfn.seeds.device
    if hfn.seeds.device != dev:
        hfn = replace(hfn, seeds=hfn.seeds.to(dev))
    return ChainTable(nbuckets=nbuckets, arena=arena, max_chain=max_chain,
                      dirty_cap=dirty_cap, hfn=hfn,
                      **_chain_arrays(nbuckets, arena, dev))


def chain_dirty(t: ChainTable) -> torch.Tensor:
    """0-dim i32: nodes allocated since the last compaction (they live at
    [sorted_upto, arena - free_top): allocation is always a prefix)."""
    return (t.arena - t.free_top - t.sorted_upto).to(I32)


def chain_lookup(t: ChainTable, keys: torch.Tensor,
                 bucket: torch.Tensor | None = None):
    """Batched walk from ``heads[b]`` along ``anext``, at most ``max_chain``
    nodes a query (the ``chain_walk`` kernel on a CUDA arena, its plain
    version ``ref.chain_lookup_ref`` on the CPU).
    Returns (found, val, loc node index or -1)."""
    from repro_torch.kernels import probe
    b = hashing.bucket_of(t.hfn, keys, t.nbuckets) if bucket is None \
        else bucket
    return probe.chain_walk((t.akey, t.aval, t.astate), (t.anext, t.heads),
                            b, keys, t.max_chain)


def chain_insert(t: ChainTable, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor, bucket: torch.Tensor | None = None):
    """Set-semantic insert: winners absent from their chains (the walk of
    ``chain_lookup``) take nodes from the free-stack tail in want-rank order
    and are linked at their buckets' heads in batch order
    (``ref.chain_insert_ref``, which also holds the reference's
    ``_chain_link``).  ok=False iff present or the arena has no free node.
    New nodes extend the dirty tail.  No host read."""
    from repro_torch.kernels import ref
    winner = batch_winners(keys, mask)
    b = hashing.bucket_of(t.hfn, keys, t.nbuckets) if bucket is None \
        else bucket
    present, _, _ = chain_lookup(t, keys, b)
    akey, aval, astate, anext, heads, free_top, can = ref.chain_insert_ref(
        t.akey, t.aval, t.astate, t.anext, t.heads, t.free_stack, t.free_top,
        b, keys, vals, winner, t.max_chain, present=present)
    return replace(t, akey=akey, aval=aval, astate=astate, anext=anext,
                   heads=heads, free_top=free_top), can


def chain_delete(t: ChainTable, keys: torch.Tensor, mask: torch.Tensor,
                 bucket: torch.Tensor | None = None):
    """Tombstone the node of each winning masked key the walk finds (a
    masked scatter: no host read)."""
    winner = batch_winners(keys, mask)
    found, _, loc = chain_lookup(t, keys, bucket)
    ok = winner & found
    # TOMB outranks LIVE, so a max over the hit nodes tombstones exactly them
    astate = t.astate.scatter_reduce(0, torch.where(ok, loc, 0).long(),
                                     torch.where(ok, TOMB, 0).to(I32), "amax")
    return replace(t, astate=astate), ok


def chain_extract_chunk(t: ChainTable, cursor: torch.Tensor, n: int):
    """The rebuild chunk scan on the node arena (positions are scan order)."""
    ss, *out = _scan_chunk(t.akey, t.aval, t.astate, cursor, n)
    return (replace(t, astate=ss), *out)


def chain_compact(t: ChainTable) -> ChainTable:
    """Physically reclaim tombstones: rebuild every chain from the live
    nodes (a fresh arena, the live nodes re-inserted in arena order)."""
    live = t.astate == LIVE
    fresh = chain_make(t.nbuckets, t.arena, t.hfn, t.max_chain, t.dirty_cap)
    t2, _ = chain_insert(fresh, torch.where(live, t.akey, 0), t.aval, live)
    return t2


def chain_count_live(t: ChainTable):
    return per_table_sum(t.astate == LIVE, t)


def chain_clear(t: ChainTable) -> ChainTable:
    return replace(t, **_chain_arrays(t.nbuckets, t.arena, t.akey.device))


def _chain_parts(t: ChainTable):
    """The raw-array views the chain ops take: arena triple, link pair
    (for the bounded walk), segment quad (with the dirty count)."""
    return ((t.akey, t.aval, t.astate), (t.anext, t.heads),
            (t.bstart, t.blen, t.sorted_upto, chain_dirty(t)))
