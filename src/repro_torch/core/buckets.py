"""The linear bucket table and its plain PyTorch ops.

The paper chains nodes in lock-free linked lists; pointer chasing is hostile
to wide SIMT hardware, so the backend here is an *array-native* reformulation
with the same observable set semantics:

* ``linear`` — open addressing, linear probing: bounded vectorised probe
               sequences, no pointers at all.

(``twochoice``, ``cuckoo`` and ``chain`` of the reference are not ported yet.)

Slot states mirror the paper's two flag bits:
  LIVE                ~ reachable node
  TOMB                ~ LOGICALLY_REMOVED      (delete; reclaim deferred)
  MIGRATED            ~ IS_BEING_DISTRIBUTED   (rebuild pulled it into hazard)

All operations are *batched*: a batch of Q independent operations is the SIMT
analogue of Q concurrent threads.  Intra-batch conflicts are resolved
deterministically (lowest original index wins), which is one legal
linearization of the paper's concurrent execution.

The backend exposes:
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

BACKENDS = ("linear",)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def batch_winners(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First masked occurrence of each distinct key wins (deterministic
    linearization of intra-batch duplicate ops).

    One stable sort on a packed 64-bit word: the key (sign-extended, so
    negative keys keep their order) shifted left once, with the low bit set
    for unmasked entries so masked ones come first within a key."""
    q = keys.shape[0]
    packed = (keys.to(torch.int64) << 1) | (~mask).to(torch.int64)
    _, order = torch.sort(packed, stable=True)
    ks, ms = keys[order], mask[order]
    first = torch.ones(q, dtype=torch.bool, device=keys.device)
    first[1:] = ks[1:] != ks[:-1]
    win = torch.empty(q, dtype=torch.bool, device=keys.device)
    win[order] = ms & first
    return win


def _argpick(hit: torch.Tensor, vals: torch.Tensor, dim: int = -1):
    """Select value at the first True along dim (undefined if none)."""
    i = hit.to(torch.uint8).argmax(dim=dim)
    return torch.gather(vals, dim, i.unsqueeze(dim)).squeeze(dim), i


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
    # claim scratch of the insert kernel ([C] i32, CUDA tables only): not
    # part of the table's contents, never converted, restored by every launch
    claim: torch.Tensor | None = None


def linear_make(capacity: int, hfn: hashing.HashFn, max_probes: int = 64,
                device: torch.device | str | None = None) -> LinearTable:
    """Empty table on ``device`` (default: where the hash seeds live)."""
    dev = torch.device(device) if device is not None else hfn.seeds.device
    if hfn.seeds.device != dev:
        hfn = replace(hfn, seeds=hfn.seeds.to(dev))

    def z():
        return torch.zeros(capacity, dtype=I32, device=dev)
    claim = None
    if dev.type == "cuda":
        from repro_torch.kernels.probe import new_claim
        claim = new_claim(capacity, dev)
    return LinearTable(capacity=capacity, max_probes=max_probes, hfn=hfn,
                       key=z(), val=z(), state=z(), claim=claim)


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
    winner = batch_winners(keys, mask)
    found, _, loc = linear_lookup(t, keys)
    ok = winner & found
    # TOMB outranks LIVE, so a max over the hit slots tombstones exactly them
    state = t.state.scatter_reduce(
        0, torch.where(ok, loc, 0).long(),
        torch.where(ok, TOMB, 0).to(I32), "amax")
    return replace(t, state=state), ok


def linear_extract_chunk(t: LinearTable, cursor: torch.Tensor, n: int):
    dev = t.key.device
    pos = cursor.long() + torch.arange(n, dtype=torch.int64, device=dev)
    valid = pos < t.capacity
    cpos = torch.where(valid, pos, 0)
    live = valid & (t.state[cpos] == LIVE)
    hkeys = torch.where(live, t.key[cpos], 0).to(I32)
    hvals = torch.where(live, t.val[cpos], 0).to(I32)
    state = t.state.scatter_reduce(
        0, cpos, torch.where(live, MIGRATED, 0).to(I32), "amax")
    new_cursor = torch.clamp(cursor.long() + n, max=t.capacity).to(I32)
    return replace(t, state=state), hkeys, hvals, live, new_cursor


def linear_count_live(t: LinearTable):
    return (t.state == LIVE).sum()


def linear_clear(t: LinearTable) -> LinearTable:
    def z():
        return torch.zeros_like(t.key)
    return replace(t, key=z(), val=z(), state=z())
