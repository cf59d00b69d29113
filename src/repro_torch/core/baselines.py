"""The paper's comparison systems (§2, §6.1) in PyTorch.

The paper benchmarks DHash against three practical hash tables.  Each is
reproduced here with its *cost structure* in the batched model (a batch of Q
ops = Q concurrent threads), function for function as in the reference:

* ``HTXu``   — Herbert Xu's dynamic table (Linux IGMP, 2010).  Two pointer
  sets per node, modelled as two chain structures; while a rebuild is in
  progress every update maintains BOTH, and updates take per-bucket locks
  (``lock_serialized``: a round grants at most one pending op a bucket, so
  the rounds are the largest number of ops aimed at one bucket).  The
  rebuild relinks the active set into the passive one a chunk at a time;
  memory is 2x.

* ``HTRHT``  — Linux rhashtable (Graf, 2014).  One pointer set; the
  rebuild walks every bucket of a chunk to its TAIL to move one node
  (O(len) a node, O(len^2) a bucket), updates take per-bucket locks,
  lookups during a rebuild probe old then new.

* ``HTSplit`` — split-ordered lists (Shalev & Shavit, 2006).  Lock-free but
  only *resizable*: the bucket is ``key & (2^i - 1)``, so no key set can be
  rebuilt away (the paper's §1 attack).  A resize is one rechain pass.

All three use the chain ops of ``buckets.py``, whose walk is the
``chain_walk`` kernel on the card (``chain_tail`` is RHT's tail walk), so
the cost of a hop is the same for every contender.

Where the reference branches on a device scalar with ``lax.cond``, the flag
here is a host value: HT-Xu's ``active`` and ``rebuilding``, HT-RHT's
``rebuilding`` and HT-Split's ``nactive`` change only in the functions the
host calls (``*_make``, ``*_rebuild_start``, ``*_rebuild_finish``,
``split_resize``), so a branch on them reads nothing.  The cursors stay on
the device, and ``xu_rebuild_done`` / ``rht_rebuild_done`` return a device
bool the caller polls.  ``lock_serialized`` reads the host once a call (its
round count); no other op here reads it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import buckets, hashing
from repro_torch.core.struct_utils import replace, state_dataclass

I32 = torch.int32


def _scalar(v: int, device) -> torch.Tensor:
    return torch.full((), v, dtype=I32, device=device)    # (no copy)


def _ones(keys: torch.Tensor, mask):
    return torch.ones(keys.shape, dtype=torch.bool, device=keys.device) \
        if mask is None else mask


# ---------------------------------------------------------------------------
# lock serialization model (shared by HT-Xu and HT-RHT)
# ---------------------------------------------------------------------------

def lock_serialized(op: Callable, t, keys, vals, mask, nbuckets: int,
                    bucket_fn: Callable):
    """Apply a batched update under per-bucket mutexes.

    Each round grants the lock of every contended bucket to the lowest-index
    pending op and applies the granted ops together; the rest retry next
    round.  ``op`` changes neither the hash function nor the bucket count,
    so each op's bucket is fixed for the call and the rounds are the largest
    number of masked ops aimed at one bucket: counted on the device and read
    once (the reference's ``while_loop`` runs the same rounds).
    Returns (t', ok, rounds)."""
    q, dev = keys.shape[0], keys.device
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    b = bucket_fn(t, keys).long()
    per = torch.zeros(nbuckets, dtype=I32, device=dev).scatter_add_(
        0, b, mask.to(I32))
    rounds = int(per.amax())                      # the one host read
    pending = mask
    ok = torch.zeros(q, dtype=torch.bool, device=dev)
    for _ in range(rounds):
        claim = torch.full((nbuckets + 1,), q, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(pending, b, nbuckets), idx,
                              "amin")
        grant = pending & (claim[b] == idx)
        t, got = op(t, keys, vals, grant)
        pending = pending & ~grant
        ok = ok | got
    return t, ok, rounds


def _bucket(t, keys):
    return hashing.bucket_of(t.hfn, keys, t.nbuckets)


def _delete_op(t, k, v, m):
    return buckets.chain_delete(t, k, m)


# ---------------------------------------------------------------------------
# HT-Xu: two pointer sets per node
# ---------------------------------------------------------------------------

@state_dataclass
class HTXu:
    chunk: int
    t0: buckets.ChainTable
    t1: buckets.ChainTable
    active: int             # which structure serves lookups (host)
    rebuilding: bool        # (host)
    cursor: torch.Tensor    # 0-dim i32: arena scan of the active table


def xu_make(nbuckets: int, arena: int, *, chunk: int = 256, seed: int = 0,
            max_chain: int = 64, device: torch.device | str = "cuda") -> HTXu:
    rng = np.random.default_rng(seed)
    t0 = buckets.chain_make(nbuckets, arena,
                            hashing.fresh("mix32", rng, device), max_chain)
    t1 = buckets.chain_make(nbuckets, arena,
                            hashing.fresh("mix32", rng, device), max_chain)
    return HTXu(chunk=chunk, t0=t0, t1=t1, active=0, rebuilding=False,
                cursor=_scalar(0, device))


def _xu_pick(x: HTXu):
    return (x.t0, x.t1) if x.active == 0 else (x.t1, x.t0)


def _xu_put(x: HTXu, act, pas) -> dict:
    return dict(t0=act, t1=pas) if x.active == 0 else dict(t0=pas, t1=act)


def xu_lookup(x: HTXu, keys):
    act, _ = _xu_pick(x)
    f, v, _ = buckets.chain_lookup(act, keys)
    return f, v


def _xu_apply(x: HTXu, op, keys, vals, mask):
    """Update under per-bucket locks; during a rebuild, maintain BOTH sets.
    The lock is taken ONCE an op (one bucket lock covers the node's entry in
    both pointer sets); the passive set's maintenance is one more pass with
    the full mask, not more lock rounds.  ``ok`` is the active set's."""
    act, pas = _xu_pick(x)
    act, ok, _ = lock_serialized(op, act, keys, vals, mask, act.nbuckets,
                                 _bucket)
    if x.rebuilding:
        pas, _ = op(pas, keys, vals, mask)
    return replace(x, **_xu_put(x, act, pas)), ok


def xu_insert(x: HTXu, keys, vals, mask=None):
    return _xu_apply(x, buckets.chain_insert, keys, vals, _ones(keys, mask))


def xu_delete(x: HTXu, keys, mask=None):
    return _xu_apply(x, _delete_op, keys, keys, _ones(keys, mask))


def xu_rebuild_start(x: HTXu, *, seed: int) -> HTXu:
    """Reset the passive structure with a fresh hash function."""
    act, pas = _xu_pick(x)
    dev = pas.akey.device
    fresh = buckets.chain_make(pas.nbuckets, pas.arena,
                               hashing.fresh("mix32", seed, dev),
                               pas.max_chain)
    return replace(x, **_xu_put(x, act, fresh), rebuilding=True,
                   cursor=_scalar(0, dev))


def xu_rebuild_chunk(x: HTXu) -> HTXu:
    """Relink one arena chunk of the active set into the passive set (one
    pass, no hazard period: every node stays reachable through the active
    set)."""
    act, pas = _xu_pick(x)
    pos = x.cursor + torch.arange(x.chunk, dtype=I32, device=x.cursor.device)
    valid = pos < act.arena
    cpos = torch.where(valid, pos, 0).long()
    live = valid & (act.astate[cpos] == buckets.LIVE)
    ks = torch.where(live, act.akey[cpos], 0)
    vs = torch.where(live, act.aval[cpos], 0)
    pas, _ = buckets.chain_insert(pas, ks, vs, live)
    return replace(x, **_xu_put(x, act, pas),
                   cursor=torch.clamp(x.cursor + x.chunk, max=act.arena))


def xu_rebuild_done(x: HTXu) -> torch.Tensor:
    act, _ = _xu_pick(x)
    return (x.cursor >= act.arena) & x.rebuilding


def xu_rebuild_finish(x: HTXu) -> HTXu:
    return replace(x, active=1 - x.active, rebuilding=False,
                   cursor=_scalar(0, x.cursor.device))


# ---------------------------------------------------------------------------
# HT-RHT: Linux rhashtable
# ---------------------------------------------------------------------------

@state_dataclass
class HTRHT:
    bchunk: int             # buckets processed a rebuild chunk
    old: buckets.ChainTable
    new: buckets.ChainTable
    rebuilding: bool        # (host)
    bcursor: torch.Tensor   # 0-dim i32: bucket scan position (wraps)


def rht_make(nbuckets: int, arena: int, *, bchunk: int = 256, seed: int = 0,
             max_chain: int = 64,
             device: torch.device | str = "cuda") -> HTRHT:
    rng = np.random.default_rng(seed)
    old = buckets.chain_make(nbuckets, arena,
                             hashing.fresh("mix32", rng, device), max_chain)
    new = buckets.chain_make(nbuckets, arena,
                             hashing.fresh("mix32", rng, device), max_chain)
    return HTRHT(bchunk=bchunk, old=old, new=new, rebuilding=False,
                 bcursor=_scalar(0, device))


def rht_lookup(r: HTRHT, keys):
    f_old, v_old, _ = buckets.chain_lookup(r.old, keys)
    if not r.rebuilding:
        return f_old, v_old
    f_new, v_new, _ = buckets.chain_lookup(r.new, keys)
    return f_old | f_new, torch.where(f_old, v_old, v_new)


def rht_insert(r: HTRHT, keys, vals, mask=None):
    mask = _ones(keys, mask)
    side = "new" if r.rebuilding else "old"
    tab = getattr(r, side)
    t, ok, _ = lock_serialized(buckets.chain_insert, tab, keys, vals, mask,
                               tab.nbuckets, _bucket)
    return replace(r, **{side: t}), ok


def rht_delete(r: HTRHT, keys, mask=None):
    mask = _ones(keys, mask)
    t_old, ok_old, _ = lock_serialized(_delete_op, r.old, keys, keys, mask,
                                       r.old.nbuckets, _bucket)
    if not r.rebuilding:
        return replace(r, old=t_old), ok_old
    t_new, ok_new, _ = lock_serialized(_delete_op, r.new, keys, keys,
                                       mask & ~ok_old, r.new.nbuckets,
                                       _bucket)
    return replace(r, old=t_old, new=t_new), ok_old | ok_new


def rht_rebuild_start(r: HTRHT, *, seed: int) -> HTRHT:
    dev = r.new.akey.device
    fresh = buckets.chain_make(r.new.nbuckets, r.new.arena,
                               hashing.fresh("mix32", seed, dev),
                               r.new.max_chain)
    return replace(r, new=fresh, rebuilding=True, bcursor=_scalar(0, dev))


def _set(x: torch.Tensor, where: torch.Tensor, idx: torch.Tensor,
         value: int) -> torch.Tensor:
    """``x`` with ``x[idx] = value`` where ``where``, without a
    synchronisation: the other writes go to a spare slot past the end, and
    the value is filled in (an indexed assignment of a Python number would
    copy it to the device from pageable memory)."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    out.index_fill_(0, torch.where(where, idx, n).long(), value)
    return out[:n]


def rht_rebuild_chunk(r: HTRHT) -> HTRHT:
    """Distribute the TAIL node of each of the next ``bchunk`` buckets.

    Graf's algorithm re-traverses the chain to reach the tail for every
    node it moves (the ``chain_tail`` walk: the paper's stated drawback #1,
    and why DHash wins Fig 3)."""
    from repro_torch.kernels import probe
    old = r.old
    nb = old.nbuckets
    b = (r.bcursor + torch.arange(r.bchunk, dtype=I32,
                                  device=r.bcursor.device)) % nb
    tail, prev = probe.chain_tail(old.heads, old.anext, r.bcursor, r.bchunk,
                                  old.max_chain)
    has = tail >= 0
    tc = torch.where(has, tail, 0).long()
    was_live = has & (old.astate[tc] == buckets.LIVE)
    ks = torch.where(was_live, old.akey[tc], 0)
    vs = torch.where(was_live, old.aval[tc], 0)
    # unlink the tail: prev.next = -1, or head = -1 if the tail was the head
    old = replace(old,
                  anext=_set(old.anext, has & (prev >= 0), prev, -1),
                  heads=_set(old.heads, has & (prev < 0), b, -1),
                  astate=_set(old.astate, has, tc, buckets.EMPTY))
    new, _ = buckets.chain_insert(r.new, ks, vs, was_live)
    return replace(r, old=old, new=new, bcursor=(r.bcursor + r.bchunk) % nb)


def rht_rebuild_done(r: HTRHT) -> torch.Tensor:
    return (buckets.chain_count_live(r.old) == 0) & r.rebuilding


def rht_rebuild_finish(r: HTRHT) -> HTRHT:
    return replace(r, old=r.new, new=r.old, rebuilding=False,
                   bcursor=_scalar(0, r.bcursor.device))


# ---------------------------------------------------------------------------
# HT-Split: split-ordered resizable table (lock-free, fixed hash)
# ---------------------------------------------------------------------------

@state_dataclass
class HTSplit:
    max_buckets: int        # head-array capacity (max 2^i)
    t: buckets.ChainTable   # nbuckets == max_buckets; nactive are in use
    nactive: int            # the current 2^i bucket count (host)


def split_make(max_buckets: int, arena: int, *, init_buckets: int = 64,
               seed: int = 0, max_chain: int = 64,
               device: torch.device | str = "cuda") -> HTSplit:
    t = buckets.chain_make(max_buckets, arena,
                           hashing.fresh("mix32", seed, device), max_chain)
    return HTSplit(max_buckets=max_buckets, t=t, nactive=init_buckets)


def _split_bucket(s: HTSplit, keys):
    # THE structural constraint: bucket = key mod 2^i. No seed, no defence.
    return (keys & (s.nactive - 1)).to(I32)


def split_lookup(s: HTSplit, keys):
    f, v, _ = buckets.chain_lookup(s.t, keys, bucket=_split_bucket(s, keys))
    return f, v


def split_insert(s: HTSplit, keys, vals, mask=None):
    t, ok = buckets.chain_insert(s.t, keys, vals, _ones(keys, mask),
                                 bucket=_split_bucket(s, keys))
    return replace(s, t=t), ok


def split_delete(s: HTSplit, keys, mask=None):
    t, ok = buckets.chain_delete(s.t, keys, _ones(keys, mask),
                                 bucket=_split_bucket(s, keys))
    return replace(s, t=t), ok


def split_resize(s: HTSplit, grow: bool) -> HTSplit:
    """Double/halve the bucket count.  Split-ordered lists republish bucket
    pointers without moving nodes; the batched analogue is one rechain pass
    over the live nodes (no per-node distribution, no hazard period)."""
    nact = min(s.nactive * 2, s.max_buckets) if grow \
        else max(s.nactive // 2, 1)
    s2 = replace(s, nactive=nact)
    t = s.t
    live = t.astate == buckets.LIVE
    keys = torch.where(live, t.akey, 0)
    fresh = buckets.chain_make(t.nbuckets, t.arena, t.hfn, t.max_chain)
    t2, _ = buckets.chain_insert(fresh, keys, t.aval, live,
                                 bucket=_split_bucket(s2, keys))
    return replace(s2, t=t2)
