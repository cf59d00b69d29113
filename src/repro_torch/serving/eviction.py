"""Clock/LRU eviction for the prefix cache, itself a DHash client.

State (``PrefixState``):

* ``table``: the forward prefix index, ``fingerprint -> page`` (what
  ``prefix_cache.match_prefix`` queries); any backend.
* ``rev``: the reverse index, ``page_key(page) = page + 1 -> fingerprint``
  (linear), how a victim page finds the fingerprint it must delete.
* ``refcnt``: pin counts per page; a pinned page is never a victim.
* ``cached`` / ``stamp`` / ``clock``: clock-LRU bookkeeping; victims are
  the coldest stamps among ``cached & refcnt == 0``, ties to the lowest
  page id.

On a CUDA device the two indexes always run DHash's kernels (``fused``);
elsewhere ``fused`` follows ``DHASH_FUSED`` as in the reference
(``table_fused``).

Invariant: every cached page has exactly one forward and one reverse
entry (``publish`` rolls back a forward insert whose reverse insert failed,
``evict`` deletes both or neither).

The table ops are DHash's device-flag forms and write the two indexes IN
PLACE; no function here reads the host.  Where the reference gates a
repair on ``lax.cond`` (``publish``'s roll-back), the port runs the masked
op unconditionally: a delete whose mask is all clear changes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core import dhash
from repro_torch.core.struct_utils import replace, state_dataclass

I32 = torch.int32
STAMP_MAX = torch.iinfo(torch.int32).max


def table_fused(device, fused: bool | None = None) -> bool | None:
    """``fused`` for a serving table on ``device``: the caller's choice;
    else True on a CUDA device (the kernels, never their plain versions);
    else None, so that ``dhash.make`` reads ``DHASH_FUSED``."""
    if fused is None and torch.device(device).type == "cuda":
        return True
    return fused


def page_key(pages: torch.Tensor) -> torch.Tensor:
    """Reverse-index key of a page id (shifted so page 0 and the invalid
    marker -1 stay distinct key values)."""
    return pages.to(I32) + 1


@state_dataclass
class PrefixState:
    n_pages: int
    table: dhash.DHashState      # fingerprint -> page (forward prefix index)
    rev: dhash.DHashState        # page_key(page) -> fingerprint
    refcnt: torch.Tensor         # [n_pages] i32 pin counts
    cached: torch.Tensor         # [n_pages] bool: page holds a published block
    stamp: torch.Tensor          # [n_pages] i32 last-touch clock tick
    clock: torch.Tensor          # scalar i32
    evictions: torch.Tensor      # scalar i32 cumulative victim count


def make(n_pages: int, *, backend: str = "linear",
         capacity: int | None = None, chunk: int = 256, seed: int = 11,
         fused: bool | None = None, device: torch.device | str = "cuda",
         **backend_kw) -> PrefixState:
    """The eviction state on ``device``.  ``capacity`` sizes the forward
    index (default ``4 * n_pages``); the reverse index is linear at
    ``2 * n_pages``."""
    if capacity is None:
        capacity = 4 * n_pages
    table = dhash.make(backend, capacity=capacity, chunk=chunk, seed=seed,
                       fused=table_fused(device, fused), device=device,
                       **backend_kw)
    rev = dhash.make("linear", capacity=2 * n_pages, chunk=chunk,
                     seed=seed + 7, fused=table_fused(device), device=device)
    return PrefixState(
        n_pages=n_pages, table=table, rev=rev,
        refcnt=torch.zeros((n_pages,), dtype=I32, device=device),
        cached=torch.zeros((n_pages,), dtype=torch.bool, device=device),
        stamp=torch.zeros((n_pages,), dtype=I32, device=device),
        clock=torch.ones((), dtype=I32, device=device),
        evictions=torch.zeros((), dtype=I32, device=device))


def _target(ps: PrefixState, pages: torch.Tensor) -> torch.Tensor:
    return torch.clamp(pages, 0, ps.n_pages - 1).long()


def _scatter_hit(ps: PrefixState, pages: torch.Tensor, mask: torch.Tensor):
    """[n_pages] bool: pages named by the masked batch (dup-safe)."""
    hits = torch.zeros((ps.n_pages,), dtype=I32, device=pages.device)
    return hits.index_add_(0, _target(ps, pages), mask.to(I32)) > 0


def publish(ps: PrefixState, fps: torch.Tensor, pages: torch.Tensor,
            mask: torch.Tensor):
    """Publish ``fingerprint -> page`` mappings and mark the pages cached.

    Set semantics: an already-published fingerprint keeps its EXISTING page
    (an epoch-consistent pre-lookup screens it out, also mid-rebuild, where
    the insert alone checks only its target table).  Returns ``(ps', ok)``,
    ``ok`` marking mappings that landed in BOTH indexes."""
    already, _ = dhash.lookup_by_flag(ps.table, fps)
    table, ok = dhash.insert_by_flag(ps.table, fps, pages, mask & ~already)
    rev, okr = dhash.insert_by_flag(ps.rev, page_key(pages), fps, ok)
    # roll back a forward entry whose reverse insert failed (masked: the
    # healthy path deletes nothing)
    table, _ = dhash.delete_by_flag(table, fps, ok & ~okr)
    ok = ok & okr
    hit = _scatter_hit(ps, pages, ok)
    return replace(ps, table=table, rev=rev,
                   cached=ps.cached | hit,
                   stamp=torch.where(hit, ps.clock, ps.stamp),
                   clock=ps.clock + 1), ok


def touch(ps: PrefixState, pages: torch.Tensor,
          mask: torch.Tensor) -> PrefixState:
    """Stamp pages with the current clock tick (a hit re-warms its pages)."""
    hit = _scatter_hit(ps, pages, mask)
    return replace(ps, stamp=torch.where(hit, ps.clock, ps.stamp),
                   clock=ps.clock + 1)


def acquire(ps: PrefixState, pages: torch.Tensor,
            mask: torch.Tensor) -> PrefixState:
    """Pin pages (+1 refcnt each masked reference; duplicates accumulate)."""
    return replace(ps, refcnt=ps.refcnt.index_add(
        0, _target(ps, pages), mask.to(I32)))


def release(ps: PrefixState, pages: torch.Tensor,
            mask: torch.Tensor) -> PrefixState:
    """Unpin pages (-1 refcnt per masked reference)."""
    return replace(ps, refcnt=ps.refcnt.index_add(
        0, _target(ps, pages), -mask.to(I32)))


def evictable(ps: PrefixState) -> torch.Tensor:
    """[n_pages] bool: cached and unpinned, the victim candidates."""
    return ps.cached & (ps.refcnt == 0)


def evict(ps: PrefixState, k: int, want):
    """Evict up to ``want`` (a count, ``<= k``; nothing when <= 0) coldest
    unpinned cached pages.

    The victim scan is one ``topk`` over the composite key ``(stamp, page
    id)`` (pinned and uncached pages at ``STAMP_MAX``): the key is unique,
    so ties between equal stamps go to the lowest page id whatever the
    sort, as the reference's index-stable ``lax.top_k`` gives.  Each victim
    resolves its fingerprint through the reverse index; both entries are
    deleted and ``cached`` drops.  Returns ``(ps', pages[k], ok[k])``;
    ``ok`` marks pages actually evicted."""
    n = ps.n_pages
    ids = torch.arange(n, dtype=torch.int64, device=ps.stamp.device)
    cold = torch.where(evictable(ps), ps.stamp, STAMP_MAX).to(torch.int64)
    key = torch.topk(cold * n + ids, k, largest=False, sorted=True).values
    idx = (key % n).to(I32)
    pick = ((key // n) != STAMP_MAX) & \
        (torch.arange(k, device=ids.device) < want)
    found, fps = dhash.lookup_by_flag(ps.rev, page_key(idx))
    # a cached page with no reverse entry is never freed (unreachable by
    # the invariant)
    ok = pick & found
    table, _ = dhash.delete_by_flag(ps.table, fps, ok)
    rev, _ = dhash.delete_by_flag(ps.rev, page_key(idx), ok)
    hit = _scatter_hit(ps, idx, ok)
    return replace(ps, table=table, rev=rev,
                   cached=ps.cached & ~hit,
                   evictions=ps.evictions + ok.sum(dtype=I32)), idx, ok
