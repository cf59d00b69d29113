"""Paged KV cache with a DHash page table.

``(seq_id, block_idx) -> physical page`` lives in a DHash instance, so the
cache can be rehashed live while decode steps keep resolving pages: lookups
follow the ordered old -> hazard -> new check and never wait for the
rebuild.

**Multi-tenant mode** (``make(..., n_tenants=T)``): the page table is a
``dhash.make_stack`` of T per-tenant tables (tenant = ``seq_id % T``), each
with its own live rehash epoch (``start_rehash(kv, mask)``).  Table ops
group a flat key batch by tenant through the port's counting router
(``distributed._route``) into a ``[T, ceil(c·N/T) + spill_cap]`` send
buffer; keys past a tenant's cap ride the spill slab of the same buffer in
the same pass.  ``route_spill`` / ``route_drop`` accumulate the per-tenant
spill and the keys a compact slab could not carry.  The page POOL is
shared.

Differences from the reference, none of them visible in a result:

* Every table op is a DHash device-flag form (``lookup_by_flag``,
  ``insert_by_flag``, ``delete_by_flag``, ``rebuild_step_``, the stack
  ops): nothing in a decode step or a rehash step reads the host, and the
  tables (and the pools) are written IN PLACE.  A ``PagedKV`` passed to an
  op must not be used again; use the one it returns.
* The pools hold one page more than ``n_pages``: page ``n_pages`` is the
  sink that takes the writes the reference drops (``mode="drop"``, an
  inactive slot's write) and is never read.  ``free_stack`` scatters drop
  an index past the end the same way (a one-slot sink, then cut off).
* ``_evict_for`` runs the eviction masked instead of behind ``lax.cond``:
  a shortage <= 0 picks no victim and leaves the state as it was.
* ``paged_decode_attention`` gathers all ``n_blocks`` pages of a layer at
  once and sums the reference's block-by-block online softmax in closed
  form (see its docstring): the reference's loop over 32 blocks, run
  eagerly, issues ~15 operations a block
  (``docs/torch_port/paged_attention_forms.py`` times both).

``resolve_blocks`` runs once a layer, as in the reference: a page-table
lookup of ``B × n_blocks`` keys in every layer of every step.  Its calls
are counted in ``COUNTS["resolve_blocks"]`` (a harness reads it).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import dhash
from repro_torch.core.distributed import (_route, _route_payload, _unroute,
                                          route_cap, route_spill_cap)
from repro_torch.core.struct_utils import replace, state_dataclass
from repro_torch.serving import eviction

F32 = torch.float32
I32 = torch.int32
NEG_INF = -2.0e38
COUNTS = {"resolve_blocks": 0}


def block_key(seq_id: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """Pack the page-table key in int32; 15 bits of block index."""
    return (seq_id.to(I32) << 15) | block_idx.to(I32)


@state_dataclass
class PagedKV:
    layers: int
    page_size: int
    n_pages: int
    kv_heads: int
    head_dim: int
    max_blocks: int              # blocks per sequence bound
    n_tenants: int               # 1 = one page table; T > 1 = a stack
    cap_factor: float            # tenant-router cap c (<= 0: full width)
    spill_slack: float           # spill-slab budget (route_spill_cap):
                                 # 1.0 = overflow-proof; < 1 = compact slab
                                 # with exactly counted drops
    evict_batch: int             # max victims per evict-on-pressure pass
    pool_k: torch.Tensor         # [L, n_pages + 1, page, KV, HD]; the last
    pool_v: torch.Tensor         # page is the sink of dropped writes
    table: dhash.DHashState      # block_key -> page id ([T]-stacked if T > 1)
    free_stack: torch.Tensor     # [n_pages] i32
    free_top: torch.Tensor       # scalar i32
    route_spill: torch.Tensor    # [T] i32 cumulative router overflow
    route_drop: torch.Tensor     # [T] i32 cumulative keys a compact slab
                                 # could not carry
    alloc_fail: torch.Tensor     # scalar i32: masked allocations that found
                                 # no free page (after eviction, if enabled)
    prefix: eviction.PrefixState | None  # prefix cache + eviction (None =
                                 # caching disabled)

    @property
    def device(self) -> torch.device:
        return self.free_stack.device


def make(layers: int, page_size: int, n_pages: int, kv_heads: int,
         head_dim: int, *, max_blocks: int = 4096, dtype=torch.bfloat16,
         table_chunk: int = 256, seed: int = 3,
         n_tenants: int = 1, cap_factor: float = 2.0,
         spill_slack: float = 1.0,
         prefix_cache: bool = False, prefix_backend: str = "linear",
         prefix_capacity: int | None = None, prefix_seed: int = 11,
         prefix_fused: bool | None = None, evict_batch: int = 8,
         prefix_kw: dict | None = None,
         device: torch.device | str = "cuda") -> PagedKV:
    """An empty paged cache on ``device``.  On a CUDA device the page table
    runs DHash's kernels; elsewhere its ``fused`` follows ``DHASH_FUSED``
    (``dhash.make``'s default), as in the reference."""
    shp = (layers, n_pages + 1, page_size, kv_heads, head_dim)
    fused = eviction.table_fused(device)
    if n_tenants == 1:
        table = dhash.make("linear", capacity=2 * n_pages, chunk=table_chunk,
                           seed=seed, fused=fused, device=device)
    else:
        # every tenant's table is sized for the whole pool
        table = dhash.make_stack(n_tenants, "linear", capacity=2 * n_pages,
                                 chunk=table_chunk, seed=seed, fused=fused,
                                 device=device)
    prefix = None
    if prefix_cache:
        prefix = eviction.make(n_pages, backend=prefix_backend,
                               capacity=prefix_capacity, chunk=table_chunk,
                               seed=prefix_seed, fused=prefix_fused,
                               device=device, **(prefix_kw or {}))
    return PagedKV(
        layers=layers, page_size=page_size, n_pages=n_pages,
        kv_heads=kv_heads, head_dim=head_dim, max_blocks=max_blocks,
        n_tenants=n_tenants, cap_factor=cap_factor, spill_slack=spill_slack,
        evict_batch=evict_batch,
        pool_k=torch.zeros(shp, dtype=dtype, device=device),
        pool_v=torch.zeros(shp, dtype=dtype, device=device),
        table=table,
        free_stack=torch.arange(n_pages, dtype=I32, device=device),
        free_top=torch.full((), n_pages, dtype=I32, device=device),
        route_spill=torch.zeros((n_tenants,), dtype=I32, device=device),
        route_drop=torch.zeros((n_tenants,), dtype=I32, device=device),
        alloc_fail=torch.zeros((), dtype=I32, device=device),
        prefix=prefix)


def tenant_of(kv: PagedKV, seq_ids: torch.Tensor) -> torch.Tensor:
    """Owning tenant of each sequence (the engine's default partition)."""
    return torch.remainder(seq_ids.to(I32), kv.n_tenants).to(I32)


def _tenants(kv: PagedKV, seq_ids: torch.Tensor, n: int):
    """The tenant of each of ``n`` keys a sequence, flat [B * n]; None for
    one table, whose ops take no tenant."""
    if kv.n_tenants == 1:
        return None
    b = seq_ids.shape[0]
    return tenant_of(kv, seq_ids)[:, None].expand(b, n).reshape(-1)


def _scatter_drop(x: torch.Tensor, idx: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``x`` with ``src[i]`` written at ``idx[i]``; an index at or past the
    end lands in a one-slot sink that is cut off (the reference's
    ``mode="drop"``)."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros((1,))])
    out.scatter_(0, torch.where(idx < n, idx, n).long(), src.to(x.dtype))
    return out[:n]


# -- tenant-routed table access: a flat [N] batch grouped by owning tenant
# into capped [T, ceil(c*N/T) + spill_cap] buffers, one stack op, results
# scattered back to batch order; n_tenants == 1 is the single-table op ----

def _tenant_route(kv: PagedKV, tenant: torch.Tensor, keys: torch.Tensor):
    """Single-pass two-level route of a [N] batch by owning tenant."""
    cap = route_cap(kv.cap_factor, keys.shape[0], kv.n_tenants)
    return _route(keys, tenant, kv.n_tenants, cap,
                  route_spill_cap(keys.shape[0], cap, kv.spill_slack))


def table_lookup(kv: PagedKV, tenant: torch.Tensor, keys: torch.Tensor):
    """(found[N], vals[N]) across the tenant stack; ``tenant`` aligns with
    ``keys``.  Under a compact slab, slab-exhausted keys come back
    not-found."""
    if kv.n_tenants == 1:
        return dhash.lookup_by_flag(kv.table, keys)
    rt = _tenant_route(kv, tenant, keys)
    f, v = dhash.stack_lookup(kv.table, rt.send, rt.smask)
    return _unroute(f, rt, fill=False).bool(), _unroute(v, rt, fill=0)


def table_insert(kv: PagedKV, tenant: torch.Tensor, keys: torch.Tensor,
                 vals: torch.Tensor, mask: torch.Tensor):
    """(kv', ok[N]) across the tenant stack; a compact slab's shortfall
    reports ok=False and lands in ``route_drop``."""
    if kv.n_tenants == 1:
        table, ok = dhash.insert_by_flag(kv.table, keys, vals, mask)
        return replace(kv, table=table), ok
    rt = _tenant_route(kv, tenant, keys)
    table, ok = dhash.stack_insert(kv.table, rt.send,
                                   _route_payload(vals, rt),
                                   _route_payload(mask, rt))
    okb = _unroute(ok, rt, fill=False).bool()
    return replace(kv, table=table,
                   route_spill=kv.route_spill + rt.overflow,
                   route_drop=kv.route_drop + rt.dropped), okb


def table_delete(kv: PagedKV, tenant: torch.Tensor, keys: torch.Tensor,
                 mask: torch.Tensor):
    """(kv', ok[N]) across the tenant stack, as ``table_insert``."""
    if kv.n_tenants == 1:
        table, ok = dhash.delete_by_flag(kv.table, keys, mask)
        return replace(kv, table=table), ok
    rt = _tenant_route(kv, tenant, keys)
    table, ok = dhash.stack_delete(kv.table, rt.send,
                                   _route_payload(mask, rt))
    okb = _unroute(ok, rt, fill=False).bool()
    return replace(kv, table=table,
                   route_spill=kv.route_spill + rt.overflow,
                   route_drop=kv.route_drop + rt.dropped), okb


def resolve_blocks(kv: PagedKV, seq_ids: torch.Tensor, n_blocks: int):
    """DHash-resolve the page of every (seq, block) pair.
    seq_ids: [B] -> (pages [B, n_blocks] i32, found [B, n_blocks])."""
    COUNTS["resolve_blocks"] += 1
    b = seq_ids.shape[0]
    blk = torch.arange(n_blocks, dtype=I32, device=seq_ids.device)
    keys = block_key(seq_ids[:, None], blk[None, :]).reshape(-1)
    found, page = table_lookup(kv, _tenants(kv, seq_ids, n_blocks), keys)
    return page.reshape(b, n_blocks), found.reshape(b, n_blocks)



def _evict_for(kv: PagedKV, shortage: torch.Tensor) -> PagedKV:
    """Evict up to ``shortage`` cold unpinned cached pages into the free
    stack.  Masked, not gated: at a shortage <= 0 no victim is picked and
    the state is left as it was (the reference skips the call behind
    ``lax.cond``; a host branch here would read the device)."""
    ps, pages, ok = eviction.evict(kv.prefix, kv.evict_batch, shortage)
    rank = torch.cumsum(ok.to(I32), 0, dtype=I32) - 1
    dst = torch.where(ok, kv.free_top + rank, kv.n_pages)
    return replace(kv, prefix=ps,
                   free_stack=_scatter_drop(kv.free_stack, dst, pages),
                   free_top=kv.free_top + ok.sum(dtype=I32))


def alloc_pages(kv: PagedKV, seq_ids: torch.Tensor, block_idx: torch.Tensor,
                mask: torch.Tensor):
    """Allocate one page per masked (seq, block) and insert it into the
    table.  Idempotent: pairs already mapped keep their page.  With the
    prefix cache, pool pressure evicts cold unpinned cached pages first;
    ``kv.alloc_fail`` counts masked requests that still found no page.
    Returns (kv', pages [B], -1 where none was allocated)."""
    keys = block_key(seq_ids, block_idx)
    tenant = _tenants(kv, seq_ids, 1)
    present, _ = table_lookup(kv, tenant, keys)
    # router-dropped keys (a compact slab) are excluded from allocation
    servable = (_tenant_route(kv, tenant, keys).served
                if kv.n_tenants > 1 else torch.ones_like(mask))
    want = mask & servable & ~present
    if kv.prefix is not None:
        need = want.sum(dtype=I32)
        kv = _evict_for(kv, need - kv.free_top)
    rank = torch.cumsum(want.to(I32), 0, dtype=I32) - 1
    can = want & (rank < kv.free_top)
    page = kv.free_stack[torch.where(can, kv.free_top - 1 - rank, 0).long()]
    kv, ok = table_insert(kv, tenant, keys, page, can)
    used = (can & ok).sum(dtype=I32)
    fail = ((mask & ~servable) | (want & ~can) | (can & ~ok)).sum(dtype=I32)
    return replace(kv, free_top=kv.free_top - used,
                   alloc_fail=kv.alloc_fail + fail), \
        torch.where(can & ok, page, -1)


def resolve_blocks_at(kv: PagedKV, seq_ids: torch.Tensor,
                      block_idx: torch.Tensor):
    keys = block_key(seq_ids, block_idx)
    found, page = table_lookup(kv, _tenants(kv, seq_ids, 1), keys)
    return page, found


def append_token(kv: PagedKV, seq_ids: torch.Tensor, positions: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> PagedKV:
    """Write one token's K/V for every layer (pools written in place).

    k_new/v_new: [L, B, KV, HD]; positions: [B] (0-based index of the new
    token).  Allocates a fresh page when the position opens a new block."""
    ps = kv.page_size
    blk, off = positions // ps, positions % ps
    kv, pages_new = alloc_pages(kv, seq_ids, blk, off == 0)
    pages, found = resolve_blocks_at(kv, seq_ids, blk)
    page = torch.where(found, pages, pages_new)
    # a page of -1 (no page) indexes the last page, as a negative index
    # does in the reference's scatter
    page = torch.where(page < 0, page + kv.n_pages, page).long()
    lidx = torch.arange(kv.layers, device=page.device)[:, None]
    kv.pool_k[lidx, page[None, :], off.long()[None, :]] = k_new
    kv.pool_v[lidx, page[None, :], off.long()[None, :]] = v_new
    return kv


def paged_decode_attention(kv: PagedKV, layer: int, q1: torch.Tensor,
                           seq_ids: torch.Tensor, cache_len: torch.Tensor,
                           n_blocks: int, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Flash-decoding over pages for ONE layer of the pool.

    q1: [B, Hq, HD]; returns [B, Hq, HD].  The reference scans the blocks
    with a running (max, denominator, accumulator).  Here the layer's
    ``n_blocks`` pages are gathered at once, and the same quantities are
    formed for every block together: the running max ``m_b`` (a cumulative
    max over the blocks' maxima), the weights ``w_b = exp(s_b - m_b)``
    (in float32, to the value dtype for the product, as the reference's)
    and the block products ``w_b v_b``.  The recurrence ``acc_b =
    acc_{b-1} * exp(m_{b-1} - m_b) + w_b v_b`` (and ``l`` alike) is summed
    in closed form: the product of the later corrections is ``exp(m_b -
    m_last)``.  The result equals the scan's up to float rounding; the
    layer issues one gather a pool and two products instead of a loop of
    ``n_blocks`` steps.  The accumulator is float32 and is cast at the
    end."""
    b, hq, hd = q1.shape
    hkv, ps = kv.kv_heads, kv.page_size
    g = hq // hkv
    scale = 1.0 / np.sqrt(hd)
    pages, found = resolve_blocks(kv, seq_ids, n_blocks)    # [B, n_blocks]
    have = found & (pages >= 0)
    qg = q1.reshape(b, hkv, g, hd)
    pg = torch.where(have, pages, 0).long()          # a miss reads page 0
    # the gathered pages as [B, KV, HD, nb * ps] keys and [B, KV, nb, ps,
    # HD] values: the products are the reference's einsums, as matmuls
    kb = kv.pool_k[layer][pg].permute(0, 3, 4, 1, 2).flatten(3)
    vb = kv.pool_v[layer][pg].permute(0, 3, 1, 2, 4)
    s = (qg @ kb).unflatten(-1, (n_blocks, ps)).to(F32) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(n_blocks * ps, dtype=I32,
                       device=q1.device).view(1, n_blocks, ps)
    clen = cache_len[:, None, None]
    ok = (pos < clen) & have[:, :, None]                          # [B, nb, ps]
    if window > 0:
        ok &= pos >= clen - window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m = torch.cummax(s.amax(-1), dim=-1).values               # [B,h,g,nb]
    w = torch.exp(s - m[..., None])
    carry = torch.exp(m - m[..., -1:])                        # to the end
    l = (w.sum(-1) * carry).sum(-1)
    pv = (w.to(vb.dtype).transpose(2, 3) @ vb).to(F32)       # [B,h,nb,g,HD]
    acc = (pv * carry.transpose(2, 3)[..., None]).sum(2)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, hd).to(q1.dtype)


def free_sequences(kv: PagedKV, seq_ids: torch.Tensor,
                   max_blocks: int) -> PagedKV:
    """Release all pages of finished sequences to the free stack and delete
    their table entries.  With the prefix cache, a finished sequence's
    cached pages (the ones it holds a pin on) are unpinned instead of
    freed; they return to the pool only through eviction."""
    blk = torch.arange(max_blocks, dtype=I32, device=seq_ids.device)
    keys = block_key(seq_ids[:, None], blk[None, :]).reshape(-1)
    tenant = _tenants(kv, seq_ids, max_blocks)
    found, pages = table_lookup(kv, tenant, keys)
    kv, ok = table_delete(kv, tenant, keys, found)
    push = ok
    if kv.prefix is not None:
        tgt = torch.clamp(pages, 0, kv.n_pages - 1).long()
        pinned = ok & kv.prefix.cached[tgt]
        kv = replace(kv, prefix=eviction.release(kv.prefix, pages, pinned))
        push = ok & ~pinned
    # push freed pages (deterministic order)
    rank = torch.cumsum(push.to(I32), 0, dtype=I32) - 1
    dst = torch.where(push, kv.free_top + rank, kv.n_pages)
    return replace(kv, free_stack=_scatter_drop(kv.free_stack, dst, pages),
                   free_top=kv.free_top + push.sum(dtype=I32))


def _one(kv: PagedKV, seq_id, n: int):
    """(block keys [n], tenants [n]) of blocks 0..n-1 of ONE sequence."""
    seq = torch.as_tensor(seq_id, dtype=I32, device=kv.device)
    blk = torch.arange(n, dtype=I32, device=kv.device)
    keys = block_key(seq.expand(n), blk)
    return keys, _tenants(kv, seq.reshape(1), n)


def adopt_prefix(kv: PagedKV, seq_id, fps: torch.Tensor,
                 valid: torch.Tensor):
    """Adopt the longest cached prefix for ONE admitted sequence.

    ``fps``: [n] block fingerprints, ``valid``: [n] bool (False past the
    prompt's full blocks).  The contiguous run of cached fingerprints is
    mapped into the sequence's page table, pinned and re-warmed; failed
    page-table inserts truncate the run (stragglers rolled back).  Returns
    ``(kv', n_adopt, pages [n])`` with -1 past the adopted length."""
    ps = kv.prefix
    found, pages = dhash.lookup_by_flag(ps.table, fps)
    run = torch.cumprod((found & valid).to(I32), 0, dtype=I32).bool()
    keys, tenant = _one(kv, seq_id, fps.shape[0])
    kv, ok = table_insert(kv, tenant, keys, pages, run)
    keep = torch.cumprod((run & ok).to(I32), 0, dtype=I32).bool()
    kv, _ = table_delete(kv, tenant, keys, run & ok & ~keep)
    ps = eviction.touch(eviction.acquire(ps, pages, keep), pages, keep)
    return replace(kv, prefix=ps), keep.sum(dtype=I32), \
        torch.where(keep, pages, -1)


def publish_blocks(kv: PagedKV, seq_id, fps: torch.Tensor,
                   mask: torch.Tensor):
    """Publish ONE sequence's fully written blocks into the prefix cache
    (its own page-table entries; the sequence takes a pin on each published
    page).  Returns ``(kv', n_pub)``."""
    keys, tenant = _one(kv, seq_id, fps.shape[0])
    found, pages = table_lookup(kv, tenant, keys)
    ps, ok = eviction.publish(kv.prefix, fps, pages, mask & found)
    ps = eviction.acquire(ps, pages, ok)
    return replace(kv, prefix=ps), ok.sum(dtype=I32)


def _finish_step_(t: dhash.DHashState) -> None:
    """One rebuild transition and, where it completes the rebuild, the
    epoch swap, in place (the reference's
    ``finish_same_shape(rebuild_step(t))``)."""
    dhash.finish_same_shape_(t, go=dhash.rebuild_step_(t, swap=True))


def rehash_step(kv: PagedKV) -> PagedKV:
    """One live rebuild transition on the page table, in place.

    One table: the transition only (the engine swaps the epoch from the
    host, as the reference's does).  A tenant stack: every rebuilding
    tenant advances and swaps on the device the moment ITS rebuild
    completes.  The prefix index and its reverse index advance their own
    epochs the same way."""
    if kv.n_tenants == 1:
        dhash.rebuild_step_(kv.table)
    else:
        dhash.stack_finish_same_shape_(
            kv.table, go=dhash.stack_rebuild_step_(kv.table, swap=True))
    if kv.prefix is not None:
        _finish_step_(kv.prefix.table)
        _finish_step_(kv.prefix.rev)
    return kv


def start_prefix_rehash(kv: PagedKV, *, seed: int | None = None) -> PagedKV:
    """Begin a live same-shape rehash of the prefix (fingerprint) index
    with a fresh hash seed.  Host-side helper (one read of the flag): a
    no-op if a rebuild is already in flight."""
    ps = kv.prefix
    if ps is None:
        raise ValueError("prefix cache is disabled (make(prefix_cache=True))")
    if bool(ps.table.rebuilding):
        return kv
    table = dhash.rebuild_start(ps.table, seed=seed)
    return replace(kv, prefix=replace(ps, table=table))


def start_rehash(kv: PagedKV, mask=None) -> PagedKV:
    """Begin a live rehash on the selected tenants' tables ([T] bool; all
    by default), in place; tables mid-rebuild are untouched.  Multi-tenant
    only."""
    if kv.n_tenants == 1:
        raise ValueError("start_rehash targets a tenant stack; use "
                         "dhash.rebuild_start on kv.table for n_tenants=1")
    return replace(kv, table=dhash.stack_autostart(kv.table, mask))


def table_load(kv: PagedKV, *, with_spill: bool = False):
    """Active-table load factor per tenant table ([T] f32; scalar for one
    table): live entries in the active (old) table over its capacity.
    ``with_spill=True`` returns ``(load, route_spill, route_drop)``."""
    be = backends.get(kv.table.backend)
    load = be.count_live(kv.table.old) / be.capacity_of(kv.table.old)
    return (load, kv.route_spill, kv.route_drop) if with_spill else load


def table_health(kv: PagedKV):
    """(live_load, tomb_load) per tenant table ([T] f32 pair; scalars for
    one table), the elastic rehash trigger's inputs
    (``core.policy.rehash_wanted``)."""
    be = backends.get(kv.table.backend)
    cap = be.capacity_of(kv.table.old)
    return (be.count_live(kv.table.old) / cap,
            be.count_tomb(kv.table.old) / cap)
