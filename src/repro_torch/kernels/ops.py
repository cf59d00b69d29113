"""The op layer over the kernels.

Linear: ``probe_lookup`` is the accelerated equivalent of
``ref.probe_lookup_ref`` (and of ``buckets.linear_lookup``'s inner loop;
given the table's hash function as ``hfn`` in place of the start slots, the
kernel hashes the keys itself);
``ordered_lookup_fused`` is the rebuild-epoch path (one ``probe2`` launch for
the whole old -> hazard -> new ordered check); ``probe_insert`` /
``probe_delete`` are the write paths (the insert kernel; the location-emitting
lookup + one scatter); ``ordered_delete_fused`` is the rebuild-epoch delete
(the same ``probe2`` launch's location outputs drive the old/new tombstones
and the hazard kill); ``extract_chunk_fused`` is the rebuild chunk scan,
which the two-row backends run on their flattened arrays.

Twochoice and cuckoo (two candidate rows a key, [B, W] tables):
``twochoice_lookup`` / ``twochoice_insert`` / ``twochoice_delete`` over the
``tc_lookup`` and ``tc_insert`` kernels (the lookup and delete given the
rows, or the table's two hash functions, which the kernel applies itself),
``cuckoo_insert`` (``tc_insert`` with the bounded kick-out in its resolve),
and ``twochoice_ordered_lookup`` /
``twochoice_ordered_delete`` over ``tc_probe2``, whose outputs have the
meaning of ``probe2``'s, so both ordered deletes land through one helper.

Chain (a bucket-sorted node arena): ``chain_lookup_fused`` /
``chain_delete_fused`` / ``chain_insert_fused`` over the ``chain_probe``
kernel, ``chain_ordered_lookup`` / ``chain_ordered_delete`` over
``chain_probe2`` (outputs with ``probe2``'s meaning, landed by the same
helper), and ``chain_compact_fused``, the compaction that keeps the arena
sorted: plain PyTorch, as the reference's is XLA ops and no kernel.

Each op is one kernel launch plus the tensor ops that the reference also
runs outside its kernels (the deletes' scatters; the chain insert's
allocation and relink, with the one sort that orders it).  There is no
padding, no query sort, no tile map and no fallback branch: nothing here
reads a value back to the host, so an op never synchronises.  On CPU tensors
the same code runs through the kernels' plain versions (``kernels/probe.py``).

In-place contract: ``probe_insert`` and ``chain_insert_fused`` write the
table arrays they are given; the deletes write the state arrays;
``extract_chunk_fused`` writes the state array.  Each returns the arrays it
wrote, so callers may use them functionally.  All work runs under
``torch.no_grad()``: there is no gradient anywhere on this path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import probe

I32 = torch.int32
EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3

# Field of ``DHashState`` and argument of ``dhash.make`` kept for parity with
# the reference's API (resident new-table blocks of its tile map).  The Hopper
# linear kernels gather both tables in place and do not use it.
NRES_CAP = 16

# Dirty-tail window of the chain backend: the nodes inserted since the last
# compaction are found by a dense compare against a window of this many
# nodes; a tail grown past it can no longer prove absence, so a miss there
# takes the bounded walk, and ``backend.chain_maybe_compact`` re-sorts the
# arena at exactly this threshold.  The default of the ``dirty_cap``
# parameter; the live value is a ``BucketBackend`` descriptor field.
DIRTY_CAP = 512

# Largest chunk (hazard buffer) the extract and probe2 kernels take.  Above
# it the backend adapter raises for a table on a CUDA device and uses the
# plain scan only for a table on the CPU (a documented contract).
EXTRACT_MAX_CHUNK = probe.EXTRACT_MAX_CHUNK


def _tombstone_(state: torch.Tensor, ok: torch.Tensor, loc: torch.Tensor):
    """state[loc[ok]] = TOMB in place, without a host read: TOMB outranks
    LIVE, so an atomic max with 0 from the idle queries changes nothing."""
    state.scatter_reduce_(0, torch.where(ok, loc, 0).long(),
                          torch.where(ok, TOMB, 0).to(I32), "amax")
    return state


def _probe(tkey, tval, tstate, h0, qkey, hfn, max_probes: int):
    """The lookup kernel on start slots ``h0``, or, where ``h0`` is None,
    with the start slots hashed in the kernel by the table's ``hfn``."""
    if (h0 is None) == (hfn is None):
        raise ValueError("give exactly one of h0 and hfn")
    if hfn is None:
        return probe.probe_lookup(tkey, tval, tstate, h0, qkey, max_probes)
    return probe.probe_lookup_hashed(tkey, tval, tstate, hfn, qkey,
                                     max_probes)


@torch.no_grad()
def probe_lookup(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor | None, qkey: torch.Tensor, *,
                 hfn=None, max_probes: int = 64, with_loc: bool = False):
    """Batched linear-probe lookup. Returns (found[Q], val[Q]), or
    (found, val, loc[Q]) when ``with_loc`` — ``loc`` is the hit's physical
    slot in [0, C) (-1 on miss), the probe telemetry input.

    Args:
      tkey/tval/tstate: table arrays [C].
      h0: start slot per query (hash(key) % C), [Q]; None with ``hfn``.
      qkey: query keys [Q].
      hfn: the table's ``HashFn``, in place of ``h0``: the kernel hashes
        each key itself (``probe.probe_lookup_hashed``, equal to
        ``bucket_of`` first).
    """
    found, val, loc = _probe(tkey, tval, tstate, h0, qkey, hfn, max_probes)
    return (found, val, loc) if with_loc else (found, val)


@torch.no_grad()
def ordered_lookup(old_tables, new_tables, hazard_key, hazard_val, hazard_live,
                   h0_old, h0_new, qkey, *, max_probes: int = 64):
    """UNFUSED rebuild-epoch lookup: old table -> hazard buffer -> new table
    (the paper's Lemma 4.1 order), each table pass its own ``probe_lookup``
    launch and the hazard check a dense compare.  Kept as the comparison
    baseline for ``ordered_lookup_fused``."""
    f_old, v_old = probe_lookup(*old_tables, h0_old, qkey,
                                max_probes=max_probes)
    eq = (qkey[:, None] == hazard_key[None, :]) & hazard_live[None, :]
    f_hz = eq.any(-1)
    v_hz = hazard_val[eq.to(torch.uint8).argmax(dim=-1)]
    f_new, v_new = probe_lookup(*new_tables, h0_new, qkey,
                                max_probes=max_probes)
    found = f_old | f_hz | f_new
    val = torch.where(f_old, v_old, torch.where(f_hz, v_hz, v_new))
    return found, val


@torch.no_grad()
def ordered_lookup_fused(old_tables, new_tables, hazard_key, hazard_val,
                         hazard_live, h0_old, h0_new, qkey, *,
                         max_probes: int = 64, nres_cap: int = NRES_CAP,
                         rebuilding=None, with_loc: bool = False):
    """FUSED rebuild-epoch lookup: ONE ``probe2`` launch emits the
    Lemma-4.1-ordered result for both tables plus the hazard buffer, whatever
    the size of the new table.  ``nres_cap`` is accepted and unused.  On a
    table stack ([T, ...] operands) ``rebuilding`` (one flag a table) sends
    the idle tables to their old table alone.  Returns (found, val), and
    the old table's hit slot ``loc_old`` too when ``with_loc``."""
    found, val, _, loc_old, _, _ = probe.probe2(
        old_tables, new_tables, hazard_key, hazard_val, hazard_live, h0_old,
        h0_new, qkey, max_probes, rebuilding)
    return (found, val, loc_old) if with_loc else (found, val)


@torch.no_grad()
def probe_insert(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor, *, max_probes: int = 64,
                 with_present: bool = False, alt=None, use_alt=None):
    """Batched linear-probe INSERT via the ``probe_insert`` kernel; writes
    ``tkey/tval/tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered (at most one True per
    distinct key; use ``buckets.batch_winners``).  Set semantics: ok=False if
    the key is already LIVE or no free slot exists within ``max_probes``.
    The placement is ``ref.probe_insert_ref``'s, slot for slot.

    Returns (tkey, tval, tstate, ok[Q]) — the arrays it was given — and,
    when ``with_present``, also ``present[Q]`` (masked keys found LIVE
    before the batch).  A table stack's operands are [T, ...]; ``alt`` /
    ``use_alt`` pick each table's target on the device
    (``probe.probe_insert``).
    """
    ok, present = probe.probe_insert(tkey, tval, tstate, h0, keys, vals, mask,
                                     max_probes, alt=alt, use_alt=use_alt)
    if with_present:
        return tkey, tval, tstate, ok, present
    return tkey, tval, tstate, ok


@torch.no_grad()
def probe_delete(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor | None, keys: torch.Tensor,
                 mask: torch.Tensor, *, hfn=None, max_probes: int = 64):
    """Batched linear-probe DELETE: the location-emitting lookup kernel +
    ONE tombstone scatter; writes ``tstate`` IN PLACE.  ``h0`` and ``hfn``
    as in ``probe_lookup``: start slots, or None and the table's
    ``HashFn``.

    Caller contract: ``mask`` is winner-filtered, so distinct masked keys
    occupy distinct slots.  Returns (tstate, ok[Q]).
    """
    found, _val, loc = _probe(tkey, tval, tstate, h0, keys, hfn,
                             max_probes)
    ok = mask & found
    return _tombstone_(tstate, ok, loc), ok


def _land_ordered_delete(old_state, new_state, hazard_live, mask, f_old,
                         loc_old, hz_idx, loc_new):
    """Land a rebuild-epoch delete from the location outputs of ``probe2`` /
    ``tc_probe2``: tombstone the old-table slot, or clear the hazard live
    bit, or tombstone the new-table slot (old > hazard > new; at most one
    fires — the kernels report hz_idx / loc_new only where nothing earlier
    resolved).  Writes both state arrays IN PLACE (row-major [B, W] arrays
    through their flat view).  A table stack's [T, Q] outputs land on its
    stacked arrays, each table's locations offset to its row.  Returns
    (old_state, new_state, hazard_live', ok)."""
    ok_old = mask & f_old
    ok_hz = mask & (hz_idx >= 0)
    ok_new = mask & (loc_new >= 0)

    def flat(loc, arr):
        # table t's locations into the flat view of the stacked ``arr``
        if loc.dim() == 1:
            return loc
        rows = torch.arange(loc.shape[0], dtype=loc.dtype, device=loc.device)
        return (loc + rows[:, None] * (arr.numel() // arr.shape[0])).view(-1)

    _tombstone_(old_state.view(-1), ok_old.view(-1), flat(loc_old, old_state))
    _tombstone_(new_state.view(-1), ok_new.view(-1), flat(loc_new, new_state))
    kill = torch.zeros(hazard_live.numel(), dtype=I32,
                       device=hazard_live.device)
    kill.scatter_reduce_(0, torch.where(ok_hz.view(-1),
                                        flat(hz_idx, hazard_live), 0).long(),
                         ok_hz.view(-1).to(I32), "amax")
    return old_state, new_state, hazard_live & (kill.view(
        hazard_live.shape) == 0), ok_old | ok_hz | ok_new


@torch.no_grad()
def ordered_delete_fused(old_tables, new_tables, hazard_key, hazard_val,
                         hazard_live, h0_old, h0_new, keys, mask, *,
                         max_probes: int = 64, nres_cap: int = NRES_CAP,
                         rebuilding=None):
    """FUSED rebuild-epoch delete (paper Alg. 5): ONE ``probe2`` launch
    resolves the ordered check, then three scatters land the result —
    tombstone the old-table slot, or clear the hazard live bit
    (LOGICALLY_REMOVED on an in-flight entry; landing drops it), or
    tombstone the new-table slot.  Writes both state arrays IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (old_state, new_state, hazard_live', ok[Q]); ``hazard_live'`` is a new
    tensor.  On a table stack ([T, ...] operands) ``rebuilding`` (one flag
    a table) makes it the steady delete of the idle tables (their old table
    alone).
    """
    _f, _v, *locs = probe.probe2(old_tables, new_tables, hazard_key,
                                 hazard_val, hazard_live, h0_old, h0_new,
                                 keys, max_probes, rebuilding)
    return _land_ordered_delete(old_tables[2], new_tables[2], hazard_live,
                                mask, *locs)


@torch.no_grad()
def extract_chunk_fused(tkey: torch.Tensor, tval: torch.Tensor,
                        tstate: torch.Tensor, cursor: torch.Tensor, *,
                        chunk: int, out=None, run=None, hold=None):
    """Rebuild chunk scan via the extract kernel: ONE launch reads the slots
    at ``cursor`` (a 0-dim int32 tensor; never read on the host), compacts
    the live entries, and marks them MIGRATED in ``tstate`` IN PLACE.
    Requires ``chunk <= EXTRACT_MAX_CHUNK`` (the caller gates).  With
    ``out`` (the hazard buffer) the scan writes it and advances ``cursor``
    in place, and only where the device flags ``run`` and not ``hold``
    allow (``probe.extract``).

    Returns (tstate, hkeys[chunk], hvals[chunk], hlive[chunk] bool,
    new_cursor) — identical set contents to the plain scan, with the hazard
    entries compacted to the front.
    """
    if chunk > EXTRACT_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the extract kernel's "
                         f"{EXTRACT_MAX_CHUNK}")
    hk, hv, hl, new_cursor = probe.extract(tkey, tval, tstate, cursor, chunk,
                                           out=out, run=run, hold=hold)
    return tstate, hk, hv, hl, new_cursor


# ---------------------------------------------------------------------------
# twochoice / cuckoo: two candidate rows a key
# ---------------------------------------------------------------------------

def _tc_probe(tkey, tval, tstate, rows_a, rows_b, qkey, hfn_a, hfn_b,
              nbuckets: int, b_offset: int):
    """The two-row lookup kernel on the rows given, or, where both rows are
    None, with the rows hashed in the kernel by the table's two hash
    functions."""
    rows = (rows_a is not None, rows_b is not None)
    fns = (hfn_a is not None, hfn_b is not None)
    if not (rows == (True, True) and fns == (False, False)
            or rows == (False, False) and fns == (True, True)):
        raise ValueError("give exactly one of rows (rows_a and rows_b) and "
                         "hash functions (hfn_a and hfn_b)")
    if hfn_a is None:
        return probe.tc_lookup(tkey, tval, tstate, rows_a, rows_b, qkey)
    return probe.tc_lookup_hashed(tkey, tval, tstate, hfn_a, hfn_b, nbuckets,
                                  b_offset, qkey)


@torch.no_grad()
def twochoice_lookup(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor | None,
                     rows_b: torch.Tensor | None, qkey: torch.Tensor, *,
                     hfn_a=None, hfn_b=None, nbuckets: int = 0,
                     b_offset: int = 0):
    """Batched two-row lookup on a [B, W] table: ONE ``tc_lookup`` launch,
    a-row priority (the tie-break of ``buckets.twochoice_lookup``).

    The rows are given (``rows_a``, ``rows_b``), or both are None and the
    kernel hashes each key itself (``probe.tc_lookup_hashed``): row a is
    ``bucket_of(hfn_a, key, nbuckets)``, row b ``b_offset + bucket_of(hfn_b,
    key, nbuckets)`` (``b_offset`` 0 on a twochoice table, ``nbuckets`` on
    a cuckoo table).  Exactly one of the two, else ValueError.

    Returns (found[Q], val[Q] — 0 on a miss, loc[Q] flat slot or -1) —
    ``loc`` is reused by ``twochoice_delete`` so deleting never probes
    twice."""
    return _tc_probe(tkey, tval, tstate, rows_a, rows_b, qkey, hfn_a, hfn_b,
                     nbuckets, b_offset)


@torch.no_grad()
def twochoice_insert(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor,
                     rows_b: torch.Tensor, keys: torch.Tensor,
                     vals: torch.Tensor, mask: torch.Tensor, *,
                     max_rounds: int = 8, claim: torch.Tensor | None = None,
                     with_present: bool = False, alt=None, use_alt=None):
    """Batched two-row INSERT via the ``tc_insert`` claim kernel; writes
    ``tkey/tval/tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Set semantics: ok=False
    if the key is LIVE in either row or no round found a lane.  The placement
    is ``ref.tc_insert_ref``'s, slot for slot.

    Returns (tkey, tval, tstate, ok[Q]) and, when ``with_present``, also
    ``present[Q]`` (masked keys LIVE in either row before the batch).  A
    table stack's operands are [T, ...]; ``alt`` / ``use_alt`` pick each
    table's target on the device (``probe.tc_insert``)."""
    ok, present = probe.tc_insert(tkey, tval, tstate, rows_a, rows_b, keys,
                                  vals, mask, max_rounds, claim, alt=alt,
                                  use_alt=use_alt)
    if with_present:
        return tkey, tval, tstate, ok, present
    return tkey, tval, tstate, ok


@torch.no_grad()
def cuckoo_insert(tkey: torch.Tensor, tval: torch.Tensor,
                  tstate: torch.Tensor, rows_a: torch.Tensor,
                  rows_b: torch.Tensor, hfn_a, hfn_b, nbuckets: int,
                  keys: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                  *, max_kick: int, claim: torch.Tensor | None = None,
                  with_present: bool = False, alt=None, use_alt=None):
    """Batched cuckoo INSERT on a [2B, W] table: ONE ``tc_insert`` launch
    (two claim rounds, one a side) whose resolve also runs the bounded
    kick-out for the winners left unplaced and absent from both rows
    (``probe.cuckoo_insert``); writes ``tkey/tval/tstate`` IN PLACE.  The
    placement is ``ref.tc_insert_ref(max_rounds=2)`` then
    ``ref.cuckoo_kick_ref``'s, slot for slot.

    Caller contract: ``mask`` is winner-filtered.  Returns (tkey, tval,
    tstate, ok[Q]) and, when ``with_present``, also ``present[Q]``.  A
    table stack as ``twochoice_insert``'s, with stacked hash functions."""
    ok, present = probe.cuckoo_insert(tkey, tval, tstate, rows_a, rows_b,
                                      hfn_a, hfn_b, nbuckets, keys, vals,
                                      mask, max_kick, claim, alt=alt,
                                      use_alt=use_alt)
    if with_present:
        return tkey, tval, tstate, ok, present
    return tkey, tval, tstate, ok


@torch.no_grad()
def twochoice_delete(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor | None,
                     rows_b: torch.Tensor | None, keys: torch.Tensor,
                     mask: torch.Tensor, *, hfn_a=None, hfn_b=None,
                     nbuckets: int = 0, b_offset: int = 0):
    """Batched two-row DELETE: the ``tc_lookup`` launch's location output +
    ONE tombstone scatter; writes ``tstate`` IN PLACE.  Rows or hash
    functions as in ``twochoice_lookup``.

    Caller contract: ``mask`` is winner-filtered.  Returns (tstate, ok[Q])."""
    found, _val, loc = _tc_probe(tkey, tval, tstate, rows_a, rows_b, keys,
                                 hfn_a, hfn_b, nbuckets, b_offset)
    ok = mask & found
    _tombstone_(tstate.view(-1), ok, loc)
    return tstate, ok


@torch.no_grad()
def twochoice_ordered_lookup(old_tables, new_tables, hazard_key, hazard_val,
                             hazard_live, rows_a_old, rows_b_old, rows_a_new,
                             rows_b_new, qkey, *, nres_cap: int = NRES_CAP,
                             rebuilding=None, with_loc: bool = False):
    """Two-row rebuild-epoch lookup: ONE ``tc_probe2`` launch emits the
    Lemma-4.1-ordered result for both tables plus the hazard buffer.
    ``nres_cap`` is accepted and unused.  On a table stack ``rebuilding``
    sends the idle tables to their old table alone, as in
    ``ordered_lookup_fused``.  Returns (found[Q], val[Q]), and ``loc_old``
    too when ``with_loc``."""
    found, val, _, loc_old, _, _ = probe.tc_probe2(
        old_tables, new_tables, hazard_key, hazard_val, hazard_live,
        rows_a_old, rows_b_old, rows_a_new, rows_b_new, qkey, rebuilding)
    return (found, val, loc_old) if with_loc else (found, val)


@torch.no_grad()
def twochoice_ordered_delete(old_tables, new_tables, hazard_key, hazard_val,
                             hazard_live, rows_a_old, rows_b_old, rows_a_new,
                             rows_b_new, keys, mask, *,
                             nres_cap: int = NRES_CAP, rebuilding=None):
    """Two-row rebuild-epoch delete (paper Alg. 5): the SAME single
    ``tc_probe2`` launch resolves old slot / hazard index / new slot, and
    the three scatters of the linear ordered delete land the result.  Writes
    both state arrays IN PLACE.  On a table stack ``rebuilding`` makes it
    the steady delete of the idle tables.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (old_state, new_state, hazard_live', ok[Q])."""
    _f, _v, *locs = probe.tc_probe2(old_tables, new_tables, hazard_key,
                                    hazard_val, hazard_live, rows_a_old,
                                    rows_b_old, rows_a_new, rows_b_new, keys,
                                    rebuilding)
    return _land_ordered_delete(old_tables[2], new_tables[2], hazard_live,
                                mask, *locs)


# ---------------------------------------------------------------------------
# chain: the arena-sorted node layout
# ---------------------------------------------------------------------------
#
# After ``chain_compact_fused`` bucket b's nodes occupy [bstart[b],
# bstart[b] + blen[b]); nodes inserted since then form the contiguous dirty
# tail.  Argument convention, as the reference's: ``arena = (akey, aval,
# astate)``, ``links = (anext, heads)``, ``seg = (bstart, blen, sorted_upto,
# dirty)``.

def _masked_set_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                 mask: torch.Tensor) -> None:
    """``dst[idx[mask]] = src[mask]`` in place without a host read (a
    boolean index would read the count).  Caller contract: the masked
    ``idx`` are distinct.  Every unmasked entry writes, to the first masked
    entry's index, the value that entry writes there (or ``dst[0]`` to 0
    when nothing is masked), so the duplicate writes agree whatever their
    order."""
    if not mask.numel():
        return
    # one-element index tensors: indexing with a 0-dim tensor reads it on
    # the host
    first = mask.to(torch.uint8).argmax().view(1)
    some = mask.any()
    sink = torch.where(some, idx.index_select(0, first).long(), 0)
    fill = torch.where(some, src.index_select(0, first),
                       dst.index_select(0, sink))
    dst.scatter_(0, torch.where(mask, idx.long(), sink),
                 torch.where(mask, src, fill).to(dst.dtype))


@torch.no_grad()
def chain_lookup_fused(arena, links, seg, bq, qkey, *, max_chain: int = 64,
                       dirty_cap: int = DIRTY_CAP):
    """Chain lookup: ONE ``chain_probe`` launch (segment scan, dirty
    window, and the bounded walk for what they leave open, all in the
    kernel).  Returns (found[Q], val[Q], loc[Q] node index or -1) — ``loc``
    is reused by the delete so deleting never probes twice."""
    return probe.chain_probe(arena, links, seg, bq, qkey, max_chain,
                             dirty_cap)


@torch.no_grad()
def chain_delete_fused(arena, links, seg, bq, keys, mask, *,
                       max_chain: int = 64, dirty_cap: int = DIRTY_CAP):
    """Chain delete: the ``chain_probe`` launch's location + ONE tombstone
    scatter (logical deletion; the compaction reclaims); writes ``astate``
    IN PLACE.  Caller contract: ``mask`` is winner-filtered.
    Returns (astate, ok[Q])."""
    found, _val, loc = probe.chain_probe(arena, links, seg, bq, keys,
                                         max_chain, dirty_cap)
    ok = mask & found
    return _tombstone_(arena[2], ok, loc), ok


@torch.no_grad()
def chain_insert_fused(arena, links, seg, free_stack, free_top, bq, keys,
                       vals, mask, *, max_chain: int = 64,
                       dirty_cap: int = DIRTY_CAP,
                       with_present: bool = False):
    """Chain insert: the presence probe (ONE ``chain_probe`` launch), then
    allocation and relinking as the reference's fused insert does them —
    new nodes come off the free-stack tail in want-rank order (positions
    ascend, so they extend the dirty tail) and are linked at their buckets'
    heads in (bucket, batch index) order: each chains to the next inserted
    node of its bucket (a suffix-min scan), the last to the old head, and
    the first becomes the head (a prefix-max scan).  The node placement and
    pointer structure are ``buckets.chain_insert``'s.  Writes the arena,
    ``anext``, ``heads`` and the 0-dim ``free_top`` IN PLACE, without a host
    read.

    Caller contract: ``mask`` is winner-filtered.  Returns (akey, aval,
    astate, anext, heads, free_top, ok[Q]) — the tensors it was given — and,
    when ``with_present``, also ``present[Q]`` (masked keys found before the
    batch)."""
    akey, aval, astate = arena
    anext, heads = links
    q, dev = keys.shape[0], keys.device
    found, _, _ = probe.chain_probe(arena, links, seg, bq, keys, max_chain,
                                    dirty_cap)
    want = mask & ~found
    rank = torch.cumsum(want.to(I32), 0, dtype=I32) - 1
    can = want & (rank < free_top)
    node = free_stack[torch.where(can, free_top - 1 - rank, 0).long()]
    _masked_set_(akey, node, keys, can)
    _masked_set_(aval, node, vals, can)
    _masked_set_(astate, node, torch.full_like(keys, LIVE), can)

    order = torch.sort(bq, stable=True).indices   # (bucket, batch index)
    can_s, node_s, b_s = can[order], node[order], bq[order].long()
    pos = torch.arange(q, dtype=torch.int64, device=dev)
    w = torch.where(can_s, pos, q)
    nxt = torch.full_like(w, q)
    nxt[:-1] = w[1:]
    m = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    nxt_idx = torch.clamp(m, max=q - 1)
    same_b = (m < q) & (b_s[nxt_idx] == b_s)
    nxt_node = torch.where(same_b, node_s[nxt_idx], heads[b_s])
    wp = torch.where(can_s, pos, -1)
    prev = torch.full_like(wp, -1)
    prev[1:] = wp[:-1]
    pm = torch.cummax(prev, 0).values
    is_first = can_s & ((pm < 0) | (b_s[torch.clamp(pm, min=0)] != b_s))
    _masked_set_(anext, node_s, nxt_node, can_s)
    _masked_set_(heads, b_s, node_s, is_first)
    free_top.sub_(can.sum().to(I32))
    out = (akey, aval, astate, anext, heads, free_top, can)
    return (*out, mask & found) if with_present else out


@torch.no_grad()
def chain_compact_fused(akey, aval, astate, bq_nodes, *, nbuckets: int):
    """The compaction of the arena-sorted layout: ONE stable sort keyed on
    (bucket, arena index) with dead nodes after every bucket, the gather
    that packs the live nodes, per-bucket (start, len), and the pointer
    rebuild (node i chains to i + 1 within its bucket), so the walk stays
    valid.  Tombstoned and migrated nodes are reclaimed — the batched
    analogue of the paper's deferred ``call_rcu`` free.  Functional.

    The reference takes (start, len) from a histogram and an exclusive
    scan; here they are read off the sorted keys with one binary search a
    bucket (the same numbers: the start of bucket b is the count of live
    nodes in buckets below b), which spares the histogram's atomic adds —
    every dead node of the arena adds to the one bin past the last bucket.

    Returns (akey', aval', astate', anext', heads', free_stack', free_top',
    bstart, blen, sorted_upto)."""
    n, dev = akey.shape[0], akey.device
    idx = torch.arange(n, dtype=I32, device=dev)
    live = astate == LIVE
    sortkey = torch.where(live, bq_nodes, nbuckets).to(I32)
    sb, order = torch.sort(sortkey, stable=True)
    ls = live[order]
    akey2 = torch.where(ls, akey[order], 0)
    aval2 = torch.where(ls, aval[order], 0)
    astate2 = torch.where(ls, LIVE, EMPTY).to(I32)
    edges = torch.searchsorted(sb, torch.arange(nbuckets + 1, dtype=I32,
                                                device=dev)).to(I32)
    bstart, counts, lcount = edges[:-1], edges[1:] - edges[:-1], edges[-1]
    chain_on = ls.clone()
    chain_on[:-1] &= sb[1:] == sb[:-1]
    chain_on[-1:] = False
    anext2 = torch.where(chain_on, idx + 1, -1).to(I32)
    heads2 = torch.where(counts > 0, bstart, -1).to(I32)
    return (akey2, aval2, astate2, anext2, heads2, n - 1 - idx, n - lcount,
            bstart, counts, lcount)


@torch.no_grad()
def chain_ordered_lookup(old_arena, old_links, old_seg, new_arena, new_links,
                         new_seg, hazard_key, hazard_val, hazard_live,
                         bq_old, bq_new, qkey, *, max_chain: int = 64,
                         nres_cap: int = NRES_CAP,
                         dirty_cap: int = DIRTY_CAP):
    """Chain rebuild-epoch lookup: ONE ``chain_probe2`` launch emits the
    Lemma-4.1-ordered result (old arena -> hazard buffer -> new arena),
    whatever the size of the new arena, fallback included.  ``nres_cap`` is
    accepted and unused.  Returns (found[Q], val[Q])."""
    found, val, *_ = probe.chain_probe2(
        (old_arena, old_links, old_seg), (new_arena, new_links, new_seg),
        hazard_key, hazard_val, hazard_live, bq_old, bq_new, qkey, max_chain,
        dirty_cap)
    return found, val


@torch.no_grad()
def chain_ordered_delete(old_arena, old_links, old_seg, new_arena, new_links,
                         new_seg, hazard_key, hazard_val, hazard_live,
                         bq_old, bq_new, keys, mask, *, max_chain: int = 64,
                         nres_cap: int = NRES_CAP,
                         dirty_cap: int = DIRTY_CAP):
    """Chain rebuild-epoch delete (paper Alg. 5): the SAME single
    ``chain_probe2`` launch resolves old node / hazard index / new node, and
    the three scatters of the linear ordered delete land the result.  Writes
    both state arrays IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (old_astate, new_astate, hazard_live', ok[Q])."""
    _f, _v, *locs = probe.chain_probe2(
        (old_arena, old_links, old_seg), (new_arena, new_links, new_seg),
        hazard_key, hazard_val, hazard_live, bq_old, bq_new, keys, max_chain,
        dirty_cap)
    return _land_ordered_delete(old_arena[2], new_arena[2], hazard_live,
                                mask, *locs)
