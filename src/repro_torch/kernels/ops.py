"""The op layer over the kernels.

Linear: ``probe_lookup`` is the accelerated equivalent of
``ref.probe_lookup_ref`` (and of ``buckets.linear_lookup``'s inner loop);
``ordered_lookup_fused`` is the rebuild-epoch path (one ``probe2`` launch for
the whole old -> hazard -> new ordered check); ``probe_insert`` /
``probe_delete`` are the write paths (the claim kernel; the location-emitting
lookup + one scatter); ``ordered_delete_fused`` is the rebuild-epoch delete
(the same ``probe2`` launch's location outputs drive the old/new tombstones
and the hazard kill); ``extract_chunk_fused`` is the rebuild chunk scan,
which the two-row backends run on their flattened arrays.

Twochoice and cuckoo (two candidate rows a key, [B, W] tables):
``twochoice_lookup`` / ``twochoice_insert`` / ``twochoice_delete`` over the
``tc_lookup`` and ``tc_insert`` kernels, and ``twochoice_ordered_lookup`` /
``twochoice_ordered_delete`` over ``tc_probe2``, whose outputs have the
meaning of ``probe2``'s, so both ordered deletes land through one helper.

Each op is one kernel launch plus, for the deletes, the scatters that the
reference also runs outside its kernels.  There is no padding, no sort, no
tile map and no fallback branch: nothing here reads a value back to the host,
so an op never synchronises.  On CPU tensors the same code runs through the
kernels' plain versions (``kernels/probe.py``).

In-place contract: ``probe_insert`` writes the table arrays it is given;
``probe_delete`` and ``ordered_delete_fused`` write the state arrays;
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


@torch.no_grad()
def probe_lookup(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor, qkey: torch.Tensor, *,
                 max_probes: int = 64, with_loc: bool = False):
    """Batched linear-probe lookup. Returns (found[Q], val[Q]), or
    (found, val, loc[Q]) when ``with_loc`` — ``loc`` is the hit's physical
    slot in [0, C) (-1 on miss), the probe telemetry input.

    Args:
      tkey/tval/tstate: table arrays [C].
      h0: start slot per query (hash(key) % C), [Q].
      qkey: query keys [Q].
    """
    found, val, loc = probe.probe_lookup(tkey, tval, tstate, h0, qkey,
                                         max_probes)
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
                         max_probes: int = 64, nres_cap: int = NRES_CAP):
    """FUSED rebuild-epoch lookup: ONE ``probe2`` launch emits the
    Lemma-4.1-ordered result for both tables plus the hazard buffer, whatever
    the size of the new table.  ``nres_cap`` is accepted and unused."""
    found, val, *_ = probe.probe2(old_tables, new_tables, hazard_key,
                                  hazard_val, hazard_live, h0_old, h0_new,
                                  qkey, max_probes)
    return found, val


@torch.no_grad()
def probe_insert(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
                 mask: torch.Tensor, *, max_probes: int = 64,
                 claim: torch.Tensor | None = None,
                 with_present: bool = False):
    """Batched linear-probe INSERT via the claim kernel; writes
    ``tkey/tval/tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered (at most one True per
    distinct key; use ``buckets.batch_winners``).  Set semantics: ok=False if
    the key is already LIVE or no free slot exists within ``max_probes``.
    The placement is ``ref.probe_insert_ref``'s, slot for slot.

    Returns (tkey, tval, tstate, ok[Q]) — the arrays it was given — and,
    when ``with_present``, also ``present[Q]`` (masked keys found LIVE
    before the batch).
    """
    ok, present = probe.probe_insert(tkey, tval, tstate, h0, keys, vals, mask,
                                     max_probes, claim)
    if with_present:
        return tkey, tval, tstate, ok, present
    return tkey, tval, tstate, ok


@torch.no_grad()
def probe_delete(tkey: torch.Tensor, tval: torch.Tensor, tstate: torch.Tensor,
                 h0: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor, *,
                 max_probes: int = 64):
    """Batched linear-probe DELETE: the location-emitting lookup kernel +
    ONE tombstone scatter; writes ``tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered, so distinct masked keys
    occupy distinct slots.  Returns (tstate, ok[Q]).
    """
    found, _val, loc = probe.probe_lookup(tkey, tval, tstate, h0, keys,
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
    through their flat view).  Returns (old_state, new_state, hazard_live',
    ok)."""
    ok_old = mask & f_old
    ok_hz = mask & (hz_idx >= 0)
    ok_new = mask & (loc_new >= 0)
    _tombstone_(old_state.view(-1), ok_old, loc_old)
    _tombstone_(new_state.view(-1), ok_new, loc_new)
    kill = torch.zeros(hazard_live.shape[0], dtype=I32,
                       device=hazard_live.device)
    kill.scatter_reduce_(0, torch.where(ok_hz, hz_idx, 0).long(),
                         ok_hz.to(I32), "amax")
    return old_state, new_state, hazard_live & (kill == 0), \
        ok_old | ok_hz | ok_new


@torch.no_grad()
def ordered_delete_fused(old_tables, new_tables, hazard_key, hazard_val,
                         hazard_live, h0_old, h0_new, keys, mask, *,
                         max_probes: int = 64, nres_cap: int = NRES_CAP):
    """FUSED rebuild-epoch delete (paper Alg. 5): ONE ``probe2`` launch
    resolves the ordered check, then three scatters land the result —
    tombstone the old-table slot, or clear the hazard live bit
    (LOGICALLY_REMOVED on an in-flight entry; landing drops it), or
    tombstone the new-table slot.  Writes both state arrays IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (old_state, new_state, hazard_live', ok[Q]); ``hazard_live'`` is a new
    tensor.
    """
    _f, _v, *locs = probe.probe2(old_tables, new_tables, hazard_key,
                                 hazard_val, hazard_live, h0_old, h0_new,
                                 keys, max_probes)
    return _land_ordered_delete(old_tables[2], new_tables[2], hazard_live,
                                mask, *locs)


@torch.no_grad()
def extract_chunk_fused(tkey: torch.Tensor, tval: torch.Tensor,
                        tstate: torch.Tensor, cursor: torch.Tensor, *,
                        chunk: int):
    """Rebuild chunk scan via the extract kernel: ONE launch reads the slots
    at ``cursor`` (a 0-dim int32 tensor; never read on the host), compacts
    the live entries, and marks them MIGRATED in ``tstate`` IN PLACE.
    Requires ``chunk <= EXTRACT_MAX_CHUNK`` (the caller gates).

    Returns (tstate, hkeys[chunk], hvals[chunk], hlive[chunk] bool,
    new_cursor) — identical set contents to the plain scan, with the hazard
    entries compacted to the front.
    """
    if chunk > EXTRACT_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the extract kernel's "
                         f"{EXTRACT_MAX_CHUNK}")
    hk, hv, hl, new_cursor = probe.extract(tkey, tval, tstate, cursor, chunk)
    return tstate, hk, hv, hl, new_cursor


# ---------------------------------------------------------------------------
# twochoice / cuckoo: two candidate rows a key
# ---------------------------------------------------------------------------

@torch.no_grad()
def twochoice_lookup(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor,
                     rows_b: torch.Tensor, qkey: torch.Tensor):
    """Batched two-row lookup on a [B, W] table: ONE ``tc_lookup`` launch,
    a-row priority (the tie-break of ``buckets.twochoice_lookup``).

    Returns (found[Q], val[Q] — 0 on a miss, loc[Q] flat slot or -1) —
    ``loc`` is reused by ``twochoice_delete`` so deleting never probes
    twice."""
    return probe.tc_lookup(tkey, tval, tstate, rows_a, rows_b, qkey)


@torch.no_grad()
def twochoice_insert(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor,
                     rows_b: torch.Tensor, keys: torch.Tensor,
                     vals: torch.Tensor, mask: torch.Tensor, *,
                     max_rounds: int = 8, claim: torch.Tensor | None = None,
                     with_present: bool = False):
    """Batched two-row INSERT via the ``tc_insert`` claim kernel; writes
    ``tkey/tval/tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Set semantics: ok=False
    if the key is LIVE in either row or no round found a lane.  The placement
    is ``ref.tc_insert_ref``'s, slot for slot.

    Returns (tkey, tval, tstate, ok[Q]) and, when ``with_present``, also
    ``present[Q]`` (masked keys LIVE in either row before the batch)."""
    ok, present = probe.tc_insert(tkey, tval, tstate, rows_a, rows_b, keys,
                                  vals, mask, max_rounds, claim)
    if with_present:
        return tkey, tval, tstate, ok, present
    return tkey, tval, tstate, ok


@torch.no_grad()
def twochoice_delete(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, rows_a: torch.Tensor,
                     rows_b: torch.Tensor, keys: torch.Tensor,
                     mask: torch.Tensor):
    """Batched two-row DELETE: the ``tc_lookup`` launch's location output +
    ONE tombstone scatter; writes ``tstate`` IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Returns (tstate, ok[Q])."""
    found, _val, loc = probe.tc_lookup(tkey, tval, tstate, rows_a, rows_b,
                                       keys)
    ok = mask & found
    _tombstone_(tstate.view(-1), ok, loc)
    return tstate, ok


@torch.no_grad()
def twochoice_ordered_lookup(old_tables, new_tables, hazard_key, hazard_val,
                             hazard_live, rows_a_old, rows_b_old, rows_a_new,
                             rows_b_new, qkey, *, nres_cap: int = NRES_CAP):
    """Two-row rebuild-epoch lookup: ONE ``tc_probe2`` launch emits the
    Lemma-4.1-ordered result for both tables plus the hazard buffer.
    ``nres_cap`` is accepted and unused.  Returns (found[Q], val[Q])."""
    found, val, *_ = probe.tc_probe2(old_tables, new_tables, hazard_key,
                                     hazard_val, hazard_live, rows_a_old,
                                     rows_b_old, rows_a_new, rows_b_new,
                                     qkey)
    return found, val


@torch.no_grad()
def twochoice_ordered_delete(old_tables, new_tables, hazard_key, hazard_val,
                             hazard_live, rows_a_old, rows_b_old, rows_a_new,
                             rows_b_new, keys, mask, *,
                             nres_cap: int = NRES_CAP):
    """Two-row rebuild-epoch delete (paper Alg. 5): the SAME single
    ``tc_probe2`` launch resolves old slot / hazard index / new slot, and
    the three scatters of the linear ordered delete land the result.  Writes
    both state arrays IN PLACE.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (old_state, new_state, hazard_live', ok[Q])."""
    _f, _v, *locs = probe.tc_probe2(old_tables, new_tables, hazard_key,
                                    hazard_val, hazard_live, rows_a_old,
                                    rows_b_old, rows_a_new, rows_b_new, keys)
    return _land_ordered_delete(old_tables[2], new_tables[2], hazard_live,
                                mask, *locs)
