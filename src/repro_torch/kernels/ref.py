"""Plain PyTorch oracles for the kernels (the ground truth in tests).

Functional: inputs are never modified.  Written loop for loop as the
reference's ``kernels/ref.py`` so the two can be read side by side; the
in-place plain versions that stand beside the CUDA kernels live in
``kernels/probe.py``.  ``cuckoo_kick_ref`` is no kernel's oracle: as in the
reference, the cuckoo kick-out runs as plain tensor code on every path.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing

I32 = torch.int32
EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3


def probe_lookup_ref(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, h0: torch.Tensor,
                     qkey: torch.Tensor, max_probes: int):
    """Linear-probe lookup oracle.

    Probes slots h0, h0+1, ... (mod C): stop on LIVE match (found) or EMPTY
    (absent); skip TOMB/MIGRATED.  Returns (found[Q] bool, val[Q] i32).
    """
    c = tkey.shape[0]
    q = qkey.shape[0]
    dev = tkey.device
    active = torch.ones(q, dtype=torch.bool, device=dev)
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    val = torch.zeros(q, dtype=I32, device=dev)
    h0 = h0.long()
    for i in range(max_probes):
        pos = (h0 + i) % c
        st = tstate[pos]
        hit = active & (st == LIVE) & (tkey[pos] == qkey)
        stop = active & (st == EMPTY)
        val = torch.where(hit, tval[pos], val)
        found = found | hit
        active = active & ~hit & ~stop
    return found, val


def probe_insert_ref(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, h0: torch.Tensor,
                     keys: torch.Tensor, vals: torch.Tensor,
                     mask: torch.Tensor, max_probes: int):
    """Linear-probe insert oracle on raw table arrays (claim-first-non-LIVE,
    lowest batch index wins a contested slot — the same linearization as
    ``buckets.linear_insert``).

    Caller contract: ``mask`` is winner-filtered (at most one True per
    distinct key; use ``buckets.batch_winners``).  Returns
    (tkey', tval', tstate', ok[Q]).
    """
    c = tkey.shape[0]
    q = keys.shape[0]
    dev = tkey.device
    present, _ = probe_lookup_ref(tkey, tval, tstate, h0, keys, max_probes)
    pending = mask & ~present
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    # one spare slot at index c takes the writes of queries that do not act
    pad = torch.zeros(1, dtype=I32, device=dev)
    key = torch.cat([tkey, pad])
    val = torch.cat([tval, pad])
    state = torch.cat([tstate, pad])
    h0 = h0.long()
    for p in range(max_probes):
        pos = (h0 + p) % c
        free = pending & (state[pos] != LIVE)
        wpos = torch.where(free, pos, c)
        claim = torch.full((c + 1,), q, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, wpos, idx, "amin")
        won = free & (claim[pos] == idx)
        wp = torch.where(won, pos, c)
        key[wp] = keys
        val[wp] = vals
        state[wp] = torch.where(won, LIVE, 0).to(I32)
        pending = pending & ~won
        done = done | won
    return key[:c], val[:c], state[:c], done


def ordered_lookup_ref(old_t, new_t, hazard_key, hazard_val, hazard_live,
                       h0_old, h0_new, qkey, max_probes: int):
    """The paper's ordered three-way check: old -> hazard -> new."""
    f_old, v_old = probe_lookup_ref(*old_t, h0_old, qkey, max_probes)
    eq = (qkey[:, None] == hazard_key[None, :]) & hazard_live[None, :]
    f_hz = eq.any(-1)
    v_hz = hazard_val[eq.to(torch.uint8).argmax(dim=-1)]
    f_new, v_new = probe_lookup_ref(*new_t, h0_new, qkey, max_probes)
    found = f_old | f_hz | f_new
    val = torch.where(f_old, v_old, torch.where(f_hz, v_hz, v_new))
    return found, val


def probe_delete_ref(tkey: torch.Tensor, tval: torch.Tensor,
                     tstate: torch.Tensor, h0: torch.Tensor,
                     keys: torch.Tensor, mask: torch.Tensor,
                     max_probes: int):
    """Linear-probe delete oracle: tombstone the LIVE slot holding each
    masked key (probe from h0, skip TOMB/MIGRATED, stop at EMPTY).

    Caller contract: ``mask`` is winner-filtered (at most one True per
    distinct key).  Returns (tstate', ok[Q]).
    """
    c = tkey.shape[0]
    q = keys.shape[0]
    dev = tkey.device
    active = torch.ones(q, dtype=torch.bool, device=dev)
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    loc = torch.full((q,), -1, dtype=torch.int64, device=dev)
    h0 = h0.long()
    for i in range(max_probes):
        pos = (h0 + i) % c
        st = tstate[pos]
        hit = active & (st == LIVE) & (tkey[pos] == keys)
        stop = active & (st == EMPTY)
        loc = torch.where(hit, pos, loc)
        found = found | hit
        active = active & ~hit & ~stop
    ok = mask & found
    state = torch.cat([tstate, torch.zeros(1, dtype=I32, device=dev)])
    state[torch.where(ok, loc, c)] = TOMB
    return state[:c], ok


def tc_row_lookup_ref(tkey: torch.Tensor, tval: torch.Tensor,
                      tstate: torch.Tensor, rows: torch.Tensor,
                      qkey: torch.Tensor):
    """Single-row twochoice lookup oracle: gather row ``rows[e]`` and match
    all W lanes.  Returns (found[E], val[E], loc[E] flat slot or -1)."""
    w = tkey.shape[1]
    rows = rows.long()
    krow, vrow, srow = tkey[rows], tval[rows], tstate[rows]   # [E, W]
    hit = (krow == qkey[:, None]) & (srow == LIVE)
    found = hit.any(-1)
    lane = hit.to(torch.uint8).argmax(dim=-1)                  # first True
    val = torch.gather(vrow, 1, lane[:, None])[:, 0]
    return (found, torch.where(found, val, 0).to(I32),
            torch.where(found, rows * w + lane, -1).to(I32))


def tc_insert_ref(tkey: torch.Tensor, tval: torch.Tensor,
                  tstate: torch.Tensor, rows_a: torch.Tensor,
                  rows_b: torch.Tensor, keys: torch.Tensor,
                  vals: torch.Tensor, mask: torch.Tensor, max_rounds: int):
    """Twochoice insert oracle on raw [B, W] arrays: alternate the two row
    choices per round, claim the row's first non-LIVE lane, lowest batch
    index wins a contested lane (the linearisation of
    ``buckets.twochoice_insert``).

    Caller contract: ``mask`` is winner-filtered.  Returns
    (tkey', tval', tstate', ok[Q]).
    """
    b, w = tkey.shape
    q = keys.shape[0]
    dev = tkey.device
    fa, _, _ = tc_row_lookup_ref(tkey, tval, tstate, rows_a, keys)
    fb, _, _ = tc_row_lookup_ref(tkey, tval, tstate, rows_b, keys)
    pending = mask & ~(fa | fb)
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    nslots = b * w
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    # one spare slot at index nslots takes the writes of queries that do not
    # act
    pad = torch.zeros(1, dtype=I32, device=dev)
    key = torch.cat([tkey.reshape(-1), pad])
    val = torch.cat([tval.reshape(-1), pad])
    state = torch.cat([tstate.reshape(-1), pad])
    rows_a, rows_b = rows_a.long(), rows_b.long()
    for r in range(max_rounds):
        bkt = rows_a if r % 2 == 0 else rows_b
        row_free = state[:nslots].view(b, w)[bkt] != LIVE          # [Q, W]
        has_free = pending & row_free.any(-1)
        lane = row_free.to(torch.uint8).argmax(dim=-1)
        flat = bkt * w + lane
        wflat = torch.where(has_free, flat, nslots)
        claim = torch.full((nslots + 1,), q, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, wflat, idx, "amin")
        won = has_free & (claim[flat] == idx)
        wp = torch.where(won, flat, nslots)
        key[wp] = keys
        val[wp] = vals
        state[wp] = torch.where(won, LIVE, 0).to(I32)
        pending = pending & ~won
        done = done | won
    return (key[:nslots].view(b, w), val[:nslots].view(b, w),
            state[:nslots].view(b, w), done)


def tc_delete_ref(tkey: torch.Tensor, tval: torch.Tensor,
                  tstate: torch.Tensor, rows_a: torch.Tensor,
                  rows_b: torch.Tensor, keys: torch.Tensor,
                  mask: torch.Tensor):
    """Twochoice delete oracle: tombstone the LIVE lane holding each masked
    key in either row.  Caller contract: mask winner-filtered.  Returns
    (tstate', ok[Q])."""
    b, w = tkey.shape
    fa, _, la = tc_row_lookup_ref(tkey, tval, tstate, rows_a, keys)
    fb, _, lb = tc_row_lookup_ref(tkey, tval, tstate, rows_b, keys)
    ok = mask & (fa | fb)
    loc = torch.where(fa, la, lb).long()
    state = torch.cat([tstate.reshape(-1),
                       torch.zeros(1, dtype=I32, device=tkey.device)])
    state[torch.where(ok, loc, b * w)] = TOMB
    return state[: b * w].view(b, w), ok


def cuckoo_kick_ref(tkey: torch.Tensor, tval: torch.Tensor,
                    tstate: torch.Tensor, rows_a: torch.Tensor,
                    rows_b: torch.Tensor, hfn_a, hfn_b, nbuckets: int,
                    keys: torch.Tensor, vals: torch.Tensor,
                    pending: torch.Tensor, max_kick: int,
                    first_iter: int = 0):
    """Batched bounded kick-out over the cuckoo table's [2B, W] rows (side A
    rows [0, B), side B rows [B, 2B); ``rows_a``/``rows_b`` are the two
    candidate rows of each query, already side-offset).

    Runs exactly ``max_kick`` iterations, numbered from ``first_iter`` (the
    number sets the scan rotation below), so iterations [0, n) and then
    [n, m) with the still-pending queries give what [0, m) gives.  In each
    iteration every still-pending query forms one of two plans:

    * plan A — either candidate row has a free lane: claim its first free
      lane (a-row first);
    * plan B — both rows full: pick a LIVE victim lane whose occupant's
      ALTERNATE row (the other side, under the other hash function) has a
      free lane, move the victim there and take its lane.  The 2W candidate
      lanes (a-row lanes, then b-row lanes) are scanned from a start rotated
      by the iteration, so two queries fighting over the same rows do not
      ping-pong on one victim.

    Arbitration is per ROW: a scatter-min lock over all 2B rows (lowest batch
    index wins); a query acts only if it owns every row its plan touches
    (the target row for plan A; victim row and alternate row for plan B).
    Losers retry in the next iteration.  A resident only ever moves into a
    free lane of its own alternate row, so on exhaustion only the NEW key
    reports ok=False.

    Caller contract: ``pending`` is winner-filtered and presence-checked.
    Returns (tkey', tval', tstate', done[Q]).
    """
    b2, w = tkey.shape
    q = keys.shape[0]
    dev = tkey.device
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    lane_ids = torch.arange(2 * w, dtype=torch.int64, device=dev)
    lw = lane_ids % w
    nslots = b2 * w
    pad = torch.zeros(1, dtype=I32, device=dev)
    key = torch.cat([tkey.reshape(-1), pad])     # spare slot nslots
    val = torch.cat([tval.reshape(-1), pad])
    state = torch.cat([tstate.reshape(-1), pad])
    K, V, S = (x[:nslots].view(b2, w) for x in (key, val, state))
    ra, rb = rows_a.long(), rows_b.long()
    pend = pending.clone()
    done = torch.zeros(q, dtype=torch.bool, device=dev)
    # victim candidates: the 2W lanes, a-row lanes then b-row lanes [Q, 2W]
    vrow = torch.cat([ra[:, None].expand(q, w), rb[:, None].expand(q, w)], 1)
    side_a = lane_ids[None, :] < w

    def first(mask2d):                           # first True along the rows
        return mask2d.to(torch.uint8).argmax(dim=-1)

    def pick(x, sel):
        return torch.gather(x, 1, sel[:, None])[:, 0]

    for it in range(first_iter, first_iter + max_kick):
        free_a = (S[ra] != LIVE).any(-1)
        free_b = (S[rb] != LIVE).any(-1)

        # plan A: direct claim of a free lane (a-row priority)
        plan_a = pend & (free_a | free_b)
        row_a_tgt = torch.where(free_a, ra, rb)
        lane_a = first(S[row_a_tgt] != LIVE)

        # plan B: move a victim whose alternate row has a free lane; a
        # victim in side A relocates to B + hb(victim), in side B to
        # ha(victim) — always the other side
        vkey = K[vrow, lw]                                         # [Q, 2W]
        alt_a = nbuckets + hashing.bucket_of(hfn_b, vkey, nbuckets)
        alt_b = hashing.bucket_of(hfn_a, vkey, nbuckets)
        valt = torch.where(side_a, alt_a, alt_b).long()
        cand = (S[vrow, lw] == LIVE) & (S[valt] != LIVE).any(-1)  # [Q, 2W]
        rot = (lane_ids + it) % (2 * w)
        sel = rot[first(cand[:, rot])]
        plan_b = pend & ~plan_a & cand.any(-1)
        b_vrow, b_valt = pick(vrow, sel), pick(valt, sel)
        b_vlane = sel % w
        b_vkey = pick(vkey, sel)

        # per-row locks: plan A needs its target row, plan B victim + alt
        lock = torch.full((b2 + 1,), q, dtype=torch.int64, device=dev)
        lock.scatter_reduce_(0, torch.where(plan_a, row_a_tgt, b2), idx,
                             "amin")
        lock.scatter_reduce_(0, torch.where(plan_b, b_vrow, b2), idx, "amin")
        lock.scatter_reduce_(0, torch.where(plan_b, b_valt, b2), idx, "amin")
        own_a = plan_a & (lock[row_a_tgt] == idx)
        own_b = plan_b & (lock[b_vrow] == idx) & (lock[b_valt] == idx)

        # plan B: the victim lands in its alternate row's first free lane,
        # then the new key takes the vacated lane
        alt_lane = first(S[b_valt] != LIVE)
        b_vval = V[b_vrow, b_vlane]
        mv = torch.where(own_b, b_valt * w + alt_lane, nslots)
        key[mv] = b_vkey
        val[mv] = b_vval
        state[mv] = torch.where(own_b, LIVE, 0).to(I32)

        won = own_a | own_b
        wp = torch.where(own_a, row_a_tgt * w + lane_a,
                         torch.where(own_b, b_vrow * w + b_vlane, nslots))
        key[wp] = keys
        val[wp] = vals
        state[wp] = torch.where(won, LIVE, 0).to(I32)
        pend = pend & ~won
        done = done | won
    return K, V, S, done


def chain_lookup_ref(akey: torch.Tensor, aval: torch.Tensor,
                     astate: torch.Tensor, anext: torch.Tensor,
                     heads: torch.Tensor, b: torch.Tensor,
                     qkey: torch.Tensor, max_chain: int):
    """Pointer-chasing chain lookup oracle: lock-step batched walk from
    ``heads[b]`` along ``anext``, at most ``max_chain`` nodes a query.
    Returns (found[Q], val[Q], loc[Q] node or -1).  The loop ends early once
    no walk is left (a host read every 8 hops; the result is that of all
    ``max_chain`` hops)."""
    q, dev = qkey.shape[0], qkey.device
    cur = heads[b.long()].long()
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    val = torch.zeros(q, dtype=I32, device=dev)
    loc = torch.full((q,), -1, dtype=I32, device=dev)
    for hop in range(max_chain):
        if hop % 8 == 0 and not bool((cur >= 0).any()):
            break
        valid = cur >= 0
        c = torch.where(valid, cur, 0)
        hit = valid & (astate[c] == LIVE) & (akey[c] == qkey)
        val = torch.where(hit, aval[c], val)
        loc = torch.where(hit, c.to(I32), loc)
        found |= hit
        cur = torch.where(valid & ~hit, anext[c].long(), -1)
    return found, val, loc


def chain_delete_ref(akey: torch.Tensor, aval: torch.Tensor,
                     astate: torch.Tensor, anext: torch.Tensor,
                     heads: torch.Tensor, b: torch.Tensor,
                     keys: torch.Tensor, mask: torch.Tensor, max_chain: int):
    """Pointer-chasing chain delete oracle: walk, then tombstone the node
    holding each masked key (logical deletion; the compaction reclaims).
    Caller contract: mask winner-filtered.  Returns (astate', ok[Q])."""
    found, _, loc = chain_lookup_ref(akey, aval, astate, anext, heads, b,
                                     keys, max_chain)
    ok = mask & found
    astate = astate.clone()
    astate[loc[ok].long()] = TOMB
    return astate, ok


def chain_insert_ref(akey, aval, astate, anext, heads, free_stack, free_top,
                     b, keys, vals, mask, max_chain: int, present=None):
    """Pointer-chasing chain insert oracle on raw arena arrays: presence by
    the bounded walk (or ``present``, where the caller walked), want-rank
    allocation from the free-stack tail, insert-at-head linking in
    original-index order — the linearisation, node placement and pointer
    structure of ``buckets.chain_insert``.  It reads nothing on the host:
    the writes of queries that do not act go to a spare slot past the end
    of each array.

    Caller contract: ``mask`` is winner-filtered.  Returns
    (akey', aval', astate', anext', heads', free_top', ok[Q]).
    """
    q, dev = keys.shape[0], keys.device
    n, nb = akey.shape[0], heads.shape[0]
    if present is None:
        present, _, _ = chain_lookup_ref(akey, aval, astate, anext, heads, b,
                                         keys, max_chain)
    want = mask & ~present
    rank = torch.cumsum(want.to(I32), 0) - 1
    can = want & (rank < free_top)
    node = free_stack[torch.where(can, free_top - 1 - rank, 0).long()]
    pad = torch.zeros(1, dtype=I32, device=dev)

    def put(x, size, where, idx, v):
        out = torch.cat([x, pad])
        out[torch.where(where, idx, size).long()] = v
        return out[:size]

    akey, aval = put(akey, n, can, node, keys), put(aval, n, can, node, vals)
    astate = put(astate, n, can, node, torch.full_like(keys, LIVE))
    sortkey = torch.where(can, b, nb)
    order = torch.sort(sortkey, stable=True).indices    # (bucket, index)
    sb, snode, scan = sortkey[order], node[order], can[order]
    same = torch.zeros(q, dtype=torch.bool, device=dev)
    same[:-1] = sb[1:] == sb[:-1]
    nxt_same = torch.full((q,), -1, dtype=I32, device=dev)
    nxt_same[:-1] = snode[1:]
    old_head = heads[torch.where(scan, sb, 0).long()]
    nxt = torch.where(same, nxt_same, torch.where(scan, old_head, -1))
    anext = put(anext, n, scan, snode, nxt.to(I32))
    first = scan.clone()
    first[1:] &= sb[1:] != sb[:-1]
    heads = put(heads, nb, first, sb, snode)
    return akey, aval, astate, anext, heads, \
        (free_top - can.sum()).to(I32), can


def chain_ordered_lookup_ref(old_arena, old_links, new_arena, new_links,
                             hazard_key, hazard_val, hazard_live,
                             b_old, b_new, qkey, max_chain: int):
    """The paper's ordered three-way check over chained tables:
    old chains -> hazard buffer -> new chains."""
    f_old, v_old, _ = chain_lookup_ref(*old_arena, *old_links, b_old, qkey,
                                       max_chain)
    eq = (qkey[:, None] == hazard_key[None, :]) & hazard_live[None, :]
    f_hz = eq.any(-1)
    v_hz = hazard_val[eq.to(torch.uint8).argmax(dim=-1)]
    f_new, v_new, _ = chain_lookup_ref(*new_arena, *new_links, b_new, qkey,
                                       max_chain)
    found = f_old | f_hz | f_new
    val = torch.where(f_old, v_old, torch.where(f_hz, v_hz, v_new))
    return found, val
