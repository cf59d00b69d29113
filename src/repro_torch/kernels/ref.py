"""Plain PyTorch oracles for the linear kernels (the ground truth in tests).

Functional: inputs are never modified.  Written loop for loop as the
reference's ``kernels/ref.py`` so the two can be read side by side; the
in-place plain versions that stand beside the CUDA kernels live in
``kernels/probe.py``.
"""
from __future__ import annotations

import torch

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
