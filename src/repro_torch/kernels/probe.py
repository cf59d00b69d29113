"""The kernels: wrappers, launch counters, plain versions.

Each public function here is the wrapper of one hand-written CUDA kernel
(``csrc/<name>.cu``, compiled for sm_90a at first use by ``build.py``):

====================  =========================================  ============
wrapper               replaces (src/repro/kernels/probe.py)      source
====================  =========================================  ============
``probe_lookup``      ``_probe_kernel``                          probe_lookup.cu
``probe2``            ``_probe2_kernel``                         probe2.cu
``probe_insert``      ``_probe_insert_kernel`` + the wrapper's   probe_insert.cu
                      cross-tile claim resolution
``extract``           ``_extract_kernel`` + the MIGRATED         extract.cu
                      scatter
``tc_lookup``         ``_tc_lookup_kernel`` + the wrapper's      tc_lookup.cu
                      a-row-priority recombine
``tc_insert``         ``_tc_insert_kernel`` + the wrapper's      tc_insert.cu
                      shadowing, cross-tile resolution and
                      fallback
``tc_probe2``         ``_tc_probe2_kernel`` +                    tc_probe2.cu
                      ``_tc_ordered_combine``
``chain_probe``       ``_chain_probe_kernel`` + the wrapper's    chain_probe.cu
                      dirty-tail window and bounded-walk
                      fallback
``chain_probe2``      ``_chain_probe2_kernel`` + the wrappers'   chain_probe2.cu
                      windows, ordering and fallbacks
``cuckoo_kick``       no Pallas kernel: the reference's XLA      cuckoo_kick.cu
                      ``cuckoo_kick_ref`` behind ``lax.cond``
``epoch_swap``        no Pallas kernel: the reference's XLA      epoch_swap.cu
                      ``finish_same_shape`` and
                      ``rebuild_autostart``
``chain_compact``     no Pallas kernel: the reference's XLA      chain_compact.cu
                      ``chain_compact_fused`` behind
                      ``lax.cond`` (``chain_maybe_compact``,
                      the freeze at a start)
====================  =========================================  ============

The first four serve the linear backend; the three ``tc_*`` kernels serve
twochoice and cuckoo (cuckoo passes side-offset rows of its [2B, W] table);
the two ``chain_*`` kernels serve chain, whose chunk scan is ``extract`` on
the flat node arena.  ``cuckoo_kick`` is the cuckoo insert's bounded
kick-out, ``epoch_swap`` the engine step's epoch swap and rebuild start and
``chain_compact`` the chain arena's compaction, each guarded by flags
computed on the device, so that a step inside a rebuild epoch never asks
the host (``extract`` takes two such flags too).  An engine's rebuild step
launches ``extract`` as its one transition (``transition``: the landing's
bookkeeping, the guarded scan and the epoch decision) and ``epoch_swap``
as the exchange on that decision.  Three more entries launch a kernel of
the table and are counted on it: ``probe_lookup_hashed`` is
``probe_lookup`` with the start slots hashed in the kernel (the linear
steady state's lookup and delete), ``tc_lookup_hashed`` is ``tc_lookup``
with both rows hashed in the kernel (the twochoice and cuckoo steady
state's lookup and delete), and ``cuckoo_insert`` is ``tc_insert`` with the
cuckoo kick-out run by its resolve's last block (the cuckoo insert: two
kernels, no ``cuckoo_kick`` launch).

What bounds each kernel on an H100 and what its design does about it is
written at the top of its ``.cu`` file; in short: ``probe_lookup`` — latency
(one query a thread walking aligned windows of 4 slots, state, key and
value loaded together; the start slot hashed in the kernel); ``probe2`` —
bytes (two probe runs a query; the hazard buffer staged as a hashed set,
built once an SM, where a lookup is a few shared-memory loads);
``probe_insert`` — bytes (no claim round: each block resolves its range of
start slots in descending start slot, one kernel boundary between the reads
and the writes); ``extract`` — launch latency (one block, one shuffle
scan, 16-byte loads, no barrier its step's work does not need);
``tc_lookup`` — round trips to L2 (a pair of lanes a query, one a row,
both in flight; a lane reads its row's keys as 16-byte loads, then the
state and value of a lane only where the key matches; the rows hashed in
the kernel);
``tc_probe2`` — bytes (four rows a query, the hazard buffer as
``probe2``'s); ``tc_insert`` — latency (a bid launch and a resolve
launch over the grid for round 0, the later rounds and the cuckoo kick-out
in the resolve's last block, no grid-wide barrier); ``chain_probe`` — bytes (a
segment scan a query, the dirty tail staged as a hashed set in shared
memory, as ``chain_probe2`` stages its two);
``chain_probe2`` — bytes (a segment of a few nodes in each arena; the
hazard buffer and both dirty tails staged as hashed sets in shared memory,
``dhash_set_*`` in ``dhash_common.cuh``); ``cuckoo_kick`` — latency (one
block, a few rows a pending key an iteration; the body the cuckoo insert
runs in ``tc_insert``'s resolve); ``epoch_swap`` — bytes once
an epoch (16-byte words, only what the outcome needs is read), launch
latency on every other step (one launch that reads go); ``chain_compact``
— bytes where it runs (no sort of the arena: the sorted runs give most
nodes their place, a bucket's thread ranks its few tail nodes, the block
of its tile a flooded bucket's; the bucket totals scanned a tile a block),
launch latency where its guard is off (three launches that read the guard
and return).

What the TPU design needed and these kernels do not have: a padded copy of
the table (a thread wraps its own probe), a query sort, query tiles, a
resident-block map, a ``complete`` output and a fallback pass (the chain
kernels run the reference's bounded walk themselves for the queries their
segment scan cannot settle).  Results come back in query order, one a query,
and ``loc`` is the physical slot in ``[0, C)`` (for a [B, W] table the flat
slot ``row * W + lane``, for a chain arena the node index).

A table axis.  ``probe2``, ``probe_insert``, ``tc_probe2``, ``tc_insert``
(and ``cuckoo_insert``), ``extract`` (and ``transition``) and
``epoch_swap`` also take a table stack: every operand leads with [T] (the
stack's tables, each contiguous), one launch serves the T tables, and
per-table device flags pick each table's branch in the kernel (``probe2``'s
and ``tc_probe2``'s ``rebuilding``: the ordered check or the old table
alone; ``probe_insert``'s and ``tc_insert``'s ``use_alt``: the target
table; the transition's and the exchange's own rows of flags, cursors and
go).  A call is stacked where its queries are [T, Q] (``probe2``,
``probe_insert``, ``tc_probe2``, ``tc_insert``) or its cursor is [T]
(``extract``, ``transition``, ``epoch_swap``); one table is T = 1 of the
same kernel.  The plain versions run a stack table by table.

Beside each wrapper stands ``<name>_plain``: the same function with the same
signature and the same in-place behaviour in plain PyTorch.  A wrapper takes
the plain version only when the tensors it was given lie on the CPU; for CUDA
tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts the
kernel launches (and nothing else; ``transition`` counts on ``extract``,
whose kernel it launches, and ``epoch_swap`` adds one more where it
launches its decision kernel too); ``reset_launches`` / ``launch_counts``
set and read all twelve.  ``kick_tally`` reads a device counter the kick-out adds
to, in ``tc_insert``'s resolve or in its own kernel (launches that found
pending keys, iterations, keys taken), for a harness; it is zeroed with the
launch counts.

Data types: tables, keys, values, start slots and locations are ``int32``;
masks and flags are ``torch.bool`` (one byte, read by the kernels as
``uint8_t``).
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import ref

I32 = torch.int32
EMPTY, LIVE, TOMB, MIGRATED = 0, 1, 2, 3
CLAIM_FREE = 2**31 - 1      # value of every claim word between launches
# contract of the extract kernel (one block) and of the probe2 kernels (the
# hazard buffer staged in shared memory): the largest chunk they take
EXTRACT_MAX_CHUNK = 4096

KERNELS = ("probe_lookup", "probe2", "probe_insert", "extract", "tc_lookup",
           "tc_insert", "tc_probe2", "chain_probe", "chain_probe2",
           "cuckoo_kick", "epoch_swap", "chain_compact")
MAX_WIDTH = 32              # widest row the tc_* kernels take
MAX_DIRTY = 512             # widest dirty-tail window the chain_* kernels stage


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _check(*tensors_and_types):
    """Every tensor on one CUDA device, contiguous, of the stated dtype."""
    dev = tensors_and_types[0][0].device
    for t, dt in tensors_and_types:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"kernel operand has dtype {t.dtype}, wants {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _launch(name: str, counter, dev: torch.device, *args):
    """Call the C entry point on PyTorch's current stream of ``dev``; raise
    if the launch was refused.  Outputs and scratch come from PyTorch's
    caching allocator on that same stream, so a tensor the caller drops
    while the kernel still runs is only reused by work queued behind it."""
    from repro_torch.kernels import build
    fn = build.load()[name]
    argv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if dev.index == torch.cuda.current_device():
        err = fn(*argv, torch.cuda.current_stream().cuda_stream)
    else:   # the C side launches on the calling thread's current device
        with torch.cuda.device(dev):
            err = fn(*argv, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} was not launched: "
                           f"cudaError {err}")
    counter.launches += 1


def _wrappers():
    return [globals()[k] for k in KERNELS]


def reset_launches() -> None:
    for f in _wrappers():
        f.launches = 0
    for t in _KICK_TALLY.values():
        t.zero_()


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in _wrappers()}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (shaped as ``launch_counts``) to the
    counters: a CUDA graph's replay launches what its capture recorded, and
    the capture itself, which runs nothing, takes its own back."""
    for f in _wrappers():
        f.launches += times * counts.get(f.__name__, 0)


# the kick-out's counters, one int32[3] a device: launches that found
# pending keys, iterations run, pending keys taken
_KICK_TALLY: dict = {}


def _kick_tally(dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _KICK_TALLY:
        _KICK_TALLY[dev] = torch.zeros(3, dtype=I32, device=dev)
    return _KICK_TALLY[dev]


def kick_tally(dev: torch.device | str = "cuda") -> dict[str, int]:
    """What the kick-out did on ``dev`` (in ``tc_insert``'s resolve or in
    its own kernel) since the last ``reset_launches``: launches that found
    pending keys (``runs``),
    iterations, pending keys taken.  One device-to-host read, made by the
    caller (a harness), never by a step."""
    runs, iters, keys = _kick_tally(torch.device(dev)).tolist()
    return {"runs": runs, "iterations": iters, "keys": keys}


def new_claim(rows, device) -> torch.Tensor:
    """The claim words of a two-row table of ``rows`` rows (one a row; a
    shape, such as (T, rows) for a table stack):
    allocated once with the table, all ``CLAIM_FREE`` between launches.
    ``tc_insert`` takes them as its rows' claim words and the kick-out (in
    ``tc_insert``'s resolve or ``cuckoo_kick``) as its row locks; each
    launch restores every word it takes."""
    shape = (rows,) if isinstance(rows, int) else tuple(rows)
    return torch.full(shape, CLAIM_FREE, dtype=I32, device=device)


# ---------------------------------------------------------------------------
# probe_lookup
# ---------------------------------------------------------------------------

def probe_lookup_plain(tkey, tval, tstate, h0, qkey, max_probes: int):
    """Plain version of ``probe_lookup``: lock-step probe rounds over the
    whole batch.  Returns (found[Q] bool, val[Q] i32, loc[Q] i32)."""
    c, q, dev = tkey.shape[0], qkey.shape[0], tkey.device
    active = torch.ones(q, dtype=torch.bool, device=dev)
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    val = torch.zeros(q, dtype=I32, device=dev)
    loc = torch.full((q,), -1, dtype=I32, device=dev)
    pos = h0.long()
    for _ in range(max_probes):
        st = tstate[pos]
        hit = active & (st == LIVE) & (tkey[pos] == qkey)
        val = torch.where(hit, tval[pos], val)
        loc = torch.where(hit, pos.to(I32), loc)
        found |= hit
        active &= ~hit & (st != EMPTY)
        pos = (pos + 1) % c
    return found, val, loc


def probe_lookup(tkey, tval, tstate, h0, qkey, max_probes: int):
    """Batched linear-probe lookup: from ``h0`` walk at most ``max_probes``
    slots (wrapping at C), stop at EMPTY, hit on LIVE with an equal key.
    Returns (found[Q] bool, val[Q] i32 — 0 on a miss, loc[Q] i32 — the
    hit's slot in [0, C), -1 on a miss)."""
    if tkey.device.type == "cpu":
        return probe_lookup_plain(tkey, tval, tstate, h0, qkey, max_probes)
    _check((tkey, I32), (tval, I32), (tstate, I32), (h0, I32), (qkey, I32))
    q, dev = qkey.shape[0], tkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    val = torch.empty(q, dtype=I32, device=dev)
    loc = torch.empty(q, dtype=I32, device=dev)
    if q:
        _launch("probe_lookup", probe_lookup, dev, tkey, tval, tstate,
                tkey.shape[0], h0, None, 0, qkey, q, max_probes, found, val,
                loc)
    return found, val, loc


def probe_lookup_hashed_plain(tkey, tval, tstate, hfn, qkey,
                              max_probes: int):
    """Plain version of ``probe_lookup_hashed``: ``hashing.bucket_of``, then
    ``probe_lookup_plain``."""
    h0 = hashing.bucket_of(hfn, qkey, tkey.shape[0])
    return probe_lookup_plain(tkey, tval, tstate, h0, qkey, max_probes)


def probe_lookup_hashed(tkey, tval, tstate, hfn, qkey, max_probes: int):
    """``probe_lookup`` with the start slots hashed in the kernel:
    ``h0 = hashing.bucket_of(hfn, qkey, C)``, bit for bit, computed from the
    table's hash function (``hfn``: its kind and seeds) by each query's
    thread, so the caller runs no hashing ops.  The same kernel as
    ``probe_lookup`` (counted there).  Returns (found, val, loc)."""
    if tkey.device.type == "cpu":
        return probe_lookup_hashed_plain(tkey, tval, tstate, hfn, qkey,
                                         max_probes)
    _check((tkey, I32), (tval, I32), (tstate, I32), (qkey, I32),
           (hfn.seeds, torch.int64))
    q, dev = qkey.shape[0], tkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    val = torch.empty(q, dtype=I32, device=dev)
    loc = torch.empty(q, dtype=I32, device=dev)
    if q:
        _launch("probe_lookup", probe_lookup, dev, tkey, tval, tstate,
                tkey.shape[0], None, hfn.seeds,
                hashing.HASH_KINDS.index(hfn.kind), qkey, q, max_probes,
                found, val, loc)
    return found, val, loc


# ---------------------------------------------------------------------------
# probe2
# ---------------------------------------------------------------------------

def probe2_plain(old_t, new_t, hazard_key, hazard_val, hazard_live,
                 h0_old, h0_new, qkey, max_probes: int, rebuilding=None):
    """Plain version of ``probe2`` (dense [Q, chunk] hazard compare; a
    stack, table by table)."""
    if qkey.dim() == 2:
        return _stacked([probe2_plain(
            _row(old_t, i), _row(new_t, i), hazard_key[i], hazard_val[i],
            hazard_live[i], h0_old[i], h0_new[i], qkey[i], max_probes,
            _row(rebuilding, i)) for i in range(qkey.shape[0])])
    old = probe_lookup_plain(*old_t, h0_old, qkey, max_probes)
    return _by_flag(old, _ordered(
        old, hazard_key, hazard_val, hazard_live, qkey,
        probe_lookup_plain(*new_t, h0_new, qkey, max_probes)), rebuilding)


def _by_flag(old, full, rebuilding):
    """A plain ordered check's outputs where ``rebuilding`` (a table's
    flag, or None: set) is set, else the steady branch's: the old table's
    (found, val, loc) alone, ``hz_idx`` and ``loc_new`` -1."""
    if rebuilding is None:
        return full
    minus1 = torch.full_like(old[2], -1)
    steady = (old[0], old[1], old[0], old[2], minus1, minus1)
    return tuple(torch.where(rebuilding, a, b) for a, b in zip(full, steady))


def _row(x, i: int):
    """Table ``i`` of a stacked operand: a tensor's row, each tensor's row
    of a tuple, or None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(t[i] for t in x)
    return x[i]


def _stacked(results: list) -> tuple:
    """The tables' results of a plain version run table by table, stacked
    on a leading axis."""
    return tuple(torch.stack(r) for r in zip(*results))


def _stack_of(n: int, *tensors) -> None:
    """Every operand of a stacked call leads with the stack's ``n``
    tables."""
    for t in tensors:
        if t.dim() < 1 or t.shape[0] != n:
            raise ValueError(f"a stacked kernel operand of shape "
                             f"{tuple(t.shape)} does not lead with the "
                             f"stack's {n} tables")


def _ordered(old, hazard_key, hazard_val, hazard_live, qkey, new):
    """The ordered combine of both plain probe2 versions: the old table's
    (found, val, loc), the dense hazard compare, the new table's."""
    f_old, v_old, loc_old = old
    eq = (qkey[:, None] == hazard_key[None, :]) & hazard_live[None, :]
    hz_i = eq.to(torch.uint8).argmax(dim=1)     # first (lowest) match
    f_hz = eq.any(dim=1) & ~f_old
    resolved = f_old | f_hz
    f_new, v_new, loc_new = new
    f_new = f_new & ~resolved
    found = resolved | f_new
    val = torch.where(f_old, v_old, torch.where(
        f_hz, hazard_val[hz_i], torch.where(f_new, v_new, 0)))
    minus1 = torch.full_like(loc_old, -1)
    return (found, val.to(I32), f_old, loc_old,
            torch.where(f_hz, hz_i.to(I32), minus1),
            torch.where(f_new, loc_new, minus1))


def probe2(old_t, new_t, hazard_key, hazard_val, hazard_live,
           h0_old, h0_new, qkey, max_probes: int, rebuilding=None):
    """Rebuild-epoch ordered check in one pass: old table, hazard buffer,
    new table, priority old > hazard > new.

    ``old_t`` / ``new_t`` are (key, val, state) triples (sizes may differ).
    Returns (found, val, f_old, loc_old, hz_idx, loc_new): ``loc_old`` is the
    old-table slot of a hit; ``hz_idx`` the lowest live hazard index holding
    the key, reported only where the old table did not resolve the query;
    ``loc_new`` the new-table slot, reported only where neither of the
    others resolved it; -1 = none.  Contract: a hazard buffer of at most
    4096 entries, what ``extract`` fills.

    A table stack (``qkey`` [T, Q]): every operand leads with the T tables
    (tables [T, C], hazard [T, chunk], start slots [T, Q]) and every output
    is [T, Q]; one launch serves all T.  ``rebuilding`` (bool, one a
    table) marks the tables mid-rebuild: the others answer from their old
    table alone (``hz_idx`` and ``loc_new`` -1), the reference's steady
    branch; None is every table."""
    if qkey.device.type == "cpu":
        return probe2_plain(old_t, new_t, hazard_key, hazard_val,
                            hazard_live, h0_old, h0_new, qkey, max_probes,
                            rebuilding)
    if hazard_key.shape[-1] > EXTRACT_MAX_CHUNK:
        raise ValueError(f"hazard buffer of {hazard_key.shape[-1]} entries "
                         f"exceeds the probe2 kernel's {EXTRACT_MAX_CHUNK}")
    _check(*[(t, I32) for t in (*old_t, *new_t, hazard_key, hazard_val,
                                h0_old, h0_new, qkey)],
           (hazard_live, torch.bool))
    n = qkey.shape[0] if qkey.dim() == 2 else 1
    if qkey.dim() == 2:
        _stack_of(n, *old_t, *new_t, hazard_key, hazard_val, hazard_live,
                  h0_old, h0_new)
    if rebuilding is not None:
        _check((qkey, I32), (rebuilding, torch.bool))
        if rebuilding.numel() != n:
            raise ValueError("probe2: one rebuilding flag a table")
    q, dev = qkey.shape[-1], qkey.device
    found = torch.empty(qkey.shape, dtype=torch.bool, device=dev)
    f_old = torch.empty(qkey.shape, dtype=torch.bool, device=dev)
    val, loc_old, hz_idx, loc_new = (
        torch.empty(qkey.shape, dtype=I32, device=dev) for _ in range(4))
    if q:
        _launch("probe2", probe2, dev, *old_t, old_t[0].shape[-1],
                *new_t, new_t[0].shape[-1], hazard_key, hazard_val,
                hazard_live, hazard_key.shape[-1], h0_old, h0_new, qkey, q,
                max_probes, found, val, f_old, loc_old, hz_idx, loc_new, n,
                rebuilding)
    return found, val, f_old, loc_old, hz_idx, loc_new


# ---------------------------------------------------------------------------
# probe_insert
# ---------------------------------------------------------------------------

def probe_insert_plain(tkey, tval, tstate, h0, keys, vals, mask,
                       max_probes: int, *, alt=None, use_alt=None):
    """Plain version of ``probe_insert``; mutates tkey/tval/tstate (or the
    ``alt`` table) in place; a stack table by table."""
    if keys.dim() == 2:
        return _stacked([probe_insert_plain(
            tkey[i], tval[i], tstate[i], h0[i], keys[i], vals[i], mask[i],
            max_probes, alt=_row(alt, i), use_alt=_row(use_alt, i))
            for i in range(keys.shape[0])])
    if use_alt is not None:
        # two masked inserts, one of which inserts nothing (no host read)
        ok_a, pr_a = probe_insert_plain(*alt, h0, keys, vals,
                                        mask & use_alt, max_probes)
        ok, pr = probe_insert_plain(tkey, tval, tstate, h0, keys, vals,
                                    mask & ~use_alt, max_probes)
        return ok | ok_a, pr | pr_a
    c, q, dev = tkey.shape[0], keys.shape[0], tkey.device
    present, _, _ = probe_lookup_plain(tkey, tval, tstate, h0, keys,
                                       max_probes)
    present &= mask
    pending = mask & ~present
    ok = torch.zeros(q, dtype=torch.bool, device=dev)
    idx = torch.arange(q, dtype=torch.int64, device=dev)
    # bids of a round go into word `slot`; word c takes those of idle queries
    bid = torch.full((c + 1,), q, dtype=torch.int64, device=dev)
    pos = h0.long()
    for _ in range(max_probes):
        free = pending & (tstate[pos] != LIVE)
        wpos = torch.where(free, pos, c)
        bid.scatter_reduce_(0, wpos, idx, "amin")
        won = free & (bid[pos] == idx)
        bid[wpos] = q                       # restore only what was touched
        w = won.nonzero().squeeze(1)
        wp = pos[w]
        tkey[wp] = keys[w]
        tval[wp] = vals[w]
        tstate[wp] = LIVE
        ok |= won
        pending &= ~won
        pos = (pos + 1) % c
    return ok, present


def probe_insert(tkey, tval, tstate, h0, keys, vals, mask, max_probes: int,
                 *, alt=None, use_alt=None):
    """Batched claim-first-non-LIVE insert; MUTATES tkey/tval/tstate.

    Presence is proved on the table as it was before the batch; then
    ``max_probes`` rounds run in lock step, round ``p`` looking at slot
    ``(h0 + p) mod C``; a slot that is not LIVE at the start of a round goes
    to the lowest batch index that wants it.  The placement is that of
    ``ref.probe_insert_ref`` slot for slot.  The kernel runs no round: it
    resolves every start slot's group in descending start slot
    (``csrc/probe_insert.cu``), and needs no scratch but one int32 target
    a query.

    Caller contract: ``mask`` is winner-filtered (at most one True per
    distinct key).  Returns (ok[Q] bool, present[Q] bool): ``present`` marks
    masked keys that were already LIVE, which tells a duplicate from a full
    window.

    A table stack (``keys`` [T, Q]): tables [T, C], every batch operand and
    output [T, Q], each table resolved on its own, one launch for all T.
    ``alt`` (a (key, val, state) triple shaped as the table) and
    ``use_alt`` (bool, one a table) give each table its target on the
    device: ``alt`` where ``use_alt`` is set, else the table given — the
    reference's ``cond(rebuilding)`` between new and old table."""
    if tkey.device.type == "cpu":
        return probe_insert_plain(tkey, tval, tstate, h0, keys, vals, mask,
                                  max_probes, alt=alt, use_alt=use_alt)
    _check((tkey, I32), (tval, I32), (tstate, I32), (h0, I32), (keys, I32),
           (vals, I32), (mask, torch.bool))
    c, q, dev = tkey.shape[-1], keys.shape[-1], tkey.device
    n = keys.shape[0] if keys.dim() == 2 else 1
    if keys.dim() == 2:
        _stack_of(n, tkey, tval, tstate, h0, vals, mask)
    if (alt is None) != (use_alt is None):
        raise ValueError("probe_insert: give both alt and use_alt, or none")
    if use_alt is not None:
        _check(*((t, I32) for t in alt), (use_alt, torch.bool))
        if any(t.shape != tkey.shape for t in alt) or use_alt.numel() != n:
            raise ValueError("probe_insert: the alternative table must be "
                             "shaped as the table, with one flag a table")
    ok = torch.empty(keys.shape, dtype=torch.bool, device=dev)
    present = torch.empty(keys.shape, dtype=torch.bool, device=dev)
    if q:
        slot = torch.empty(keys.shape, dtype=I32, device=dev)
        _launch("probe_insert", probe_insert, dev, tkey, tval, tstate, c, h0,
                keys, vals, mask, q, max_probes, ok, present, slot, n,
                *(alt or (None, None, None)), use_alt)
    return ok, present


# ---------------------------------------------------------------------------
# extract
# ---------------------------------------------------------------------------

def extract_plain(tkey, tval, tstate, cursor, chunk: int, *, out=None,
                  run=None, hold=None):
    """Plain version of ``extract``; marks the migrated slots in ``tstate``
    in place (and with ``out`` writes the hazard buffer and the cursor in
    place).  The flags are honoured by computing the scan and selecting.
    A stack (``cursor`` [T]) table by table."""
    if cursor.dim() == 1:
        res = [extract_plain(tkey[i], tval[i], tstate[i], cursor[i], chunk,
                             out=_row(out, i), run=_row(run, i),
                             hold=_row(hold, i))
               for i in range(cursor.shape[0])]
        return (*out, cursor) if out is not None else _stacked(res)
    c, dev = tkey.shape[0], tkey.device
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    pos = cursor.long() + lane
    valid = pos < c
    cpos = torch.where(valid, pos, 0)
    live = valid & (tstate[cpos] == LIVE)
    rank = torch.cumsum(live, 0) - 1
    dest = torch.where(live, rank, chunk)       # word `chunk` is discarded
    hk = torch.zeros(chunk + 1, dtype=I32, device=dev)
    hv = torch.zeros(chunk + 1, dtype=I32, device=dev)
    hk[dest] = torch.where(live, tkey[cpos], 0)
    hv[dest] = torch.where(live, tval[cpos], 0)
    hl = lane < live.sum()
    new_cursor = torch.clamp(cursor.long() + chunk, max=c).to(I32)
    go = _go(run, hold, dev)
    # MIGRATED is the largest state, so a max leaves every other slot as is
    tstate.scatter_reduce_(0, cpos, torch.where(live & go, MIGRATED, 0)
                           .to(I32), "amax")
    hk, hv = hk[:chunk].contiguous(), hv[:chunk].contiguous()
    if out is None:
        return hk, hv, hl, new_cursor
    for dst, src in zip((*out, cursor), (hk, hv, hl, new_cursor)):
        dst.copy_(torch.where(go, src, dst))
    return (*out, cursor)


def _go(run, hold, dev) -> torch.Tensor:
    """run & ~hold as a 0-dim bool tensor (a missing flag does not stop)."""
    go = torch.ones((), dtype=torch.bool, device=dev)
    if run is not None:
        go = go & run
    if hold is not None:
        go = go & ~hold
    return go


def extract(tkey, tval, tstate, cursor, chunk: int, *, out=None, run=None,
            hold=None):
    """Rebuild chunk scan: the ``chunk`` slots at ``cursor`` (a 0-dim int32
    tensor, read on the device), LIVE ones compacted in slot order to the
    front of the hazard outputs and marked MIGRATED in ``tstate`` IN PLACE.
    Slots at or past C never migrate.  Contract: ``chunk <= 4096``.
    Returns (hkeys[chunk], hvals[chunk], hlive[chunk] bool, new_cursor).

    ``out`` = (hkeys, hvals, hlive) makes the scan write the hazard buffer
    and advance ``cursor`` IN PLACE (and returns them).  ``run`` / ``hold``
    are 0-dim bool device flags: the scan happens only where ``run`` is set
    and ``hold`` is not, else nothing is written — the reference's
    ``lax.cond(rebuilding & ~pending)``, decided on the device.

    A table stack (``cursor`` [T]): tables [T, C], flags [T], hazard
    outputs [T, chunk], each table scanned at its own cursor, one launch
    (a block a table)."""
    if tkey.device.type == "cpu":
        return extract_plain(tkey, tval, tstate, cursor, chunk, out=out,
                             run=run, hold=hold)
    if chunk > EXTRACT_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the extract kernel's "
                         f"{EXTRACT_MAX_CHUNK}")
    _check((tkey, I32), (tval, I32), (tstate, I32), (cursor, I32))
    dev, lead = tkey.device, tuple(cursor.shape)
    n = cursor.numel()
    if lead:
        _stack_of(n, tkey, tval, tstate)
    if out is None:
        hk = torch.empty(lead + (chunk,), dtype=I32, device=dev)
        hv = torch.empty(lead + (chunk,), dtype=I32, device=dev)
        hl = torch.empty(lead + (chunk,), dtype=torch.bool, device=dev)
        new_cursor = torch.empty(lead, dtype=I32, device=dev)
    else:
        (hk, hv, hl), new_cursor = out, cursor
        _check((hk, I32), (hv, I32), (hl, torch.bool))
        if tuple(hk.shape) != lead + (chunk,):
            raise ValueError("hazard buffer does not match the chunk")
    for f in (run, hold):
        if f is not None:
            _check((tkey, I32), (f, torch.bool))
            if f.numel() != n:
                raise ValueError("extract: one flag a table")
    _launch("extract", extract, dev, tkey, tval, tstate, tkey.shape[-1],
            cursor, chunk, hk, hv, hl, new_cursor, run, hold, None, None,
            None, 0, 0, n)
    return hk, hv, hl, new_cursor


def transition_plain(tkey, tval, tstate, cursor, chunk: int, hazard,
                     rebuilding, ok, present, swap: bool,
                     start: bool) -> torch.Tensor:
    """Plain version of ``transition``: the sequence it replaces — the
    snapshot ``any``, the landing's keep mask, the guarded
    ``extract_plain``, ``_epoch_flags`` — writing the same tensors in
    place (a stack table by table).  Returns go[2] bool (go[T, 2])."""
    if cursor.dim() == 1:
        return torch.stack([transition_plain(
            tkey[i], tval[i], tstate[i], cursor[i], chunk, _row(hazard, i),
            rebuilding[i], ok[i], present[i], swap, start)
            for i in range(cursor.shape[0])])
    hl = hazard[2]
    pending = hl.any()
    hl.copy_(hl & ~ok & ~present)
    extract_plain(tkey, tval, tstate, cursor, chunk, out=hazard,
                  run=rebuilding, hold=pending)
    return torch.stack(_epoch_flags(hl, cursor, rebuilding, tkey.shape[0],
                                    swap, start))


def transition(tkey, tval, tstate, cursor, chunk: int, hazard, rebuilding,
               ok, present, swap: bool, start: bool) -> torch.Tensor:
    """One rebuild transition of an engine step, after the landing insert,
    in ONE ``extract`` launch (``csrc/extract.cu``, counted as
    ``extract``), IN PLACE:

    (a) ``pending = any(hazard_live)``, taken before the buffer changes (one
    transition a call: a landing that empties the buffer does not let the
    scan run in the same step); (b) the landing's bookkeeping
    ``hazard_live &= ~ok & ~present`` (``ok`` / ``present`` bool[chunk],
    the landing insert's outputs); (c) the chunk scan of ``extract`` into
    ``hazard`` = (hkeys, hvals, hlive) at ``cursor``, where ``rebuilding``
    is set and nothing was pending; (d) the epoch decision: go[0] = swap
    (allowed by ``swap``: rebuilding, the cursor at the table's end and no
    hazard entry live), go[1] = start (allowed by ``start``: after a swap
    or where no rebuild runs) — the flags ``epoch_swap`` reads.

    (``tkey``, ``tval``, ``tstate``) are the scanned table's flat arrays;
    their length is its scan-order capacity.  Contract: ``chunk <= 4096``
    on a CUDA device.  Returns go[2] bool on the device.

    A table stack (``cursor`` [T]): the tables' arrays [T, C], the hazard
    buffer, ``ok`` and ``present`` [T, chunk], ``rebuilding`` [T]; each
    table runs its own transition on its own flags, one launch (a block a
    table).  Returns go[T, 2]."""
    dev = tkey.device
    if dev.type == "cpu":
        return transition_plain(tkey, tval, tstate, cursor, chunk, hazard,
                                rebuilding, ok, present, swap, start)
    if chunk > EXTRACT_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} exceeds the extract kernel's "
                         f"{EXTRACT_MAX_CHUNK}")
    hk, hv, hl = hazard
    _check((tkey, I32), (tval, I32), (tstate, I32), (cursor, I32), (hk, I32),
           (hv, I32), (hl, torch.bool), (rebuilding, torch.bool),
           (ok, torch.bool), (present, torch.bool))
    lead, n = tuple(cursor.shape), cursor.numel()
    if not tuple(hk.shape) == tuple(hv.shape) == tuple(hl.shape) \
            == tuple(ok.shape) == tuple(present.shape) == lead + (chunk,):
        raise ValueError("transition: the hazard buffer, ok and present "
                         "must match the chunk")
    if lead:
        _stack_of(n, tkey, tval, tstate, rebuilding)
    go = torch.empty(lead + (2,), dtype=torch.bool, device=dev)
    _launch("extract", extract, dev, tkey, tval, tstate, tkey.shape[-1],
            cursor, chunk, hk, hv, hl, cursor, rebuilding, None, ok, present,
            go, int(swap), int(start), n)
    return go


# ---------------------------------------------------------------------------
# tc_lookup
# ---------------------------------------------------------------------------

def _check_rows(*tables, lead: int = 0):
    """[rows, W] tables of one width the tc_* kernels take ([T, rows, W]
    with ``lead`` 1: a table stack)."""
    nd = 2 + lead
    w = tables[0].shape[-1] if tables[0].dim() == nd else -1
    for t in tables:
        if t.dim() != nd or t.shape[-1] != w:
            raise ValueError(f"two-row kernels take [rows, W] tables of one "
                             f"width, got {tuple(t.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"two-row kernels take widths 1..{MAX_WIDTH}, "
                         f"got {w}")
    return w


def tc_lookup_plain(tkey, tval, tstate, rows_a, rows_b, qkey):
    """Plain version of ``tc_lookup``: both rows gathered whole, a-row
    priority."""
    fa, va, la = ref.tc_row_lookup_ref(tkey, tval, tstate, rows_a, qkey)
    fb, vb, lb = ref.tc_row_lookup_ref(tkey, tval, tstate, rows_b, qkey)
    return fa | fb, torch.where(fa, va, vb), torch.where(fa, la, lb)


def tc_lookup(tkey, tval, tstate, rows_a, rows_b, qkey):
    """Batched two-row lookup on a [B, W] table: the LIVE lane holding the
    key in row ``rows_a``, else in row ``rows_b``.  Returns (found[Q] bool,
    val[Q] i32 — 0 on a miss, loc[Q] i32 — the flat slot row * W + lane,
    -1 on a miss)."""
    if tkey.device.type == "cpu":
        return tc_lookup_plain(tkey, tval, tstate, rows_a, rows_b, qkey)
    w = _check_rows(tkey, tval, tstate)
    _check((tkey, I32), (tval, I32), (tstate, I32), (rows_a, I32),
           (rows_b, I32), (qkey, I32))
    q, dev = qkey.shape[0], tkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    val = torch.empty(q, dtype=I32, device=dev)
    loc = torch.empty(q, dtype=I32, device=dev)
    if q:
        _launch("tc_lookup", tc_lookup, dev, tkey, tval, tstate, w, rows_a,
                rows_b, None, 0, None, 0, 0, 0, qkey, q, found, val, loc)
    return found, val, loc


def tc_lookup_hashed_plain(tkey, tval, tstate, hfn_a, hfn_b, nbuckets: int,
                           b_offset: int, qkey):
    """Plain version of ``tc_lookup_hashed``: ``hashing.bucket_of`` for
    both rows, then ``tc_lookup_plain``."""
    rows_a = hashing.bucket_of(hfn_a, qkey, nbuckets)
    rows_b = hashing.bucket_of(hfn_b, qkey, nbuckets)
    if b_offset:
        rows_b = rows_b + b_offset
    return tc_lookup_plain(tkey, tval, tstate, rows_a, rows_b, qkey)


def tc_lookup_hashed(tkey, tval, tstate, hfn_a, hfn_b, nbuckets: int,
                     b_offset: int, qkey):
    """``tc_lookup`` with the rows hashed in the kernel: row a =
    ``hashing.bucket_of(hfn_a, qkey, nbuckets)``, row b = ``b_offset +
    hashing.bucket_of(hfn_b, qkey, nbuckets)``, bit for bit, computed by the
    kernel from the table's two hash functions (their kinds and seeds), so
    the caller runs no hashing ops.  ``b_offset`` is 0 on a twochoice table
    and ``nbuckets`` on a cuckoo table's [2B, W] array.  The same kernel as
    ``tc_lookup`` (counted there).  Returns (found, val, loc)."""
    if not (nbuckets >= 1 and b_offset >= 0
            and b_offset + nbuckets <= tkey.shape[0]):
        raise ValueError(f"rows [0, {nbuckets}) and [{b_offset}, "
                         f"{b_offset + nbuckets}) do not lie in a table of "
                         f"{tkey.shape[0]} rows")
    if tkey.device.type == "cpu":
        return tc_lookup_hashed_plain(tkey, tval, tstate, hfn_a, hfn_b,
                                      nbuckets, b_offset, qkey)
    w = _check_rows(tkey, tval, tstate)
    _check((tkey, I32), (tval, I32), (tstate, I32), (qkey, I32),
           (hfn_a.seeds, torch.int64), (hfn_b.seeds, torch.int64))
    q, dev = qkey.shape[0], tkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    val = torch.empty(q, dtype=I32, device=dev)
    loc = torch.empty(q, dtype=I32, device=dev)
    if q:
        _launch("tc_lookup", tc_lookup, dev, tkey, tval, tstate, w, None,
                None, hfn_a.seeds, hashing.HASH_KINDS.index(hfn_a.kind),
                hfn_b.seeds, hashing.HASH_KINDS.index(hfn_b.kind), nbuckets,
                b_offset, qkey, q, found, val, loc)
    return found, val, loc


# ---------------------------------------------------------------------------
# tc_insert
# ---------------------------------------------------------------------------

def tc_insert_plain(tkey, tval, tstate, rows_a, rows_b, keys, vals, mask,
                    max_rounds: int, claim=None, *, alt=None, use_alt=None):
    """Plain version of ``tc_insert`` (``ref.tc_insert_ref`` written back);
    mutates tkey/tval/tstate (or the ``alt`` table) in place; a stack table
    by table.  ``claim`` is accepted for signature parity and not used."""
    if keys.dim() == 2:
        return _stacked([tc_insert_plain(
            tkey[i], tval[i], tstate[i], rows_a[i], rows_b[i], keys[i],
            vals[i], mask[i], max_rounds, alt=_row(alt, i),
            use_alt=_row(use_alt, i)) for i in range(keys.shape[0])])
    if use_alt is not None:
        # two masked inserts, one of which inserts nothing (no host read)
        ok_a, pr_a = tc_insert_plain(*alt, rows_a, rows_b, keys, vals,
                                     mask & use_alt, max_rounds)
        ok, pr = tc_insert_plain(tkey, tval, tstate, rows_a, rows_b, keys,
                                 vals, mask & ~use_alt, max_rounds)
        return ok | ok_a, pr | pr_a
    fa, _, _ = ref.tc_row_lookup_ref(tkey, tval, tstate, rows_a, keys)
    fb, _, _ = ref.tc_row_lookup_ref(tkey, tval, tstate, rows_b, keys)
    k, v, s, ok = ref.tc_insert_ref(tkey, tval, tstate, rows_a, rows_b, keys,
                                    vals, mask, max_rounds)
    tkey.copy_(k)
    tval.copy_(v)
    tstate.copy_(s)
    return ok, mask & (fa | fb)


def tc_scratch_words(q: int, max_kick: int) -> int:
    """The int32 words of ``tc_insert``'s scratch for a batch of ``q`` (a
    table's: a stack takes one such region a table): the layout
    ``csrc/tc_insert.cu`` states (a round-0 slot and a list entry a query,
    the list's length and the count of blocks done, and with the kick-out a
    word a query for the queries the rounds leave and three plan words a
    query)."""
    return 2 * q + 2 + 4 * q * (max_kick > 0)


def _fn_row(fn, i: int):
    """Function ``i`` of a stack of hash functions."""
    return hashing.HashFn(kind=fn.kind, seeds=fn.seeds[i])


def _tc_launch(tkey, tval, tstate, rows_a, rows_b, keys, vals, mask,
               max_rounds: int, claim, kick=None, alt=None, use_alt=None):
    """One ``tc_insert`` launch; ``kick`` = (hfn_a, hfn_b, nbuckets,
    max_kick) runs the cuckoo kick-out in its resolve.  A table stack where
    ``keys`` is [T, Q].  Returns (ok, present)."""
    n = keys.shape[0] if keys.dim() == 2 else 1
    w = _check_rows(tkey, tval, tstate, lead=int(keys.dim() == 2))
    q, dev = keys.shape[-1], tkey.device
    rows = tkey.shape[-2]
    if claim is None:
        claim = new_claim(tkey.shape[:-1], dev)
    _check((tkey, I32), (tval, I32), (tstate, I32), (claim, I32),
           (rows_a, I32), (rows_b, I32), (keys, I32), (vals, I32),
           (mask, torch.bool))
    if tuple(claim.shape) != tuple(tkey.shape[:-1]):
        raise ValueError("claim words do not match the table's rows")
    if keys.dim() == 2:
        _stack_of(n, tkey, tval, tstate, claim, rows_a, rows_b, vals, mask)
    if (alt is None) != (use_alt is None):
        raise ValueError("tc_insert: give both alt and use_alt, or none")
    if use_alt is not None:
        _check(*((t, I32) for t in alt), (use_alt, torch.bool))
        if any(t.shape != tkey.shape for t in alt) or use_alt.numel() != n:
            raise ValueError("tc_insert: the alternative table must be "
                             "shaped as the table, with one flag a table")
    hfn_a, hfn_b, nbuckets, max_kick = kick or (None, None, 0, 0)
    stride = 0
    if kick is not None:
        _check((hfn_a.seeds, torch.int64), (hfn_b.seeds, torch.int64))
        if keys.dim() == 2:
            _stack_of(n, hfn_a.seeds, hfn_b.seeds)
            stride = hfn_a.seeds[0].numel()
    ok = torch.empty(keys.shape, dtype=torch.bool, device=dev)
    present = torch.empty(keys.shape, dtype=torch.bool, device=dev)
    if q:
        # a region a table
        scratch = torch.empty(tc_scratch_words(q, max_kick) * n, dtype=I32,
                              device=dev)
        stacked = keys.dim() == 2
        _launch("tc_insert", tc_insert, dev, tkey, tval, tstate, claim, w,
                rows_a, rows_b, keys, vals, mask, q, max_rounds, ok, present,
                scratch, max_kick, nbuckets,
                None if kick is None else hfn_a.seeds,
                0 if kick is None else hashing.HASH_KINDS.index(hfn_a.kind),
                None if kick is None else hfn_b.seeds,
                0 if kick is None else hashing.HASH_KINDS.index(hfn_b.kind),
                None if kick is None else _kick_tally(dev), n,
                rows if stacked else 0, stride,
                *(alt or (None, None, None)), use_alt)
    return ok, present


def tc_insert(tkey, tval, tstate, rows_a, rows_b, keys, vals, mask,
              max_rounds: int, claim=None, *, alt=None, use_alt=None):
    """Batched claim-a-lane two-row insert on a [B, W] table; MUTATES
    tkey/tval/tstate.

    Presence is proved in both rows on the table as it was before the batch;
    then ``max_rounds`` rounds run in lock step, round ``r`` looking at row
    ``rows_a`` if ``r`` is even, else ``rows_b``, and taking the row's first
    lane that is not LIVE at the start of the round; the lowest batch index
    wins a contested lane.  The placement is ``ref.tc_insert_ref``'s, slot
    for slot.  The kernel has no grid-wide barrier: round 0 is a bid launch
    and a resolve launch over the grid, and the resolve's last block to
    finish runs the later rounds over the queries still pending
    (``csrc/tc_insert.cu``).

    Caller contract: ``mask`` is winner-filtered.  ``claim`` is the table's
    claim words (``new_claim(B)``, one a row); without them fresh words are
    allocated for this call.  Returns (ok[Q] bool, present[Q] bool).

    A table stack (``keys`` [T, Q]): tables [T, B, W], claim words [T, B],
    rows and every batch operand and output [T, Q], each table resolved on
    its own (its own list and last block), one launch of each kernel for
    all T.  ``alt`` (a (key, val, state) triple shaped as the table) and
    ``use_alt`` (bool, one a table) give each table its target on the
    device, as ``probe_insert``'s do; the rows are the target's."""
    if tkey.device.type == "cpu":
        return tc_insert_plain(tkey, tval, tstate, rows_a, rows_b, keys, vals,
                               mask, max_rounds, alt=alt, use_alt=use_alt)
    return _tc_launch(tkey, tval, tstate, rows_a, rows_b, keys, vals, mask,
                      max_rounds, claim, alt=alt, use_alt=use_alt)


# the claim rounds of the cuckoo insert: one try a side
CUCKOO_ROUNDS = 2


def cuckoo_insert_plain(tkey, tval, tstate, rows_a, rows_b, hfn_a, hfn_b,
                        nbuckets: int, keys, vals, mask, max_kick: int,
                        claim=None, *, alt=None, use_alt=None):
    """Plain version of ``cuckoo_insert``: ``tc_insert_plain`` with two
    rounds, then ``cuckoo_kick_plain``; mutates the table (or the ``alt``
    table) in place; a stack table by table.  ``claim`` is accepted for
    signature parity and not used."""
    if keys.dim() == 2:
        return _stacked([cuckoo_insert_plain(
            tkey[i], tval[i], tstate[i], rows_a[i], rows_b[i],
            _fn_row(hfn_a, i), _fn_row(hfn_b, i), nbuckets, keys[i], vals[i],
            mask[i], max_kick, alt=_row(alt, i), use_alt=_row(use_alt, i))
            for i in range(keys.shape[0])])
    if use_alt is not None:
        ok_a, pr_a = cuckoo_insert_plain(*alt, rows_a, rows_b, hfn_a, hfn_b,
                                         nbuckets, keys, vals,
                                         mask & use_alt, max_kick)
        ok, pr = cuckoo_insert_plain(tkey, tval, tstate, rows_a, rows_b,
                                     hfn_a, hfn_b, nbuckets, keys, vals,
                                     mask & ~use_alt, max_kick)
        return ok | ok_a, pr | pr_a
    ok, present = tc_insert_plain(tkey, tval, tstate, rows_a, rows_b, keys,
                                  vals, mask, CUCKOO_ROUNDS)
    cuckoo_kick_plain(tkey, tval, tstate, rows_a, rows_b, hfn_a, hfn_b,
                      nbuckets, keys, vals, mask, ok, present, max_kick)
    return ok, present


def cuckoo_insert(tkey, tval, tstate, rows_a, rows_b, hfn_a, hfn_b,
                  nbuckets: int, keys, vals, mask, max_kick: int,
                  claim=None, *, alt=None, use_alt=None):
    """The cuckoo insert on a [2B, W] table in ONE ``tc_insert`` launch (its
    two kernels); MUTATES the table.

    The claim rounds of ``tc_insert`` (two: row a, then row b), then the
    bounded kick-out of ``cuckoo_kick`` for the winners they left unplaced
    and absent from both rows, run by the resolve's last block over the
    list the rounds left (``csrc/tc_insert.cu``): the placement of
    ``tc_insert_plain`` then ``cuckoo_kick_plain``, slot for slot.  Counted
    on ``tc_insert``; what the kick-out did goes to ``kick_tally``.
    Caller contract: ``mask`` is winner-filtered.  ``claim`` is the table's
    claim words (``new_claim(2B)``); without them fresh words are
    allocated.  Returns (ok[Q] bool, present[Q] bool).  A table stack as
    ``tc_insert``'s, with a stack of hash functions (seeds [T, ...]): each
    table's last block kicks out with its own, those of its target."""
    if tkey.device.type == "cpu":
        return cuckoo_insert_plain(tkey, tval, tstate, rows_a, rows_b, hfn_a,
                                   hfn_b, nbuckets, keys, vals, mask,
                                   max_kick, alt=alt, use_alt=use_alt)
    return _tc_launch(tkey, tval, tstate, rows_a, rows_b, keys, vals, mask,
                      CUCKOO_ROUNDS, claim, (hfn_a, hfn_b, nbuckets, max_kick),
                      alt=alt, use_alt=use_alt)


# ---------------------------------------------------------------------------
# tc_probe2
# ---------------------------------------------------------------------------

def tc_probe2_plain(old_t, new_t, hazard_key, hazard_val, hazard_live,
                    rows_a_old, rows_b_old, rows_a_new, rows_b_new, qkey,
                    rebuilding=None):
    """Plain version of ``tc_probe2`` (dense [Q, chunk] hazard compare; a
    stack, table by table)."""
    if qkey.dim() == 2:
        return _stacked([tc_probe2_plain(
            _row(old_t, i), _row(new_t, i), hazard_key[i], hazard_val[i],
            hazard_live[i], rows_a_old[i], rows_b_old[i], rows_a_new[i],
            rows_b_new[i], qkey[i], _row(rebuilding, i))
            for i in range(qkey.shape[0])])
    old = tc_lookup_plain(*old_t, rows_a_old, rows_b_old, qkey)
    return _by_flag(old, _ordered(
        old, hazard_key, hazard_val, hazard_live, qkey,
        tc_lookup_plain(*new_t, rows_a_new, rows_b_new, qkey)), rebuilding)


def tc_probe2(old_t, new_t, hazard_key, hazard_val, hazard_live,
              rows_a_old, rows_b_old, rows_a_new, rows_b_new, qkey,
              rebuilding=None):
    """Two-row rebuild-epoch ordered check in one pass: old rows a then b,
    the hazard buffer, new rows a then b; priority old > hazard > new.

    ``old_t`` / ``new_t`` are (key, val, state) triples of [B, W] tables
    (same W; row counts may differ).  Returns (found, val, f_old, loc_old,
    hz_idx, loc_new) with the meaning of ``probe2``'s, locations as flat
    slots.  Contract: a hazard buffer of at most 4096 entries.

    A table stack (``qkey`` [T, Q]) as ``probe2``'s: tables [T, B, W],
    hazard [T, chunk], rows and outputs [T, Q], one launch for all T;
    ``rebuilding`` (bool, one a table) sends the idle tables to their old
    rows alone (``hz_idx`` and ``loc_new`` -1); None is every table."""
    if qkey.device.type == "cpu":
        return tc_probe2_plain(old_t, new_t, hazard_key, hazard_val,
                               hazard_live, rows_a_old, rows_b_old,
                               rows_a_new, rows_b_new, qkey, rebuilding)
    if hazard_key.shape[-1] > EXTRACT_MAX_CHUNK:
        raise ValueError(f"hazard buffer of {hazard_key.shape[-1]} entries "
                         f"exceeds the tc_probe2 kernel's {EXTRACT_MAX_CHUNK}")
    stacked = qkey.dim() == 2
    w = _check_rows(*old_t, *new_t, lead=int(stacked))
    _check(*[(t, I32) for t in (*old_t, *new_t, hazard_key, hazard_val,
                                rows_a_old, rows_b_old, rows_a_new,
                                rows_b_new, qkey)],
           (hazard_live, torch.bool))
    n = qkey.shape[0] if stacked else 1
    if stacked:
        _stack_of(n, *old_t, *new_t, hazard_key, hazard_val, hazard_live,
                  rows_a_old, rows_b_old, rows_a_new, rows_b_new)
    if rebuilding is not None:
        _check((qkey, I32), (rebuilding, torch.bool))
        if rebuilding.numel() != n:
            raise ValueError("tc_probe2: one rebuilding flag a table")
    q, dev = qkey.shape[-1], qkey.device
    found = torch.empty(qkey.shape, dtype=torch.bool, device=dev)
    f_old = torch.empty(qkey.shape, dtype=torch.bool, device=dev)
    val, loc_old, hz_idx, loc_new = (
        torch.empty(qkey.shape, dtype=I32, device=dev) for _ in range(4))
    if q:
        _launch("tc_probe2", tc_probe2, dev, *old_t, *new_t, w, hazard_key,
                hazard_val, hazard_live, hazard_key.shape[-1], rows_a_old,
                rows_b_old, rows_a_new, rows_b_new, qkey, q, found, val,
                f_old, loc_old, hz_idx, loc_new, n, rebuilding,
                old_t[0].shape[-2] if stacked else 0,
                new_t[0].shape[-2] if stacked else 0)
    return found, val, f_old, loc_old, hz_idx, loc_new


# ---------------------------------------------------------------------------
# chain_probe
# ---------------------------------------------------------------------------
#
# Argument convention of the chain kernels, as in the reference's chain ops:
# ``arena = (akey, aval, astate)``, ``links = (anext, heads)``, ``seg =
# (bstart, blen, sorted_upto, dirty)`` with the last two 0-dim int32 tensors
# (read on the device), and ``bq`` each query's bucket.


def chain_dirty_window(arena, sorted_upto, dirty, qkey, dirty_cap: int):
    """Dense compare of the query batch against the arena's dirty tail (the
    plain form of what the chain kernels stage in shared memory).

    The window is the ``size = min(dirty_cap, N)`` nodes at ``base =
    min(sorted_upto, N - size)``; positions below ``sorted_upto`` are the
    segment scan's and do not count.  Returns (found, val, loc, covered):
    the first LIVE match's value and node, and whether the window holds the
    whole tail (0-dim), i.e. whether a miss proves absence."""
    akey, aval, astate = arena
    n = akey.shape[0]
    size = min(dirty_cap, n)
    base = torch.clamp(sorted_upto.long(), max=n - size)
    pos = base + torch.arange(size, dtype=torch.int64, device=akey.device)
    valid = (astate[pos] == LIVE) & (pos >= sorted_upto)
    eq = (qkey[:, None] == akey[pos][None, :]) & valid[None, :]
    hit = eq.any(-1)
    i = eq.to(torch.uint8).argmax(dim=-1)
    val = torch.where(hit, aval[pos][i], 0).to(I32)
    loc = torch.where(hit, pos[i], -1).to(I32)
    covered = sorted_upto + dirty <= base + size
    return hit, val, loc, covered


def _chain_fast_plain(arena, seg, bq, qkey, max_chain: int, dirty_cap: int):
    """The kernels' fast path in plain PyTorch: the bucket's sorted segment
    (scanned only when at most ``max_chain`` long), then the dirty-tail
    window.  Returns (found, val, loc, complete); ``complete`` marks the
    queries whose miss proves absence."""
    akey, aval, astate = arena
    bstart, blen, sorted_upto, dirty = seg
    n, q, dev = akey.shape[0], qkey.shape[0], qkey.device
    b = bq.long()
    h0, qlen = bstart[b].long(), blen[b]
    scan = qlen <= max_chain
    found = torch.zeros(q, dtype=torch.bool, device=dev)
    val = torch.zeros(q, dtype=I32, device=dev)
    loc = torch.full((q,), -1, dtype=I32, device=dev)
    span = int(torch.where(scan, qlen, 0).max()) if q else 0
    for p in range(span):
        pos = torch.clamp(h0 + p, max=n - 1)
        hit = scan & ~found & (p < qlen) & (astate[pos] == LIVE) & \
            (akey[pos] == qkey)
        val = torch.where(hit, aval[pos], val)
        loc = torch.where(hit, pos.to(I32), loc)
        found |= hit
    fw, vw, lw, covered = chain_dirty_window(arena, sorted_upto, dirty, qkey,
                                             dirty_cap)
    return (found | fw, torch.where(found, val, vw),
            torch.where(found, loc, lw), scan & covered)


def _chain_walk_where(need, arena, links, bq, qkey, max_chain: int, out):
    """``out`` = (found, val, loc) with the queries in ``need`` replaced by
    the reference's bounded walk (``ref.chain_lookup_ref``, run on those
    queries only)."""
    sel = need.nonzero().squeeze(1)
    found, val, loc = (x.clone() for x in out)
    if sel.numel():
        f, v, l = ref.chain_lookup_ref(*arena, *links, bq[sel], qkey[sel],
                                       max_chain)
        found[sel], val[sel], loc[sel] = f, v, l
    return found, val, loc


def chain_probe_plain(arena, links, seg, bq, qkey, max_chain: int,
                      dirty_cap: int):
    """Plain version of ``chain_probe``: the segment scan and the dirty
    window, then the bounded walk for what they leave open."""
    f, v, l, complete = _chain_fast_plain(arena, seg, bq, qkey, max_chain,
                                          dirty_cap)
    return _chain_walk_where(~f & ~complete, arena, links, bq, qkey,
                             max_chain, (f, v, l))


def _window(dirty_cap: int, arena) -> int:
    """The dirty window of an arena (``min(dirty_cap, N)`` nodes), within
    what the chain kernels stage."""
    size = min(dirty_cap, arena[0].shape[0])
    if not 1 <= size <= MAX_DIRTY:
        raise ValueError(f"the chain kernels stage a dirty window of "
                         f"1..{MAX_DIRTY} nodes, got {size}")
    return size


def chain_probe(arena, links, seg, bq, qkey, max_chain: int,
                dirty_cap: int):
    """Batched chain lookup over the bucket-sorted arena: the LIVE node
    holding the key in bucket ``bq``'s segment (scanned when at most
    ``max_chain`` long), else in the dirty tail (the window of ``size =
    min(dirty_cap, N)`` nodes at ``min(sorted_upto, N - size)``); a query
    found in neither whose absence is not proven takes the bounded walk of
    ``ref.chain_lookup_ref``.  The result is the reference's fused chain
    lookup's.  Returns (found[Q] bool, val[Q] i32 — 0 on a miss, loc[Q] i32
    — the hit's node index, -1 on a miss).  Contract: a dirty window of at
    most 512 nodes."""
    if qkey.device.type == "cpu":
        return chain_probe_plain(arena, links, seg, bq, qkey, max_chain,
                                 dirty_cap)
    wsize = _window(dirty_cap, arena)
    _check(*[(t, I32) for t in (*arena, *links, *seg, bq, qkey)])
    q, dev = qkey.shape[0], qkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    val = torch.empty(q, dtype=I32, device=dev)
    loc = torch.empty(q, dtype=I32, device=dev)
    if q:
        _launch("chain_probe", chain_probe, dev, *arena, *links,
                arena[0].shape[0], *seg, bq, qkey, q, max_chain, wsize,
                found, val, loc)
    return found, val, loc


# ---------------------------------------------------------------------------
# chain_probe2
# ---------------------------------------------------------------------------

def chain_probe2_plain(old, new, hazard_key, hazard_val, hazard_live,
                       bq_old, bq_new, qkey, max_chain: int, dirty_cap: int):
    """Plain version of ``chain_probe2``: both arenas' fast paths and the
    dense [Q, chunk] hazard compare, the reference's settle rule, then its
    fallback (old walk, hazard, new walk) for the queries left open."""
    (oa, ol, os_), (na, nl, ns) = old, new
    fo, vo, lo, co = _chain_fast_plain(oa, os_, bq_old, qkey, max_chain,
                                       dirty_cap)
    fn, vn, ln, cn = _chain_fast_plain(na, ns, bq_new, qkey, max_chain,
                                       dirty_cap)
    f_hz = ((qkey[:, None] == hazard_key[None, :])
            & hazard_live[None, :]).any(-1)
    need = ~(fo | (co & (f_hz | fn | cn)))
    return _ordered(
        _chain_walk_where(need, oa, ol, bq_old, qkey, max_chain,
                          (fo, vo, lo)),
        hazard_key, hazard_val, hazard_live, qkey,
        _chain_walk_where(need, na, nl, bq_new, qkey, max_chain,
                          (fn, vn, ln)))


def chain_probe2(old, new, hazard_key, hazard_val, hazard_live, bq_old,
                 bq_new, qkey, max_chain: int, dirty_cap: int):
    """Chain rebuild-epoch ordered check in one pass: old arena, hazard
    buffer, new arena; priority old > hazard > new.

    ``old`` / ``new`` are (arena, links, seg) triples of the chain kernels'
    convention (sizes may differ).  A query is settled by the fast paths
    (segment scan, dirty window, dense hazard compare) as the reference's
    ``_chain_probe2_run`` settles it, else by its fallback: the old arena's
    bounded walk, the hazard buffer, the new arena's bounded walk.  Returns
    (found, val, f_old, loc_old, hz_idx, loc_new) with the meaning of
    ``probe2``'s, locations as node indices.  Contract: a hazard buffer of at
    most 4096 entries and a dirty window of at most 512 nodes."""
    if qkey.device.type == "cpu":
        return chain_probe2_plain(old, new, hazard_key, hazard_val,
                                  hazard_live, bq_old, bq_new, qkey,
                                  max_chain, dirty_cap)
    if hazard_key.shape[0] > EXTRACT_MAX_CHUNK:
        raise ValueError(f"hazard buffer of {hazard_key.shape[0]} entries "
                         f"exceeds the chain_probe2 kernel's "
                         f"{EXTRACT_MAX_CHUNK}")
    wsizes = (_window(dirty_cap, old[0]), _window(dirty_cap, new[0]))
    _check(*[(t, I32) for part in (*old, *new) for t in part],
           *[(t, I32) for t in (hazard_key, hazard_val, bq_old, bq_new,
                                qkey)],
           (hazard_live, torch.bool))
    q, dev = qkey.shape[0], qkey.device
    found = torch.empty(q, dtype=torch.bool, device=dev)
    f_old = torch.empty(q, dtype=torch.bool, device=dev)
    val, loc_old, hz_idx, loc_new = (
        torch.empty(q, dtype=I32, device=dev) for _ in range(4))
    if q:
        def arena_args(a):
            (k, v, s), (nx, hd), (bs, bl, su, dt) = a
            return (k, v, s, nx, hd, k.shape[0], bs, bl, su, dt)
        _launch("chain_probe2", chain_probe2, dev, *arena_args(old),
                *arena_args(new), hazard_key, hazard_val, hazard_live,
                hazard_key.shape[0], bq_old, bq_new, qkey, q, max_chain,
                *wsizes, found, val, f_old, loc_old, hz_idx, loc_new)
    return found, val, f_old, loc_old, hz_idx, loc_new


# ---------------------------------------------------------------------------
# cuckoo_kick
# ---------------------------------------------------------------------------

def cuckoo_kick_plain(tkey, tval, tstate, rows_a, rows_b, hfn_a, hfn_b,
                      nbuckets: int, keys, vals, winner, ok, present,
                      max_kick: int, claim=None):
    """Plain version of ``cuckoo_kick``: ``ref.cuckoo_kick_ref`` over the
    whole batch for ``max_kick`` iterations on the pending queries, behind
    the same flag; writes the table and ``ok`` in place.  ``claim`` is
    accepted for signature parity and not used."""
    pend = winner & ~ok & ~present
    if not bool(pend.any()):
        return ok
    k, v, st, done = ref.cuckoo_kick_ref(tkey, tval, tstate, rows_a, rows_b,
                                         hfn_a, hfn_b, nbuckets, keys, vals,
                                         pend, max_kick)
    for dst, src in ((tkey, k), (tval, v), (tstate, st)):
        dst.copy_(src)
    ok |= done
    return ok


def cuckoo_kick(tkey, tval, tstate, rows_a, rows_b, hfn_a, hfn_b,
                nbuckets: int, keys, vals, winner, ok, present,
                max_kick: int, claim=None):
    """The cuckoo insert's bounded kick-out on a [2B, W] table; MUTATES the
    table and ``ok`` (a placed key's entry becomes True).

    The pending queries are ``winner & ~ok & ~present`` (the claim kernel's
    outputs); the placement is ``ref.cuckoo_kick_ref`` over the whole batch
    for ``max_kick`` iterations, slot for slot (the scan start rotated by
    the iteration, the per-row lock to the lowest batch index).  One launch,
    which returns after one pass over the flags when nothing is pending and
    stops on the device when no key is left (``csrc/cuckoo_kick.cu``).
    ``claim`` is the table's claim words, the row locks (``new_claim(2B)``);
    without them fresh words are allocated.  Returns ``ok``."""
    if tkey.device.type == "cpu":
        return cuckoo_kick_plain(tkey, tval, tstate, rows_a, rows_b, hfn_a,
                                 hfn_b, nbuckets, keys, vals, winner, ok,
                                 present, max_kick)
    w = _check_rows(tkey, tval, tstate)
    q, dev = keys.shape[0], tkey.device
    if claim is None:
        claim = new_claim(tkey.shape[0], dev)
    _check((tkey, I32), (tval, I32), (tstate, I32), (claim, I32),
           (rows_a, I32), (rows_b, I32), (keys, I32), (vals, I32),
           (winner, torch.bool), (ok, torch.bool), (present, torch.bool),
           (hfn_a.seeds, torch.int64), (hfn_b.seeds, torch.int64))
    if claim.shape[0] != tkey.shape[0]:
        raise ValueError("claim words do not match the table's rows")
    if q:
        lst = torch.empty(4 * q, dtype=I32, device=dev)   # list, then plan
        _launch("cuckoo_kick", cuckoo_kick, dev, tkey, tval, tstate, w,
                nbuckets, rows_a, rows_b, keys, vals, winner, ok, present, q,
                max_kick, hfn_a.seeds, hashing.HASH_KINDS.index(hfn_a.kind),
                hfn_b.seeds, hashing.HASH_KINDS.index(hfn_b.kind), claim, lst,
                lst.data_ptr() + 4 * q, _kick_tally(dev))
    return ok


# ---------------------------------------------------------------------------
# chain_compact
# ---------------------------------------------------------------------------

def _compact_guard(free_top, sorted_upto, n: int, where, dirty_cap: int):
    """The compaction's guard as a 0-dim bool, or None when it always runs."""
    run = where
    if dirty_cap >= 0:
        over = (n - free_top - sorted_upto) > dirty_cap
        run = over if run is None else run & over
    return run


def chain_compact_plain(fields, hfn, nbuckets: int, where=None,
                        dirty_cap: int = -1):
    """Plain version of ``chain_compact``: ``ops.chain_compact_fused`` (one
    stable sort of the arena) computed, and taken with ``torch.where`` where
    the guard holds, IN PLACE."""
    from repro_torch.kernels import ops
    akey, aval, astate, *_ = fields
    run = _compact_guard(fields[6], fields[9], akey.numel(), where,
                         dirty_cap)
    new = ops.chain_compact_fused(akey, aval, astate,
                                  hashing.bucket_of(hfn, akey, nbuckets),
                                  nbuckets=nbuckets)
    for dst, src in zip(fields, new):
        dst.copy_(src if run is None else torch.where(run, src, dst))


def compact_scratch_words(n: int, nbuckets: int) -> int:
    """The int32 words of ``chain_compact``'s scratch for an arena of ``n``
    nodes and ``nbuckets`` buckets: the layout ``csrc/chain_compact.cu``
    states (four control words, a sum and a start per tile of 256 buckets,
    two words a bucket, four a node)."""
    return 4 + 2 * ((nbuckets + 255) // 256) + 2 * nbuckets + 4 * n


def chain_compact(fields, hfn, nbuckets: int, where=None,
                  dirty_cap: int = -1):
    """The chain arena's compaction, guarded on the device, IN PLACE.

    ``fields`` are a chain table's (akey, aval, astate, anext, heads,
    free_stack, free_top, bstart, blen, sorted_upto), ``hfn`` its hash
    function over ``nbuckets`` buckets.  It runs where ``where`` (a 0-dim
    bool on the device, or None) is set and, with ``dirty_cap`` >= 0, the
    dirty tail is longer than ``dirty_cap``; elsewhere the launch returns at
    once.  Where it runs it writes what ``ops.chain_compact_fused`` returns:
    the live nodes packed in (bucket, arena index) order, the links, the
    free stack, the bucket offsets (``csrc/chain_compact.cu``: no sort of the
    arena; it reads the layout the last compaction left)."""
    akey = fields[0]
    if akey.device.type == "cpu":
        return chain_compact_plain(fields, hfn, nbuckets, where, dirty_cap)
    _check(*((f, I32) for f in fields), (hfn.seeds, torch.int64))
    if where is not None:
        _check((where, torch.bool))
        if where.numel() != 1:
            raise ValueError("chain_compact: the flag must be one bool")
    n, dev = akey.numel(), akey.device
    scratch = torch.empty(compact_scratch_words(n, nbuckets), dtype=I32,
                          device=dev)
    _launch("chain_compact", chain_compact, dev, *fields, n, nbuckets,
            hashing.HASH_KINDS.index(hfn.kind), hfn.seeds, where, dirty_cap,
            scratch)


# ---------------------------------------------------------------------------
# epoch_swap
# ---------------------------------------------------------------------------
#
# A table's leaves come with what the rebuild start's clear writes into them:
# ("fill", v) — every word v; ("desc",) — n - 1 - i (a chain free stack);
# ("seeds", kind, salt_offset) — a hash function's seeds, reseeded as
# ``hashing.reseed(fn, epoch + 1 + salt_offset)``.

_LEAF_MODE = {"fill": 0, "desc": 1, "seeds": 2}


def _epoch_flags(hazard_live, cursor, rebuilding, capacity: int, swap: bool,
                 start: bool):
    go_swap = rebuilding & (cursor.long() >= capacity) & ~hazard_live.any()
    if not swap:
        go_swap = torch.zeros_like(go_swap)
    go_start = (go_swap | ~rebuilding) if start \
        else torch.zeros_like(go_swap)
    return go_swap, go_start


def _cleared(spec, x: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """What the rebuild start writes into leaf ``x`` under ``spec``."""
    if spec[0] == "fill":
        return torch.full_like(x, spec[1])
    if spec[0] == "desc":
        n = x.numel()
        return (n - 1 - torch.arange(n, dtype=x.dtype,
                                     device=x.device)).view(x.shape)
    _, kind, off = spec
    return hashing.reseed(hashing.HashFn(kind=kind, seeds=x),
                          salt + off).seeds


def epoch_swap_plain(old, new, specs, hazard_live, cursor, rebuilding, epoch,
                     lookups, expensive, capacity: int, swap: bool,
                     start: bool, go=None) -> torch.Tensor:
    """Plain version of ``epoch_swap``: the same decisions as tensors, the
    leaves selected with ``torch.where`` in place; a stack table by table.
    Returns go[2] bool (go[T, 2])."""
    if cursor.dim() == 1:
        return torch.stack([epoch_swap_plain(
            [a[i] for a in old], [b[i] for b in new], specs, hazard_live[i],
            cursor[i], rebuilding[i], epoch[i], lookups[i], expensive[i],
            capacity, swap, start, _row(go, i))
            for i in range(cursor.shape[0])])
    if go is None:
        go_swap, go_start = _epoch_flags(hazard_live, cursor, rebuilding,
                                         capacity, swap, start)
    else:
        go_swap, go_start = go[0], go[1]
    salt = (epoch + go_swap.to(I32) + 1).to(I32)
    for a, b, spec in zip(old, new, specs):
        a0 = a.clone()
        a.copy_(torch.where(go_swap, b, a))
        mid = torch.where(go_swap, a0, b)
        b.copy_(torch.where(go_start, _cleared(spec, mid, salt), mid))
    epoch.add_(go_swap.to(I32))
    for x in (lookups, expensive):
        x.copy_(torch.where(go_swap, 0, x))
    cursor.copy_(torch.where(go_swap | go_start, 0, cursor))
    rebuilding.copy_(go_start | (rebuilding & ~go_swap))
    return torch.stack([go_swap, go_start])


# the leaf descriptors of the last calls, by their contents (the leaves'
# pointers, sizes and modes): the tables' tensors never move, so an engine
# step finds its descriptor and its go buffer here
_EPOCH_DESC: dict = {}
_EPOCH_DESC_KEEP = 16


def _epoch_desc(old, new, specs, dev, n: int = 1):
    """(descriptor, go buffer) of the leaves of ``n`` stacked tables: one
    row of five int64 words a leaf (old pointer, new pointer, a table's
    elements, mode, fill), a CPU tensor the C side reads when it launches,
    and go [2] (one table) or [n, 2]."""
    rows = []
    for a, b, spec in zip(old, new, specs, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError("epoch_swap: the two tables' leaves differ")
        mode = _LEAF_MODE[spec[0]]
        if spec[0] == "seeds":
            _check((a, torch.int64), (b, torch.int64))
            mode += spec[1] == "multiply_shift"
            fill = spec[2]
        else:
            _check((a, I32), (b, I32))
            fill = spec[1] if spec[0] == "fill" else 0
        rows.append((a.data_ptr(), b.data_ptr(), a.numel() // n, mode, fill))
    key = (dev, n, tuple(rows))
    hit = _EPOCH_DESC.pop(key, None)
    if hit is None:
        hit = (torch.tensor(rows, dtype=torch.int64).reshape(-1),
               torch.empty((n, 2) if n > 1 else (2,), dtype=torch.bool,
                           device=dev))
        while len(_EPOCH_DESC) >= _EPOCH_DESC_KEEP:
            _EPOCH_DESC.pop(next(iter(_EPOCH_DESC)))
    _EPOCH_DESC[key] = hit
    return hit


def epoch_swap(old, new, specs, hazard_live, cursor, rebuilding, epoch,
               lookups, expensive, capacity: int, swap: bool,
               start: bool, go=None) -> torch.Tensor:
    """The epoch swap and the next rebuild's start, decided on the device,
    IN PLACE.

    ``old`` / ``new`` are the two tables' tensor leaves in one order (same
    shapes), ``specs`` what a rebuild start clears each to (see above).
    ``swap`` (when the old and new tables share shapes) allows the swap,
    taken where ``rebuilding`` is set, ``cursor >= capacity`` and no hazard
    entry is live — the reference's ``finish_same_shape``: the leaves'
    contents change places, cursor / lookups / expensive go to 0, rebuilding
    falls, the epoch counter rises.  ``start`` (continuous rebuild) allows
    the start, taken after a swap or where no rebuild runs — the
    reference's ``rebuild_autostart``: the new table is cleared, its hash
    functions reseeded from the new epoch + 1, rebuilding rises, cursor 0.

    ``go`` (bool[2] on the device, from ``transition``) gives the decision:
    one launch, the exchange (``csrc/epoch_swap.cu``).  Without it this
    call decides first from ``hazard_live``, ``cursor`` and ``rebuilding``
    (a second kernel; ``epoch_swap.launches`` counts both) into a buffer
    kept with the leaves' descriptor, valid until the next call on the same
    leaves.  Returns go[2] bool on the device: (swapped, started).

    A table stack (``cursor`` [T]): every leaf [T, ...], the scalars [T],
    ``hazard_live`` [T, chunk], ``go`` [T, 2]; each table decides, swaps,
    clears and reseeds (from its own epoch + 1 and its own seeds) on its
    own row, one call for all T.  Returns go[T, 2]."""
    dev = cursor.device
    if dev.type == "cpu":
        return epoch_swap_plain(old, new, specs, hazard_live, cursor,
                                rebuilding, epoch, lookups, expensive,
                                capacity, swap, start, go)
    n = cursor.numel()
    desc, own = _epoch_desc(old, new, specs, dev, n)
    _check((cursor, I32), (epoch, I32), (lookups, I32), (expensive, I32),
           (rebuilding, torch.bool), (hazard_live, torch.bool))
    if cursor.dim():
        _stack_of(n, *old, epoch, lookups, expensive, rebuilding,
                  hazard_live)
    decide = go is None
    if decide:
        go = own
    else:
        _check((go, torch.bool))
        if go.numel() != 2 * n:
            raise ValueError("epoch_swap: go must be two bools a table")
    _launch("epoch_swap", epoch_swap, dev, desc, len(old),
            hazard_live if decide else None, hazard_live.shape[-1], cursor,
            rebuilding, epoch, lookups, expensive, capacity, int(swap),
            int(start), go, n)
    epoch_swap.launches += decide               # the decision's kernel
    return go


reset_launches()
