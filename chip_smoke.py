#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (written
for an H100) and the CUDA toolkit:

    python3 chip_smoke.py            # everything, as described below
    python3 chip_smoke.py --steps 300 --tc-steps 300 --cuckoo-steps 300 \
        --big-steps 16  # shorter
    python3 chip_smoke.py --profile build/profile.txt  # + profiler tables
    python3 chip_smoke.py --baseline OTHER/build/repro_torch_kernels
        # phase 2 also runs another tree's probe_lookup, probe2,
        # probe_insert, tc_lookup, tc_insert, tc_probe2, chain_probe,
        # chain_probe2 and chain_compact on its timed inputs, its tc_insert and cuckoo_kick
        # as the cuckoo insert, and its sequence for a rebuild transition
        # and the epoch exchange (extract, epoch_swap and the PyTorch ops
        # around them), in turns with this tree's

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and then

1. prints the environment (torch / CUDA / nvcc, the card and its power limit);
2. holds every kernel against its plain PyTorch version on the card at the
   shapes of the ``dhash-paper`` configuration, exact equality, on inputs
   chosen to hurt (tombstones, migrated slots, wrap-around, one hot start
   slot or row pair, full rows, rows a == b, duplicates, ragged batch sizes,
   a partial last chunk, killed hazard entries, a new table 4x the old with
   a bucket count that is not a power of two; for chain hits in the sorted
   segments and the dirty tail, a segment longer than max_chain, a tail
   longer than the window, empty buckets; for the four kernels that stage
   their buffers as hashed sets, duplicate live hazard keys with dead
   entries between them, an empty and a full hazard buffer, a buffer whose
   keys all share one home slot of the index, duplicate live keys and dead
   nodes in both dirty tails, batches of 1, 33 and 256 queries; for the
   linear insert, tables of 64, 100 and 4096 slots, a full table, windows
   wider than the table or than 64 slots, a group on the last start slot
   of a block's range, wrapping runs, keys all present, TOMB and MIGRATED
   slots taken, a landing-shaped batch, one query, 3000 keys on one start
   slot at the head of a batch of 20000; for the two-row insert, 2048 keys
   on one row, a full table, one query, widths 4 and 8, two and eight
   rounds; the cuckoo kick-out at the main path's
   load, under a flood, on a crowded table and with nothing pending, alone
   and as the cuckoo insert runs it (in tc_insert's resolve); for the
   lookup both forms, start slots given and hashed in the kernel, with
   walks that wrap, tables not 16-byte aligned and all three hash kinds; for
   the two-row lookup both forms, rows given and hashed in the kernel at
   both b-row offsets (twochoice and cuckoo), at the lookup's and the
   delete's batch sizes, with one hash function for both rows, widths 4, 6,
   12 and 16, a table not 16-byte aligned and all three hash kinds; the
   guarded extract; the rebuild step's transition (the landing's
   bookkeeping, the guarded scan and the epoch decision in one extract
   launch) on every backend's tables with hazard flags empty, partial and
   full, the landing's ok / present all, none and random, the cursor on
   the first, a middle (aligned and not), the partial last chunk and at
   the end, rebuilding on and off, swap and start allowed or not; the
   epoch swap's exchange on every backend's tables on its own decision and
   on a given go, and on leaves that are not 16-byte aligned; ``probe2``
   with new tables twice, four times and a quarter of the old, and the
   linear rebuild step (landing insert and transition) across those
   sizes, as a resize runs it; the chain
   compaction after a user insert, with its guard off, on a full arena, on
   floods of one bucket and of eight buckets in eight tiles, on listed
   buckets at tile edges and on a tail of dead nodes; and the four kernels
   with a table axis — ``probe2``, ``probe_insert``, the transition and
   ``epoch_swap`` — at T = 8 tables of 2^21 slots in mixed states: tables
   mid-rebuild at three cursors, a live hazard buffer on three, idle ones,
   an exchange that swaps two tables and starts a third), ``tc_probe2``
   and ``tc_insert`` (twochoice, and cuckoo with its kick-out) with the
   table axis at T = 8 two-row tables of the main path's shapes (three
   mid-rebuild with live hazard buffers, idle ones, one under a 2048-key
   flood of one row pair, one full; each inserting into its target by its
   flag) and the crowded kick-out at T = 8 against one of its tables, and
   times kernel and plain version;
3. drives the main path of each backend — ``dhash.make(backend,
   fused=True)`` with ``backend`` linear (a), twochoice (b), cuckoo (c) and
   chain (d) at the unreduced ``dhash-paper`` size under ``DHashEngine``
   with continuous rebuild — through complete live hash-function swaps (one
   for linear by default, two or more for the others), checking every
   step's outputs against a dense numpy oracle, the kernel launch counts of
   every step and, on a two-row table, that every refused insert found both
   its rows full (on chain: that the free stack was empty); the cuckoo path
   also takes a collision flood mid-epoch (2048 keys to one row) and must
   keep every acknowledged key through the next swap; (e) runs the chain
   arm of the collision-flood benchmark (2048 keys into one bucket, then a
   live swap) and reports its four lookup rates; (f) holds each backend's
   engine, replaying its step from a CUDA graph, to the same engine in the
   eager mode across a live swap (tolerance 0, one key held), with the
   oracle checking every step, and the launches its replays credit to the
   kernels the profiler sees; (g) runs linear under the elastic policy: a
   burst that grows the table to 2^22 slots, a drain during which a
   tombstone reclaim fires on the device, and the shrink to 2^20, every
   answer checked by the oracle and a stretch held to an eager twin;
   (h) drives a linear table stack (``DHashStackEngine``, 8 tables of the
   unreduced shard, each its shard's traffic a step) through staggered
   live swaps against a dense oracle a table on the device, with its
   tables' single-table twins over a stretch across a swap (answers and
   every state tensor equal), its launches a step (one of each of the four
   kernels' launches a single-table step makes, whatever T) held to the
   profiler, and its step timed against eight single-table engines in
   turn; (i) runs the same stack under the policy, deletes draining two
   tables until each fires its rehash on the device between polls; (j)
   replays the routed service step (``distributed.routed_service_step``)
   of four unreduced linear shards in one process from one CUDA graph
   through a live swap of every shard, against a dense oracle on the
   device and an eager twin, then at cap_factor 2.0 and 1.0, its launches
   held to the profiler and the router timed by op; (k) routes 2 shards x
   8 tenants (linear, then cuckoo) under zipf and one-tenant skew through
   the overflow-proof and a compact spill slab: overflow and dropped
   against a host histogram, one lookup-kernel launch a routed stack
   lookup.
   Every engine step of phases 3-5 is replayed from a CUDA graph (the
   engine's own cache: the first step of a key runs eagerly and is
   captured), but for the reference engines of 3f, 3g and 4, which run in
   the eager mode;
4. runs the same engines in lock step with the port's own plain
   (``fused=False``) path on the card for one epoch at a smaller table;
5. repeats a short stretch of the linear main path on a table far larger
   than the L2 cache (2**25 slots).

Any failed check raises, so the process exits non-zero and prints no result
line.  The last line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is one JSON object describing every kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# one 32-bit integer operation a float32 lane a clock: half of the data
# sheet's 67 TFLOP/s (which counts a fused multiply-add as two)
INT_OPS_PER_S = 33.5e12

KERNEL_INFO = {
    "probe_lookup": ("src/repro_torch/kernels/csrc/probe_lookup.cu",
                     "src/repro/kernels/probe.py:163"),
    "probe2": ("src/repro_torch/kernels/csrc/probe2.cu",
               "src/repro/kernels/probe.py:178"),
    "probe_insert": ("src/repro_torch/kernels/csrc/probe_insert.cu",
                     "src/repro/kernels/probe.py:244"),
    "extract": ("src/repro_torch/kernels/csrc/extract.cu",
                "src/repro/kernels/probe.py:463"),
    "tc_lookup": ("src/repro_torch/kernels/csrc/tc_lookup.cu",
                  "src/repro/kernels/probe.py:574"),
    "tc_insert": ("src/repro_torch/kernels/csrc/tc_insert.cu",
                  "src/repro/kernels/probe.py:592"),
    "tc_probe2": ("src/repro_torch/kernels/csrc/tc_probe2.cu",
                  "src/repro/kernels/probe.py:732"),
    "chain_probe": ("src/repro_torch/kernels/csrc/chain_probe.cu",
                    "src/repro/kernels/probe.py:906"),
    "chain_probe2": ("src/repro_torch/kernels/csrc/chain_probe2.cu",
                     "src/repro/kernels/probe.py:925"),
    # no pallas_call: the reference's XLA code behind lax.cond
    "cuckoo_kick": ("src/repro_torch/kernels/csrc/cuckoo_kick.cu",
                    "src/repro/core/backend.py:446"),
    "epoch_swap": ("src/repro_torch/kernels/csrc/epoch_swap.cu",
                   "src/repro/core/dhash.py:433"),
    "chain_compact": ("src/repro_torch/kernels/csrc/chain_compact.cu",
                      "src/repro/core/backend.py:624"),
}
BACKENDS = ("linear", "twochoice", "cuckoo", "chain")
# the kernels each backend's main path runs: (lookup, insert, rebuild-epoch
# probe); the extract kernel is shared
PATH_KERNELS = {"linear": ("probe_lookup", "probe_insert", "probe2"),
                "twochoice": ("tc_lookup", "tc_insert", "tc_probe2"),
                "cuckoo": ("tc_lookup", "tc_insert", "tc_probe2"),
                "chain": ("chain_probe", "chain_probe", "chain_probe2")}


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    integer operations over the peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return dict(bound_ms=max(tb, to) * 1e3,
                bound_by="bytes" if tb >= to else "operations")


def log(*a):
    print(*a, flush=True)


OUTPUTS = ("found", "val", "f_old", "loc_old", "hz_idx", "loc_new")
# the kernels --baseline runs from another tree, in turns with this tree's
BASELINE_KERNELS = ("probe_lookup", "probe2", "probe_insert", "tc_lookup",
                    "tc_insert", "tc_probe2", "chain_probe", "chain_probe2",
                    "cuckoo_kick", "chain_compact")
# ... and the two whose C interfaces changed, as the sequence the other tree
# runs for one rebuild transition and the exchange behind it
# (``baseline_sequence``)
BASELINE_SEQUENCE = ("extract", "epoch_swap")
SET_LOOKUP_OPS = 4      # a staged-set lookup: hash, probe, compare, select


def set_shift(n: int) -> int:
    """32 - log2 of the index size of an ``n``-entry staged set
    (``dhash_set_slots`` in ``dhash_common.cuh``)."""
    slots = 2
    while slots < 2 * n:
        slots <<= 1
    return 33 - slots.bit_length()


def set_home(keys: np.ndarray, n: int) -> np.ndarray:
    """The home slot of each key in the index of an ``n``-entry staged set
    (``dhash_set_home``: the top bits of key * 0x9E3779B1 mod 2^32)."""
    k = keys.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    return ((k * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)) >> \
        np.uint64(set_shift(n))


def one_run_keys(n: int, rng) -> np.ndarray:
    """``n`` distinct keys that all have one home slot in the index of an
    ``n``-entry staged set: every key in one probe run, the worst case."""
    shift = set_shift(n)
    inv = pow(0x9E3779B1, -1, 1 << 32)
    prod = (np.uint64(1234) << np.uint64(shift)) + rng.choice(
        1 << shift, n, replace=False).astype(np.uint64)
    keys = ((prod * np.uint64(inv)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)
    check(np.unique(set_home(keys, n)).size == 1, "one_run_keys: two homes")
    return keys


def hazard_cases(hk, hv, hl, rng, device) -> dict:
    """Hazard buffers of the size of ``hk`` for the staged set, each with
    the keys to query in it: ``duplicates`` (a quarter of the live entries
    give their key to two more live entries at higher indices, with other
    values; a third of those lowest copies and another third of the middle
    ones killed; dead entries between them), ``empty`` (nothing live),
    ``full`` (every entry live, distinct fresh keys) and ``one_run`` (every
    entry live, every key with one home slot in the kernels' index)."""
    ch = hk.numel()
    live = hl.nonzero().squeeze(1)
    perm = live[torch.as_tensor(rng.permutation(live.numel()), device=device)]
    m = live.numel() // 4
    a, b, c = perm[:3 * m].view(m, 3).sort(dim=1).values.unbind(1)
    dk, dv, dl = hk.clone(), hv.clone(), hl.clone()
    dk[b], dk[c] = dk[a], dk[a]
    dv[b], dv[c] = dv[a] + 1, dv[a] + 2
    dl[a[: m // 3]] = False
    dl[b[m // 3: 2 * m // 3]] = False
    fresh = np.unique(rng.integers(-(1 << 31), -(1 << 30), 2 * ch))
    fk = torch.as_tensor(rng.permutation(fresh)[:ch].astype(np.int32),
                         device=device)
    rk = torch.as_tensor(one_run_keys(ch, rng), device=device)
    ones = torch.ones_like(hl)
    return {"duplicates": (dk, dv, dl, dk[a]),
            "empty": (hk, hv, torch.zeros_like(hl), hk[live]),
            "full": (fk, fk * 5 + 1, ones, fk),
            "one_run": (rk, rk * 5 + 1, ones, rk)}


def load_baseline(path: str) -> dict:
    """The C entry points of the kernels that ``--baseline`` times from
    another tree's build directory, with the argument types that tree's
    own ``build.py`` declares (``path`` is ``<tree>/build/repro_torch_kernels``).
    ``probe_insert`` and ``tc_insert`` come as functions with the arguments
    of this tree's wrappers; ``tc_insert`` through either C interface the
    other tree may have: the cooperative one with a claim word a slot and a
    pending counter (17 arguments), the bid / resolve one without the
    kick-out (18), or this tree's without the table axis (23), or with it
    (30: called for one table by ``baseline_one_table``).  ``probe_lookup``
    and ``tc_lookup`` come as entry points with this tree's arguments (``baseline_lookup``: start slots
    given only; ``baseline_tc_lookup``: rows given only);
    ``cuckoo_kick`` as it is (its C interface did not change).  ``extract`` and
    ``epoch_swap`` come as one function, the other tree's rebuild
    transition and exchange (``baseline_sequence``)."""
    import ctypes
    import glob
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    spec = importlib.util.spec_from_file_location(
        "baseline_build", os.path.join(root, "src", "repro_torch", "kernels",
                                       "build.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    out = {}
    for name in BASELINE_KERNELS + BASELINE_SEQUENCE:
        found = glob.glob(os.path.join(path, f"{name}-*.so"))
        check(len(found) == 1, f"--baseline: {len(found)} builds of {name} "
                               f"in {path}")
        fn = getattr(ctypes.CDLL(found[0]), f"dhash_{name}")
        fn.argtypes = other._ARGTYPES[f"dhash_{name}"]
        fn.restype = ctypes.c_int
        out[name] = fn
    for name in ("probe2", "probe_insert", "extract", "epoch_swap",
                 "tc_probe2", "tc_insert"):
        out[name] = baseline_one_table(name, out[name])
    out["probe_lookup"] = baseline_lookup(out["probe_lookup"])
    out["tc_lookup"] = baseline_tc_lookup(out["tc_lookup"])
    out["probe_insert"] = baseline_insert(out["probe_insert"])
    out["tc_insert"] = baseline_tc_insert(out["tc_insert"])
    out["chain_compact"] = baseline_compact(out["chain_compact"])
    out["sequence"], out["epoch_swap"] = baseline_sequence(
        out.pop("extract"), out.pop("epoch_swap"))
    return out


def baseline_one_table(name: str, fn):
    """Another tree's entry point of a kernel that has the table axis here
    (``probe2``, ``probe_insert``, ``extract``, ``epoch_swap``,
    ``tc_probe2``, ``tc_insert``): where that tree's has no table axis (its
    arguments are this tree's but for those of the axis, which come last
    before the stream), a function taking this tree's arguments for one
    table (T = 1, the axis's pointers null and its strides 0) and calling
    it without them.  The result keeps the other entry point's
    ``argtypes``."""
    from repro_torch.kernels import build
    axis = {"probe2": 2, "probe_insert": 5, "extract": 1, "epoch_swap": 1,
            "tc_probe2": 4, "tc_insert": 7}
    k = len(fn.argtypes) - 1
    if len(fn.argtypes) != len(build._ARGTYPES[build._ENTRY[name]]) \
            - axis[name]:
        return fn

    def call(*argv):
        axis = argv[k:-1]
        check(axis[0] == 1 and all(a is None or a == 0 for a in axis[1:]),
              f"--baseline {name}: that tree's kernel takes one table")
        return fn(*argv[:k], argv[-1])
    call.argtypes = fn.argtypes
    return call


def baseline_sequence(extract_fn, swap_fn):
    """What an engine step of another tree runs for one rebuild transition
    after its landing and for the exchange behind it, on that tree's C
    entry points ``extract_fn`` (the guarded scan, 13 arguments: run and
    hold, no landing, no decision) and ``swap_fn`` (the decision kernel and
    the exchange): ``pending = hazard_live.any()``, ``hazard_live &= ~ok &
    ~present`` (PyTorch ops), the scan held on ``pending``, then the
    epoch_swap call; the arguments of ``transition_step``.  Also that
    tree's ``epoch_swap`` alone (its decision and its exchange), with the
    arguments of ``probe.epoch_swap`` but ``go``.  A tree whose ``extract``
    has this tree's C interface (the transition) runs
    ``transition_step`` on its own two entry points."""
    from repro_torch.core import backend
    from repro_torch.kernels import probe
    if len(extract_fn.argtypes) >= 18:      # the transition's interface
        def run_same(e, ok, present, swap, start):
            with swapped("extract", extract_fn), \
                    swapped("epoch_swap", swap_fn):
                return transition_step(e, ok, present, swap, start)

        def exchange_same(*a):
            with swapped("epoch_swap", swap_fn):
                return probe.epoch_swap(*a)
        return run_same, exchange_same
    descs = {}

    def exchange(old, new, specs, hl, cursor, rebuilding, epoch, lookups,
                 expensive, capacity, swap, start):
        key = tuple(x.data_ptr() for x in old + new)
        if key not in descs:
            descs[key] = (probe._epoch_desc(old, new, specs,
                                            cursor.device)[0],
                          torch.empty(2, dtype=torch.bool,
                                      device=cursor.device))
        desc, go = descs[key]
        ptr = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in (
            desc, len(old), hl, hl.shape[0], cursor, rebuilding, epoch,
            lookups, expensive, capacity, int(swap), int(start), go)]
        check(swap_fn(*ptr, torch.cuda.current_stream().cuda_stream) == 0,
              "--baseline epoch_swap was not launched")
        return go

    def run(e, ok, present, swap, start):
        hk, hv, hl = e.hazard_key, e.hazard_val, e.hazard_live
        pending = hl.any()
        hl.copy_(hl & ~ok & ~present)
        arrays = scan_arrays(e.old)
        stream = torch.cuda.current_stream().cuda_stream
        ptr = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in (
            *arrays, arrays[0].numel(), e.cursor, e.chunk, hk, hv, hl,
            e.cursor, e.rebuilding, pending)]
        check(extract_fn(*ptr, stream) == 0,
              "--baseline extract was not launched")
        lo, ln = backend.epoch_leaves(e.old), backend.epoch_leaves(e.new)
        return exchange([x for x, _ in lo], [x for x, _ in ln],
                        [s for _, s in lo], hl, e.cursor, e.rebuilding,
                        e.epoch, e.lookups, e.expensive, arrays[0].numel(),
                        swap, start)
    return run, exchange


def variant_entry(source: str, old: str, new: str, *more: str):
    """This tree's C entry point of ``csrc/<source>.cu`` built from that
    source with the text ``old`` (found once) replaced by ``new`` (and each
    further pair of ``more`` likewise), into the build directory: a variant
    that a design choice is timed against, in turns with the kernel as it
    stands."""
    import ctypes
    import hashlib
    from repro_torch.kernels import build
    src = (build.CSRC / f"{source}.cu").read_text()
    pairs = [(old, new), *zip(more[::2], more[1::2])]
    for a, b in pairs:
        check(src.count(a) == 1, f"variant of {source}: {a!r} not found once")
        src = src.replace(a, b)
    tag = hashlib.sha256((build.source_hash() + src).encode()).hexdigest()
    out = build.build_dir() / f"variant-{source}-{tag[:16]}"
    so = out / f"{source}.so"
    if not so.is_file():            # built once a run
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{source}.cu").write_text(src)
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                            str(build.CSRC), "-o", str(so),
                            str(out / f"{source}.cu")],
                           capture_output=True, text=True)
        check(r.returncode == 0, f"the variant of {source} did not build:\n"
                                 f"{r.stdout}{r.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), build._ENTRY[source])
    fn.argtypes = build._ARGTYPES[build._ENTRY[source]]
    fn.restype = ctypes.c_int
    return fn


def scan_arrays(t) -> tuple:
    """The flat (key, val, state) arrays a table's rebuild scan reads."""
    if hasattr(t, "akey"):
        return t.akey, t.aval, t.astate
    return t.key.view(-1), t.val.view(-1), t.state.view(-1)


def transition_step(e, ok, present, swap, start):
    """This tree's rebuild transition after the landing and the exchange
    behind it, as an engine step launches them: one ``extract`` launch
    (``probe.transition``), one ``epoch_swap`` launch on its go."""
    from repro_torch.core import backend
    from repro_torch.kernels import probe
    go = backend.get(e.backend).transition_fused(
        e.old, e.cursor, e.chunk, (e.hazard_key, e.hazard_val,
                                   e.hazard_live), e.rebuilding, ok, present,
        swap, start)
    lo, ln = backend.epoch_leaves(e.old), backend.epoch_leaves(e.new)
    return probe.epoch_swap([x for x, _ in lo], [x for x, _ in ln],
                            [s for _, s in lo], e.hazard_live, e.cursor,
                            e.rebuilding, e.epoch, e.lookups, e.expensive,
                            backend.get(e.backend).capacity_of(e.old), swap,
                            start, go)


def transition_step_plain(e, ok, present, swap, start):
    """``transition_step`` with the plain versions."""
    from repro_torch.core import backend
    from repro_torch.kernels import probe
    go = probe.transition_plain(
        *scan_arrays(e.old), e.cursor, e.chunk,
        (e.hazard_key, e.hazard_val, e.hazard_live), e.rebuilding, ok,
        present, swap, start)
    lo, ln = backend.epoch_leaves(e.old), backend.epoch_leaves(e.new)
    return probe.epoch_swap_plain([x for x, _ in lo], [x for x, _ in ln],
                                  [s for _, s in lo], e.hazard_live,
                                  e.cursor, e.rebuilding, e.epoch, e.lookups,
                                  e.expensive,
                                  backend.get(e.backend).capacity_of(e.old),
                                  swap, start, go)


def baseline_compact(fn):
    """Another tree's ``dhash_chain_compact`` entry point ``fn`` for this
    tree's wrapper to call: the same arguments, but a scratch of the
    largest layout that tree may have, 3 + 3 nb + 5 n words (the one-block
    scan's; this tree's wrapper sizes the scratch for its own kernel)."""
    scratch = {}

    def call(*argv):
        n, nb = argv[10], argv[11]
        if (n, nb) not in scratch:
            scratch[n, nb] = torch.empty(3 + 3 * nb + 5 * n,
                                         dtype=torch.int32, device="cuda")
        argv = list(argv)
        argv[16] = scratch[n, nb].data_ptr()
        return fn(*argv)
    return call


def baseline_insert(fn):
    """``probe.probe_insert`` on another tree's C entry point ``fn``."""
    def insert(tk, tv, ts, h0, keys, vals, mask, max_probes):
        c, q, dev = tk.shape[0], keys.shape[0], tk.device
        ok = torch.empty(q, dtype=torch.bool, device=dev)
        present = torch.empty(q, dtype=torch.bool, device=dev)
        # one table: no alternative target
        args = (tk, tv, ts, c, h0, keys, vals, mask, q, max_probes, ok,
                present, torch.empty(q, dtype=torch.int32, device=dev), 1,
                None, None, None, None)
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"--baseline probe_insert was not launched: {err}")
        return ok, present
    return insert


def baseline_tc_insert(fn):
    """``probe.tc_insert`` on another tree's C entry point ``fn``.  Where
    that tree's interface folds the kick-out in the resolve (23 arguments,
    or 30 with the table axis; a 23-argument one comes here through
    ``baseline_one_table``), the function carries the entry point as
    ``entry``, so that the other tree's cuckoo insert is its own folded
    launch."""
    from repro_torch.kernels import probe
    claims = {}

    def insert(tk, tv, ts, ra, rb, keys, vals, mask, max_rounds):
        q, dev, w = keys.shape[0], tk.device, tk.shape[1]
        if len(fn.argtypes) in (23, 30):
            if tk.shape[0] not in claims:
                claims[tk.shape[0]] = probe.new_claim(tk.shape[0], dev)
            with swapped("tc_insert", fn):
                return probe.tc_insert(tk, tv, ts, ra, rb, keys, vals, mask,
                                       max_rounds, claims[tk.shape[0]])
        ok = torch.empty(q, dtype=torch.bool, device=dev)
        present = torch.empty(q, dtype=torch.bool, device=dev)
        i32 = torch.int32
        if len(fn.argtypes) == 17:      # a claim word a slot, cooperative
            if tk.numel() not in claims:
                claims[tk.numel()] = probe.new_claim(tk.numel(), dev)
            args = (tk, tv, ts, claims[tk.numel()], w, ra, rb, keys, vals,
                    mask, q, max_rounds, ok, present,
                    torch.empty(q, dtype=i32, device=dev),
                    torch.zeros(1, dtype=i32, device=dev))
        else:
            if tk.shape[0] not in claims:
                claims[tk.shape[0]] = probe.new_claim(tk.shape[0], dev)
            args = (tk, tv, ts, claims[tk.shape[0]], w, ra, rb, keys, vals,
                    mask, q, max_rounds, ok, present,
                    torch.empty(q, dtype=i32, device=dev),
                    torch.empty(q, dtype=i32, device=dev),
                    torch.empty(2, dtype=i32, device=dev))
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"--baseline tc_insert was not launched: {err}")
        return ok, present
    insert.entry = fn if len(fn.argtypes) in (23, 30) else None
    return insert


def compare_cases(name: str, kernel, plain, cases: dict, reps: int,
                  baseline: dict | None, outputs=OUTPUTS) -> dict:
    """Each case's arguments through the kernel and its plain version
    (exact equality) and timed.  With a baseline the other tree's kernel is
    held against the plain version too and the two are timed in turns,
    baseline, this tree, this tree, baseline, on the same inputs."""
    from repro_torch.kernels import build
    lib = build.load()
    out = {}
    for label, args in cases.items():
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for x, y, n in zip(got, want, outputs):
            same(x, y, f"{name} {label} {n}")
        entry = {}
        if baseline is None:
            entry["ms"] = time_ms(lambda: kernel(*args), reps)
        else:
            mine = lib[name]
            try:
                lib[name] = baseline[name]
                for x, y, n in zip(kernel(*args), want, outputs):
                    same(x, y, f"{name} (baseline) {label} {n}")
                t = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    lib[name] = baseline[name] if who == "parent" else mine
                    t[who].append(time_ms(lambda: kernel(*args), reps))
            finally:
                lib[name] = mine
            entry["ms"], entry["parent_ms"] = t["this"], t["parent"]
        out[label] = entry
        log(f"    {name} {label}: equal to the plain version; ms "
            + json.dumps(entry))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi gave no output"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """Exact equality of two tensors; returns the max abs difference (0)."""
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: shape/dtype {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    check(err == 0, f"{what}: kernel and plain version differ (max abs {err},"
                    f" {int((a != b).sum())} of {a.numel()} elements)")
    return err


def time_ms(fn, reps: int, setup=None, queue_ahead: bool = True) -> float:
    """Median device time of ``fn`` over ``reps`` calls: a CUDA event before
    and after each call, read after one synchronise at the end.  The stream
    is first kept busy long enough for the host to queue all the calls ahead
    of the device (at least 60M clocks, and 2.5x the host's own time for
    ``reps`` calls, measured on a warm-up call): the events then bracket the
    device's own time, not the host's time to enqueue the work.  ``setup``
    (restoring mutated inputs) runs before each call, outside its events.
    ``queue_ahead=False`` is for the plain versions, which synchronise
    inside."""
    for _ in range(2):          # warm-up
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queue_ahead:
        # clock rate of the card: about 2e9 cycles a second
        torch.cuda._sleep(int(max(6e7, 2.5 * reps * host_s * 2e9)))
    evs = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def port_kernel_sources() -> dict:
    """``__global__`` function name -> the source whose wrapper launches
    it (each ``csrc/<name>.cu`` belongs to the wrapper ``probe.<name>``)."""
    from repro_torch.kernels import build
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)")
    return {m.group(1): p.stem for p in build.CSRC.glob("*.cu")
            for m in pat.finditer(p.read_text())}


def port_kernel_names() -> set:
    """The names of the ``__global__`` functions of the port's sources."""
    return set(port_kernel_sources())


def lookup_batches(events) -> list:
    """A steady step launches its lookup kernel twice, on the lookup's
    batch (65536 queries) and on the delete's (8192), each launch inside a
    range named by its batch.  The profiler gives each range a span on the
    device over the kernels launched in it (one launch a range): a row a
    batch of the launches and µs a launch, and of the ranges whose launch
    the profiler lost."""
    from torch.autograd import DeviceType
    spans, calls = {}, {}
    for e in events:
        if e.name.startswith("batch of "):
            if e.device_type == DeviceType.CPU:
                calls[e.name] = calls.get(e.name, 0) + 1
            else:
                spans.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
    rows = []
    for name in sorted(calls):
        us = spans.get(name, [])
        rows.append(f"  {name}: {len(us)} launches"
                    + (f", {statistics.mean(us):.3f} us a launch "
                       f"({min(us):.3f}-{max(us):.3f})" if us else "")
                    + f"; {calls[name] - len(us)} of {calls[name]} ranges "
                    f"lost their launch")
    return rows


def profile_steps(eng, oracle, cfg, n_steps: int, step0: int, path: str,
                  steady: bool = False):
    """``n_steps`` more engine steps under torch.profiler; writes the kernel
    table, the device's busy share and the PyTorch ops a step by name to
    ``path`` (``steady``: also logs them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import probe
    batches = [oracle.batch(cfg.lookups_per_step, cfg.updates_per_step,
                            step0 + s) for s in range(n_steps)]
    # steady: each launch of a lookup kernel's hashed wrapper runs inside a
    # range named by its wrapper and batch size (``lookup_batches``; the
    # position of qkey in the wrapper's arguments by name)
    qkey_at = {"probe_lookup_hashed": 4, "tc_lookup_hashed": 7}
    saved = {n: getattr(probe, n) for n in qkey_at} if steady else {}

    def ranged(name, fn):
        def call(*a, **k):
            q = a[qkey_at[name]].numel()
            with record_function(f"batch of {name}, Q={q}"):
                return fn(*a, **k)
        return call
    for n, fn in saved.items():
        setattr(probe, n, ranged(n, fn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for s, (look, ins, vals, dele) in enumerate(batches):
                mask = ~oracle.present[ins]
                out = eng.step(oracle.key(look), oracle.key(ins), vals,
                               oracle.key(dele), ins_mask=mask)
                oracle.step(look, ins, vals, mask, dele, out,
                            f"profile step {s}")
            torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(probe, n, fn)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # kernel and memcpy rows only: an op row repeats its kernels' time, and
    # so does the device side of a range (the steady profile's batches),
    # whose host side is the harness's, not PyTorch ops
    ranges = [getattr(e, "is_user_annotation", False) for e in ka]
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e, r in zip(ka, ranges)
                 if e.device_type == DeviceType.CUDA and not r)
    cpu_us = sum(e.self_cpu_time_total for e, r in zip(ka, ranges) if not r)
    # device-to-host copies: the engine's polls, the harness's epoch read
    # and the oracle's four outputs a step; anything more is a read the
    # engine does not count
    d2h = sum(e.count for e in ka if e.key.startswith("Memcpy DtoH"))
    # PyTorch ops a step, and the ops the rebuild step's transition took
    # over (the hazard flags' snapshot and keep mask), by name, wherever in
    # the step they run: calls and device µs a step
    n_ops = sum(e.count for e in ka if e.key.startswith("aten::"))
    named = {k: [0, 0.0] for k in ("aten::any", "aten::bitwise_not",
                                   "aten::bitwise_and", "aten::copy_")}
    for e in ka:
        if e.key in named:
            named[e.key][0] += e.count
            named[e.key][1] += getattr(e, "device_time_total",
                                       getattr(e, "cuda_time_total", 0))
    op_line = (f"PyTorch ops a step: {n_ops / n_steps:.2f}; of them "
               + ", ".join(f"{k} {c / n_steps:.2f} ({us / n_steps:.3f} us)"
                           for k, (c, us) in named.items()))
    by_name = sorted(((e.count / n_steps, e.key) for e in ka
                      if e.key.startswith("aten::")), reverse=True)
    name_line = "PyTorch ops a step by name: " + ", ".join(
        f"{k} {c:.2f}" for c, k in by_name)
    # the port's own kernels, each a row whatever its rank in the table
    names = port_kernel_names()
    rows = []
    for e in ka:
        m = re.match(r"(?:void )?(\w+)", e.key)
        if e.device_type == DeviceType.CUDA and m and m.group(1) in names:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            rows.append(f"  {m.group(1)}: {e.count} launches, "
                        f"{us / max(e.count, 1):.3f} us a launch, "
                        f"{us / n_steps:.3f} us a step")
    if steady:
        rows += lookup_batches(prof.events())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{n_steps} steps, wall {wall_ms:.1f} ms (with the host "
                f"oracle), device busy {dev_us / 1e3:.1f} ms, host in "
                f"PyTorch ops {cpu_us / 1e3:.1f} ms, {d2h} device-to-host "
                f"copies\n")
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40))
        f.write("\nthe port's kernels:\n" + "\n".join(sorted(rows)) + "\n")
        f.write(op_line + "\n" + name_line + "\n")
    for row in sorted(rows):
        log("   " + row)
    log("    " + op_line)
    if steady:
        log("    " + name_line)
    log(f"  profile of {n_steps} steps: device busy "
        f"{dev_us / 1e3 / n_steps:.3f} ms a step, host time in PyTorch ops "
        f"{cpu_us / 1e3 / n_steps:.3f} ms a step, device-to-host copies "
        f"{d2h / n_steps:.2f} a step (the oracle's 4 and the engine's polls "
        f"included) -> {path}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def count_visits(tstate, h0, found, loc, max_probes: int) -> int:
    """Slots a lookup batch has to read: to the hit, else to the first EMPTY
    slot, else ``max_probes``."""
    c = tstate.shape[0]
    pos = h0.long()
    active = torch.ones_like(found)
    visits = torch.zeros((), dtype=torch.int64, device=h0.device)
    for _ in range(max_probes):
        visits += active.sum()
        active &= (tstate[pos] != 0) & ~(found & (loc.long() == pos))
        pos = (pos + 1) % c
    return int(visits)


def build_table(probe, hashing, c: int, n_live: int, rng, device, seed: int,
                max_probes: int):
    """A table of ``c`` slots with ``n_live`` random keys placed by the PLAIN
    insert, then a share of them tombstoned and a share marked MIGRATED."""
    hfn = hashing.fresh("mix32", seed, device)
    tk, tv, ts = (torch.zeros(c, dtype=torch.int32, device=device)
                  for _ in range(3))
    uniq = np.unique(rng.integers(-(1 << 30), 1 << 30, n_live + n_live // 4))
    check(uniq.size >= n_live, "not enough distinct keys drawn")
    keys = torch.as_tensor(rng.permutation(uniq)[:n_live].astype(np.int32),
                           device=device)
    vals = keys * 3 + 1
    for i in range(0, n_live, 1 << 17):
        k, v = keys[i:i + (1 << 17)], vals[i:i + (1 << 17)]
        probe.probe_insert_plain(
            tk, tv, ts, hashing.bucket_of(hfn, k, c), k, v,
            torch.ones_like(k, dtype=torch.bool), max_probes)
    live = (ts == 1).nonzero().squeeze(1)
    pick = torch.as_tensor(rng.permutation(live.numel()), device=device)
    n = live.numel() // 10
    ts[live[pick[:n]]] = 2           # TOMB
    ts[live[pick[n:2 * n]]] = 3      # MIGRATED
    return hfn, tk, tv, ts, keys


def insert_equal(probe, label, tab, h0, k, v, m, p):
    """``probe_insert`` and its plain version on copies of ``tab``: the
    table after the batch, ``ok`` and ``present`` equal (tolerance 0).
    Returns (max abs err, ok, present, table) of the kernel."""
    a = [t.clone() for t in tab]
    b = [t.clone() for t in tab]
    ok_k, pr_k = probe.probe_insert(*a, h0, k, v, m, p)
    torch.cuda.synchronize()
    ok_p, pr_p = probe.probe_insert_plain(*b, h0, k, v, m, p)
    err = max(same(ok_k, ok_p, f"probe_insert {label} ok"),
              same(pr_k, pr_p, f"probe_insert {label} present"))
    for x, y, n in zip(a, b, ("key", "val", "state")):
        err = max(err, same(x, y, f"probe_insert {label} table {n}"))
    return err, ok_k, pr_k, a


def random_table(c: int, rng, device, live: float = 0.45,
                 dead: float = 0.2):
    """``c`` slots at random states (EMPTY, LIVE, TOMB, MIGRATED), each with
    a distinct positive key."""
    st = rng.choice(4, c, p=[1 - live - dead, live, dead / 2, dead / 2])
    key = rng.choice(np.arange(1, 40 * c + 1), c, replace=False)
    return tuple(torch.as_tensor(x.astype(np.int32), device=device)
                 for x in (key, key * 3 + 1, st))


def fresh_batch(q: int, rng, device, h0=None, c: int = 0):
    """``q`` distinct fresh (negative) keys, values, a random mask (90 %),
    and start slots ``h0`` (uniform over ``c`` slots when not given)."""
    k = -rng.choice(np.arange(1, 1 << 30), q, replace=False).astype(np.int32)
    if h0 is None:
        h0 = rng.integers(0, c, q)

    def t(x, dt=torch.int32):
        return torch.as_tensor(x, dtype=dt, device=device)
    return (t(h0), t(k), t(k * 5 + 2), t(rng.random(q) < 0.9, torch.bool))


def insert_cases(probe, hashing, hfn, tab, QU: int, CH: int, P: int, rng,
                 device) -> dict:
    """The probe_insert cases beside phase 2's batches, each (table, h0,
    keys, values, mask, max_probes): small tables (C = 64 with more queries
    than slots, C = 100, C = 4096 with clustered start slots, a full table),
    windows wider than the table or than 64 slots (the lock-step path),
    and on the main table a group of 100 on the last start slot of a
    block's range, runs that wrap C - 1 -> 0, keys all present, start slots
    on TOMB and MIGRATED slots, a landing-shaped batch of ``CH`` keys into
    a new table, one query, and a batch of 20000 whose first 3000 keys
    share one start slot."""
    tk, tv, ts = tab
    C = tk.numel()
    out = {}
    for c, p, q in ((64, 64, 200), (100, 64, 300), (4096, 64, 3000)):
        t = random_table(c, rng, device)
        centres = rng.integers(0, c, 5)
        h0 = (rng.choice(centres, q) + rng.integers(0, 8, q)) % c
        out[f"C={c} P={p} Q={q}"] = (t, *fresh_batch(q, rng, device, h0), p)
    full = random_table(4096, rng, device, live=1.0, dead=0.0)
    out["full table C=4096"] = (full, *fresh_batch(2000, rng, device,
                                                   c=4096), 64)
    for c, p, q in ((48, 64, 120), (4096, 100, 2000)):
        t = random_table(c, rng, device)
        centres = rng.integers(0, c, 5)
        h0 = (rng.choice(centres, q) + rng.integers(0, 8, q)) % c
        out[f"lock-step C={c} P={p} Q={q}"] = (
            t, *fresh_batch(q, rng, device, h0), p)
    # the block ranges of the kernel's greedy path at QU queries
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(min((QU + 63) // 64, sms), -(-C // (C - P + 1)))
    w = -(-C // blocks)
    h0 = hashing.bucket_of(hfn, torch.as_tensor(
        -rng.choice(np.arange(1, 1 << 30), QU, replace=False).astype(
            np.int32), device=device), C).cpu().numpy()
    hb = h0.copy()
    hb[:100] = w - 1
    out["range boundary"] = (tab, *fresh_batch(QU, rng, device, hb), P)
    hw = h0.copy()
    hw[:2000] = C - 1 - rng.integers(0, 40, 2000)
    out["wrap"] = (tab, *fresh_batch(QU, rng, device, hw), P)
    live = (ts == 1).nonzero().squeeze(1)
    pk = tk[live[torch.as_tensor(rng.choice(live.numel(), QU, replace=False),
                                 device=device)]].contiguous()
    out["all present"] = (tab, hashing.bucket_of(hfn, pk, C), pk, pk * 5 + 2,
                          torch.ones(QU, dtype=torch.bool, device=device), P)
    dead = ((ts == 2) | (ts == 3)).nonzero().squeeze(1).cpu().numpy()
    out["TOMB / MIGRATED"] = (tab, *fresh_batch(
        QU, rng, device, rng.choice(dead, QU, replace=False)), P)
    hfn2, nk, nv, ns, _ = build_table(probe, hashing, C, 1 << 18, rng, device,
                                      33, P)
    lk = torch.as_tensor(-rng.choice(np.arange(1, 1 << 30), CH,
                                     replace=False).astype(np.int32),
                         device=device)
    out["landing"] = ((nk, nv, ns), hashing.bucket_of(hfn2, lk, C), lk,
                      lk * 5 + 2, torch.as_tensor(rng.random(CH) < 0.8,
                                                  device=device), P)
    out["Q=1"] = (tab, *fresh_batch(1, rng, device, c=C), P)
    # a batch of several sweeps whose hot start slot comes first: the block
    # stops listing in the first sweep and must still answer the rest
    q = 20000
    hs = hashing.bucket_of(hfn, torch.as_tensor(
        -rng.choice(np.arange(1, 1 << 30), q, replace=False).astype(np.int32),
        device=device), C).cpu().numpy()
    hs[:3000] = C - 5
    out["hot start slot, Q=20000"] = (tab, *fresh_batch(q, rng, device, hs),
                                      P)
    return out


def time_insert_cases(probe, cases: dict, reps: int, baseline):
    """Each insert case held against the plain version (tolerance 0; with a
    baseline, the other tree's kernel too) and timed on a restored copy of
    its table; with a baseline in turns, baseline, this tree, this tree,
    baseline.  Returns (max abs err, {case: times})."""
    out, err = {}, 0
    for label, (tab, h0, k, v, m, p) in cases.items():
        e, ok, pr, after = insert_equal(probe, label, tab, h0, k, v, m, p)
        err = max(err, e)
        # slots that were TOMB or MIGRATED and took a key
        dead = int((((tab[2] == 2) | (tab[2] == 3)) & (after[2] == 1)).sum())
        a = [t.clone() for t in tab]

        def restore():
            for x, y in zip(a, tab):
                x.copy_(y)

        def mine():
            probe.probe_insert(*a, h0, k, v, m, p)
        entry = {"placed": int(ok.sum()), "present": int(pr.sum()),
                 "dead_slots_taken": dead}
        if baseline is None:
            entry["ms"] = time_ms(mine, reps, restore)
        else:
            other = baseline["probe_insert"]
            restore()
            ok_b, pr_b = other(*a, h0, k, v, m, p)
            b = [t.clone() for t in tab]
            ok_p, pr_p = probe.probe_insert_plain(*b, h0, k, v, m, p)
            for x, y, n in zip((ok_b, pr_b, *a), (ok_p, pr_p, *b),
                               ("ok", "present", "key", "val", "state")):
                same(x, y, f"probe_insert (baseline) {label} {n}")
            t = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                fn = mine if who == "this" else (
                    lambda: other(*a, h0, k, v, m, p))
                t[who].append(time_ms(fn, reps, restore))
            entry["ms"], entry["parent_ms"] = t["this"], t["parent"]
        out[label] = entry
        log(f"    probe_insert {label}: equal to the plain version; "
            + json.dumps(entry))
    full = out["full table C=4096"]
    check(full["placed"] == 0, "probe_insert: a full table placed a key")
    present = out["all present"]
    check(present["placed"] == 0 and present["present"] > 0,
          f"probe_insert: all present {present}")
    check(out["TOMB / MIGRATED"]["dead_slots_taken"] > 0,
          "probe_insert: no TOMB or MIGRATED slot was taken")
    return err, out


LOOKUP_OUTPUTS = ("found", "val", "loc")
# integer operations of one mix32 hash (bucket_of of a key, the mask
# included), the hash of every table the port builds
MIX32_OPS = 12


def swapped(name: str, fn):
    """A context in which the C entry point of kernel ``name`` is ``fn``."""
    import contextlib

    from repro_torch.kernels import build

    @contextlib.contextmanager
    def ctx():
        lib = build.load()
        mine = lib[name]
        lib[name] = fn
        try:
            yield
        finally:
            lib[name] = mine
    return ctx()


def wrap_keys(hashing, hfn, c: int, n: int, device) -> torch.Tensor:
    """``n`` distinct fresh keys whose start slot (``bucket_of``) is one of
    the last 40 of ``c`` slots, found by rejection sampling on the card:
    their walks wrap at ``c``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(40)
    got = torch.empty(0, dtype=torch.int32, device=device)
    while got.numel() < n:
        cand = torch.randint(1 << 30, (1 << 31) - 1, (1 << 22,),
                             generator=gen, device=device, dtype=torch.int32)
        got = torch.unique(torch.cat(
            [got, cand[hashing.bucket_of(hfn, cand, c) >= c - 40]]))
    return got[torch.randperm(got.numel(), generator=gen,
                              device=device)[:n]]


def baseline_lookup(fn):
    """Another tree's ``dhash_probe_lookup`` entry point ``fn`` for this
    tree's wrapper: where that tree's takes start slots only (12
    arguments: no seeds, no hash kind), the start-slot form."""
    if len(fn.argtypes) != 12:
        return fn

    def call(*argv):
        check(argv[4] is not None, "--baseline probe_lookup takes h0 only")
        return fn(*argv[:5], *argv[7:])
    return call


def lookup_cases(hfn, tk, tv, ts, keys, Q: int, P: int, rng, device,
                 reps: int, baseline) -> dict:
    """``probe_lookup`` (start slots given) and ``probe_lookup_hashed``
    (start slots hashed in the kernel) against ``probe_lookup_plain``
    (tolerance 0) on phase 2's table: ragged Q, hits, misses, TOMB and
    MIGRATED runs, walks that wrap at C (given start slots in the last 40
    slots; for the hashed form keys found by rejection sampling whose hash
    lands there, inserted into a copy of the table, so that their runs
    wrap, and the table's own keys that hash there), batches of 1
    and 33, the table's arrays one slot off their start (not 16-byte
    aligned, C - 1 slots: the slot-by-slot walk, and a bucket count that is
    not a power of two), hash functions of the other two kinds.  Then the
    time of both forms; what bounds the kernel: a launch of one query and
    the profiler's device µs a call; with a baseline, the other tree's
    kernel in turns with this tree's on the same start slots, and its
    sequence (``bucket_of``, then its kernel) in turns with the hashed
    form."""
    from repro_torch.core import hashing
    from repro_torch.kernels import probe
    C, i32 = tk.shape[0], torch.int32

    def inputs(q, c=C, fn=hfn):
        hit = keys[torch.as_tensor(rng.integers(0, keys.numel(), q // 2),
                                   device=device)]
        miss = torch.as_tensor(
            rng.integers(1 << 30, (1 << 31) - 1, q - q // 2).astype(np.int32),
            device=device)
        qk = torch.cat([hit, miss])[torch.as_tensor(rng.permutation(q),
                                                    device=device)]
        return hashing.bucket_of(fn, qk, c).contiguous(), qk.contiguous()

    near_end = keys[hashing.bucket_of(hfn, keys, C) >= C - 40]
    wrapping = wrap_keys(hashing, hfn, C, Q // 64, device)
    # each case: (key, val, state, h0, qkey), and the hash function
    cases, fns = {}, {}
    for q in (Q + 77, Q, 33, 1):
        h0, qk = inputs(q)
        h0[: q // 16] = C - 1 - torch.arange(q // 16, device=device,
                                             dtype=i32) % 40   # wrap
        cases[f"Q={q}"], fns[f"Q={q}"] = (tk, tv, ts, h0, qk), hfn
    # a copy of the table with the wrapping keys inserted: they fill its
    # last 40 slots and run on past C from slot 0
    wt = [x.clone() for x in (tk, tv, ts)]
    probe.probe_insert_plain(*wt, hashing.bucket_of(hfn, wrapping, C),
                             wrapping, wrapping * 3 + 1,
                             torch.ones_like(wrapping, dtype=torch.bool), P)
    h0, qk = inputs(Q)
    qk[: wrapping.numel()] = wrapping
    qk[wrapping.numel(): wrapping.numel() + near_end.numel()] = near_end
    cases["wrapping keys"] = (*wt, hashing.bucket_of(hfn, qk, C), qk)
    cases["unaligned, C-1"] = (tk[1:], tv[1:], ts[1:], *inputs(Q, C - 1))
    fns["wrapping keys"] = fns["unaligned, C-1"] = hfn
    for kind in ("multiply_shift", "tabulation"):
        fns[kind] = hashing.fresh(kind, 7, device)
        cases[kind] = (tk, tv, ts, *inputs(Q, C, fns[kind]))
    err, out = 0, {}
    for label, (k_, v_, s_, h0, qk) in cases.items():
        want = probe.probe_lookup_plain(k_, v_, s_, h0, qk, P)
        got = probe.probe_lookup(k_, v_, s_, h0, qk, P)
        torch.cuda.synchronize()
        for x, y, n in zip(got, want, LOOKUP_OUTPUTS):
            err = max(err, same(x, y, f"probe_lookup {label} {n}"))
        # the hashed form: its start slots are bucket_of's, never forced
        hw = probe.probe_lookup_plain(
            k_, v_, s_, hashing.bucket_of(fns[label], qk, k_.shape[0]), qk, P)
        hg = probe.probe_lookup_hashed(k_, v_, s_, fns[label], qk, P)
        torch.cuda.synchronize()
        for x, y, n in zip(hg, hw, LOOKUP_OUTPUTS):
            err = max(err, same(x, y, f"probe_lookup_hashed {label} {n}"))
        out[label] = {"hits": int(want[0].sum()), "hashed_hits":
                      int(hw[0].sum())}
    hw = probe.probe_lookup_plain(*cases["wrapping keys"], P)
    check(bool(((hw[2] >= 0) & (hw[2] < cases["wrapping keys"][3])).any()),
          "probe_lookup: no hit across the wrap at C")
    log(f"  probe_lookup ok, both forms: " + json.dumps(out)
        + f"; {wrapping.numel()} fresh keys and {near_end.numel()} table "
        f"keys hashed into the last 40 slots")

    # the timed batch: phase 2's (hits and misses, a sixteenth forced to
    # wrap) for the start-slot form, its keys for the hashed one
    *tab, h0, qk = cases[f"Q={Q}"]
    found, _, loc = probe.probe_lookup(*tab, h0, qk, P)
    check(bool(found.any()) and not bool(found.all()),
          "probe_lookup: inputs must mix hits and misses")
    visits = count_visits(ts, h0, found, loc, P)
    fh, _, lh = probe.probe_lookup_hashed(*tab, hfn, qk, P)
    visits_h = count_visits(ts, hashing.bucket_of(hfn, qk, C), fh, lh, P)
    *_, h1, k1 = cases["Q=1"]
    calls = {"windows": lambda: probe.probe_lookup(*tab, h0, qk, P),
             "windows, hashed": lambda: probe.probe_lookup_hashed(
                 *tab, hfn, qk, P),
             "Q=1": lambda: probe.probe_lookup(*tab, h1, k1, P),
             "Q=1, hashed": lambda: probe.probe_lookup_hashed(*tab, hfn, k1,
                                                              P)}
    # in: key (and h0) a query, state and key of each slot visited, value
    # of a hit; out: found, val, loc; operations: two a slot visited (and a
    # hash a query)
    res = dict(
        max_abs_err=err, ms=time_ms(calls["windows"], reps),
        plain_ms=time_ms(lambda: probe.probe_lookup_plain(*tab, h0, qk, P), 3,
                         queue_ahead=False),
        **bound(Q * 8 + visits * 8 + int(found.sum()) * 4 + Q * 9,
                2 * visits),
        hashed=dict(ms=time_ms(calls["windows, hashed"], reps),
                    **bound(Q * 4 + visits_h * 8 + int(fh.sum()) * 4 + Q * 9,
                            2 * visits_h + MIX32_OPS * Q),
                    visits=visits_h),
        visits=visits, q1_ms=time_ms(calls["Q=1"], reps),
        q1_hashed_ms=time_ms(calls["Q=1, hashed"], reps), cases=out)
    # what bounds it: device µs a call in the profile
    prof = {k: profile_calls(f, 50, lambda: None)[0]
            for k, f in calls.items()}
    if baseline is not None:
        res["in_turns"] = compare_cases(
            "probe_lookup", probe.probe_lookup, probe.probe_lookup_plain,
            {k: (*cases[k], P) for k in (f"Q={Q}", "Q=1")}, reps, baseline,
            LOOKUP_OUTPUTS)
        other = baseline["probe_lookup"]

        def parent_hashed():
            with swapped("probe_lookup", other):
                return probe.probe_lookup(
                    *tab, hashing.bucket_of(hfn, qk, C), qk, P)
        t = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            t[who].append(time_ms(
                parent_hashed if who == "parent" else calls["windows, hashed"],
                reps))
        res["in_turns"]["hashed"] = {
            "ms": t["this"], "parent_bucket_of_and_kernel_ms": t["parent"]}
        with swapped("probe_lookup", other):
            prof["parent"] = profile_calls(calls["windows"], 50,
                                           lambda: None)[0]
            prof["parent, Q=1"] = profile_calls(calls["Q=1"], 50,
                                                lambda: None)[0]
        prof["parent bucket_of and kernel"] = profile_calls(
            parent_hashed, 50, lambda: None)[0]
    # the hash's PyTorch ops, by name: what the steady state's lookup and
    # delete no longer issue
    _, n_ops, _ = profile_calls(lambda: hashing.bucket_of(hfn, qk, C), 20,
                                lambda: None)
    res["bucket_of_ops"] = n_ops
    res["profile_us"] = prof
    log(f"  probe_lookup times: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("cases", "in_turns")}))
    return res


def phase_kernels(device, cfg, reps: int, baseline=None) -> dict:
    from repro_torch.core import buckets, hashing
    from repro_torch.kernels import probe
    rng = np.random.default_rng(11)
    C = 1 << 21
    P = 64
    Q, QU, CH = cfg.lookups_per_step, cfg.updates_per_step, cfg.chunk
    res = {}
    i32 = torch.int32

    hfn, tk, tv, ts, keys = build_table(probe, hashing, C, 1 << 20, rng,
                                        device, 21, P)
    log(f"  table: C={C} live={int((ts == 1).sum())} "
        f"tomb={int((ts == 2).sum())} migrated={int((ts == 3).sum())}")

    # -- probe_lookup, both forms (start slots given, hashed in the kernel)
    res["probe_lookup"] = lookup_cases(hfn, tk, tv, ts, keys, Q, P, rng,
                                       device, reps, baseline)

    # -- probe_insert: hot start slot past max_probes, wrap, duplicates,
    #    keys already live, ragged Q
    def insert_inputs(q):
        fresh = torch.as_tensor(
            rng.integers(-(1 << 31), -(1 << 30), q).astype(np.int32),
            device=device)
        k = fresh.clone()
        k[: q // 8] = keys[: q // 8]                 # already live (or dead)
        k[q // 8: q // 4] = k[q // 4: q // 4 + (q // 4 - q // 8)]  # duplicates
        h0 = hashing.bucket_of(hfn, k, C)
        hot = slice(q // 2, q // 2 + 3000)
        h0[hot] = C - 5                              # one start slot, wraps
        mask = torch.as_tensor(rng.random(q) < 0.9, device=device)
        return (h0.contiguous(), k.contiguous(), (k * 5 + 2).contiguous(),
                buckets.batch_winners(k, mask))

    err = 0
    for q in (QU + 5, QU):
        h0, k, v, m = insert_inputs(q)
        tab = (tk, tv, ts)
        e, ok_k, pr_k, _ = insert_equal(probe, f"Q={q}", tab, h0, k, v, m,
                                        P)
        err = max(err, e)
        failed = m & ~ok_k & ~pr_k
        check(int(failed.sum()) > 0, "probe_insert: the hot slot must "
              "overflow max_probes")
    log(f"  probe_insert ok: Q={QU} placed={int(ok_k.sum())} "
        f"present={int(pr_k.sum())} no-slot={int(failed.sum())} (3000 keys "
        f"on one start slot: more than a block lists, counted)")
    hot = ((tk, tv, ts), h0, k, v, m, P)
    # timed on the main path's kind of batch: fresh keys, hashed start slots
    k = torch.as_tensor(rng.integers(-(1 << 31), -(1 << 30), QU)
                        .astype(np.int32), device=device)
    h0, v = hashing.bucket_of(hfn, k, C), k * 5 + 2
    m = buckets.batch_winners(k, torch.ones_like(k, dtype=torch.bool))
    a = [t.clone() for t in (tk, tv, ts)]

    def restore():
        for x, y in zip(a, (tk, tv, ts)):
            x.copy_(y)
    restore()
    ok_t, pr_t = probe.probe_insert(*a, h0, k, v, m, P)
    visits = count_visits(ts, h0, pr_t, torch.full_like(h0, -1), P)
    nbytes = QU * 13 + visits * 8 + int(ok_t.sum()) * 12 + QU * 2
    res["probe_insert"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.probe_insert(*a, h0, k, v, m, P), reps,
                   restore),
        plain_ms=time_ms(
            lambda: probe.probe_insert_plain(*a, h0, k, v, m, P), 3, restore,
            queue_ahead=False),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    cases = {"phase-2": ((tk, tv, ts), h0, k, v, m, P),
             "hot start slot": hot}
    cases.update(insert_cases(probe, hashing, hfn, (tk, tv, ts), QU, CH, P,
                              rng, device))
    errs, res["probe_insert"]["cases"] = time_insert_cases(
        probe, cases, reps, baseline)
    res["probe_insert"]["max_abs_err"] = max(err, errs)

    # -- extract: first chunk, a middle one, the partial last one, the end
    err = 0
    for cur in (0, 5 * CH + 123, C - 1000, C):
        cursor = torch.tensor(cur, dtype=i32, device=device)
        sa, sb = ts.clone(), ts.clone()
        out_k = probe.extract(tk, tv, sa, cursor, CH)
        torch.cuda.synchronize()
        out_p = probe.extract_plain(tk, tv, sb, cursor, CH)
        for x, y, n in zip((*out_k, sa), (*out_p, sb),
                           ("hkey", "hval", "hlive", "cursor", "state")):
            err = max(err, same(x, y, f"extract cursor={cur} {n}"))
    cursor = torch.tensor(5 * CH, dtype=i32, device=device)
    sa = ts.clone()
    n_live = int(probe.extract(tk, tv, sa, cursor, CH)[2].sum())
    # in: every slot's state, key and value of the live slots, the cursor;
    # out: the hazard buffer, the MIGRATED marks, the cursor
    nbytes = CH * 4 + n_live * 8 + 4 + CH * 9 + n_live * 4 + 4
    res["extract"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.extract(tk, tv, sa, cursor, CH), reps,
                   lambda: sa.copy_(ts)),
        plain_ms=time_ms(lambda: probe.extract_plain(tk, tv, sa, cursor, CH),
                         3, lambda: sa.copy_(ts), queue_ahead=False),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    log(f"  extract ok: chunk={CH} live in the timed chunk={n_live}")

    # the guarded, in-place form an engine step launches: the hazard buffer
    # and the cursor written in place where run is set and hold is not,
    # nothing anywhere else
    flags = {v: torch.tensor(v, device=device) for v in (False, True)}
    for run, hold in ((True, False), (False, False), (True, True)):
        outs = []
        for fn in (probe.extract, probe.extract_plain):
            st = ts.clone()
            hz = (torch.full((CH,), 7, dtype=i32, device=device),
                  torch.full((CH,), 9, dtype=i32, device=device),
                  torch.ones(CH, dtype=torch.bool, device=device))
            cur = torch.tensor(5 * CH, dtype=i32, device=device)
            fn(tk, tv, st, cur, CH, out=hz, run=flags[run],
               hold=flags[hold])
            torch.cuda.synchronize()
            outs.append((*hz, cur, st))
        for x, y, n in zip(*outs, ("hkey", "hval", "hlive", "cursor",
                                   "state")):
            err = max(err, same(x, y, f"extract run={run} hold={hold} {n}"))
        idle = bool(outs[0][2].all()) and int(outs[0][3]) == 5 * CH \
            and torch.equal(outs[0][4], ts)
        check(idle == (not run or hold), f"extract run={run} hold={hold}: "
              f"the guard did not hold")
    res["extract"]["max_abs_err"] = err
    hz = (torch.zeros(CH, dtype=i32, device=device),
          torch.zeros(CH, dtype=i32, device=device),
          torch.zeros(CH, dtype=torch.bool, device=device))
    cur = torch.tensor(5 * CH, dtype=i32, device=device)
    res["extract"]["guarded_idle_ms"] = time_ms(
        lambda: probe.extract(tk, tv, sa, cur, CH, out=hz, run=flags[False]),
        reps)
    log(f"  extract guarded ok: in place where run and not hold, nothing "
        f"written otherwise; an idle launch "
        f"{res['extract']['guarded_idle_ms']:.4f} ms")


    # -- probe2: old table mid-rebuild, hazard buffer with killed entries,
    #    new tables 2x, 4x and a quarter of the old, and one of its size
    err = 0
    so = ts.clone()
    cursor = torch.tensor(7 * CH, dtype=i32, device=device)
    hk, hv, hl, _ = probe.extract_plain(tk, tv, so, cursor, CH)
    hz_live = int(hl.sum())
    hl = hl & torch.as_tensor(rng.random(CH) < 0.8, device=device)  # kills
    # new tables of 2x and 4x the old (growth), a quarter (a shrink) and
    # the old's size, the last the one timed below
    for c_new, seed in ((2 * C, 33), (C // 4, 34), (4 * C, 31), (C, 32)):
        hfn2, nk, nv, ns, nkeys = build_table(probe, hashing, c_new, 1 << 18,
                                              rng, device, seed, P)
        for q in (Q + 77, Q):
            n4 = q // 4
            qk = torch.cat([
                keys[torch.as_tensor(rng.integers(0, keys.numel(), n4),
                                     device=device)],
                hk[torch.as_tensor(rng.integers(0, max(hz_live, 1), n4),
                                   device=device)],
                nkeys[torch.as_tensor(rng.integers(0, nkeys.numel(), n4),
                                      device=device)],
                torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                             q - 3 * n4).astype(np.int32),
                                device=device)])
            qk = qk[torch.as_tensor(rng.permutation(q),
                                    device=device)].contiguous()
            h0o = hashing.bucket_of(hfn, qk, C)
            h0n = hashing.bucket_of(hfn2, qk, c_new)
            args = ((tk, tv, so), (nk, nv, ns), hk, hv, hl, h0o, h0n, qk, P)
            out_k = probe.probe2(*args)
            torch.cuda.synchronize()
            out_p = probe.probe2_plain(*args)
            for x, y, n in zip(out_k, out_p, OUTPUTS):
                err = max(err, same(x, y, f"probe2 Cnew={c_new} Q={q} {n}"))
            check(bool(out_k[2].any()) and bool((out_k[4] >= 0).any())
                  and bool((out_k[5] >= 0).any()) and not bool(out_k[0].all()),
                  "probe2: inputs must hit old, hazard, new and nothing")
    found, _, f_old, loc_old, hz_idx, loc_new = out_k
    # the work of the function, whatever implements it: a hazard lookup
    # (SET_LOOKUP_OPS) for each query the old table did not resolve, two
    # operations a slot visited
    hz_lookups = int((~f_old).sum())
    v_old = count_visits(so, h0o, f_old, loc_old, P)
    unres = ~f_old & (hz_idx < 0)
    v_new = count_visits(ns, h0n[unres], (loc_new >= 0)[unres],
                         loc_new[unres], P)
    nbytes = Q * 12 + (v_old + v_new) * 8 + CH * 9 + Q * 18
    ops = SET_LOOKUP_OPS * hz_lookups + 2 * (v_old + v_new)
    res["probe2"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.probe2(*args), reps),
        plain_ms=time_ms(lambda: probe.probe2_plain(*args), 3,
                         queue_ahead=False),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S
        else "operations")
    log(f"  probe2 ok: Q={Q} hazard lookups={hz_lookups} "
        f"visits old={v_old} new={v_new}")

    # -- probe2 on the staged set's own cases (as tc_probe2's below):
    #    duplicate live hazard keys with dead entries between them, an empty
    #    and a full buffer, every key in one probe run of the index; batches
    #    of 1, 33 and 256 queries
    cases = {"phase-2": args}
    for label, (ck, cv, cl, ckeys) in hazard_cases(hk, hv, hl, rng,
                                                   device).items():
        n4 = Q // 4
        cq = torch.cat([
            keys[torch.as_tensor(rng.integers(0, keys.numel(), n4),
                                 device=device)],
            ckeys[torch.as_tensor(rng.integers(0, ckeys.numel(), n4),
                                  device=device)],
            nkeys[torch.as_tensor(rng.integers(0, nkeys.numel(), n4),
                                  device=device)],
            torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                         Q - 3 * n4).astype(np.int32),
                            device=device)])
        cq = cq[torch.as_tensor(rng.permutation(Q), device=device)]
        cases[label] = ((tk, tv, so), (nk, nv, ns), ck, cv, cl,
                        hashing.bucket_of(hfn, cq, C),
                        hashing.bucket_of(hfn2, cq, C), cq.contiguous(), P)
    for q in (1, 33, 256):
        for label in ("phase-2", "full"):
            a = cases[label]
            cases[f"{label} Q={q}"] = (*a[:5], *(t[:q] for t in a[5:8]), P)
    res["probe2"]["cases"] = compare_cases(
        "probe2", probe.probe2, probe.probe2_plain, cases, reps, baseline)
    hits = {k: int((probe.probe2(*a)[4] >= 0).sum())
            for k, a in cases.items() if "Q=" not in k}
    check(hits["empty"] == 0 and min(hits["duplicates"], hits["full"],
                                     hits["one_run"]) > Q // 8,
          f"probe2: hazard hits of the cases {hits}")
    log(f"  probe2 cases ok: hazard hits {hits}")

    # -- the chunk contract: above 4096 a table on the card is refused, by
    #    the wrappers and by the backend adapter; nothing runs the plain scan
    from repro_torch.core import backend
    big = 2 * probe.EXTRACT_MAX_CHUNK
    zk, zl = torch.zeros(big, dtype=i32, device=device), torch.zeros(
        big, dtype=torch.bool, device=device)
    table = backend.get("linear").make(1 << 14, 0, device=device)
    before = probe.launch_counts()
    for what, call in (
            ("extract", lambda: probe.extract(tk, tv, ts.clone(), cursor, big)),
            ("probe2", lambda: probe.probe2(
                (tk, tv, so), (nk, nv, ns), zk, zk, zl, h0o, h0n, qk, P)),
            ("backend.extract_chunk_fused",
             lambda: backend.extract_chunk_fused(
                 table, torch.zeros((), dtype=i32, device=device), big)),
            ("backend.transition_fused",
             lambda: backend.transition_fused(
                 table, torch.zeros((), dtype=i32, device=device), big,
                 (zk, zk, zl), zl[0], zl, zl, True, True))):
        try:
            call()
        except ValueError:
            continue
        check(False, f"{what}: a chunk of {big} on the card must raise")
    check(probe.launch_counts() == before, "a refused chunk was launched")
    log(f"  chunk contract ok: chunk {big} on the card raises in extract, "
        f"probe2 and the backend adapters")
    return res


def build_rows_table(probe, hashing, b: int, w: int, n_live: int, rng,
                     device, seed: int, kind: str = "mix32",
                     cuckoo: bool = False):
    """A [b, w] two-row table with ``n_live`` random keys placed by the PLAIN
    insert under two ``kind`` hash functions, then a share of them
    tombstoned and a share marked MIGRATED; with ``cuckoo`` in a cuckoo
    table's layout (rows a in [0, b/2), rows b in [b/2, b)).
    Returns (hfn_a, hfn_b, key, val, state, keys)."""
    hfa = hashing.fresh(kind, seed, device)
    hfb = hashing.fresh(kind, seed + 1000, device)
    nb, off = (b // 2, b // 2) if cuckoo else (b, 0)
    tk, tv, ts = (torch.zeros((b, w), dtype=torch.int32, device=device)
                  for _ in range(3))
    uniq = np.unique(rng.integers(-(1 << 30), 1 << 30, n_live + n_live // 4))
    check(uniq.size >= n_live, "not enough distinct keys drawn")
    keys = torch.as_tensor(rng.permutation(uniq)[:n_live].astype(np.int32),
                           device=device)
    for i in range(0, n_live, 1 << 17):
        k = keys[i:i + (1 << 17)]
        probe.tc_insert_plain(tk, tv, ts, hashing.bucket_of(hfa, k, nb),
                              off + hashing.bucket_of(hfb, k, nb), k,
                              k * 3 + 1,
                              torch.ones_like(k, dtype=torch.bool), 8)
    flat = ts.view(-1)
    live = (flat == 1).nonzero().squeeze(1)
    pick = torch.as_tensor(rng.permutation(live.numel()), device=device)
    n = live.numel() // 10
    flat[live[pick[:n]]] = 2          # TOMB
    flat[live[pick[n:2 * n]]] = 3     # MIGRATED
    return hfa, hfb, tk, tv, ts, keys


def rows_read(probe_ref, tk, tv, ts, ra, qk, need=None) -> int:
    """Rows a two-row probe reads: row a, and row b where row a missed (of
    the queries in ``need``)."""
    fa = probe_ref.tc_row_lookup_ref(tk, tv, ts, ra, qk)[0]
    if need is None:
        need = torch.ones_like(fa)
    return int(need.sum()) + int((need & ~fa).sum())


def tc_lookup_need(tk, ts, ra, rb, qk) -> dict:
    """What a two-row lookup must read of the table: the keys of row a,
    and of row b where row a holds no LIVE copy and ``rb != ra``; in a row
    read, the state of each lane whose key is the query's, in lane order up
    to the first LIVE one; the value of a hit."""
    w = tk.shape[1]
    lane = torch.arange(w, device=tk.device)

    def row(r, need):
        r = r.long()
        match = (tk[r] == qk[:, None]) & need[:, None]
        live = match & (ts[r] == 1)          # LIVE
        hit = live.any(1)
        first = torch.where(hit, live.to(torch.uint8).argmax(1), w)
        return hit, int((match & (lane <= first[:, None])).sum())
    hit_a, states_a = row(ra, torch.ones_like(qk, dtype=torch.bool))
    need_b = ~hit_a & (rb != ra)
    hit_b, states_b = row(rb, need_b)
    return dict(rows_read=qk.numel() + int(need_b.sum()),
                states_read=states_a + states_b,
                hits=int((hit_a | hit_b).sum()))


def tc_lookup_bound(need: dict, w: int, q: int, hashed: bool) -> dict:
    """``tc_lookup``'s bound from ``tc_lookup_need``: in, the keys of each
    row read, the states it needs, a value a hit, and a query's key (with
    its two rows where they are given); out, found, val and loc a query.
    Operations: a compare and a mask bit a key read, and two hashes a
    query where the kernel hashes."""
    nbytes = (need["rows_read"] * w * 4 + need["states_read"] * 4
              + need["hits"] * 4 + q * (4 if hashed else 12) + q * 9)
    ops = need["rows_read"] * w * 2 + (2 * MIX32_OPS * q if hashed else 0)
    return bound(nbytes, ops)


def l2_flush(device):
    """A function that evicts the table from L2 (50 MB): it writes 128 MiB
    on the stream, for a time taken cold (its write is outside the
    events)."""
    buf = torch.empty(32 << 20, dtype=torch.int32, device=device)
    return lambda: buf.fill_(0)


def baseline_tc_lookup(fn):
    """Another tree's ``dhash_tc_lookup`` entry point ``fn`` for this tree's
    wrapper: where that tree's takes rows only (12 arguments: no hash
    functions, no bucket count, no offset), the rows-given form."""
    if len(fn.argtypes) != 12:
        return fn

    def call(*argv):
        check(argv[4] is not None, "--baseline tc_lookup takes rows only")
        return fn(*argv[:6], *argv[12:])
    return call


def tc_lookup_cases(tab, lookup_inputs, cfg, reps: int, device,
                    baseline) -> dict:
    """``tc_lookup`` (rows given) and ``tc_lookup_hashed`` (the rows hashed
    in the kernel) against their plain versions (tolerance 0).  Rows given,
    on phase 2's twochoice table (2^18 x 8): ragged Q, hits in row a and b,
    misses, dead keys, a sixteenth of the queries with both rows one row.
    Both forms, on that table (b-row offset 0) and on a cuckoo table of
    the main path's layout (2 x 2^17 x 8, offset 2^17), at Q = 65536 + 77,
    65536 (the lookup's batch), 8192 (the delete's), 33 and 1; hashed with
    one hash function for both rows (every ra == rb); tables of widths 4,
    6 (lane by lane), 12 and 16 (more than one step of 16-byte loads), one
    not 16-byte aligned (lane by lane), the other two hash kinds on tables
    whose bucket counts are not powers of two.  Then the time of both forms
    at the main path's two batches on both layouts; what bounds the kernel
    (the profiler's device µs a call); with a baseline, the other tree's
    kernel in turns with this tree's on the same rows, and its sequence
    (two ``bucket_of``, then its kernel) in turns with the hashed form."""
    from repro_torch.core import hashing
    from repro_torch.kernels import probe, ref
    hfa, hfb, tk, tv, ts, keys = tab
    B, W = tk.shape
    Q, QU = cfg.lookups_per_step, cfg.updates_per_step
    err = 0
    for q in (Q + 77, Q):
        ra, rb, qk = lookup_inputs(q)
        out_k = probe.tc_lookup(tk, tv, ts, ra, rb, qk)
        torch.cuda.synchronize()
        out_p = probe.tc_lookup_plain(tk, tv, ts, ra, rb, qk)
        for a, b, n in zip(out_k, out_p, LOOKUP_OUTPUTS):
            err = max(err, same(a, b, f"tc_lookup Q={q} {n}"))
    f, _, loc = out_k
    check(bool(f.any()) and not bool(f.all())
          and bool((f & (loc.long() // W == rb.long())
                    & (ra != rb)).any()),
          "tc_lookup: inputs must mix hits in row a, in row b and misses")
    need = tc_lookup_need(tk, ts, ra, rb, qk)
    check(need["hits"] == int(f.sum()), "tc_lookup_need counts other hits")
    timed_rows = (ra, rb, qk)

    # the hashed form's cases: (table, hfn_a, hfn_b, nbuckets, b_offset,
    # queries); each also through the rows-given form on the same rows
    rng = np.random.default_rng(20)

    def queries(kk, q):
        hit = kk[torch.as_tensor(rng.integers(0, kk.numel(), q // 2),
                                 device=device)]
        miss = torch.as_tensor(
            rng.integers(1 << 30, (1 << 31) - 1, q - q // 2).astype(np.int32),
            device=device)
        return torch.cat([hit, miss])[torch.as_tensor(
            rng.permutation(q), device=device)].contiguous()

    ck = build_rows_table(probe, hashing, B, W, cfg.capacity_per_shard, rng,
                          device, 61, cuckoo=True)
    layouts = {"twochoice": ((tk, tv, ts), hfa, hfb, B, 0, keys),
               "cuckoo": (ck[2:5], ck[0], ck[1], B // 2, B // 2, ck[5])}
    cases = {}
    for name, (t_, fa, fb, nb, off, kk) in layouts.items():
        for q in (Q + 77, Q, QU, 33, 1):
            cases[f"{name} Q={q}"] = (t_, fa, fb, nb, off, queries(kk, q))
    mixed = [f"{n} Q={q}" for n in layouts for q in (Q + 77, Q, QU)]
    cases["twochoice, one hash function (ra == rb)"] = (
        (tk, tv, ts), hfa, hfa, B, 0, queries(keys, Q))
    for label, (b, w, n, seed, kind, cuckoo) in {
            "W=4, cuckoo": (4096, 4, 6000, 62, "mix32", True),
            "W=6": (4096, 6, 9000, 63, "mix32", False),
            "W=12": (1024, 12, 5000, 64, "mix32", False),
            "W=16, cuckoo": (2048, 16, 12000, 65, "mix32", True),
            "tabulation, 3001 rows": (3001, 8, 8000, 66, "tabulation", False),
            "multiply_shift, cuckoo 2 x 1500 rows": (
                3000, 8, 8000, 67, "multiply_shift", True)}.items():
        fa, fb, k_, v_, s_, kk = build_rows_table(
            probe, hashing, b, w, n, rng, device, seed, kind, cuckoo)
        nb, off = (b // 2, b // 2) if cuckoo else (b, 0)
        cases[label] = ((k_, v_, s_), fa, fb, nb, off, queries(kk, 3001))
    # the unaligned case on a width-8 table: a copy of phase 2's table one
    # int32 off 16-byte alignment
    un = []
    for x in (tk, tv, ts):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        buf[1:] = x.view(-1)
        un.append(buf[1:].view(B, W))
    check(un[0].data_ptr() % 16 != 0, "the unaligned copy is aligned")
    cases["W=8, not 16-byte aligned"] = (tuple(un), hfa, hfb, B, 0,
                                         queries(keys, 3001))
    out = {}
    for label, (t_, fa, fb, nb, off, qk) in cases.items():
        want = probe.tc_lookup_hashed_plain(*t_, fa, fb, nb, off, qk)
        got = probe.tc_lookup_hashed(*t_, fa, fb, nb, off, qk)
        torch.cuda.synchronize()
        for x, y, n in zip(got, want, LOOKUP_OUTPUTS):
            err = max(err, same(x, y, f"tc_lookup_hashed {label} {n}"))
        ra_, rb_ = (hashing.bucket_of(fa, qk, nb),
                    off + hashing.bucket_of(fb, qk, nb))
        got = probe.tc_lookup(*t_, ra_, rb_, qk)
        torch.cuda.synchronize()
        for x, y, n in zip(got, want, LOOKUP_OUTPUTS):
            err = max(err, same(x, y, f"tc_lookup {label} {n}"))
        f, _, loc = want
        in_b = f & (loc.long() // t_[0].shape[1] == rb_.long()) & (ra_ != rb_)
        out[label] = {"hits": int(f.sum()), "in_row_b": int(in_b.sum()),
                      "same_row": int((ra_ == rb_).sum())}
        if label in mixed:
            check(out[label]["in_row_b"] > 0 and not bool(f.all()),
                  f"tc_lookup {label}: inputs must mix hits in row a, in "
                  f"row b and misses")
    check(out["twochoice, one hash function (ra == rb)"]["same_row"] == Q,
          "tc_lookup: one hash function must give ra == rb")
    log("  tc_lookup ok, both forms: " + json.dumps(out))

    # timed: the main path's two batches (the lookup's and the delete's)
    # on both layouts, rows given and hashed
    timed = {}
    for name in layouts:
        for q in (Q, QU):
            t_, fa, fb, nb, off, qk = cases[f"{name} Q={q}"]
            rows = (hashing.bucket_of(fa, qk, nb),
                    off + hashing.bucket_of(fb, qk, nb))
            timed[f"{name} Q={q}"] = dict(
                rows=(*t_, *rows, qk), hashed=(*t_, fa, fb, nb, off, qk))
    tk_args = (tk, tv, ts, *timed_rows)
    hk_args = (tk, tv, ts, hfa, hfb, B, 0, timed_rows[2])
    qk = timed_rows[2]
    need_h = tc_lookup_need(tk, ts, hashing.bucket_of(hfa, qk, B),
                            hashing.bucket_of(hfb, qk, B), qk)
    # warm: the table stays in L2 between the calls (as on the main path,
    # where old and new tables fit it); cold: L2 flushed before each call,
    # the reads the bound's HBM rate is for
    flush = l2_flush(device)
    res = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.tc_lookup(*tk_args), reps),
        cold_ms=time_ms(lambda: probe.tc_lookup(*tk_args), reps,
                        setup=flush),
        plain_ms=time_ms(lambda: probe.tc_lookup_plain(*tk_args), 3,
                         queue_ahead=False),
        **tc_lookup_bound(need, W, Q, hashed=False), **need,
        # the hashed form on the same queries
        hashed=dict(
            ms=time_ms(lambda: probe.tc_lookup_hashed(*hk_args), reps),
            cold_ms=time_ms(lambda: probe.tc_lookup_hashed(*hk_args), reps,
                            setup=flush),
            **tc_lookup_bound(need_h, W, Q, hashed=True), **need_h),
        cases=out)
    res["batches"] = {}
    for k, a in timed.items():
        t_, fa, fb, nb, off, qk_ = cases[k]
        need_k = tc_lookup_need(t_[0], t_[2], *a["rows"][3:5], qk_)
        res["batches"][k] = dict(
            rows_ms=time_ms(lambda: probe.tc_lookup(*a["rows"]), reps),
            rows_cold_ms=time_ms(lambda: probe.tc_lookup(*a["rows"]), reps,
                                 setup=flush),
            rows_bound_ms=tc_lookup_bound(need_k, t_[0].shape[1], qk_.numel(),
                                          hashed=False)["bound_ms"],
            hashed_ms=time_ms(
                lambda: probe.tc_lookup_hashed(*a["hashed"]), reps),
            hashed_cold_ms=time_ms(
                lambda: probe.tc_lookup_hashed(*a["hashed"]), reps,
                setup=flush),
            hashed_bound_ms=tc_lookup_bound(
                need_k, t_[0].shape[1], qk_.numel(), hashed=True)["bound_ms"],
            **need_k)
    # what bounds it: device µs a call in the profile
    calls = {"rows, phase 2": lambda: probe.tc_lookup(*tk_args)}
    for k, a in timed.items():
        calls[f"rows, {k}"] = lambda a=a: probe.tc_lookup(*a["rows"])
        calls[f"hashed, {k}"] = lambda a=a: probe.tc_lookup_hashed(
            *a["hashed"])
    prof = {k: profile_calls(f, 50, lambda: None)[0]
            for k, f in calls.items()}
    if baseline is not None:
        other = baseline["tc_lookup"]
        res["in_turns"] = compare_cases(
            "tc_lookup", probe.tc_lookup, probe.tc_lookup_plain,
            {"phase 2": tk_args,
             **{k: a["rows"] for k, a in timed.items()}},
            reps, baseline, LOOKUP_OUTPUTS)

        def parent_hashed(a):
            k_, v_, s_, fa, fb, nb, off, qk = a
            with swapped("tc_lookup", other):
                return probe.tc_lookup(
                    k_, v_, s_, hashing.bucket_of(fa, qk, nb),
                    off + hashing.bucket_of(fb, qk, nb), qk)
        for k, a in timed.items():
            t = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                t[who].append(time_ms(
                    (lambda: parent_hashed(a["hashed"])) if who == "parent"
                    else (lambda: probe.tc_lookup_hashed(*a["hashed"])),
                    reps))
            res["in_turns"][f"hashed, {k}"] = {
                "ms": t["this"], "parent_bucket_of_and_kernel_ms":
                t["parent"]}
            log(f"    tc_lookup hashed {k}: ms "
                + json.dumps(res["in_turns"][f"hashed, {k}"]))
        with swapped("tc_lookup", other):
            for k, a in timed.items():
                prof[f"parent rows, {k}"] = profile_calls(
                    lambda a=a: probe.tc_lookup(*a["rows"]), 50,
                    lambda: None)[0]
        for k, a in timed.items():
            prof[f"parent bucket_of and kernel, {k}"] = profile_calls(
                lambda a=a: parent_hashed(a["hashed"]), 50,
                lambda: None)[0]
    res["profile_us"] = prof
    log(f"  tc_lookup times: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("cases", "in_turns")}))
    return res


def phase_tc_kernels(device, cfg, reps: int, baseline=None) -> dict:
    """The three two-row kernels against their plain versions at the
    twochoice shapes of the main path (2^18 rows x 8 lanes)."""
    from repro_torch.core import backend, buckets, hashing
    from repro_torch.kernels import probe, ref
    rng = np.random.default_rng(12)
    B, W = cfg.capacity_per_shard // 4, 8
    Q, QU, CH = cfg.lookups_per_step, cfg.updates_per_step, cfg.chunk
    res = {}
    i32 = torch.int32

    hfa, hfb, tk, tv, ts, keys = build_rows_table(probe, hashing, B, W,
                                                  cfg.capacity_per_shard,
                                                  rng, device, 41)
    log(f"  two-row table: {B} x {W} live={int((ts == 1).sum())} "
        f"tomb={int((ts == 2).sum())} migrated={int((ts == 3).sum())} "
        f"full rows={int(((ts == 1).sum(1) == W).sum())}")

    def rows(k, nb=B, fa=hfa, fb=hfb):
        return (hashing.bucket_of(fa, k, nb).contiguous(),
                hashing.bucket_of(fb, k, nb).contiguous())

    # -- tc_lookup: ragged Q, hits in row a and b, misses, dead keys, a == b
    def lookup_inputs(q):
        hit = keys[torch.as_tensor(rng.integers(0, keys.numel(), q // 2),
                                   device=device)]
        miss = torch.as_tensor(
            rng.integers(1 << 30, (1 << 31) - 1, q - q // 2).astype(np.int32),
            device=device)
        qk = torch.cat([hit, miss])[torch.as_tensor(rng.permutation(q),
                                                    device=device)]
        ra, rb = rows(qk)
        rb[: q // 16] = ra[: q // 16]                  # both choices one row
        return ra, rb, qk.contiguous()

    res["tc_lookup"] = tc_lookup_cases((hfa, hfb, tk, tv, ts, keys),
                                       lookup_inputs, cfg, reps, device,
                                       baseline)

    # -- tc_insert: a hot row pair, duplicates, keys already live or dead,
    #    rows a == b, ragged Q; twochoice's 8 rounds and cuckoo's 2; 2048
    #    keys on one row, a full table, one query, a table of width 4, a
    #    landing's batch
    def insert_inputs(q, kk=keys, nb=B, fa=hfa, fb=hfb):
        k = torch.as_tensor(
            rng.integers(-(1 << 31), -(1 << 30), q).astype(np.int32),
            device=device)
        n = min(q // 8, kk.numel())
        k[:n] = kk[:n]                               # already live (or dead)
        k[q // 8: q // 4] = k[q // 4: q // 4 + (q // 4 - q // 8)]  # dups
        ra, rb = rows(k, nb, fa, fb)
        hot = slice(q // 2, q // 2 + 3000)
        ra[hot], rb[hot] = 7, 11                     # one hot row pair
        rb[q // 4: q // 4 + 200] = ra[q // 4: q // 4 + 200]
        mask = torch.as_tensor(rng.random(q) < 0.9, device=device)
        return (ra, rb, k.contiguous(), (k * 5 + 2).contiguous(),
                buckets.batch_winners(k, mask))

    def fresh_inputs(q, nb=B, fa=hfa, fb=hfb):
        k = torch.as_tensor(np.unique(rng.integers(
            -(1 << 31), -(1 << 30), 2 * q))[:q].astype(np.int32),
            device=device)
        k = k[torch.as_tensor(rng.permutation(q), device=device)]
        ra, rb = rows(k, nb, fa, fb)
        return (ra, rb, k.contiguous(), (k * 5 + 2).contiguous(),
                torch.ones_like(k, dtype=torch.bool))

    W4 = 4
    hfa4, hfb4, tk4, tv4, ts4, keys4 = build_rows_table(
        probe, hashing, B // 4, W4, B // 2, rng, device, 43)
    full = [torch.ones((1024, W), dtype=i32, device=device) for _ in range(3)]
    full[0].copy_(torch.arange(1024 * W, device=device).view(1024, W))
    err = 0
    cases = []                   # (label, table, claim, args, rounds)

    def add(label, tab, args, rounds):
        cases.append((label, tab, probe.new_claim(tab[0].shape[0], device),
                      args, rounds))

    for q, rounds in ((QU + 5, 8), (QU, 8), (QU, 2)):
        add(f"mixed Q={q} r={rounds}", (tk, tv, ts), insert_inputs(q), rounds)
    for rounds in (2, 8):
        fl = fresh_inputs(2048)
        fl[0].fill_(7)                               # 2048 keys on one row
        add(f"flood r={rounds}", (tk, tv, ts), fl, rounds)
        add(f"full table r={rounds}", full, fresh_inputs(QU, 1024), rounds)
        add(f"one query r={rounds}", (tk, tv, ts),
            tuple(t[:1] for t in fresh_inputs(1)), rounds)
        add(f"W=4 r={rounds}", (tk4, tv4, ts4),
            insert_inputs(QU, keys4, B // 4, hfa4, hfb4), rounds)
        add(f"landing Q={CH} r={rounds}", (tk, tv, ts), fresh_inputs(CH),
            rounds)
    for label, tab, claim, args, rounds in cases:
        b = [t.clone() for t in tab]
        ok_p, pr_p = probe.tc_insert_plain(*b, *args, rounds)
        a = [t.clone() for t in tab]
        ok_k, pr_k = probe.tc_insert(*a, *args, rounds, claim)
        torch.cuda.synchronize()
        what = f"tc_insert {label}"
        err = max(err, same(ok_k, ok_p, f"{what} ok"),
                  same(pr_k, pr_p, f"{what} present"))
        for x, y, n in zip(a, b, ("key", "val", "state")):
            err = max(err, same(x, y, f"{what} {n}"))
        check(bool((claim == probe.CLAIM_FREE).all()),
              f"{what}: claim words left behind")
        failed = args[4] & ~ok_p & ~pr_p
        log(f"  tc_insert ok: {label} placed={int(ok_p.sum())} "
            f"present={int(pr_p.sum())} no-lane={int(failed.sum())}")
        if label.startswith("mixed"):
            check(int(failed.sum()) > 2000, "tc_insert: most of the hot row "
                  "pair's inserts must find no lane")
        if label.startswith("full"):
            check(not bool(ok_p.any()), "tc_insert: a full table took a key")
        if label.startswith("flood"):
            check(0 < int(ok_p.sum()) < 2048, "tc_insert: the flood must "
                  "place some keys and refuse some")
    # timed on the main path's kind of batch (fresh keys, hashed rows) at
    # the user insert's Q and the landing's, and the parent's kernel in
    # turns with this tree's where --baseline gives it
    claim = probe.new_claim(B, device)
    a = [t.clone() for t in (tk, tv, ts)]

    def restore():
        for x, y in zip(a, (tk, tv, ts)):
            x.copy_(y)
    timed = {}
    for q in (QU, CH):
        ins = fresh_inputs(q)
        for rounds in (8, 2):
            entry = {}
            if baseline is None:
                entry["ms"] = time_ms(
                    lambda: probe.tc_insert(*a, *ins, rounds, claim), reps,
                    restore)
            else:
                fn = baseline["tc_insert"]
                restore()
                ok_b, pr_b = fn(*a, *ins, rounds)
                b = [t.clone() for t in (tk, tv, ts)]
                ok_p, pr_p = probe.tc_insert_plain(*b, *ins, rounds)
                for x, y, n in zip((ok_b, pr_b, *a), (ok_p, pr_p, *b),
                                   ("ok", "present", "key", "val", "state")):
                    same(x, y, f"tc_insert (baseline) Q={q} r={rounds} {n}")
                t = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    t[who].append(time_ms(
                        (lambda: fn(*a, *ins, rounds)) if who == "parent"
                        else (lambda: probe.tc_insert(*a, *ins, rounds,
                                                      claim)),
                        reps, restore))
                entry["ms"], entry["parent_ms"] = t["this"], t["parent"]
            timed[f"Q={q} r={rounds}"] = entry
            log(f"    tc_insert Q={q} max_rounds={rounds}: ms "
                + json.dumps(entry))
    restore()
    ins = fresh_inputs(QU)
    m = ins[4]
    ok_t, pr_t = probe.tc_insert(*a, *ins, 8, claim)
    nrows = rows_read(ref, tk, tv, ts, ins[0], ins[2], m)
    pend = int((m & ~pr_t).sum())
    res["tc_insert"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.tc_insert(*a, *ins, 8, claim), reps,
                   restore),
        plain_ms=time_ms(
            lambda: probe.tc_insert_plain(*a, *ins, 8), 3, restore,
            queue_ahead=False),
        # in: rows, key, val, mask; the presence rows (key + state); one
        # state row a pending query; out: the winners' slots, ok, present
        **bound(QU * 17 + nrows * W * 8 + pend * W * 4
                + int(ok_t.sum()) * 12 + QU * 2,
                nrows * W * 2 + pend * W),
        cases=timed)

    # -- tc_probe2: old table mid-rebuild, hazard buffer with killed
    #    entries, new tables 4x (+3 rows, not a power of two) and 1x
    err = 0
    so = ts.clone()
    cursor = torch.tensor(7 * CH, dtype=i32, device=device)
    hk, hv, hl, _ = probe.extract_plain(tk.view(-1), tv.view(-1), so.view(-1),
                                        cursor, CH)
    hz_live = int(hl.sum())
    hl = hl & torch.as_tensor(rng.random(CH) < 0.8, device=device)  # kills
    for b_new, seed in ((4 * B + 3, 51), (B, 52)):
        nfa, nfb, nk, nv, ns, nkeys = build_rows_table(
            probe, hashing, b_new, W, B, rng, device, seed)
        for q in (Q + 77, Q):
            n4 = q // 4
            qk = torch.cat([
                keys[torch.as_tensor(rng.integers(0, keys.numel(), n4),
                                     device=device)],
                hk[torch.as_tensor(rng.integers(0, max(hz_live, 1), n4),
                                   device=device)],
                nkeys[torch.as_tensor(rng.integers(0, nkeys.numel(), n4),
                                      device=device)],
                torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                             q - 3 * n4).astype(np.int32),
                                device=device)])
            qk = qk[torch.as_tensor(rng.permutation(q),
                                    device=device)].contiguous()
            rao, rbo = rows(qk)
            ran, rbn = rows(qk, b_new, nfa, nfb)
            args = ((tk, tv, so), (nk, nv, ns), hk, hv, hl, rao, rbo, ran,
                    rbn, qk)
            out_k = probe.tc_probe2(*args)
            torch.cuda.synchronize()
            out_p = probe.tc_probe2_plain(*args)
            for x, y, n in zip(out_k, out_p, OUTPUTS):
                err = max(err, same(x, y, f"tc_probe2 Bnew={b_new} Q={q} {n}"))
            check(bool(out_k[2].any()) and bool((out_k[4] >= 0).any())
                  and bool((out_k[5] >= 0).any()) and not bool(out_k[0].all()),
                  "tc_probe2: inputs must hit old, hazard, new and nothing")
    found, _, f_old, _, hz_idx, loc_new = out_k
    hz_lookups = int((~f_old).sum())
    unres = ~f_old & (hz_idx < 0)
    r_old = rows_read(ref, tk, tv, so, rao, qk)
    r_new = rows_read(ref, nk, nv, ns, ran, qk, unres)
    res["tc_probe2"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.tc_probe2(*args), reps),
        plain_ms=time_ms(lambda: probe.tc_probe2_plain(*args), 3,
                         queue_ahead=False),
        # in: four rows and a key a query, the rows read, the hazard
        # buffer, the value of a hit; out: six outputs; operations: a
        # hazard lookup for each query the old table did not resolve, two
        # a lane of each row read
        **bound(Q * 20 + (r_old + r_new) * W * 8 + CH * 9
                + int(found.sum()) * 4 + Q * 18,
                SET_LOOKUP_OPS * hz_lookups + (r_old + r_new) * W * 2))
    log(f"  tc_probe2 ok: Q={Q} hazard lookups={hz_lookups} rows read "
        f"old={r_old} new={r_new}")

    # -- tc_probe2 on the staged set's own cases: duplicate live hazard keys
    #    with dead entries between them, an empty and a full buffer, every
    #    key in one probe run of the index; small batches (one block's
    #    staging with a few queries: Q = 256 times the staging)
    cases = {"phase-2": args}
    for label, (ck, cv, cl, ckeys) in hazard_cases(hk, hv, hl, rng,
                                                   device).items():
        n4 = Q // 4
        qk = torch.cat([
            keys[torch.as_tensor(rng.integers(0, keys.numel(), n4),
                                 device=device)],
            ckeys[torch.as_tensor(rng.integers(0, ckeys.numel(), n4),
                                  device=device)],
            nkeys[torch.as_tensor(rng.integers(0, nkeys.numel(), n4),
                                  device=device)],
            torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                         Q - 3 * n4).astype(np.int32),
                            device=device)])
        qk = qk[torch.as_tensor(rng.permutation(Q), device=device)]
        rao, rbo = rows(qk)
        ran, rbn = rows(qk, B, nfa, nfb)
        cases[label] = ((tk, tv, so), (nk, nv, ns), ck, cv, cl, rao, rbo, ran,
                        rbn, qk.contiguous())
    for q in (1, 33, 256):
        for label in ("phase-2", "full"):
            a = cases[label]
            cases[f"{label} Q={q}"] = (*a[:5], *(t[:q] for t in a[5:]))
    res["tc_probe2"]["cases"] = compare_cases(
        "tc_probe2", probe.tc_probe2, probe.tc_probe2_plain, cases, reps,
        baseline)
    hits = {k: int((probe.tc_probe2(*a)[4] >= 0).sum())
            for k, a in cases.items() if "Q=" not in k}
    check(hits["empty"] == 0 and min(hits["duplicates"], hits["full"],
                                     hits["one_run"]) > Q // 8,
          f"tc_probe2: hazard hits of the cases {hits}")
    log(f"  tc_probe2 cases ok: hazard hits {hits}")

    # -- the chunk contract of the two-row path: above 4096 a table on the
    #    card is refused by tc_probe2 and by both adapters; nothing launches
    big = 2 * probe.EXTRACT_MAX_CHUNK
    zk = torch.zeros(big, dtype=i32, device=device)
    zl = torch.zeros(big, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=i32, device=device)
    tables = {n: backend.get(n).make(1 << 14, 0, device=device)
              for n in ("twochoice", "cuckoo")}
    before = probe.launch_counts()
    for what, call in (
            ("tc_probe2", lambda: probe.tc_probe2(
                (tk, tv, so), (nk, nv, ns), zk, zk, zl, rao, rbo, ran, rbn,
                qk)),
            ("backend.extract_chunk_fused, twochoice",
             lambda: backend.extract_chunk_fused(
                 tables["twochoice"], zero, big)),
            ("backend.extract_chunk_fused, cuckoo",
             lambda: backend.extract_chunk_fused(
                 tables["cuckoo"], zero, big))):
        try:
            call()
        except ValueError:
            continue
        check(False, f"{what}: a chunk of {big} on the card must raise")
    check(probe.launch_counts() == before, "a refused chunk was launched")
    log(f"  chunk contract ok: chunk {big} on the card raises in tc_probe2 "
        f"and both two-row adapters")
    return res


def build_chain(device, nb: int, n: int, n_live: int, rng, seed: int,
                hot: int = 0, tail: int = 0):
    """A chain arena of ``n`` nodes and ``nb`` buckets: ``n_live`` random
    keys (and ``hot`` more, all in bucket 5; none in buckets 1 to 3, which
    stay empty) packed into sorted segments by the compaction, a dirty tail
    of ``tail`` keys placed by the PLAIN insert, then a share of the sorted
    nodes tombstoned and a share marked MIGRATED.  The compaction is the
    plain one, so that no kernel under test builds its own inputs.  Returns
    (table, keys)."""
    from repro_torch.core import backend, buckets, hashing
    from repro_torch.kernels import probe
    t = buckets.chain_make(nb, n, hashing.fresh("mix32", seed, device),
                           device=device)
    total = n_live + tail
    uniq = np.unique(rng.integers(-(1 << 30), 1 << 30, total + total // 4))
    keys = torch.as_tensor(rng.permutation(uniq).astype(np.int32),
                           device=device)
    b = hashing.bucket_of(t.hfn, keys, nb)
    keys = keys[(b < 1) | (b > 3)][:total]
    check(keys.numel() == total, "not enough distinct keys drawn")
    if hot:
        cand = torch.empty(0, dtype=torch.int32, device=device)
        while cand.numel() < hot:
            more = torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                                1 << 22).astype(np.int32),
                                   device=device)
            more = more[hashing.bucket_of(t.hfn, more, nb) == 5]
            cand = torch.cat([cand, more]).unique()
        cand = cand[:hot]
        keys = torch.cat([keys[:n_live], cand, keys[n_live:]])
    m = keys.numel() - tail
    t.akey[:m] = keys[:m]
    t.aval[:m] = keys[:m] * 3 + 1
    t.astate[:m] = buckets.LIVE
    probe.chain_compact_plain(backend._chain_fields(t), t.hfn, nb)
    live = (t.astate == buckets.LIVE).nonzero().squeeze(1)
    pick = live[torch.as_tensor(rng.permutation(live.numel()),
                                device=device)]
    k = live.numel() // 10
    t.astate[pick[:k]] = buckets.TOMB
    t.astate[pick[k:2 * k]] = buckets.MIGRATED
    if tail:
        kt = keys[m:]
        t, ok = buckets.chain_insert(t, kt, kt * 3 + 1,
                                     torch.ones_like(kt, dtype=torch.bool))
        check(bool(ok.all()), "the dirty tail did not go in")
    return t, keys


def chain_work(t, bq, qk, sel=None):
    """What a chain kernel does for the queries in ``sel`` of one arena:
    (nodes — segment nodes read up to the hit or the segment's end, and the
    hops of the bounded walks; tail lookups — the queries the segment did
    not settle, each one lookup in the staged dirty window; the queries
    that walked; the queries the fast path found)."""
    from repro_torch.core import buckets
    from repro_torch.kernels import probe
    if sel is None:
        sel = torch.ones_like(qk, dtype=torch.bool)
    arena, links, seg = buckets._chain_parts(t)
    f, _, loc, complete = probe._chain_fast_plain(
        arena, seg, bq, qk, t.max_chain, t.dirty_cap)
    b = bq.long()
    h0, ln = t.bstart[b], t.blen[b]
    seg_hit = f & (loc < t.sorted_upto)
    nodes = torch.where(ln <= t.max_chain,
                        torch.where(seg_hit, loc - h0 + 1, ln), 0)
    tail_lookups = int((sel & ~seg_hit).sum())
    need = sel & ~f & ~complete
    cur = t.heads[b[need]].long()
    key = qk[need]
    hops = 0
    for _ in range(t.max_chain):
        act = cur >= 0
        if not bool(act.any()):
            break
        hops += int(act.sum())
        c = torch.where(act, cur, 0)
        hit = act & (t.astate[c] == buckets.LIVE) & (t.akey[c] == key)
        cur = torch.where(act & ~hit, t.anext[c].long(), -1)
    return int(nodes[sel].sum()) + hops, tail_lookups, need, f


def tail_duplicates(t, rng, device):
    """A copy of chain arena ``t`` whose dirty tail holds duplicate live
    keys: a sixth of the tail nodes give their key to two more tail nodes
    further on, with other values; a third of those lowest copies TOMB;
    another sixth of the tail nodes TOMB or MIGRATED.  Returns (table, the
    duplicated keys)."""
    from repro_torch.core import buckets
    su, d = int(t.sorted_upto), int(buckets.chain_dirty(t))
    pos = su + torch.as_tensor(rng.permutation(d), device=device)
    m = d // 6
    a, b, c = pos[:3 * m].view(m, 3).sort(dim=1).values.unbind(1)
    dead = pos[3 * m:4 * m]
    ak, av, st = t.akey.clone(), t.aval.clone(), t.astate.clone()
    ak[b], ak[c] = ak[a], ak[a]
    av[b], av[c] = av[a] + 1, av[a] + 2
    st[b], st[c] = buckets.LIVE, buckets.LIVE
    st[a[: m // 3]] = buckets.TOMB
    st[dead[: m // 2]] = buckets.TOMB
    st[dead[m // 2:]] = buckets.MIGRATED
    return dataclasses.replace(t, akey=ak, aval=av, astate=st), ak[a]


def phase_chain_kernels(device, cfg, reps: int, baseline=None) -> dict:
    """The two chain kernels against their plain versions at the chain
    shapes of the main path: an arena of 2^20 nodes, 2^16 buckets."""
    from repro_torch.core import backend, buckets, hashing
    from repro_torch.kernels import probe
    rng = np.random.default_rng(13)
    n, nb = cfg.capacity_per_shard, cfg.capacity_per_shard // 16
    Q, CH = cfg.lookups_per_step, cfg.chunk
    i32 = torch.int32
    res = {}

    t, keys = build_chain(device, nb, n, n // 2, rng, 61, hot=100, tail=300)
    hot, tail = keys[n // 2:n // 2 + 100], keys[-300:]
    # the old arena mid-rebuild: a chunk extracted into the hazard buffer
    # (its nodes MIGRATED), some hazard entries killed; and a copy of it
    # whose dirty tail outgrew the window
    so = t.astate.clone()
    old = dataclasses.replace(t, astate=so)
    cursor = torch.tensor(7 * CH, dtype=i32, device=device)
    hk, hv, hl, _ = probe.extract_plain(t.akey, t.aval, so, cursor, CH)
    hz_live = hk[hl]
    hl = hl & torch.as_tensor(rng.random(CH) < 0.8, device=device)
    extra = torch.as_tensor(rng.integers(-(1 << 31), -(1 << 30), 700)
                            .astype(np.int32), device=device).unique()
    stale, _ = buckets.chain_insert(old, extra, extra * 3 + 1,
                                    torch.ones_like(extra, dtype=torch.bool))
    cand = torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1, 1 << 20)
                           .astype(np.int32), device=device)
    bc = hashing.bucket_of(t.hfn, cand, nb)
    empty = cand[(bc >= 1) & (bc <= 3)][:64]           # buckets left empty
    blen = t.blen
    log(f"  chain arena: N={n} buckets={nb} live={int((so == 1).sum())}"
        f" tomb={int((so == 2).sum())} migrated={int((so == 3).sum())} "
        f"sorted={int(t.sorted_upto)} dirty={int(buckets.chain_dirty(t))} "
        f"(stale copy {int(buckets.chain_dirty(stale))}); longest segment "
        f"{int(blen.max())}, empty buckets {int((blen == 0).sum())}")
    check(empty.numel() > 0, "the arena must have empty buckets")

    def chain_queries(q, *key_sets):
        """``q`` queries: equal shares of each key set, the rest misses."""
        share = q // (len(key_sets) + 1)
        parts = [ks[torch.as_tensor(rng.integers(0, ks.numel(), share),
                                    device=device)] for ks in key_sets]
        parts.append(torch.as_tensor(
            rng.integers(1 << 30, (1 << 31) - 1, q - share * len(key_sets))
            .astype(np.int32), device=device))
        qk = torch.cat(parts)
        return qk[torch.as_tensor(rng.permutation(q), device=device)]

    # -- chain_probe: hits in the segments and the tail, dead nodes, the hot
    #    segment past max_chain, empty buckets, a tail past the window
    err = 0
    for table, what in ((old, "tail in window"), (stale, "tail past window")):
        for q in (Q + 77, Q):
            qk = chain_queries(q, keys, hot, tail, empty).contiguous()
            bq = hashing.bucket_of(table.hfn, qk, nb)
            args = (*buckets._chain_parts(table), bq, qk, table.max_chain,
                    table.dirty_cap)
            out_k = probe.chain_probe(*args)
            torch.cuda.synchronize()
            out_p = probe.chain_probe_plain(*args)
            for a, b, nm in zip(out_k, out_p, ("found", "val", "loc")):
                err = max(err, same(a, b, f"chain_probe {what} Q={q} {nm}"))
        f, _, loc = out_k
        nodes, lookups, need, _ = chain_work(table, bq, qk)
        check(bool(f.any()) and not bool(f.all()), "chain_probe: inputs "
              "must mix hits and misses")
        check(bool((f & (loc >= table.sorted_upto)).any()),
              "chain_probe: some hits must lie in the dirty tail")
        check(bool(need.any()) and bool((table.blen[bq.long()] == 0).any())
              and bool((table.blen[bq.long()] > table.max_chain).any()),
              "chain_probe: some queries must walk, meet an empty bucket "
              "and a segment past max_chain")
        log(f"  chain_probe ok ({what}): Q={Q} hits={int(f.sum())} "
            f"nodes read={nodes} tail lookups={lookups} "
            f"walked={int(need.sum())}")
    qk = chain_queries(Q, keys).contiguous()
    bq = hashing.bucket_of(t.hfn, qk, nb)
    args = (*buckets._chain_parts(old), bq, qk, t.max_chain, t.dirty_cap)
    f = probe.chain_probe(*args)[0]
    nodes, lookups, need, _ = chain_work(old, bq, qk)
    hits = int(f.sum())
    res["chain_probe"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.chain_probe(*args), reps),
        plain_ms=time_ms(lambda: probe.chain_probe_plain(*args), 3,
                         queue_ahead=False),
        # in: key and bucket, the bucket's (start, len), 8 bytes a node read
        # (key, state; a walk hop also its link), the value of a hit; out:
        # found, val, loc; operations: two a node, a tail lookup
        # (SET_LOOKUP_OPS) for each query its segment did not settle
        **bound(Q * 16 + nodes * 8 + int(need.sum()) * 4 + hits * 4 + Q * 9,
                2 * nodes + SET_LOOKUP_OPS * lookups))

    # -- chain_probe on the staged set's own cases: duplicate live keys and
    #    TOMB / MIGRATED nodes in the tail, an empty tail, a tail whose keys
    #    all have one home slot of the set's index, an arena of 2^16 + 3
    #    nodes (segments scanned a node a step: not 16-byte loads), small and
    #    main-path batches
    mc, dc = t.max_chain, t.dirty_cap

    def probe_case(table, *key_sets):
        qk = chain_queries(Q, keys, *key_sets).contiguous()
        return (*buckets._chain_parts(table),
                hashing.bucket_of(table.hfn, qk, table.nbuckets), qk, mc, dc)
    odd, odd_keys = build_chain(device, nb // 16, n // 16 + 3, n // 32, rng,
                                63, tail=200)
    o2, okeys = tail_duplicates(old, rng, device)
    flat = _clone_table(old)
    probe.chain_compact_plain(backend._chain_fields(flat), flat.hfn, nb)
    rk = torch.as_tensor(one_run_keys(dc, rng), device=device)
    rk = rk[~torch.isin(rk, flat.akey)]      # (a key already in the arena)
    one_run, _ = buckets.chain_insert(
        _clone_table(flat), rk, rk * 3 + 1, torch.ones_like(rk,
                                                            dtype=torch.bool))
    check(int(buckets.chain_dirty(one_run)) == rk.numel() > dc - 16
          and int(buckets.chain_dirty(flat)) == 0,
          "chain_probe cases: tails of the one-run and the empty case")
    pcases = {"phase-2": args,
              "tail_duplicates": probe_case(o2, okeys, tail),
              "empty tail": probe_case(flat, tail, hot),
              "one_run": probe_case(one_run, rk),
              "odd arena": probe_case(odd, odd_keys)}
    for q in (1, 33, 256, cfg.updates_per_step // 2, cfg.updates_per_step):
        pcases[f"phase-2 Q={q}"] = (*args[:3], args[3][:q], args[4][:q], mc,
                                    dc)
    res["chain_probe"]["cases"] = compare_cases(
        "chain_probe", probe.chain_probe, probe.chain_probe_plain, pcases,
        reps, baseline, ("found", "val", "loc"))
    tail_hits = {}
    for label in ("tail_duplicates", "one_run"):
        a = pcases[label]
        f, _, loc = probe.chain_probe(*a)
        tail_hits[label] = int((f & (loc >= a[2][2])).sum())
    check(min(tail_hits.values()) > Q // 8,
          f"chain_probe cases: hits in the tail {tail_hits}")
    log(f"  chain_probe cases ok: hits in the tail {tail_hits}")

    # -- chain_probe2: the old arena mid-rebuild, a new arena 4x the old
    #    with its own tail, and the stale old arena whose misses walk
    new, nkeys = build_chain(device, 4 * nb, 4 * n, n // 2, rng, 62,
                             tail=120)
    err = 0
    for o, what in ((old, "old in window"), (stale, "old past window")):
        for q in (Q + 77, Q):
            qk = chain_queries(q, keys, hz_live, nkeys, hot).contiguous()
            bo = hashing.bucket_of(o.hfn, qk, nb)
            bn = hashing.bucket_of(new.hfn, qk, 4 * nb)
            args = (buckets._chain_parts(o), buckets._chain_parts(new), hk,
                    hv, hl, bo, bn, qk, o.max_chain, o.dirty_cap)
            out_k = probe.chain_probe2(*args)
            torch.cuda.synchronize()
            out_p = probe.chain_probe2_plain(*args)
            for x, y, nm in zip(out_k, out_p, OUTPUTS):
                err = max(err, same(x, y, f"chain_probe2 {what} Q={q} {nm}"))
            check(bool(out_k[2].any()) and bool((out_k[4] >= 0).any())
                  and bool((out_k[5] >= 0).any()) and not bool(out_k[0].all()),
                  "chain_probe2: inputs must hit old, hazard, new and "
                  "nothing")
        log(f"  chain_probe2 ok ({what}): Q={Q} old={int(out_k[2].sum())} "
            f"hazard={int((out_k[4] >= 0).sum())} "
            f"new={int((out_k[5] >= 0).sum())} found={int(out_k[0].sum())}")
    qk = chain_queries(Q, keys, hz_live, nkeys).contiguous()
    bo = hashing.bucket_of(old.hfn, qk, nb)
    bn = hashing.bucket_of(new.hfn, qk, 4 * nb)
    args = (buckets._chain_parts(old), buckets._chain_parts(new), hk, hv, hl,
            bo, bn, qk, old.max_chain, old.dirty_cap)
    found, _, f_old, _, hz_idx, _ = probe.chain_probe2(*args)
    n_old, l_old, _, fast_old = chain_work(old, bo, qk)
    n_new, l_new, _, _ = chain_work(new, bn, qk, ~f_old & (hz_idx < 0))
    hz_lookups = int((~fast_old).sum())
    res["chain_probe2"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: probe.chain_probe2(*args), reps),
        plain_ms=time_ms(lambda: probe.chain_probe2_plain(*args), 3,
                         queue_ahead=False),
        # in: key and two buckets, each arena's (start, len) of the bucket,
        # the nodes read, the hazard buffer, the value of a hit; out: six
        # outputs; operations: two a node, a lookup (SET_LOOKUP_OPS) in each
        # tail window and in the hazard buffer that a query consults
        **bound(Q * 12 + Q * 8 + int((~f_old).sum()) * 8
                + (n_old + n_new) * 8 + CH * 9 + int(found.sum()) * 4
                + Q * 18,
                2 * (n_old + n_new)
                + SET_LOOKUP_OPS * (l_old + l_new + hz_lookups)))
    log(f"  chain_probe2 timed: lookups hazard={hz_lookups} tail old={l_old}"
        f" new={l_new}; nodes read old={n_old} new={n_new}")

    # -- chain_probe2 on the staged set's own cases: the hazard buffers of
    #    tc_probe2's cases, dirty tails with duplicate live keys and TOMB /
    #    MIGRATED nodes in both arenas, small batches
    mc, dc = old.max_chain, old.dirty_cap
    cases = {"phase-2": args}

    def chain_case(o, n, ck, cv, cl, qk):
        qk = qk.contiguous()
        return (buckets._chain_parts(o), buckets._chain_parts(n), ck, cv, cl,
                hashing.bucket_of(o.hfn, qk, nb),
                hashing.bucket_of(n.hfn, qk, 4 * nb), qk, mc, dc)
    for label, (ck, cv, cl, ckeys) in hazard_cases(hk, hv, hl, rng,
                                                   device).items():
        cases[label] = chain_case(old, new, ck, cv, cl,
                                  chain_queries(Q, keys, ckeys, nkeys))
    o2, okeys = tail_duplicates(old, rng, device)
    n2, nkeys2 = tail_duplicates(new, rng, device)
    cases["tail_duplicates"] = chain_case(
        o2, n2, hk, hv, hl, chain_queries(Q, keys, okeys, nkeys2, hz_live))
    qk = chain_queries(Q, odd_keys, hz_live, nkeys).contiguous()
    cases["odd old arena"] = (
        buckets._chain_parts(odd), buckets._chain_parts(new), hk, hv, hl,
        hashing.bucket_of(odd.hfn, qk, odd.nbuckets),
        hashing.bucket_of(new.hfn, qk, 4 * nb), qk, mc, dc)
    for q in (1, 33, 256):
        for label in ("phase-2", "full"):
            a = cases[label]
            cases[f"{label} Q={q}"] = (*a[:5], *(t[:q] for t in a[5:8]),
                                       mc, dc)
    res["chain_probe2"]["cases"] = compare_cases(
        "chain_probe2", probe.chain_probe2, probe.chain_probe2_plain, cases,
        reps, baseline)
    hits = {k: int((probe.chain_probe2(*a)[4] >= 0).sum())
            for k, a in cases.items() if "Q=" not in k}
    check(hits["empty"] == 0 and min(hits["duplicates"], hits["full"],
                                     hits["one_run"]) > Q // 8,
          f"chain_probe2: hazard hits of the cases {hits}")
    out = probe.chain_probe2(*cases["tail_duplicates"])
    tail_old = int((out[2] & (out[3] >= o2.sorted_upto)).sum())
    tail_new = int(((out[5] >= 0) & (out[5] >= n2.sorted_upto)).sum())
    check(tail_old > Q // 16 and tail_new > Q // 16,
          f"chain_probe2: tail hits old {tail_old}, new {tail_new}")
    log(f"  chain_probe2 cases ok: hazard hits {hits}; duplicate tails: "
        f"hits in the old tail {tail_old}, in the new tail {tail_new}")

    # -- the contracts of the chain path on the card: a chunk above 4096 and
    #    a dirty window above 512 are refused; nothing launches
    big = 2 * probe.EXTRACT_MAX_CHUNK
    zk = torch.zeros(big, dtype=i32, device=device)
    zl = torch.zeros(big, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=i32, device=device)
    table = backend.get("chain").make(1 << 14, 0, device=device)
    before = probe.launch_counts()
    for what, call in (
            ("chain_probe2, chunk", lambda: probe.chain_probe2(
                buckets._chain_parts(old), buckets._chain_parts(new), zk, zk,
                zl, bo, bn, qk, 64, 512)),
            ("chain_probe, window", lambda: probe.chain_probe(
                *buckets._chain_parts(t), bq, qk, 64, 1024)),
            ("backend.chain_extract_chunk_fused",
             lambda: backend.chain_extract_chunk_fused(table, zero, big))):
        try:
            call()
        except ValueError:
            continue
        check(False, f"{what}: must raise on the card")
    check(probe.launch_counts() == before, "a refused call was launched")
    log(f"  contracts ok: chunk {big} raises in chain_probe2 and the chain "
        f"adapter, a 1024-node window in chain_probe")
    return res


def cuckoo_table(device, nbuckets: int, n_live: int, rng, seed: int):
    """An empty cuckoo table of ``nbuckets`` rows a side (width 8) with
    ``n_live`` random keys offered to the plain claim rounds, ``nbuckets``
    keys a call, so rows fill unevenly; some keys find no lane."""
    from repro_torch.core import backend, buckets
    from repro_torch.kernels import probe
    t = backend.get("cuckoo").make(12 * (nbuckets - 1), seed, device=device)
    check(t.nbuckets == nbuckets, f"cuckoo table of {t.nbuckets} rows")
    keys = torch.as_tensor(np.unique(rng.integers(
        1, 1 << 30, n_live + n_live // 4))[:n_live].astype(np.int32),
        device=device)
    for i in range(0, n_live, nbuckets):
        k = keys[i:i + nbuckets]
        probe.tc_insert_plain(t.key, t.val, t.state, *buckets._ck_rows(t, k),
                              k, k * 3 + 1, torch.ones_like(k,
                                                            dtype=torch.bool),
                              8)
    return t


def fold_case(label: str, tab, args, tally: dict, baseline, reps: int):
    """The cuckoo insert as the main path runs it (``probe.cuckoo_insert``:
    the claim rounds and the kick-out in one ``tc_insert`` launch) from the
    table before the batch, against ``cuckoo_insert_plain`` (tolerance 0):
    the claim words all free afterwards, and the kick-out's tally that of
    the standalone kernel on the same batch (``tally``).  Timed against this
    tree's three launches (``tc_insert``, then ``cuckoo_kick``) and, with
    a baseline, in turns with the other tree's (its ``tc_insert``, then its
    ``cuckoo_kick``, or its own folded insert), and profiled: device µs and
    PyTorch ops a call."""
    from repro_torch.kernels import probe
    ra, rb, hfa, hfb, nb, k, v, win = args
    kick = (ra, rb, hfa, hfb, nb, k, v, win)
    dev = k.device
    pre = [x.clone() for x in (tab.key, tab.val, tab.state)]
    a = [x.clone() for x in pre]
    b = [x.clone() for x in pre]
    tally0 = probe.kick_tally(dev)
    before = probe.launch_counts()
    ok_k, pr_k = probe.cuckoo_insert(*a, ra, rb, hfa, hfb, nb, k, v, win,
                                     tab.max_kick, tab.claim)
    torch.cuda.synchronize()
    got = {n: x - tally0[n] for n, x in probe.kick_tally(dev).items()}
    launched = {n: x - before[n] for n, x in probe.launch_counts().items()
                if x != before[n]}
    ok_p, pr_p = probe.cuckoo_insert_plain(*b, ra, rb, hfa, hfb, nb, k, v,
                                           win, tab.max_kick)
    for x, y, n in zip((*a, ok_k, pr_k), (*b, ok_p, pr_p),
                       ("key", "val", "state", "ok", "present")):
        same(x, y, f"cuckoo_insert {label} {n}")
    check(bool((tab.claim == probe.CLAIM_FREE).all()),
          f"cuckoo_insert {label}: row locks left behind")
    check(got == tally, f"cuckoo_insert {label}: the kick-out's tally {got}, "
                        f"the standalone kernel's {tally}")
    check(launched == {"tc_insert": 1},
          f"cuckoo_insert {label}: launched {launched}")

    def restore():
        for x, y in zip(a, pre):
            x.copy_(y)

    def folded():
        probe.cuckoo_insert(*a, ra, rb, hfa, hfb, nb, k, v, win,
                            tab.max_kick, tab.claim)

    def composed(ins=None):
        def run():
            if ins is None:
                ok, pr = probe.tc_insert(*a, ra, rb, k, v, win, 2, tab.claim)
            else:
                ok, pr = ins(*a, ra, rb, k, v, win, 2)
            probe.cuckoo_kick(*a, *kick, ok, pr, tab.max_kick, tab.claim)
            return ok, pr
        return run
    entry = dict(placed=int(ok_k.sum()), **got,
                 ms=time_ms(folded, reps, restore),
                 three_launches_ms=time_ms(composed(), reps, restore))
    calls = {"folded": folded, "three launches": composed()}
    if baseline is not None:
        def parent():
            entry = baseline["tc_insert"].entry
            if entry is not None:       # the other tree folds the kick-out
                with swapped("tc_insert", entry):
                    return probe.cuckoo_insert(*a, ra, rb, hfa, hfb, nb, k,
                                               v, win, tab.max_kick,
                                               tab.claim)
            with swapped("cuckoo_kick", baseline["cuckoo_kick"]):
                return composed(baseline["tc_insert"])()
        restore()
        ok_b, pr_b = parent()
        torch.cuda.synchronize()
        for x, y, n in zip((*a, ok_b, pr_b), (*b, ok_p, pr_p),
                           ("key", "val", "state", "ok", "present")):
            same(x, y, f"cuckoo insert (baseline) {label} {n}")
        t = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            t[who].append(time_ms(parent if who == "parent" else folded,
                                  reps, restore))
        entry["in_turns"] = {"ms": t["this"], "parent_ms": t["parent"]}
        calls["parent"] = parent
    entry["profile"] = {}
    for name, fn in calls.items():
        us, ops, kern = profile_calls(fn, 50, restore)
        entry["profile"][name] = {"device_us": us, "ops": ops,
                                  "kernels": kern}
    log(f"  cuckoo_insert ok: {label} " + json.dumps(entry))
    return entry


def phase_guard_kernels(device, cfg, reps: int, baseline=None) -> dict:
    """The guarded kernels against their plain versions (tolerance 0): the
    cuckoo kick-out at the cuckoo main path's shape (2 x 2^17 rows x 8) on
    the main path's kind of batch, under a flood of 2048 keys on one row, on
    a crowded table where most keys must move a resident, and with nothing
    pending; the chain compaction (``compact_cases``); the rebuild step's
    transition (``transition_cases``); the epoch swap on the four backends'
    full-size tables, for a rebuild that is done (swap and start, swap
    alone), one mid-epoch (nothing) and no rebuild (start alone), each on
    its own decision and on a given go, and on leaves that are not 16-byte
    aligned."""
    from repro_torch.core import backend, buckets, hashing
    from repro_torch.kernels import probe
    rng = np.random.default_rng(14)
    QU, CH, W = cfg.updates_per_step, cfg.chunk, 8
    res = {}

    # -- cuckoo_kick
    Bs = cfg.capacity_per_shard // 8
    t = cuckoo_table(device, Bs, cfg.capacity_per_shard, rng, 71)
    crowd = cuckoo_table(device, 1 << 10, int(2 * 8 * (1 << 10) * 0.93),
                         rng, 72)
    log(f"  cuckoo table: 2 x {Bs} x {W} live={int((t.state == 1).sum())}; "
        f"crowded 2 x {crowd.nbuckets} x {W} "
        f"live={int((crowd.state == 1).sum())}")

    def fresh(q, tab, row0=False):
        if row0:                       # keys whose side-A row is row 0
            gen = torch.Generator(device=device)
            gen.manual_seed(99)
            got = torch.empty(0, dtype=torch.int32, device=device)
            while got.numel() < q:
                cand = torch.randint(1 << 30, (1 << 31) - 1, (1 << 24,),
                                     generator=gen, device=device,
                                     dtype=torch.int32)
                hit = cand[hashing.bucket_of(tab.hfn_a, cand,
                                             tab.nbuckets) == 0]
                got = torch.unique(torch.cat([got, hit]))
            k = got[:q]
        else:
            k = torch.as_tensor(np.unique(rng.integers(
                -(1 << 31), -(1 << 30), 2 * q))[:q].astype(np.int32),
                device=device)
        return k[torch.as_tensor(rng.permutation(q), device=device)]

    def kick_inputs(tab, k):
        """The claim kernel's outputs on a copy of ``tab``: the kick-out's
        inputs (table after the claim rounds, rows, flags)."""
        a = [x.clone() for x in (tab.key, tab.val, tab.state)]
        ra, rb = buckets._ck_rows(tab, k)
        win = torch.ones_like(k, dtype=torch.bool)
        ok, present = probe.tc_insert(*a, ra, rb, k, k * 7 + 3, win, 2,
                                      tab.claim)
        return a, (ra, rb, tab.hfn_a, tab.hfn_b, tab.nbuckets, k, k * 7 + 3,
                   win), ok, present

    err, kick, fold = 0, {}, {}
    for label, tab, k in (("main path", t, fresh(QU, t)),
                          ("flood", t, fresh(2048, t, row0=True)),
                          ("crowded", crowd, fresh(4096, crowd)),
                          ("nothing pending", t, fresh(QU, t))):
        a, args, ok, present = kick_inputs(tab, k)
        if label == "nothing pending":
            args = (*args[:-1], torch.zeros_like(args[-1]))
        pend = int((args[-1] & ~ok & ~present).sum())
        b = [x.clone() for x in a]
        pre = b[0].clone()
        ok_k, ok_p = ok.clone(), ok.clone()
        tally0 = probe.kick_tally(device)
        probe.cuckoo_kick(*a, *args, ok_k, present, tab.max_kick, tab.claim)
        torch.cuda.synchronize()
        tally = {n: v - tally0[n] for n, v in probe.kick_tally(device).items()}
        probe.cuckoo_kick_plain(*b, *args, ok_p, present, tab.max_kick)
        for x, y, n in zip((*a, ok_k), (*b, ok_p),
                           ("key", "val", "state", "ok")):
            err = max(err, same(x, y, f"cuckoo_kick {label} {n}"))
        check(tab.claim is None or bool((tab.claim == probe.CLAIM_FREE)
                                        .all()),
              f"cuckoo_kick {label}: row locks left behind")
        placed = int((ok_k & ~ok).sum())
        # residents that a plan B moved into their alternate row
        moved = int(((a[0] != pre) & (a[2] == 1)
                     & ~torch.isin(a[0], k)).sum())
        if label == "nothing pending":
            check(pend == 0 and tally["runs"] == 0 and placed == 0,
                  f"cuckoo_kick: ran with nothing pending {tally}")
        elif label == "crowded":
            check(placed > 0 and moved > 0 and pend > placed,
                  f"cuckoo_kick crowded: placed {placed} of {pend}, moved "
                  f"{moved}: the table must make it move residents and "
                  f"refuse some")
        a0 = [x.clone() for x in a]

        def restore():
            for x, y in zip(a, a0):
                x.copy_(y)
            ok_k.copy_(ok)
        restore()
        ms = time_ms(lambda: probe.cuckoo_kick(*a, *args, ok_k, present,
                                               tab.max_kick, tab.claim),
                     reps, restore)
        kick[label] = dict(pending=pend, placed=placed, residents_moved=moved,
                           iterations=tally["iterations"], ms=ms)
        log(f"  cuckoo_kick ok: {label} " + json.dumps(kick[label]))
        fold[label] = fold_case(label, tab, args, tally, baseline, reps)
        if label == "main path":
            q = k.numel()
            rows_b = pend * (2 + 2 * W) * W * 4 * max(tally["iterations"], 1)
            main = dict(ms=ms, nbytes=q * 3 + rows_b + placed * 24 + q,
                        ops=q + pend * 2 * W * 30)
            plain_ms = time_ms(lambda: probe.cuckoo_kick_plain(
                *a, *args, ok_k, present, tab.max_kick), 3, restore,
                queue_ahead=False)
    res["cuckoo_kick"] = dict(
        max_abs_err=err, ms=main["ms"], plain_ms=plain_ms,
        # in: three flags a query, for each pending key in each iteration
        # its two rows' states and its victims' alternate rows; out: the
        # placed keys' and moved residents' slots, ok; operations: a flag
        # test a query and a hash of each victim (about 30 integer
        # operations) for each pending key
        **bound(main["nbytes"], main["ops"]), cases=kick)
    res["cuckoo_insert"] = fold

    # -- chain_compact at the chain main path's size: after a user insert
    #    (a half-full sorted arena with dead nodes and a tail of a batch and
    #    a dirty window), a bucket of 2048 nodes in the sorted runs, a bucket
    #    flooded with 2048 tail nodes (all live, or all but 40 deleted: a
    #    long walk), an arena whose every node is tail, an arena with nothing
    #    live; the guard off by its flag and by the dirty count, and on by
    #    the flag (the freeze)
    res["chain_compact"] = compact_cases(device, cfg, reps, rng, baseline)

    # -- the rebuild step's transition on the main path's tables of every
    #    backend, and its time (with a baseline: in turns with the other
    #    tree's sequence for the same work)
    res["transition"] = transition_cases(device, cfg, reps, baseline)

    # -- epoch_swap on the main path's tables of every backend: the exchange
    #    on the go it is given (an engine step's) and with its own decision
    err, swap = 0, {}
    want_go = {"done, swap and start": [True, True],
               "done, swap alone": [True, False],
               "mid-epoch": [False, False],
               "no rebuild, start": [False, True]}
    for name in BACKENDS:
        d = random_state(name, cfg, device, 5)
        cap = backend.get(name).capacity_of(d.old)
        for label, rb, cursor, swap_on, start_on in (
                ("done, swap and start", True, cap, True, True),
                ("done, swap alone", True, cap, True, False),
                ("mid-epoch", True, cap // 2, True, True),
                ("no rebuild, start", False, 0, True, True)):
            outs = []
            for fn, given in itertools.product(
                    (probe.epoch_swap, probe.epoch_swap_plain),
                    (False, True)):
                e = dataclasses.replace(
                    d, old=_clone_table(d.old), new=_clone_table(d.new),
                    hazard_live=torch.zeros_like(d.hazard_live),
                    cursor=torch.tensor(cursor, dtype=torch.int32,
                                        device=device),
                    rebuilding=torch.tensor(rb, device=device),
                    epoch=torch.tensor(6, dtype=torch.int32, device=device),
                    lookups=torch.tensor(3, dtype=torch.int32, device=device),
                    expensive=torch.tensor(2, dtype=torch.int32,
                                           device=device))
                lo, ln = backend.epoch_leaves(e.old), backend.epoch_leaves(e.new)
                go = fn([x for x, _ in lo], [x for x, _ in ln],
                        [s for _, s in lo], e.hazard_live, e.cursor,
                        e.rebuilding, e.epoch, e.lookups, e.expensive, cap,
                        swap_on, start_on,
                        torch.tensor(want_go[label], device=device)
                        if given else None)
                torch.cuda.synchronize()
                outs.append((go.clone(), [x for x, _ in lo + ln],
                             [e.cursor, e.rebuilding, e.epoch, e.lookups,
                              e.expensive]))
            for i, (gk, lk, sk) in enumerate(outs[1:]):
                gp, lp, sp = outs[0]
                err = max(err, same(gk, gp, f"epoch_swap {name} {label} "
                                    f"form {i + 1} go"))
                for j, (x, y) in enumerate(zip(lk + sk, lp + sp)):
                    err = max(err, same(x, y, f"epoch_swap {name} {label} "
                                              f"form {i + 1} leaf {j}"))
            check(outs[0][0].tolist() == want_go[label],
                  f"epoch_swap {name} {label}: go {outs[0][0].tolist()}, "
                  f"want {want_go[label]}")
        log(f"  epoch_swap ok: {name}, four cases, on its own decision and "
            f"on a given go")

        # the exchange on a given go, as an engine step launches it: swap
        # and start (once an epoch) and idle (every other step); the call
        # that decides first, idle
        lo, ln = backend.epoch_leaves(d.old), backend.epoch_leaves(d.new)
        specs = [s for _, s in lo]
        rb_t = torch.tensor(True, device=device)
        cur_t = torch.tensor(cap // 2, dtype=torch.int32, device=device)
        scal = [torch.zeros((), dtype=torch.int32, device=device)
                for _ in range(3)]
        gos = {v: torch.tensor(v, device=device)
               for v in ((True, True), (False, False))}

        def launch(go=None):
            return lambda: probe.epoch_swap(
                [x for x, _ in lo], [x for x, _ in ln], specs, d.hazard_live,
                cur_t, rb_t, *scal, cap, True, True, go)
        # read the new table, write both (the seeds and scalars aside)
        nbytes = sum(x.numel() * x.element_size() for x, _ in ln) * 3
        swap[name] = dict(
            swap_and_start_ms=time_ms(launch(gos[True, True]), reps),
            idle_ms=time_ms(launch(gos[False, False]), reps),
            decide_idle_ms=time_ms(launch(), reps),
            **bound(nbytes, 0))
        if baseline is not None:
            # this tree's exchange on its go, the other tree's epoch_swap
            # (its decision and its exchange), in turns, on swap and start
            # and on an idle step; the other tree's held to the plain
            # version first
            def parent(cur_v):
                return lambda: baseline["epoch_swap"](
                    [x for x, _ in lo], [x for x, _ in ln], specs,
                    d.hazard_live, cur_t.fill_(cur_v), rb_t.fill_(True),
                    *scal, cap, True, True)
            mut = [v for v, _ in lo + ln] + [cur_t, rb_t, *scal]
            for cur_v in (cap, cap // 2):
                snap = [v.clone() for v in mut]
                got = []
                for fn in (parent(cur_v), lambda: probe.epoch_swap_plain(
                        [x for x, _ in lo], [x for x, _ in ln], specs,
                        d.hazard_live, cur_t.fill_(cur_v), rb_t.fill_(True),
                        *scal, cap, True, True)):
                    for v, v0 in zip(mut, snap):
                        v.copy_(v0)
                    go = fn()
                    torch.cuda.synchronize()
                    got.append([go.clone()] + [v.clone() for v in mut])
                for a, b in zip(*got):
                    same(a, b, f"epoch_swap {name} (baseline) cursor={cur_v}")
            t = {k: [] for k in ("parent", "this", "parent_idle",
                                 "this_idle")}
            for who in ("parent", "this", "this", "parent"):
                fn = launch(gos[True, True]) if who == "this" \
                    else parent(cap)
                t[who].append(time_ms(fn, reps))
                fn = launch(gos[False, False]) if who == "this" \
                    else parent(cap // 2)
                t[who + "_idle"].append(time_ms(fn, reps))
            swap[name]["in_turns"] = {
                "swap_and_start_ms": t["this"],
                "parent_swap_and_start_ms": t["parent"],
                "idle_ms": t["this_idle"], "parent_idle_ms": t["parent_idle"]}
        log(f"  epoch_swap times, {name}: " + json.dumps(swap[name]))

    # -- leaves whose tensors are not 16-byte aligned, and lengths that are
    #    not a multiple of four: the scalar loop
    for n in (1, 1001):
        for go_v in want_go.values():
            outs = []
            for fn in (probe.epoch_swap, probe.epoch_swap_plain):
                g = torch.Generator(device=device)
                g.manual_seed(n)
                bufs = [torch.randint(-9, 99, (n + 8,), generator=g,
                                      device=device, dtype=torch.int32)
                        for _ in range(4)]
                old, new = [bufs[0][1:n + 1], bufs[1][4:n + 4]], \
                    [bufs[2][3:n + 3], bufs[3][:n]]
                sc = [torch.tensor(v, dtype=torch.int32, device=device)
                      for v in (0, 6, 3, 2)]
                rbt = torch.tensor(True, device=device)
                go = fn(old, new, [("fill", 7), ("desc",)],
                        torch.zeros(8, dtype=torch.bool, device=device),
                        sc[0], rbt, *sc[1:], n, True, True,
                        torch.tensor(go_v, device=device))
                torch.cuda.synchronize()
                outs.append(bufs + sc + [rbt])
            for x, y in zip(*outs):
                err = max(err, same(x, y, f"epoch_swap unaligned n={n} "
                                          f"go={go_v}"))
    log("  epoch_swap ok: unaligned leaves of 1 and 1001 words, four cases")
    lin = swap["linear"]
    d = random_state("linear", cfg, device, 5)
    lin_cap = backend.get("linear").capacity_of(d.old)
    lo, ln = backend.epoch_leaves(d.old), backend.epoch_leaves(d.new)
    res["epoch_swap"] = dict(
        max_abs_err=err, ms=lin["swap_and_start_ms"],
        plain_ms=time_ms(lambda: probe.epoch_swap_plain(
            [x for x, _ in lo], [x for x, _ in ln], [s for _, s in lo],
            d.hazard_live, d.cursor.fill_(lin_cap), d.rebuilding.fill_(True),
            d.epoch, d.lookups, d.expensive, lin_cap, True, True), 3,
            queue_ahead=False),
        bound_ms=lin["bound_ms"], bound_by=lin["bound_by"],
        idle_ms=lin["idle_ms"], by_backend=swap)
    return res


def random_state(name: str, cfg, device, seed: int):
    """A fused state of backend ``name`` at the main path's size whose
    tables' leaves hold random words (the hash seeds aside; slot and node
    states in EMPTY..MIGRATED, 45 % LIVE), mid-rebuild."""
    from repro_torch.core import backend, dhash
    d = dhash.make(name, capacity=cfg.capacity_per_shard, chunk=cfg.chunk,
                   fused=True, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for tab in (d.old, d.new):
        for x, spec in backend.epoch_leaves(tab):
            if spec[0] != "seeds":
                x.copy_(torch.randint(-9, 1 << 20, x.shape, generator=gen,
                                      device=device, dtype=torch.int32))
        st = scan_arrays(tab)[2]
        u = torch.rand(st.shape, generator=gen, device=device)
        st.copy_((u > 0.3).int() + (u > 0.75).int() + (u > 0.9).int())
    d.rebuilding.fill_(True)
    return d


def clone_state(d):
    """A copy of a DHashState with tensors of its own."""
    return dataclasses.replace(
        d, old=_clone_table(d.old), new=_clone_table(d.new),
        **{f.name: getattr(d, f.name).clone() for f in dataclasses.fields(d)
           if isinstance(getattr(d, f.name), torch.Tensor)})


def transition_cases(device, cfg, reps: int, baseline=None) -> dict:
    """The rebuild step's transition (``probe.transition``: the landing's
    bookkeeping, the guarded scan and the epoch decision in one ``extract``
    launch) against its plain version, tolerance 0, on the main path's
    tables of the four backends: hazard flags empty, partial and full; the
    landing's ok / present all, none and random; the cursor on the first
    chunk, a middle one (aligned, and 123 slots off), the partial last one
    and at the end; rebuilding on and off; swap_on x start_on.  Then, on the
    landing step (flags pending: no scan), the scan step and the idle one
    (not rebuilding), the transition's time; with a baseline the other
    tree's sequence for the same work (``baseline_sequence``: the PyTorch
    ops, its extract, its decision and exchange) against this tree's
    transition and exchange, held equal and timed in turns, and under the
    profiler: device µs and PyTorch ops a step of this work; and this
    tree's transition and exchange against the same with the exchange
    launched as an ordinary kernel, not a programmatic dependent
    (``serial``, a variant of ``epoch_swap.cu``), in turns."""
    from repro_torch.core import backend
    from repro_torch.kernels import build, probe
    CH = cfg.chunk
    serial = None if baseline is None else variant_entry(
        "epoch_swap", "programmaticStreamSerializationAllowed = 1",
        "programmaticStreamSerializationAllowed = 0")

    def serial_step(*a):
        lib = build.load()
        mine = lib["epoch_swap"]
        lib["epoch_swap"] = serial
        try:
            return transition_step(*a)
        finally:
            lib["epoch_swap"] = mine
    gen = torch.Generator(device=device)
    gen.manual_seed(18)

    def flags(kind):
        if kind in ("empty", "none"):
            return torch.zeros(CH, dtype=torch.bool, device=device)
        if kind in ("full", "all"):
            return torch.ones(CH, dtype=torch.bool, device=device)
        return torch.rand(CH, generator=gen, device=device) < 0.5

    err, out = 0, {"cases": 0}
    for i, name in enumerate(BACKENDS):
        d = random_state(name, cfg, device, 40 + i)
        be = backend.get(name)
        c = be.capacity_of(d.old)
        hz0 = [torch.randint(-9, 1 << 20, (CH,), generator=gen,
                             device=device, dtype=torch.int32)
               for _ in range(2)]
        seen = set()
        for cur, hl_kind, okp in itertools.product(
                (0, 5 * CH, 5 * CH + 123, c - 1000, c),
                ("empty", "partial", "full"), ("all", "none", "random")):
            hl0 = flags(hl_kind)
            ok = flags(okp)
            present = flags("random") & flags("random") if okp == "random" \
                else torch.zeros_like(ok)
            for rb, swap, start in itertools.product(
                    (True, False), (False, True), (False, True)):
                outs = []
                for fn in (be.transition_fused, None):
                    st = scan_arrays(d.old)[2].clone()
                    t = dataclasses.replace(d.old, **(
                        {"astate": st} if name == "chain"
                        else {"state": st.view(d.old.state.shape)}))
                    hz = (hz0[0].clone(), hz0[1].clone(), hl0.clone())
                    cursor = torch.tensor(cur, dtype=torch.int32,
                                          device=device)
                    rbt = torch.tensor(rb, device=device)
                    if fn is None:
                        go = probe.transition_plain(
                            *scan_arrays(t), cursor, CH, hz, rbt, ok,
                            present, swap, start)
                    else:
                        go = fn(t, cursor, CH, hz, rbt, ok, present, swap,
                                start)
                        torch.cuda.synchronize()
                    outs.append((st, *hz, cursor, rbt, go))
                for x, y, n in zip(*outs, ("state", "hkey", "hval", "hlive",
                                           "cursor", "rebuilding", "go")):
                    err = max(err, same(x, y, f"transition {name} cursor="
                                        f"{cur} hl={hl_kind} ok={okp} "
                                        f"rb={rb} swap={swap} start={start} "
                                        f"{n}"))
                seen.add(tuple(outs[0][-1].tolist()))
                out["cases"] += 1
        check(seen == {(False, False), (False, True), (True, False),
                       (True, True)}, f"transition {name}: decisions {seen}")
        log(f"  transition ok: {name}, {c} slots, 360 cases (tolerance 0)")

        # times on the main path's table: the landing step, the scan step
        # (the chunk at 5 * CH) and a step that is not rebuilding
        ok, present = flags("random"), flags("none")
        hz = (hz0[0].clone(), hz0[1].clone(), flags("empty"))
        cursor = torch.tensor(5 * CH, dtype=torch.int32, device=device)
        rbt = torch.tensor(True, device=device)
        arrays = scan_arrays(d.old)
        st0 = arrays[2].clone()
        hl_land = flags("partial")

        def restore(hl_v, rb_v=True):
            def run():
                arrays[2].copy_(st0)
                hz[2].copy_(hl_v)
                cursor.fill_(5 * CH)
                rbt.fill_(rb_v)
            return run

        def launch():
            return probe.transition(*arrays, cursor, CH, hz, rbt, ok,
                                    present, True, True)
        times = {
            "scan": time_ms(launch, reps, restore(flags("empty"))),
            "land": time_ms(launch, reps, restore(hl_land)),
            "idle": time_ms(launch, reps, restore(flags("empty"), False)),
            "plain": time_ms(lambda: probe.transition_plain(
                *arrays, cursor, CH, hz, rbt, ok, present, True, True), 3,
                restore(flags("empty")), queue_ahead=False)}
        restore(flags("empty"))()
        n_live = int((arrays[2][5 * CH:6 * CH] == 1).sum())
        # the scan step: in the flags (chunk bytes), every slot's state, key
        # and value of the live slots, cursor and flag; out the hazard
        # buffer, the MIGRATED marks, cursor and go
        nbytes = CH + CH * 4 + n_live * 8 + 5 + CH * 9 + n_live * 4 + 6
        out[name] = dict(ms=times["scan"], land_ms=times["land"],
                         idle_ms=times["idle"], plain_ms=times["plain"],
                         live_in_chunk=n_live, **bound(nbytes, 0))
        log(f"  transition times, {name}: " + json.dumps(out[name]))

        if baseline is None:
            continue
        # this tree's transition and exchange against the other tree's
        # sequence for the same work, on the landing step, the scan step
        # and (linear) the step that ends the epoch: swap and start
        e0 = clone_state(d)
        e0.cursor.fill_(5 * CH)
        steps = {"land": (hl_land, 5 * CH), "scan": (flags("empty"), 5 * CH)}
        if name == "linear":
            steps["swap and start"] = (flags("empty"), c)
        for label, (hl_v, cur) in steps.items():
            runs = {}
            for who, fn in (("this", transition_step),
                            ("parent", baseline["sequence"]),
                            ("serial", serial_step),
                            ("plain", transition_step_plain)):
                e = clone_state(e0)
                e.hazard_live.copy_(hl_v)
                e.cursor.fill_(cur)
                go = fn(e, ok, present, True, True)
                torch.cuda.synchronize()
                runs[who] = [go.clone(), *(x for _, x in _leaves(e))]
            for who in ("this", "parent", "serial"):
                for x, y in zip(runs[who], runs["plain"]):
                    same(x, y, f"transition step {name} {label} ({who})")
            e = clone_state(e0)
            win = slice(5 * CH, 6 * CH)
            st_e, st_0 = scan_arrays(e.old)[2][win], scan_arrays(e0.old)[2][win]

            def setup(hl_v=hl_v, cur=cur, e=e, st_e=st_e, st_0=st_0):
                st_e.copy_(st_0)            # the scanned chunk's states
                e.hazard_live.copy_(hl_v)
                e.cursor.fill_(cur)
                e.rebuilding.fill_(True)
            t = {"parent": [], "this": [], "serial": []}
            prof = {"parent": [], "this": [], "serial": []}
            fns = {"this": transition_step, "parent": baseline["sequence"],
                   "serial": serial_step}
            for who in ("parent", "this", "serial", "serial", "this",
                        "parent"):
                fn = fns[who]
                t[who].append(time_ms(
                    lambda: fn(e, ok, present, True, True), reps, setup))
                if who in prof and len(prof[who]) < 2:
                    prof[who].append(profile_calls(
                        lambda: fn(e, ok, present, True, True), 20, setup))
            entry = {"ms": t["this"], "parent_ms": t["parent"],
                     "serial_ms": t["serial"],
                     "device_us": [p[0] for p in prof["this"]],
                     "parent_device_us": [p[0] for p in prof["parent"]],
                     "ops": prof["this"][0][1],
                     "parent_ops": prof["parent"][0][1],
                     "kernels": prof["this"][0][2],
                     "parent_kernels": prof["parent"][0][2],
                     "serial_kernels": prof["serial"][0][2]}
            out.setdefault("in_turns", {})[f"{name} {label}"] = entry
            log(f"    transition and exchange, {name} {label}: equal to the "
                f"plain version and to the parent's sequence; "
                + json.dumps(entry))
    out["max_abs_err"] = err
    return out


def hazard_pairs(d) -> list:
    """The live (key, value) pairs of a state's hazard buffer, in order."""
    hl = d.hazard_live
    return list(zip(d.hazard_key[hl].tolist(), d.hazard_val[hl].tolist()))


def resize_transition_cases(device, cfg) -> int:
    """The linear rebuild step across two table sizes, as a resize runs it:
    ``dhash.rebuild_step_(d, swap=False)`` — the landing insert into the new
    table (``probe_insert``) and the transition launch (``extract``: the
    landing's bookkeeping, the guarded scan, the epoch decision) — on a
    fused state against the same on a plain copy, tolerance 0, with the new
    table twice, four times and a quarter of the old (2^21 slots, half live,
    a tenth of those tombstoned and a tenth MIGRATED, keys placed by the
    plain insert; the new table a quarter full of other keys).  From a
    chunk in the middle (its entries extracted into the hazard buffer, a
    fifth of them killed): 6 steps (landings and scans), then from the
    partial last chunk to the end of the scan, where the epoch is done and
    no swap is allowed across sizes.  Every step's go and every tensor of
    both states are compared (the hazard buffer as its live pairs in
    order: the fused scan compacts it).  Returns the steps compared."""
    from repro_torch.core import buckets, dhash, hashing
    from repro_torch.kernels import probe
    rng = np.random.default_rng(23)
    C, P, CH = 1 << 21, 64, cfg.chunk
    hfn, tk, tv, ts, _ = build_table(probe, hashing, C, 1 << 20, rng, device,
                                     41, P)
    steps = 0
    for ratio, seed in ((2, 42), (4, 43), (0.25, 44)):
        c_new = int(C * ratio)
        hfn2, nk, nv, ns, _ = build_table(probe, hashing, c_new, c_new // 4,
                                          rng, device, seed, P)
        d = dhash.make("linear", capacity=1 << 10, chunk=CH, fused=True,
                       device=device)
        old = buckets.LinearTable(C, P, hfn, tk.clone(), tv.clone(),
                                  ts.clone())
        new = buckets.LinearTable(c_new, P, hfn2, nk, nv, ns)
        d = dataclasses.replace(d, old=old, new=new)
        d.rebuilding.fill_(True)
        d.cursor.fill_(5 * CH)
        hk, hv, hl, cur = probe.extract_plain(tk, tv, old.state, d.cursor,
                                              CH)
        for x, y in ((d.hazard_key, hk), (d.hazard_val, hv),
                     (d.hazard_live, hl & torch.as_tensor(
                         rng.random(CH) < 0.8, device=device)),
                     (d.cursor, cur)):
            x.copy_(y)
        fused = clone_state(d)
        plain = dataclasses.replace(clone_state(d), fused=False)
        for i in range(16):
            if i == 6:
                for e in (fused, plain):
                    e.cursor.fill_(C - 1000)
            go_f = dhash.rebuild_step_(fused, swap=False)
            go_p = dhash.rebuild_step_(plain, swap=False)
            torch.cuda.synchronize()
            same(go_f, go_p, f"resize transition x{ratio} step {i} go")
            for (p, a), (_, b) in zip(_leaves(fused), _leaves(plain)):
                if not p.startswith(".hazard"):
                    same(a, b, f"resize transition x{ratio} step {i} "
                         f"state{p}")
            # the fused scan compacts the hazard buffer, the plain one is
            # position-aligned (same order): equal as live (key, value)s
            check(hazard_pairs(fused) == hazard_pairs(plain),
                  f"resize transition x{ratio} step {i}: hazard buffers")
            steps += 1
            if i >= 6 and bool(dhash.rebuild_done(fused)):
                break
        check(bool(dhash.rebuild_done(fused)) and bool(fused.rebuilding),
              f"resize transition x{ratio}: the epoch must end undecided "
              f"(no swap across sizes)")
        log(f"  rebuild step across sizes ok: new table x{ratio} "
            f"({c_new} slots), {i + 1} steps (landings and scans, the last "
            f"chunk, done without a swap), fused against plain, tolerance 0")
    return steps


def profile_calls(fn, n: int, setup) -> tuple:
    """``n`` calls of ``fn``, each after ``setup``, under torch.profiler,
    less ``n`` calls of ``setup`` alone: device µs a call (every kernel and
    copy on the device), PyTorch ops a call (``aten::`` calls, nested ones
    included), and the kernels by name: [launches, device µs] a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(work):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                setup()
                if work:
                    fn()
            torch.cuda.synchronize()
        dev_us, ops, kern = 0.0, 0, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                dev_us += us
                k = re.match(r"(?:void )?([\w:]+)", e.key).group(1)[:48]
                c, u = kern.get(k, (0, 0.0))
                kern[k] = (c + e.count, u + us)
            elif e.key.startswith("aten::"):
                ops += e.count
        return dev_us, ops, kern

    (du, ou, ku), (db, ob, kb) = session(True), session(False)
    kern = {k: [(c - kb.get(k, (0, 0.0))[0]) / n,
                (u - kb.get(k, (0, 0.0))[1]) / n]
            for k, (c, u) in sorted(ku.items())
            if c != kb.get(k, (0, 0.0))[0]}
    return (du - db) / n, (ou - ob) / n, kern


def bucket_keys(t, b: int, n: int, rng, device) -> torch.Tensor:
    """``n`` distinct keys that ``t``'s hash function puts in bucket ``b``."""
    from repro_torch.core import hashing
    got = torch.empty(0, dtype=torch.int32, device=device)
    while got.numel() < n:
        more = torch.as_tensor(rng.integers(1 << 30, (1 << 31) - 1,
                                            1 << 22).astype(np.int32),
                               device=device)
        got = torch.cat([got, more[hashing.bucket_of(t.hfn, more,
                                                     t.nbuckets) == b]])
        got = got.unique()
    return got[torch.as_tensor(rng.permutation(got.numel())[:n],
                               device=device)]


def compact_cases(device, cfg, reps: int, rng, baseline=None) -> dict:
    """``chain_compact`` against its plain version (tolerance 0, all ten
    arrays) at the chain main path's size (2^20 nodes, 2^16 buckets, tiles
    of 256 buckets), and timed: where it runs (after a user insert), where
    its guard is off, and on the floods.  With a baseline the other tree's
    kernel is held against the plain version on every case too, and the
    timed cases run in turns (other, this, this, other)."""
    from repro_torch.core import backend, buckets, hashing
    from repro_torch.kernels import build, probe
    n, nb, QU = cfg.capacity_per_shard, cfg.capacity_per_shard // 16, \
        cfg.updates_per_step
    cap = backend.get("chain").dirty_cap
    ones = torch.ones(1, dtype=torch.bool, device=device)

    def tail_insert(t, keys, parts: int = 3):
        for k in keys.chunk(parts):
            t2, ok = buckets.chain_insert(t, k, k * 3 + 1,
                                          torch.ones_like(k, dtype=torch.bool))
            check(bool(ok.all()), "chain_compact: a tail insert was refused")
            t = t2
        return t

    def fresh_keys(count: int) -> torch.Tensor:
        k = np.unique(rng.integers(-(1 << 31), (1 << 31) - 1,
                                   count + count // 8))
        return torch.as_tensor(rng.permutation(k)[:count].astype(np.int32),
                               device=device)

    def flooded(seed: int, per_bucket: dict):
        t, _ = build_chain(device, nb, n, n // 2, rng, seed, tail=QU)
        fk = torch.cat([bucket_keys(t, b, m, rng, device)
                        for b, m in per_bucket.items()])
        return tail_insert(t, fk[torch.as_tensor(rng.permutation(
            fk.numel()), device=device)])

    user, _ = build_chain(device, nb, n, n // 2, rng, 81, tail=QU + cap)
    runs, _ = build_chain(device, nb, n, n // 2, rng, 82, hot=2048, tail=QU)
    flood, _ = build_chain(device, nb, n, n // 2, rng, 83, tail=QU)
    fk = bucket_keys(flood, 9, 2048, rng, device)
    flood = tail_insert(flood, fk)
    dead = _clone_table(flood)
    su, end = int(dead.sorted_upto), n - int(dead.free_top)
    dead.astate[su:end].masked_fill_(torch.isin(dead.akey[su:end], fk[40:]),
                                     buckets.TOMB)
    # eight floods in eight tiles far apart; listed buckets on both sides of
    # the edge of tiles 0 and 1 (buckets 255 and 256) and in the last bucket;
    # a tail of dead nodes only; a full arena (live == n, no free node)
    floods = flooded(86, {9 + k * (nb // 8): 2048 for k in range(8)})
    edge = flooded(87, {255: 100, 256: 100, nb - 1: 100})
    tomb = _clone_table(user)
    su, end = int(tomb.sorted_upto), n - int(tomb.free_top)
    tomb.astate[su:end] = torch.where(tomb.astate[su:end] == buckets.LIVE,
                                      buckets.TOMB, tomb.astate[su:end])
    full = buckets.chain_make(nb, n, hashing.fresh("mix32", 88, device),
                              device=device)
    fk = fresh_keys(n)
    full.akey[:n - QU], full.aval[:n - QU] = fk[:n - QU], fk[:n - QU] * 3 + 1
    full.astate[:n - QU] = buckets.LIVE
    probe.chain_compact_plain(backend._chain_fields(full), full.hfn, nb)
    full = tail_insert(full, fk[n - QU:])
    check(int(full.free_top) == 0, "chain_compact: the full arena has room")
    fresh = buckets.chain_make(nb, n, hashing.fresh("mix32", 84, device),
                               device=device)
    fresh = tail_insert(fresh, fresh_keys(65536), 4)
    empty = buckets.chain_make(nb, n, hashing.fresh("mix32", 85, device),
                               device=device)
    cases = {"after a user insert": (user, None, cap),
             "2048 nodes in one run": (runs, None, -1),
             "2048 tail nodes in one bucket": (flood, None, cap),
             "2048 tail nodes in one bucket, 40 live": (dead, None, cap),
             "8 buckets of 2048 tail nodes, 8 tiles": (floods, None, cap),
             "listed buckets at tile edges": (edge, None, cap),
             "a tail of dead nodes only": (tomb, None, cap),
             "full arena": (full, None, -1),
             "every node in the tail": (fresh, None, cap),
             "nothing live": (empty, None, -1),
             "flag off": (user, ~ones[0], -1),
             "within the dirty window": (user, None, 1 << 30),
             "flag on (freeze)": (user, ones[0], -1)}
    timed = ("after a user insert", "within the dirty window",
             "2048 tail nodes in one bucket",
             "8 buckets of 2048 tail nodes, 8 tiles", "full arena")
    lib = build.load()
    mine = lib["chain_compact"]
    err, out = 0, {}
    for label, (t, where, dcap) in cases.items():
        f0 = backend._chain_fields(t)
        a, b = [x.clone() for x in f0], [x.clone() for x in f0]
        probe.chain_compact(a, t.hfn, nb, where, dcap)
        torch.cuda.synchronize()
        probe.chain_compact_plain(b, t.hfn, nb, where, dcap)
        for i, (x, y) in enumerate(zip(a, b)):
            err = max(err, same(x, y, f"chain_compact {label} array {i}"))
        moved = not all(torch.equal(x, y) for x, y in zip(a, f0))
        if label != "nothing live":     # (compacting it changes nothing)
            off = label in ("flag off", "within the dirty window")
            check(moved != off, f"chain_compact {label}: ran={moved}")
        out[label] = dict(ran=moved, live=int(b[9]),
                          tail=n - int(f0[6]) - int(f0[9]))
        if baseline is not None:
            try:
                lib["chain_compact"] = baseline["chain_compact"]
                c = [x.clone() for x in f0]
                probe.chain_compact(c, t.hfn, nb, where, dcap)
                torch.cuda.synchronize()
            finally:
                lib["chain_compact"] = mine
            for i, (x, y) in enumerate(zip(c, b)):
                same(x, y, f"chain_compact (baseline) {label} array {i}")
        if label in timed:
            def restore():
                for x, y in zip(a, f0):
                    x.copy_(y)

            def launch():
                probe.chain_compact(a, t.hfn, nb, where, dcap)
            t_by = {"parent": [], "this": []}
            order = ("parent", "this", "this", "parent") if baseline \
                else ("this",)
            try:
                for who in order:
                    lib["chain_compact"] = baseline["chain_compact"] \
                        if who == "parent" else mine
                    t_by[who].append(time_ms(launch, reps, restore))
            finally:
                lib["chain_compact"] = mine
            out[label]["ms"] = t_by["this"] if baseline else t_by["this"][0]
            if baseline:
                out[label]["parent_ms"] = t_by["parent"]
            if label == "after a user insert":
                plain_ms = time_ms(lambda: probe.chain_compact_plain(
                    a, t.hfn, nb, where, dcap), 3, restore,
                    queue_ahead=False)
        log(f"  chain_compact ok: {label} " + json.dumps(out[label]))

    # the full arena again, on a scratch of exactly the wrapper's size
    # followed by guard words: the kernel writes nothing past it
    words = probe.compact_scratch_words(n, nb)
    scratch = torch.full((words + 4096,), 0x5A5A5A5A, dtype=torch.int32,
                         device=device)
    f = [x.clone() for x in backend._chain_fields(full)]
    rc = mine(*[x.data_ptr() for x in f], n, nb,
              hashing.HASH_KINDS.index(full.hfn.kind),
              full.hfn.seeds.data_ptr(), None, -1, scratch.data_ptr(),
              torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(rc == 0, f"chain_compact on a guarded scratch: cudaError {rc}")
    check(bool((scratch[words:] == 0x5A5A5A5A).all()),
          f"chain_compact wrote past its {words}-word scratch")
    check(int(f[9]) == n, "chain_compact: the full arena lost nodes")
    ms, idle = (np.ravel(out[k]["ms"])[0] for k in timed[:2])
    log(f"  chain_compact times, 2^20 nodes: after a user insert {ms:.4f} "
        f"ms, guard off {idle:.4f} ms, plain {plain_ms:.4f} ms; a full arena "
        f"writes nothing past its {words}-word scratch")
    return dict(max_abs_err=err, ms=float(ms), plain_ms=plain_ms,
                idle_ms=float(idle),
                # in: key, value, state of every node, each bucket's run;
                # out: key, value, state, link and free-stack word of every
                # node, each bucket's start, length and head
                **bound(n * 32 + nb * 20, 0), cases=out)


def _clone_table(t):
    """A table with every tensor cloned (hash seeds included)."""
    from repro_torch.core import hashing
    kw = {}
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.clone()
        elif isinstance(v, hashing.HashFn):
            kw[f.name] = dataclasses.replace(v, seeds=v.seeds.clone())
    return dataclasses.replace(t, **kw)


# ---------------------------------------------------------------------------
# the op stream and its dense oracle (phases 3 and 5)
# ---------------------------------------------------------------------------

class Oracle:
    """Dense ``present[]`` / ``value[]`` arrays over a key universe
    ``[-U/2, U/2)``; first occurrence wins for duplicates in a batch; the op
    order of a step is lookup, insert, delete."""

    def __init__(self, universe: int, seed: int):
        self.u = universe
        self.present = np.zeros(universe, bool)
        self.value = np.zeros(universe, np.int32)
        self.rng = np.random.default_rng(seed)
        self.no_slot = 0          # inserts the table refused for want of a slot

    def _sample(self, n: int, want_present: bool) -> np.ndarray:
        """``n`` key indices that are (not) present, best effort."""
        out = np.empty(0, np.int64)
        for _ in range(8):
            cand = self.rng.integers(0, self.u, 4 * n)
            out = np.concatenate([out, cand[self.present[cand] == want_present]])
            if out.size >= n:
                break
        if out.size < n:
            out = np.concatenate([out, self.rng.integers(0, self.u,
                                                         n - out.size)])
        return out[:n]

    def key(self, idx: np.ndarray) -> np.ndarray:
        return (idx - self.u // 2).astype(np.int32)

    def batch(self, n_look: int, n_upd: int, step: int):
        look = np.concatenate([self._sample(n_look // 2, True),
                               self._sample(n_look - n_look // 2, False)])
        self.rng.shuffle(look)
        ins = self._sample(n_upd, False)
        ins[: n_upd // 64] = ins[n_upd // 64: 2 * (n_upd // 64)]  # duplicates
        dele = self._sample(n_upd, True)
        vals = (ins * 3 + step).astype(np.int32)
        return look, ins, vals, dele

    @staticmethod
    def _first(idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """mask & first masked occurrence of each index."""
        win = np.zeros(idx.size, bool)
        pos = np.flatnonzero(mask)
        _, first = np.unique(idx[pos], return_index=True)
        win[pos[first]] = True
        return win

    def step(self, look, ins, vals, ins_mask, dele, out, where: str,
             del_mask=None):
        found, got, ok_i, ok_d = (np.asarray(t.cpu()) for t in out)
        exp_f = self.present[look]
        check(np.array_equal(found, exp_f),
              f"{where}: lookup found differs from the oracle in "
              f"{int((found != exp_f).sum())} places")
        check(np.array_equal(got, np.where(exp_f, self.value[look], 0)),
              f"{where}: lookup values differ from the oracle")
        win = self._first(ins, ins_mask)
        check(not (ok_i & ~win).any(), f"{where}: an insert the oracle "
              f"forbids was acknowledged")
        self.no_slot += int((win & ~ok_i).sum())
        self.present[ins[ok_i]] = True
        self.value[ins[ok_i]] = vals[ok_i]
        dm = self.present[dele] if del_mask is None \
            else self.present[dele] & del_mask
        exp_d = self._first(dele, dm)
        check(np.array_equal(ok_d, exp_d), f"{where}: delete ok differs from "
              f"the oracle in {int((ok_d != exp_d).sum())} places")
        self.present[dele[exp_d]] = False
        return int(found.sum())


def expected_launches(before: dict, after: dict, was_rebuilding: bool,
                      backend: str, continuous: bool) -> str | None:
    """None if the step's launches are the stated ones, else what was seen.
    A step launches only its backend's kernels (extract and epoch_swap are
    shared): steady state two lookup-kernel launches (lookup, delete) and one
    insert; in a rebuild epoch two probe2 launches, two inserts (the user's
    and the landing's, which inserts nothing when no hazard entry is live),
    one extract (the transition: the landing's bookkeeping, the scan where
    the device allows, the epoch decision) and one epoch_swap (the exchange
    on that decision: it swaps and restarts only where the rebuild is
    done); the first step of continuous rebuild adds the epoch_swap that
    starts it, which decides by itself: two kernels, the decision and the
    exchange.  A cuckoo insert is one tc_insert launch (its two kernels,
    the bid and the resolve, whose last block runs the kick-out: no
    cuckoo_kick launch); every chain insert adds its compaction (guarded
    on the dirty count), and every continuous chain step the freeze's
    compaction (guarded on the start).  (Chain's insert kernel is its lookup
    kernel, the presence probe.)"""
    d = {k: after[k] - before[k] for k in after}
    look, ins, p2 = PATH_KERNELS[backend]
    want = dict.fromkeys(after, 0)
    inserts = 2 if was_rebuilding else 1
    if was_rebuilding:
        for k, n in ((p2, 2), ("extract", 1)):
            want[k] += n
    else:
        want[look] += 2
    want[ins] += inserts
    if backend == "chain":
        want["chain_compact"] += inserts + continuous
    if was_rebuilding or continuous:
        want["epoch_swap"] += 1 if was_rebuilding else 2
    return None if d == want else f"{d} (rebuilding={was_rebuilding})"


def seeds_of(eng) -> list:
    """The seeds of each hash function of the active table."""
    from repro_torch.core import backend
    be = backend.get(eng.state.backend)
    return [h.seeds.cpu().numpy().copy() for h in be.hash_fns(eng.state.old)]


def insert_target(eng, was_rebuilding: bool, swapped: bool):
    """The table a step's inserts went to, as the state holds it after the
    step: the new one in a rebuild epoch (the old one once the step's swap
    has happened), else the old one."""
    return eng.state.new if was_rebuilding and not swapped else eng.state.old


def check_refusals(backend: str, table, before, keys, refused, ok_keys,
                   where: str) -> int:
    """A two-row table refuses an insert only when both of the key's rows
    have no lane left to it (the reference's bounded placement).  Checked
    for each refused key: every lane of its two rows that was not LIVE
    before the step (``before``: the insert target's states then) is LIVE
    now, holding on twochoice a key that this step's insert acknowledged
    (on cuckoo any key: the kick-out also moves residents into free lanes).
    Returns the number of refused keys."""
    from repro_torch.core import buckets
    n = int(refused.sum())
    if not n:
        return 0
    rows = buckets._tc_rows if backend == "twochoice" else buckets._ck_rows
    k = torch.as_tensor(keys[refused], device=before.device)
    r = torch.stack(rows(table, k), 1).long()               # [n, 2]
    was_free = before[r] != buckets.LIVE                    # [n, 2, W]
    filled = table.state[r] == buckets.LIVE
    if backend == "twochoice":
        filled &= torch.isin(table.key[r], torch.as_tensor(
            ok_keys, device=before.device))
    bad = int((was_free & ~filled).any(-1).any(-1).sum())
    check(bad == 0, f"{where}: {bad} of {n} refused inserts had a lane left "
                    f"in their rows")
    return n


def check_chain_step(eng, free0: int, win, ok_i, where: str) -> int:
    """A chain arena refuses an insert only when its free stack is empty: a
    step that refused a winner placed exactly the ``free0`` nodes the stack
    held before it.  And the compaction keeps both arenas' dirty tails
    within the window.  Returns the number of refused inserts."""
    from repro_torch.core import buckets
    refused = int((win & ~ok_i).sum())
    if refused:
        check(int(ok_i.sum()) == free0, f"{where}: {refused} inserts refused"
              f" with {free0} free nodes and {int(ok_i.sum())} placed")
    d = eng.state
    dirty = torch.stack([buckets.chain_dirty(d.old),
                         buckets.chain_dirty(d.new)]).tolist()
    check(max(dirty) <= d.old.dirty_cap, f"{where}: dirty tails {dirty} "
          f"past the window of {d.old.dirty_cap}")
    return refused


class Flood:
    """The cuckoo arm of the collision-flood benchmark: mid-epoch, ``n``
    keys that all hash to side-A row 0 of the insert target under its live
    ``hfn_a`` go in through the engine in one step.  Every acknowledged flood
    key must then be found, and the count must hold, through the next
    complete swap."""

    def __init__(self, n: int, after_swap: int, delay: int):
        self.n, self.after_swap, self.delay = n, after_swap, delay
        self.keys = self.vals = None
        self.step_ms = None
        self.kick = None
        self.swap_checked = False

    def colliders(self, t, device) -> torch.Tensor:
        from repro_torch.core import hashing
        gen = torch.Generator(device=device)
        gen.manual_seed(99)
        got = torch.empty(0, dtype=torch.int32, device=device)
        while got.numel() < self.n:
            # keys far outside the oracle's universe, so they are all fresh
            cand = torch.randint(1 << 24, (1 << 31) - 1, (1 << 24,),
                                 generator=gen, device=device,
                                 dtype=torch.int32)
            hit = cand[hashing.bucket_of(t.hfn_a, cand, t.nbuckets) == 0]
            got = torch.unique(torch.cat([got, hit]))
        return got[torch.randperm(got.numel(), generator=gen,
                                  device=device)[: self.n]]

    def maybe(self, eng, swaps: int, steps_since_swap: int):
        """Inject the flood once, ``delay`` steps into the epoch after swap
        number ``after_swap``."""
        from repro_torch.kernels import probe
        if self.keys is not None or swaps < self.after_swap or \
                steps_since_swap < self.delay or not eng.rebuilding:
            return
        keys = self.colliders(eng.state.new, eng.device)
        vals = keys * 7 + 3
        empty = np.zeros(0, np.int32)
        tally0 = probe.kick_tally(eng.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step(empty, keys, vals, empty)
        torch.cuda.synchronize()
        self.step_ms = (time.perf_counter() - t0) * 1e3
        self.kick = {k: v - tally0[k]
                     for k, v in probe.kick_tally(eng.device).items()}
        check(self.kick["runs"] >= 1, "flood: the kick-out did not run")
        ok = out[2]
        self.keys, self.vals = keys[ok], vals[ok]
        check(self.keys.numel() >= self.n - 64,
              f"flood: only {self.keys.numel()} of {self.n} acknowledged")
        log(f"  flood: {self.n} keys to side-A row 0 of the insert target, "
            f"{self.keys.numel()} acknowledged, kick-out kernel found work "
            f"{self.kick['runs']} time(s) ({self.kick['keys']} pending keys, "
            f"{self.kick['iterations']} iterations), step "
            f"{self.step_ms:.3f} ms")
        self.verify(eng, "right after the flood")

    def verify(self, eng, when: str):
        if self.keys is None:
            return
        f, v = eng.lookup(self.keys)
        check(bool(f.all()) and torch.equal(v, self.vals),
              f"flood: {int((~f).sum())} acknowledged flood keys lost "
              f"{when}")

    def extra(self) -> int:
        return 0 if self.keys is None else self.keys.numel()


def drive(eng, oracle, n_steps: int, n_look: int, n_upd: int, where: str,
          step0: int = 0, flood: Flood | None = None):
    """``n_steps`` engine steps checked against the oracle; returns per-step
    wall times (ms, each ended by a synchronise) and bookkeeping."""
    from repro_torch.kernels import probe
    times, in_rebuild, hits = [], 0, 0
    seeds = []
    # the epoch counter read here, outside the step (the engine itself
    # learns of a swap at its next poll)
    epoch = int(eng.state.epoch)
    since_swap = 0
    two_row = eng.state.backend in ("twochoice", "cuckoo")
    chain = eng.state.backend == "chain"
    for s in range(n_steps):
        if flood is not None:
            flood.maybe(eng, len(seeds), since_swap)
        look, ins, vals, dele = oracle.batch(n_look, n_upd, step0 + s)
        ins_mask = ~oracle.present[ins]
        was_rb = eng.rebuilding
        if two_row:
            states = insert_target(eng, was_rb, False).state.clone()
        if chain:
            free0 = int(insert_target(eng, was_rb, False).free_top)
        before = probe.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step(oracle.key(look), oracle.key(ins), vals,
                       oracle.key(dele), ins_mask=ins_mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = expected_launches(before, probe.launch_counts(), was_rb,
                                eng.state.backend, eng.continuous_rebuild)
        check(bad is None, f"{where} step {s}: unexpected launches {bad}")
        in_rebuild += was_rb
        hits += oracle.step(look, ins, vals, ins_mask, dele, out,
                            f"{where} step {s}")
        swapped = int(eng.state.epoch) != epoch
        if two_row:
            ok_i = np.asarray(out[2].cpu())
            check_refusals(
                eng.state.backend, insert_target(eng, was_rb, swapped),
                states, oracle.key(ins), oracle._first(ins, ins_mask) & ~ok_i,
                oracle.key(ins[ok_i]), f"{where} step {s}")
        if chain:
            check_chain_step(eng, free0, oracle._first(ins, ins_mask),
                             np.asarray(out[2].cpu()), f"{where} step {s}")
        since_swap += 1
        if swapped:
            epoch += 1
            since_swap = 0
            # quiescence: the swap has just happened, nothing is in flight
            n = eng.count()
            extra = flood.extra() if flood is not None else 0
            check(n == int(oracle.present.sum()) + extra,
                  f"{where} step {s}: count {n} != oracle "
                  f"{int(oracle.present.sum())} + {extra} after epoch swap")
            seeds.append(seeds_of(eng))
            if flood is not None and flood.keys is not None \
                    and not flood.swap_checked:
                flood.verify(eng, f"after the swap at step {s}")
                live = np.flatnonzero(oracle.present)
                f, v = eng.lookup(oracle.key(live))
                check(bool(f.all()) and np.array_equal(
                    np.asarray(v.cpu()), oracle.value[live]),
                    f"{where}: residents lost after the flood's swap")
                flood.swap_checked = True
                log(f"  flood: all {flood.extra()} acknowledged flood keys "
                    f"and all {live.size} other residents found after the "
                    f"next complete swap (step {s})")
        elif flood is not None and s % 128 == 0:
            flood.verify(eng, f"at step {s}")
    return times, in_rebuild, hits, seeds


def populate(eng, oracle, n_keys: int, batch: int, where: str):
    """Fill the table to ``n_keys`` live keys through the engine's inserts."""
    empty = np.zeros(0, np.int32)
    step = 0
    two_row = eng.state.backend in ("twochoice", "cuckoo")
    while int(oracle.present.sum()) < n_keys:
        n = min(batch, n_keys - int(oracle.present.sum()))
        ins = oracle._sample(n, False)
        vals = (ins * 3 - 1).astype(np.int32)
        mask = np.ones(n, bool)
        states = eng.state.old.state.clone() if two_row else None
        out = eng.step(empty, oracle.key(ins), vals, empty, ins_mask=mask)
        oracle.step(empty.astype(np.int64), ins, vals, mask,
                    empty.astype(np.int64), out, f"{where} populate {step}")
        if two_row:
            ok_i = np.asarray(out[2].cpu())
            check_refusals(eng.state.backend, eng.state.old, states,
                           oracle.key(ins), oracle._first(ins, mask) & ~ok_i,
                           oracle.key(ins[ok_i]), f"{where} populate {step}")
        step += 1
    return step


def phase_main(device, cfg, n_steps: int, min_epochs: int,
               profile_to: str = "", flood: Flood | None = None) -> dict:
    """The main path of ``cfg.backend``: populate to half the table's slots
    (``capacity_per_shard`` keys on the slot tables, which are twice that
    size; half the arena on chain, whose arena IS ``capacity_per_shard``
    nodes), 16 steady-state steps, then ``n_steps`` in continuous rebuild;
    the launch counts are set to 0 just before and read just after.
    Returns the launch counts."""
    from repro_torch.core import backend
    from repro_torch.kernels import probe
    eng, oracle, n_pop = main_engine(device, cfg)
    slots = backend.get(cfg.backend).capacity_of(eng.state.old)
    chain = cfg.backend == "chain"
    shape = (f"{eng.state.old.nbuckets} buckets" if chain
             else tuple(eng.state.old.key.shape))
    log(f"  populated {int(oracle.present.sum())} keys in {n_pop} engine "
        f"steps; {slots} {'nodes' if chain else 'slots'} a table ({shape}), "
        f"{oracle.no_slot} inserts found no slot")
    seed0 = seeds_of(eng)

    # -------- the main path: counts set to 0 here, read right after --------
    # (the engine's raw counters: reading ``eng.stats`` would refresh them
    # with a read of its own)
    probe.reset_launches()
    syncs0 = eng._stats.host_syncs
    steady = 16
    t_steady, _, hits_a, _ = drive(eng, oracle, steady, cfg.lookups_per_step,
                                   cfg.updates_per_step,
                                   f"{cfg.backend}/steady")
    steady_syncs = eng._stats.host_syncs - syncs0
    eng.continuous_rebuild = True
    t0 = time.perf_counter()
    times, in_rb, hits_b, seeds = drive(
        eng, oracle, n_steps, cfg.lookups_per_step, cfg.updates_per_step,
        f"{cfg.backend}/rebuild", step0=steady, flood=flood)
    wall = time.perf_counter() - t0
    launches = probe.launch_counts()
    kick = probe.kick_tally(device)
    # ------------------------------------------------------------------------
    # the engine's own reads (its polls), less the count() at each swap
    eng_syncs = eng._stats.host_syncs - syncs0 - steady_syncs - len(seeds)
    used = {*PATH_KERNELS[cfg.backend], "extract", "epoch_swap"}
    if cfg.backend == "chain":
        used.add("chain_compact")
    check(all(launches[k] > 0 for k in used),
          f"main path did not launch every kernel of its backend: {launches}")
    check(all(launches[k] == 0 for k in probe.KERNELS if k not in used),
          f"main path launched another backend's kernels: {launches}")
    epochs = len(seeds)
    check(epochs >= min_epochs,
          f"only {epochs} complete rebuild epochs in {n_steps} steps")
    allseeds = [seed0] + seeds
    check(all(not np.array_equal(x, y) for a, b in zip(allseeds, allseeds[1:])
              for x, y in zip(a, b)),
          "a hash function's seeds did not change across an epoch swap")
    if flood is not None:
        check(flood.swap_checked, "flood: no complete swap after the flood")
    ops_step = cfg.lookups_per_step + 2 * cfg.updates_per_step
    ts = sorted(times)
    dev_ops = ops_step * len(times) / (sum(times) / 1e3)
    log(f"  steady state: {steady} steps, median "
        f"{statistics.median(t_steady):.3f} ms a step, "
        f"{steady_syncs / steady:.3f} host syncs a step")
    log(f"  continuous rebuild: {n_steps} steps, {epochs} complete epochs "
        f"(hash functions swapped live {epochs} times, every seed changed), "
        f"{ops_step * n_steps} operations")
    log(f"  step ms: median {statistics.median(ts):.3f} "
        f"p99 {ts[int(0.99 * (len(ts) - 1))]:.3f} max {ts[-1]:.3f}; "
        f"{dev_ops / 1e6:.2f} M operations/s over the steps' own time "
        f"({ops_step * n_steps / wall / 1e6:.2f} M/s with the host oracle)")
    log(f"  the step replayed from CUDA graphs: {len(eng._step_keys)} keys "
        f"captured since the engine was made (populate included; the first "
        f"step of each ran eagerly), {eng._step_cache_size()} held; the "
        f"launch counts are the replays' credited ones")
    log(f"  host syncs a step: {eng_syncs / n_steps:.4f} (the engine's "
        f"polls, one in {eng.poll_every} steps; no other read)"
        + (f"; the kick-out (in tc_insert's resolve, {launches['tc_insert']}"
           f" cuckoo inserts, {launches['cuckoo_kick']} cuckoo_kick "
           f"launches) found pending keys {kick['runs']} times "
           f"({kick['keys']} keys, {kick['iterations']} iterations)"
           if cfg.backend == "cuckoo" else "")
        + f"; share of steps in a rebuild epoch: {in_rb / n_steps:.4f}; "
        f"lookup hit rate "
        f"{(hits_a + hits_b) / ((steady + n_steps) * cfg.lookups_per_step):.3f}")
    if flood is not None:
        log(f"  flood step {flood.step_ms:.3f} ms against a median step of "
            f"{statistics.median(ts):.3f} ms")
    # a refused insert is not acknowledged, so never lost.  Linear: a few a
    # run at most; a two-row table refuses a key whose two rows are full
    # (the reference's bounded placement), each refusal checked to be one
    n_ins = cfg.updates_per_step * (steady + n_steps)
    if cfg.backend == "linear":
        log(f"  inserts refused for want of a slot: {oracle.no_slot} of "
            f"{n_ins} (limit 64)")
        check(oracle.no_slot <= 64, "too many inserts found no slot")
    elif chain:
        # chain_probe serves the steady lookups and deletes (two a step)
        # and every insert's presence probe (user inserts and landings)
        ins_calls = launches["chain_probe"] - 2 * steady
        log(f"  inserts refused for want of a node: {oracle.no_slot} of "
            f"{n_ins} (populate included), each with the free stack empty; "
            f"the compaction was launched (guarded on the dirty count on the "
            f"device: no host read) after each of the {ins_calls} insert "
            f"calls, {ins_calls / (steady + n_steps):.3f} a step, and left no "
            f"dirty tail past the window; {launches['chain_compact']} "
            f"chain_compact launches with the freeze's")
    else:
        log(f"  inserts refused for want of a slot: {oracle.no_slot} of "
            f"{n_ins} (populate included), each with both rows full")
    log(f"  launches on the main path: "
        f"{ {k: v for k, v in launches.items() if v} }")
    if profile_to:
        profile_steps(eng, oracle, cfg, 40, steady + n_steps, profile_to)
    if profile_to and cfg.backend in ("linear", "twochoice", "cuckoo"):
        # the steady state (no rebuild), which serves most of a table's
        # life: the lookup and delete kernels and the insert, no epoch
        # work; on an engine built and populated as the main path's was,
        # so that the main path runs the same work with --profile or not
        del eng, oracle
        eng, oracle, _ = main_engine(device, cfg)
        root, ext = os.path.splitext(profile_to)
        profile_steps(eng, oracle, cfg, 40, 1 << 20, f"{root}_steady{ext}",
                      steady=True)
        check(not eng.rebuilding, "the steady profile started a rebuild")
    return launches


def main_engine(device, cfg, policy=None):
    """An engine of ``cfg.backend`` at full size, populated to half its
    table's slots (``capacity_per_shard`` keys on the slot tables, which
    are twice that size; half the arena on chain, whose arena IS
    ``capacity_per_shard`` nodes), with no rebuild running (and the elastic
    ``policy``, where one is given); its oracle, and the populate's engine
    steps."""
    from repro_torch.core import backend, dhash
    from repro_torch.core.engine import DHashEngine
    state = dhash.make(cfg.backend, capacity=cfg.capacity_per_shard,
                       chunk=cfg.chunk, fused=True, seed=0, device=device)
    slots = backend.get(cfg.backend).capacity_of(state.old)
    oracle = Oracle(4 * cfg.capacity_per_shard, seed=3)
    eng = DHashEngine(state, continuous_rebuild=False, policy=policy)
    n_pop = populate(eng, oracle, min(cfg.capacity_per_shard, slots // 2),
                     cfg.lookups_per_step, f"{cfg.backend}")
    return eng, oracle, n_pop


def _leaves(obj, path=""):
    """(path, tensor) of every tensor of a state container."""
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")


# kernels a wrapper's launch runs, where not one
KERNELS_A_LAUNCH = {"probe_insert": 2, "tc_insert": 2, "chain_compact": 3}


def credited_against_profiler(run, n: int, where: str,
                              traces: int = 3) -> dict:
    """Run ``run()`` (``n`` engine steps that replay one captured graph)
    three times under torch.profiler, the third traced.  The launches its
    replays credited to each wrapper, times the kernels one of its launches
    runs, must equal the kernels of its source the profiler saw on the
    device, replay for replay: the profiler's counts must be ``m`` times a
    replay's credit for every wrapper, with ``m`` the replays it saw, ``n``
    or, where it lost a replay's kernels (seen on an H100), ``n - 1``.  A
    trace that saw no kernel more than the replays credit but lost more
    than one replay's (seen once on an H100: the kernels of 3 replays of
    10 kept) is the profiler's loss, and is taken again, up to ``traces``
    times; the check is the same on each.  Returns the credited counts and
    ``m``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import probe
    sources = port_kernel_sources()
    for attempt in range(traces):
        # a wait and a warm-up round first, and a spin kernel of about 20
        # ms at each end of the traced round: unpadded, the profiler lost
        # kernels of 3 traces in 120 on an H100, at the start, the end or
        # in between (docs/torch_port/profiler_window_trials.py); padded,
        # none in 120
        sched = schedule(wait=1, warmup=1, active=1, repeat=1)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=sched) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
            torch.cuda._sleep(int(4e7))
            before = probe.launch_counts()
            run()
            after = probe.launch_counts()
            torch.cuda._sleep(int(4e7))
            torch.cuda.synchronize()
            prof.step()
        credited = {k: after[k] - before[k] for k in after
                    if after[k] > before[k]}
        seen: dict = {}
        for e in prof.events():
            m = re.match(r"(?:void )?(\w+)", e.name)
            if e.device_type == DeviceType.CUDA and m \
                    and m.group(1) in sources:
                k = sources[m.group(1)]
                seen[k] = seen.get(k, 0) + 1
        step = {}
        for k, c in credited.items():
            check(c % n == 0, f"{where}: {c} {k} launches credited in {n} "
                              f"steps")
            step[k] = c // n * KERNELS_A_LAUNCH.get(k, 1)
        m = max(range(n + 1), key=lambda i: sum(
            seen.get(k, 0) == i * v for k, v in step.items()))
        ok = m >= n - 1 and seen == {k: m * v for k, v in step.items()}
        what = (f"{where}: the profiler saw the port's kernels {seen}, the "
                f"credited launches of a replay make {step} (in {n} "
                f"replays)")
        lossy = set(seen) <= set(step) and all(
            seen[k] <= n * step[k] for k in seen)
        if ok or not lossy or attempt == traces - 1:
            check(ok, what)
            return credited, m
        log(f"  {what}: the profiler lost kernels; traced again")


def phase_graph(device, cfg, margin: int = 16, max_steps: int = 1500,
                lead: int = 48) -> dict:
    """The engine's own replay held to its eager mode: a second engine,
    cloned from the first in continuous rebuild mid-epoch (the first
    engine's steps replayed, each checked by the oracle, until ``lead``
    chunks of the table are left to scan), steps through
    ``DHashEngine.step`` — its first step eager and captured in a CUDA graph,
    every later one replayed (capture refuses any call that synchronises
    with the host) — across a complete live hash-function swap plus
    ``margin`` steps, beside the first engine stepped in the eager mode
    (``engine._eager()``) on the same batches.  Every step's four outputs
    must be equal between the two (tolerance 0) and right by the dict
    oracle; at the end every tensor of the two states (both tables, hash
    seeds, hazard buffer, scalars) must be equal, and the replaying engine
    must hold one key.  Then 10 more replayed steps under the profiler:
    their credited launches against the kernels the device ran
    (``credited_against_profiler``) and the device busy time of a step.
    Returns the replayed and eager ms a step (host clock, each ended by a
    synchronise), the replay's device span (CUDA events) and busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import backend, dhash
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.engine import DHashEngine
    name, NL, NU = cfg.backend, cfg.lookups_per_step, cfg.updates_per_step
    state = dhash.make(name, capacity=cfg.capacity_per_shard,
                       chunk=cfg.chunk, fused=True, seed=1, device=device)
    slots = backend.get(name).capacity_of(state.old)
    oracle = Oracle(4 * cfg.capacity_per_shard, seed=31)
    eager = DHashEngine(state, continuous_rebuild=False)
    with eng_mod._eager():
        populate(eager, oracle, min(cfg.capacity_per_shard, slots // 2), NL,
                 f"{name} graph")
    eager.continuous_rebuild = True
    step = 0

    def batch():
        look, ins, vals, dele = oracle.batch(NL, NU, 10_000 + step)
        return look, ins, vals, dele, ~oracle.present[ins]

    with eng_mod._eager():
        for _ in range(2):      # start the rebuild: rebuilding from here on
            look, ins, vals, dele, mask = batch()
            out = eager.step(oracle.key(look), oracle.key(ins), vals,
                             oracle.key(dele), ins_mask=mask)
            oracle.step(look, ins, vals, mask, dele, out,
                        f"{name} graph {step}")
            step += 1
    check(eager.rebuilding and bool(eager.state.rebuilding),
          "graph: the eager engine is not in a rebuild epoch")
    # the epoch's first part replayed (its answers checked), so that the
    # lock step starts ``lead`` chunks before the table's end
    while int(eager.state.cursor) + lead * cfg.chunk < slots:
        look, ins, vals, dele, mask = batch()
        out = eager.step(oracle.key(look), oracle.key(ins), vals,
                         oracle.key(dele), ins_mask=mask)
        oracle.step(look, ins, vals, mask, dele, out, f"{name} graph {step}")
        step += 1
    skipped = step - 2
    graph_eng = DHashEngine(eager.state, continuous_rebuild=True)

    epoch0 = int(eager.state.epoch)
    t_replay, t_eager, t_dev = [], [], []
    swap_at = None
    n = 0
    while n < max_steps:
        look, ins, vals, dele, mask = batch()
        args = (oracle.key(look), oracle.key(ins), vals, oracle.key(dele))
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        got = graph_eng.step(*args, ins_mask=mask)
        ev1.record()
        torch.cuda.synchronize()
        if n:                   # the first step ran eagerly and captured
            t_replay.append((time.perf_counter() - t0) * 1e3)
            t_dev.append(ev0.elapsed_time(ev1))
        t0 = time.perf_counter()
        with eng_mod._eager():
            want = eager.step(*args, ins_mask=mask)
        torch.cuda.synchronize()
        t_eager.append((time.perf_counter() - t0) * 1e3)
        for a, b, what in zip(got, want, ("found", "vals", "ok_i", "ok_d")):
            check(torch.equal(a, b), f"graph {name} step {n}: {what} of the "
                  f"replayed step differs from the eager engine's")
        oracle.step(look, ins, vals, mask, dele, got, f"{name} graph {n}")
        step += 1
        n += 1
        if swap_at is None and int(graph_eng.state.epoch) > epoch0:
            swap_at = n
        if swap_at is not None and n >= swap_at + margin:
            break
    check(swap_at is not None, f"graph {name}: no live swap in {n} replays")
    check(int(eager.state.epoch) == int(graph_eng.state.epoch),
          f"graph {name}: the two engines' epochs differ")
    pairs = list(zip(_leaves(graph_eng.state), _leaves(eager.state)))
    for (p, a), (_, b) in pairs:
        check(torch.equal(a, b), f"graph {name}: state{p} differs from the "
              f"eager engine's after {n} replays")
    keys = graph_eng._step_cache_size()
    check(keys == 1 and len(graph_eng._step_keys) == 1,
          f"graph {name}: {keys} keys held, {len(graph_eng._step_keys)} "
          f"captured across the swap (one wanted)")
    # 10 more replayed steps under the profiler (the oracle is not
    # consulted: the engine's own results were checked above)
    extra = [batch() for _ in range(10)]

    def ten():
        for look, ins, vals, dele, mask in extra:
            graph_eng.step(oracle.key(look), oracle.key(ins), vals,
                           oracle.key(dele), ins_mask=mask)
    credited, seen = credited_against_profiler(ten, 10, f"graph {name}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ten()
        torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    # the host side of a replayed step, by call (self time under the
    # profiler, which adds its own cost to each)
    host = sorted(((e.self_cpu_time_total / 10, e.count / 10, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_cpu_time_total > 0), reverse=True)
    log(f"    host us a replayed step by call, profiler on ("
        f"{sum(h[0] for h in host):.1f} in all): " + ", ".join(
            f"{k} {us:.1f} ({c:g}x)" for us, c, k in host[:10]))
    out = dict(steps=n, skipped=skipped, swap_at=swap_at,
               leaves_equal=len(pairs),
               replay_host_us=sum(h[0] for h in host),
               replay_ms=statistics.median(t_replay),
               replay_p99_ms=sorted(t_replay)[int(0.99 * (len(t_replay) - 1))],
               eager_ms=statistics.median(t_eager),
               replay_device_ms=statistics.median(t_dev),
               replay_busy_ms=busy_us / 1e3 / 10)
    log(f"  {name}: {skipped} steps of the epoch replayed first, then {n} "
        f"steps in lock step, the engine's own replay from step 2, the live "
        f"swap at step {swap_at}; answers equal to the eager mode's and the "
        f"oracle's every step, all {len(pairs)} state tensors equal at the "
        f"end, one key held; ms a step: replayed {out['replay_ms']:.3f} "
        f"(p99 {out['replay_p99_ms']:.3f}, device span "
        f"{out['replay_device_ms']:.3f}, busy {out['replay_busy_ms']:.3f}), "
        f"eager {out['eager_ms']:.3f}; credited launches of 10 replayed "
        f"steps {credited}, equal to the profiler's kernels replay for "
        f"replay ({seen} of the 10 replays seen by the profiler)")
    return out


def phase_policy(device, cfg, tomb_load: float = 0.1, max_steps: int = 9000
                 ) -> dict:
    """The elastic policy on the card: linear, fused, ``cfg`` unreduced
    (2^21 slots), under ``DHashEngine(policy=policy.make(tomb_load=...))``,
    populated as the main path's.  A burst (fresh inserts, deletes masked
    off) past the high watermark; quiet steps (lookups only) while the poll
    applies the grow and the migration to 2^22 slots runs; a drain
    (deletes, inserts masked off) below the low watermark, during which
    tombstones past ``tomb_load`` fire a reclaim rehash on the device; quiet
    steps through it, the shrink the poll applies, and its migration back to
    2^20 slots.  Every step's answers are checked against the dict oracle.
    A twin engine cloned at the poll before the grow steps in the eager mode
    on the same batches until the grow has finished: answers equal every
    step, every state and policy tensor equal at the end.  Checked: one
    grow, one shrink, at least one fire; slot counts 2^21 -> 2^22 -> 2^20;
    the engine's host reads are its polls; no key captured twice; the
    credited launches of 16 replayed steady steps against the profiler."""
    from repro_torch.core import backend
    from repro_torch.core import engine as eng_mod
    from repro_torch.core import policy as elastic
    from repro_torch.core.engine import DHashEngine
    from repro_torch.kernels import probe
    NL, NU = cfg.lookups_per_step, cfg.updates_per_step
    be = backend.get(cfg.backend)
    eng, oracle, n_pop = main_engine(
        device, cfg, policy=elastic.make(tomb_load=tomb_load, device=device))
    K = eng.poll_every

    def slots():
        return be.capacity_of(eng.state.old)
    s0 = slots()
    high, _ = elastic.watermarks(eng.policy, s0)
    _, low = elastic.watermarks(eng.policy, 2 * s0)
    log(f"  populated {int(oracle.present.sum())} keys in {n_pop} engine "
        f"steps; {s0} slots; tomb_load {tomb_load}; grow above {high} "
        f"live ({s0} slots), shrink below {low} ({2 * s0} slots)")
    syncs0, steps0 = eng._stats.host_syncs, eng._stats.steps
    keys0 = len(eng._step_keys)
    probe.reset_launches()
    t_step, t_eager, slot_seq = [], [], [slots()]
    events: dict = {}
    twin, stale = None, 0
    ones, offs = np.ones(NU, bool), np.zeros(NU, bool)
    fires = 0

    def one(kind: str):
        nonlocal twin, stale, fires
        n = eng._stats.steps
        look, ins, vals, dele = oracle.batch(NL, NU, n)
        im = ~oracle.present[ins] if kind == "burst" else offs
        dm = ones if kind == "drain" else offs
        args = (oracle.key(look), oracle.key(ins), vals, oracle.key(dele))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step(*args, ins_mask=im, del_mask=dm)
        torch.cuda.synchronize()
        t_step.append((time.perf_counter() - t0) * 1e3)
        if twin is not None:
            t0 = time.perf_counter()
            with eng_mod._eager():
                want = twin.step(*args, ins_mask=im, del_mask=dm)
            torch.cuda.synchronize()
            t_eager.append((time.perf_counter() - t0) * 1e3)
            for a, b, what in zip(out, want, ("found", "vals", "ok_i",
                                              "ok_d")):
                check(torch.equal(a, b), f"policy step {n}: {what} differs "
                      f"from the eager twin's")
        oracle.step(look, ins, vals, im, dele, out, f"policy {kind} {n}",
                    del_mask=dm)
        # the harness's own read: the fire count and the device flag
        f, rb = torch.stack([eng.policy.fires,
                             eng.state.rebuilding.to(torch.int32)]).tolist()
        if f > fires:
            events.setdefault("fires", []).append(
                (n + 1, "between polls" if (n + 1) % K else "at a poll"))
            fires = f
        stale += bool(rb) != eng.rebuilding
        if slots() != slot_seq[-1]:
            slot_seq.append(slots())
            events.setdefault("resized", []).append(n + 1)
        if eng._stats.grows + eng._stats.shrinks > len(
                events.get("resize_started", [])):
            events.setdefault("resize_started", []).append(n + 1)

    def run(kind: str, until, limit: int):
        for _ in range(limit):
            if until():
                return
            one(kind)
        check(False, f"policy: {kind} did not end in {limit} steps")

    def live():
        return int(oracle.present.sum())
    t0 = time.perf_counter()
    # quiet steps to a poll, where the twin is cloned (its polls fall on
    # the engine's), then the burst
    run("quiet", lambda: eng._stats.steps % K == 0, K)
    twin = DHashEngine(eng.state, policy=eng.policy, poll_every=K,
                       rebuild_seed=eng.rebuild_seed)
    twin_from = eng._stats.steps
    while live() <= high:
        one("burst")
    events["burst_steps"] = eng._stats.steps - twin_from
    run("quiet", lambda: eng._stats.grows == 1 and not eng.rebuilding,
        max_steps)
    check(twin is not None, "policy: the twin was never cloned")
    for (p, a), (_, b) in zip(_leaves(eng.state), _leaves(twin.state)):
        check(torch.equal(a, b), f"policy: state{p} differs from the eager "
              f"twin's after the grow")
    for (p, a), (_, b) in zip(_leaves(eng.policy), _leaves(twin.policy)):
        check(torch.equal(a, b), f"policy: policy{p} differs from the twin's")
    twin_steps = eng._stats.steps - twin_from
    twin = None
    run("drain", lambda: live() < low, max_steps)
    run("quiet", lambda: eng._stats.shrinks == 1 and not eng.rebuilding,
        max_steps)
    wall = time.perf_counter() - t0
    n_steps = eng._stats.steps - steps0
    polls = sum(1 for s in range(steps0 + 1, eng._stats.steps + 1)
                if s % K == 0)
    syncs = eng._stats.host_syncs - syncs0
    launches = probe.launch_counts()
    st = eng._stats
    check(st.grows == 1 and st.shrinks == 1,
          f"policy: {st.grows} grows and {st.shrinks} shrinks (1 and 1)")
    check(fires >= 1, "policy: no reclaim fired on the device")
    check(slot_seq == [s0, 2 * s0, s0 // 2],
          f"policy: slot counts {slot_seq}")
    check(syncs == polls, f"policy: {syncs} host reads in {n_steps} steps, "
          f"{polls} polls")
    captured = eng._step_keys[keys0:]
    check(len(set(captured)) == len(captured), "policy: a key captured twice")
    # 16 replayed steady steps (lookups, inserts and deletes) under the
    # profiler: the credited launches against the kernels the device ran
    extra = [oracle.batch(NL, NU, 1 << 20) for _ in range(16)]

    look, ins, vals, dele = oracle.batch(NL, NU, 1 << 21)
    eng.step(oracle.key(look), oracle.key(ins), vals, oracle.key(dele),
             ins_mask=~oracle.present[ins])       # this key's capture

    def sixteen():
        for look, ins, vals, dele in extra:
            eng.step(oracle.key(look), oracle.key(ins), vals,
                     oracle.key(dele), ins_mask=~oracle.present[ins])
    credited, seen = credited_against_profiler(sixteen, 16,
                                               "policy steady")
    ts = sorted(t_step)
    out = dict(steps=n_steps, burst_steps=events["burst_steps"],
               resize_started=events["resize_started"],
               resized=events["resized"], fires=events["fires"],
               slots=slot_seq, host_reads=syncs, polls=polls,
               stale_flag_steps=stale, keys_captured=len(captured),
               step_ms=statistics.median(ts),
               step_p99_ms=ts[int(0.99 * (len(ts) - 1))], step_max_ms=ts[-1],
               eager_ms=statistics.median(t_eager), twin_steps=twin_steps,
               wall_s=wall, launches={k: v for k, v in launches.items() if v},
               credited_steady=credited)
    log(f"  {n_steps} steps ({events['burst_steps']} of burst): resizes "
        f"started at steps {events['resize_started']} (polls), finished at "
        f"{events['resized']}; slots {slot_seq}; reclaim fires on the device "
        f"at {events['fires']}; host flag stale on {stale} steps; every "
        f"answer right by the oracle")
    log(f"  host reads {syncs} = polls {polls}; {len(captured)} keys "
        f"captured, none twice: " + "; ".join(
            f"sizes {k[4]} swap {k[3]}" for k in captured))
    log(f"  ms a step: replayed median {out['step_ms']:.3f} p99 "
        f"{out['step_p99_ms']:.3f} max {out['step_max_ms']:.3f}; eager twin "
        f"{out['eager_ms']:.3f} over {twin_steps} steps (answers equal every "
        f"step, every state and policy tensor equal after the grow); wall "
        f"{wall:.1f} s with the oracle")
    log(f"  launches: {out['launches']}; 16 replayed steady steps credited "
        f"{credited}, equal to the profiler's kernels replay for replay "
        f"({seen} of the 16 replays seen by the profiler)")
    return out


def mid_rebuild_split(eng, keys, reps: int) -> None:
    """Where the mid-rebuild flood lookup's device time goes: the whole
    engine lookup, its two bucket hashes alone and its ``chain_probe2``
    launch alone on the same state and batch, each timed three times (a
    median of ``reps`` each), and how many queries the kernel's hazard
    compare must run to the buffer's last live entry."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import probe
    d = eng.state
    old, new = d.old, d.new
    hz = (d.hazard_key, d.hazard_val, d.hazard_live)
    bq_old, bq_new = be._chain_bq(old, keys), be._chain_bq(new, keys)
    mc = max(old.max_chain, new.max_chain)
    dc = max(old.dirty_cap, new.dirty_cap)

    def kernel():
        probe.chain_probe2(be._chain_parts(old), be._chain_parts(new), *hz,
                           bq_old, bq_new, keys, mc, dc)

    def hashes():
        be._chain_bq(old, keys), be._chain_bq(new, keys)

    times = {name: [time_ms(fn, reps) for _ in range(3)] for name, fn in
             (("lookup", lambda: eng.lookup(keys)), ("hashes", hashes),
              ("chain_probe2", kernel))}
    f_old = probe.chain_probe2(be._chain_parts(old), be._chain_parts(new),
                               *hz, bq_old, bq_new, keys, mc, dc)[2]
    log(f"  mid-rebuild split, ms (3 medians of {reps} each): " + "; ".join(
        f"{k} " + " / ".join(f"{t:.4f}" for t in v)
        for k, v in times.items()) +
        f"; hazard live {int(d.hazard_live.sum())} of {d.hazard_live.numel()}"
        f", queries the old arena resolved {int(f_old.sum())} of "
        f"{keys.numel()}, old segment of bucket 0 {int(old.blen[0])} nodes")


def phase_chain_flood(device, cfg, reps: int, n_attack: int = 2048) -> dict:
    """The chain arm of the collision-flood benchmark
    (``benchmarks/bench_attack.py``) at the main path's size, on a table of
    its own with ``max_chain = n_attack + 64`` as there: populate half the
    arena, time a batch of resident lookups, insert ``n_attack`` keys that
    all hash to bucket 0 under the live hash function, time a batch half of
    flood keys, run a live hash-function swap through the engine with that
    batch looked up and checked on every step (timed once mid-epoch), and
    time it again after the swap.  Every flood key and every resident must
    be found with its value, and the count must be exact.  Returns the four
    lookup rates (M lookups/s)."""
    from repro_torch.core import dhash, hashing
    from repro_torch.core.engine import DHashEngine
    cap, Q = cfg.capacity_per_shard, cfg.lookups_per_step
    state = dhash.make("chain", capacity=cap, chunk=cfg.chunk, fused=True,
                       seed=7, device=device, max_chain=n_attack + 64)
    oracle = Oracle(4 * cap, seed=17)
    eng = DHashEngine(state, continuous_rebuild=False)
    populate(eng, oracle, cap // 2, Q, "flood")
    live = np.flatnonzero(oracle.present)
    rng = np.random.default_rng(23)
    pick = rng.choice(live, Q)
    resident = torch.as_tensor(oracle.key(pick), device=device)
    res_vals = torch.as_tensor(oracle.value[pick], device=device)
    rates = {}

    def rate(name, keys, expect_vals):
        f, v = eng.lookup(keys)
        check(bool(f.all()) and torch.equal(v, expect_vals),
              f"flood: {int((~f).sum())} lookups missed ({name})")
        ms = time_ms(lambda: eng.lookup(keys), reps)
        rates[name] = keys.numel() / ms / 1e3
        return ms

    ms = rate("before", resident, res_vals)
    log(f"  populated {live.size} keys; {Q} resident lookups {ms:.4f} ms")

    t = eng.state.old
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    got = torch.empty(0, dtype=torch.int32, device=device)
    while got.numel() < n_attack:
        cand = torch.randint(1 << 24, (1 << 31) - 1, (1 << 24,),
                             generator=gen, device=device, dtype=torch.int32)
        hit = cand[hashing.bucket_of(t.hfn, cand, t.nbuckets) == 0]
        got = torch.unique(torch.cat([got, hit]))
    atk = got[torch.randperm(got.numel(), generator=gen,
                             device=device)[:n_attack]]
    empty = np.zeros(0, np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = eng.step(empty, atk, atk * 7 + 3, empty)[2]
    torch.cuda.synchronize()
    ins_ms = (time.perf_counter() - t0) * 1e3
    check(bool(ok.all()), f"flood: {int((~ok).sum())} flood keys refused")
    seg0 = int(eng.state.old.blen[0])
    check(seg0 >= n_attack, f"flood: bucket 0's segment holds {seg0} nodes")
    pick = torch.as_tensor(rng.integers(0, n_attack, Q // 2), device=device)
    mixed = torch.cat([resident[: Q - Q // 2], atk[pick]])
    mixed_vals = torch.cat([res_vals[: Q - Q // 2], atk[pick] * 7 + 3])
    ms = rate("under_attack", mixed, mixed_vals)
    log(f"  flood: {n_attack} keys into bucket 0 in one step ({ins_ms:.3f} "
        f"ms), its segment now {seg0} nodes; mixed lookups (half flood "
        f"keys) {ms:.4f} ms")

    eng.request_rebuild(seed=20260714)
    steps = 0
    while eng.stats.rebuilds_completed == 0:
        out = eng.step(mixed, empty, empty, empty)
        check(bool(out[0].all()) and torch.equal(out[1], mixed_vals),
              f"flood: lookups lost during the swap at step {steps}")
        steps += 1
        if steps == cap // cfg.chunk:          # half way through the epoch
            rate("mid_rebuild", mixed, mixed_vals)
            mid_rebuild_split(eng, mixed, reps)
        check(steps < 4 * cap // cfg.chunk, "flood: the swap did not finish")
    ms = rate("after_rebuild", mixed, mixed_vals)
    n = eng.count()
    check(n == live.size + n_attack, f"flood: count {n} != {live.size} + "
          f"{n_attack} after the swap")
    f, v = eng.lookup(torch.as_tensor(oracle.key(live), device=device))
    check(bool(f.all()) and np.array_equal(
        np.asarray(v.cpu()), oracle.value[live]),
        "flood: residents lost across the swap")
    f, v = eng.lookup(atk)
    check(bool(f.all()) and torch.equal(v, atk * 7 + 3),
          "flood: flood keys lost across the swap")
    longest = int(eng.state.old.blen.max())
    log(f"  live swap: {steps} engine steps, every lookup answered; after "
        f"it all {n_attack} flood keys and all {live.size} residents found, "
        f"count {n} exact, longest segment {longest}; mixed lookups "
        f"{ms:.4f} ms")
    log("  lookup rates, M lookups/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()))
    return rates


def _content(tree: dict) -> dict:
    """A state's key -> value map as a lookup sees it: old > hazard > new."""
    def live(t):
        a = "a" if "astate" in t else ""          # a chain arena's fields
        s = t[a + "state"].reshape(-1) == 1
        return dict(zip(t[a + "key"].reshape(-1)[s].tolist(),
                        t[a + "val"].reshape(-1)[s].tolist()))
    out = live(tree["new"])
    hl = tree["hazard_live"]
    out.update(zip(tree["hazard_key"][hl].tolist(),
                   tree["hazard_val"][hl].tolist()))
    out.update(live(tree["old"]))
    return out


# ---------------------------------------------------------------------------
# table stacks: the four kernels with the table axis (phase 2), a linear
# stack engine (3h) and the policy's stack arm (3i)
# ---------------------------------------------------------------------------

STACK_T = 8
# the kernels with the table axis, and one stacked step's launches of each
# (one single-table step's): the lookup's and the delete's probe2, the user
# insert's and the landing's probe_insert, the transition's extract, the
# exchange's epoch_swap
STACK_KERNELS = {"probe2": 2, "probe_insert": 2, "extract": 1,
                 "epoch_swap": 1}


def _tt(x, device, dt=torch.int32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)


class StackOracle:
    """The dense oracle of a table stack, on the device: ``present`` and
    ``value`` [T, U] over each table's key universe ``[-U/2, U/2)`` (and a
    spare last column that masked-off writes land in); the op order of a
    step is lookup, insert, delete; the first masked occurrence of a key in
    a batch wins (found with a scatter of positions, not a sort).  Checks
    accumulate on the device (``bad``, the first failing step in
    ``first_bad``): ``verify`` reads them."""

    def __init__(self, n_tables: int, universe: int, seed: int, device):
        self.t, self.u, self.dev = n_tables, universe, device
        self.present = torch.zeros((n_tables, universe + 1), dtype=torch.bool,
                                   device=device)
        self.value = torch.zeros((n_tables, universe + 1), dtype=torch.int32,
                                 device=device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.first_bad = torch.full((), -1, dtype=torch.int64, device=device)
        self.no_slot = torch.zeros((), dtype=torch.int64, device=device)
        self._pos = torch.full((n_tables, universe + 1), 1 << 30,
                               dtype=torch.int32, device=device)

    def key(self, idx: torch.Tensor) -> torch.Tensor:
        return (idx - self.u // 2).to(torch.int32)

    def live(self) -> torch.Tensor:
        return self.present[:, :self.u].sum(-1)

    def sample(self, n: int, want_present: bool) -> torch.Tensor:
        """[T, n] key indices that are (not) present, best effort: 8n
        candidates a row (present keys are a quarter of the universe at
        the main path's load), the first n that qualify."""
        cand = torch.randint(0, self.u, (self.t, 8 * n), generator=self.gen,
                             device=self.dev)
        ok = self.present.gather(1, cand) == want_present
        order = torch.sort((~ok).to(torch.int8), dim=1, stable=True)[1]
        return cand.gather(1, order[:, :n])

    def _shuffled(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.rand(x.shape, generator=self.gen, device=self.dev)
        return x.gather(1, r.argsort(dim=1))

    def batch(self, n_look: int, n_upd: int, step: int):
        """(look, ins, vals, dele) [T, n] index tensors: lookups half
        present, fresh inserts with duplicates (n_upd / 64 of them), present
        deletes."""
        h = n_look // 2
        look = self._shuffled(torch.cat([self.sample(h, True),
                                         self.sample(n_look - h, False)], 1))
        ins = self.sample(n_upd, False)
        d = n_upd // 64
        ins[:, :d] = ins[:, d:2 * d]
        dele = self.sample(n_upd, True)
        vals = (ins * 3 + step).to(torch.int32)
        return look, ins, vals, dele

    def _first(self, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """mask & the first masked occurrence of each index in its row."""
        pos = torch.arange(idx.shape[1], dtype=torch.int32,
                           device=self.dev).expand(idx.shape)
        col = torch.where(mask, idx, self.u)
        self._pos.scatter_reduce_(1, col, pos, "amin")
        first = mask & (self._pos.gather(1, col) == pos)
        self._pos.scatter_(1, col, 1 << 30)
        return first

    def _fail(self, bad: torch.Tensor, step: int) -> None:
        self.first_bad.copy_(torch.where(bad & (self.first_bad < 0), step,
                                         self.first_bad))

    def step(self, look, ins, vals, ins_mask, dele, del_mask, out,
             step: int) -> None:
        """Hold one step's outputs (found, vals, ok_i, ok_d) to the oracle
        and apply the step, on the device."""
        found, got, ok_i, ok_d = out
        exp_f = self.present.gather(1, look)
        bad = (found != exp_f).any() | (got != torch.where(
            exp_f, self.value.gather(1, look), 0)).any()
        win = self._first(ins, ins_mask)
        bad |= (ok_i & ~win).any()
        self.no_slot += (win & ~ok_i).sum()
        col = torch.where(ok_i, ins, self.u)
        self.present.scatter_(1, col, True)
        self.value.scatter_(1, col, vals)
        exp_d = self._first(dele, self.present.gather(1, dele) & del_mask)
        bad |= (ok_d != exp_d).any()
        self.present.scatter_(1, torch.where(exp_d, dele, self.u), False)
        self.present[:, self.u] = False
        self._fail(bad, step)

    def verify(self, where: str) -> None:
        """The one read: fails at the first step whose outputs differed."""
        s = int(self.first_bad)
        check(s < 0, f"{where}: step {s}'s answers differ from the oracle's")


def stack_populate(st, oracle, batch: int) -> int:
    """Fill each table of the stack ``st`` to half its slots through
    ``dhash.stack_insert`` (keys drawn per table, uniform over its
    universe), the oracle kept.  Returns the insert calls."""
    from repro_torch.core import dhash
    cap = st.old.capacity // 2
    calls = 0
    while True:
        need = cap - oracle.live()
        if int(need.max()) <= 0:
            return calls
        ins = oracle.sample(batch, False)
        vals = (ins * 3 - 1).to(torch.int32)
        mask = torch.arange(batch, device=oracle.dev)[None, :] < need[:, None]
        _, ok = dhash.stack_insert(st, oracle.key(ins), vals, mask)
        none = torch.zeros((oracle.t, 0), dtype=torch.int64,
                           device=oracle.dev)
        oracle.step(none, ins, vals, mask, none, none.bool(),
                    (none.bool(), none.int(), ok, none.bool()), -1 - calls)
        calls += 1


def stack_state(device, cfg, seed: int):
    """A linear stack of ``STACK_T`` tables, each the ``dhash-paper`` shard
    unreduced (capacity 2^20, 2^21 slots, chunk 4096), fused, populated to
    2^20 keys a table, and its dense oracle."""
    from repro_torch.core import dhash
    cap = cfg.capacity_per_shard
    st = dhash.make_stack(STACK_T, "linear", cap, chunk=cfg.chunk,
                          fused=True, seed=seed, device=device)
    oracle = StackOracle(STACK_T, 4 * cap, seed, device)
    stack_populate(st, oracle, cfg.lookups_per_step)
    oracle.verify("stack populate")
    return st, oracle


def stack_kernel_cases(device, cfg, reps: int) -> dict:
    """The four kernels with the table axis against their plain versions,
    tolerance 0, at T = 8 tables of 2^21 slots and the main path's batches
    a table, on a stack of mixed states: tables 0-4 mid-rebuild (started
    at three different times: different cursors, a live hazard buffer on
    2, 3 and 4), 5-7 idle, tombstones on every table, fresh keys in the
    rebuilding tables' new tables; then each timed at T = 8 with its bound
    for that work."""
    from repro_torch.core import backend, dhash, hashing
    from repro_torch.core.struct_utils import map_tensors
    from repro_torch.kernels import probe
    T, CH, P = STACK_T, cfg.chunk, 64
    Q, QU = cfg.lookups_per_step, cfg.updates_per_step
    rng = np.random.default_rng(29)
    st, oracle = stack_state(device, cfg, 20)
    C = st.old.capacity
    dhash.stack_delete(st, oracle.key(oracle.sample(QU, True)))
    for start, n in (((0, 1), 9), ((2, 3), 4), ((4,), 1)):
        m = np.zeros(T, bool)
        m[list(start)] = True
        dhash.stack_autostart(st, _tt(m, device, torch.bool))
        for _ in range(n):
            dhash.stack_rebuild_step(st)
    fresh = rng.integers(-(1 << 31), -(1 << 30), (T, QU)).astype(np.int32)
    dhash.stack_insert(st, _tt(fresh, device), _tt(fresh * 7, device))
    rb = st.rebuilding.tolist()
    live_hz = st.hazard_live.any(-1).tolist()
    check(rb == [True] * 5 + [False] * 3 and live_hz ==
          [False, False, True, True, True, False, False, False],
          f"stack cases: rebuilding {rb}, live hazard {live_hz}")
    cursors = st.cursor.tolist()
    log(f"  stack: {T} linear tables of {C} slots, rebuilding {rb}, "
        f"cursors {cursors}, live hazard entries "
        f"{st.hazard_live.sum(-1).tolist()}")
    res = {}
    old = (st.old.key, st.old.val, st.old.state)
    new = (st.new.key, st.new.val, st.new.state)

    # -- probe2: a quarter old keys, a quarter hazard keys (old ones where a
    #    table has none live), a quarter keys of the new tables, the rest
    #    misses; the idle tables answer from their old table alone
    q4 = Q // 4
    rows = []
    olds = oracle.key(oracle.sample(q4, True)).cpu().numpy()
    for t in range(T):
        hz = st.hazard_key[t][st.hazard_live[t]].cpu().numpy()
        rows.append(np.concatenate([
            olds[t], rng.choice(hz, q4) if hz.size else olds[t],
            rng.choice(fresh[t], q4),
            rng.integers(1 << 30, (1 << 31) - 1, Q - 3 * q4)]))
        rng.shuffle(rows[-1])
    qk = _tt(np.stack(rows).astype(np.int32), device)
    h0o = hashing.bucket_of(st.old.hfn, qk, C)
    h0n = hashing.bucket_of(st.new.hfn, qk, C)
    args = (old, new, st.hazard_key, st.hazard_val, st.hazard_live, h0o, h0n,
            qk, P, st.rebuilding)
    out_k = probe.probe2(*args)
    torch.cuda.synchronize()
    out_p = probe.probe2_plain(*args)
    err = max(same(x, y, f"stack probe2 {n}")
              for x, y, n in zip(out_k, out_p, OUTPUTS))
    found, _, f_old, loc_old, hz_idx, loc_new = out_k
    idle = ~st.rebuilding
    check(not bool(((hz_idx >= 0) | (loc_new >= 0))[idle].any()),
          "stack probe2: an idle table looked past its old table")
    check(all(int((hz_idx[t] >= 0).sum()) > 0 for t in (2, 3, 4))
          and all(int((loc_new[t] >= 0).sum()) > 0 for t in range(5)),
          "stack probe2: the rebuilding tables must hit hazard and new")
    v_old = sum(count_visits(st.old.state[t], h0o[t], f_old[t], loc_old[t],
                             P) for t in range(T))
    v_new = 0
    for t in range(5):
        u = ~f_old[t] & (hz_idx[t] < 0)
        v_new += count_visits(st.new.state[t], h0n[t][u],
                              (loc_new[t] >= 0)[u], loc_new[t][u], P)
    hz_lookups = int((~f_old[:5]).sum())
    nbytes = T * Q * 8 + 5 * Q * 4 + (v_old + v_new) * 8 + 5 * CH * 9 \
        + T * Q * 18
    res["probe2"] = dict(
        T=T, max_abs_err=err, ms=time_ms(lambda: probe.probe2(*args), reps),
        plain_ms=time_ms(lambda: probe.probe2_plain(*args), 3,
                         queue_ahead=False),
        **bound(nbytes, SET_LOOKUP_OPS * hz_lookups + 2 * (v_old + v_new)))
    log(f"  stack probe2 ok: T={T} Q={Q} a table, idle tables {[5, 6, 7]} "
        f"on their old table alone; visits old={v_old} new={v_new}; "
        + json.dumps(res["probe2"]))

    # -- probe_insert: each table into its target by its flag (the new
    #    table mid-rebuild, else the old), an eighth of the keys present,
    #    duplicates, a random mask
    pres = []
    olds = oracle.key(oracle.sample(QU // 8, True)).cpu().numpy()
    for t in range(T):
        pres.append(fresh[t, :QU // 8] if rb[t] else olds[t])
    k = np.concatenate([np.stack(pres), rng.integers(
        -(1 << 31), -(1 << 30), (T, QU - QU // 8))], 1).astype(np.int32)
    dup = QU // 8
    k[:, QU // 4: QU // 4 + dup] = k[:, QU // 2: QU // 2 + dup]  # duplicates
    k = _tt(k, device)
    v = k * 5 + 2
    from repro_torch.core import buckets
    m = buckets.batch_winners(k, _tt(rng.random((T, QU)) < 0.9, device,
                                     torch.bool))
    h0 = torch.where(st.rebuilding[:, None],
                     hashing.bucket_of(st.new.hfn, k, C),
                     hashing.bucket_of(st.old.hfn, k, C))
    copies = [[x.clone() for x in old + new] for _ in range(2)]
    ok_k, pr_k = probe.probe_insert(*copies[0][:3], h0, k, v, m, P,
                                    alt=tuple(copies[0][3:]),
                                    use_alt=st.rebuilding)
    torch.cuda.synchronize()
    ok_p, pr_p = probe.probe_insert_plain(*copies[1][:3], h0, k, v, m, P,
                                          alt=tuple(copies[1][3:]),
                                          use_alt=st.rebuilding)
    err = max(same(ok_k, ok_p, "stack probe_insert ok"),
              same(pr_k, pr_p, "stack probe_insert present"),
              *(same(x, y, f"stack probe_insert table {i}")
                for i, (x, y) in enumerate(zip(*copies))))
    for t in range(T):          # only the target table changed
        kept = copies[0][:3] if rb[t] else copies[0][3:]
        ref = old if rb[t] else new
        check(all(torch.equal(x[t], y[t]) for x, y in zip(kept, ref)),
              f"stack probe_insert: table {t} wrote its other table")
    check(int(pr_k.sum()) > 0 and int(ok_k.sum()) > 0,
          "stack probe_insert: nothing placed or nothing present")
    target = torch.where(st.rebuilding[:, None], st.new.state, st.old.state)
    visits = sum(count_visits(target[t], h0[t], pr_k[t],
                              torch.full_like(h0[t], -1), P)
                 for t in range(T))

    def restore_insert():
        for x, y in zip(copies[0], old + new):
            x.copy_(y)
    nbytes = T * QU * 15 + visits * 8 + int(ok_k.sum()) * 12
    res["probe_insert"] = dict(
        T=T, max_abs_err=err, placed=int(ok_k.sum()), present=int(pr_k.sum()),
        ms=time_ms(lambda: probe.probe_insert(
            *copies[0][:3], h0, k, v, m, P, alt=tuple(copies[0][3:]),
            use_alt=st.rebuilding), reps, restore_insert),
        plain_ms=time_ms(lambda: probe.probe_insert_plain(
            *copies[0][:3], h0, k, v, m, P, alt=tuple(copies[0][3:]),
            use_alt=st.rebuilding), 3, restore_insert, queue_ahead=False),
        **bound(nbytes, 0))
    log(f"  stack probe_insert ok: T={T} Q={QU} a table, each into its "
        f"target by its flag; " + json.dumps(res["probe_insert"]))

    # -- the transition (extract): table 1 at the end of its table with no
    #    hazard entry live (it decides a swap), table 0 on the partial last
    #    chunk, 2, 3 and 4 landing (live hazard), 5-7 idle
    base = map_tensors(torch.clone, st)
    base.cursor[1] = C
    base.cursor[0] = C - 1000
    ok_t = torch.rand((T, CH), device=device) < 0.5
    present_t = (torch.rand((T, CH), device=device) < 0.2) & ~ok_t
    be = backend.get("linear")
    outs = []
    for fn in (be.stack_transition_fused, None):
        e = map_tensors(torch.clone, base)
        hz = (e.hazard_key, e.hazard_val, e.hazard_live)
        if fn is None:
            go = probe.transition_plain(e.old.key, e.old.val, e.old.state,
                                        e.cursor, CH, hz, e.rebuilding, ok_t,
                                        present_t, True, True)
        else:
            go = fn(e.old, e.cursor, CH, hz, e.rebuilding, ok_t, present_t,
                    True, True)
            torch.cuda.synchronize()
        outs.append((go, e.old.state, *hz, e.cursor))
    err = max(same(x, y, f"stack transition {n}") for x, y, n in zip(
        *outs, ("go", "state", "hkey", "hval", "hlive", "cursor")))
    go = outs[0][0].tolist()
    check(go[1] == [True, True] and not any(go[t][0] for t in (0, 2, 3, 4))
          and all(go[t] == [False, True] for t in (5, 6, 7)),
          f"stack transition: decisions {go}")
    e = map_tensors(torch.clone, base)
    hz = (e.hazard_key, e.hazard_val, e.hazard_live)

    def restore_transition():
        e.old.state.copy_(base.old.state)
        for x, y in zip(hz + (e.cursor,), (base.hazard_key, base.hazard_val,
                                           base.hazard_live, base.cursor)):
            x.copy_(y)
    pending = base.hazard_live.any(-1)
    scan = base.rebuilding & ~pending
    nbytes = 0
    for t in range(T):
        if bool(pending[t]):            # the landing's bookkeeping
            nbytes += CH * 4
        elif bool(scan[t]):             # the chunk scan (cf. the single)
            cur = int(base.cursor[t])
            n_live = int((base.old.state[t, cur:cur + CH] == 1).sum())
            nbytes += CH * 14 + n_live * 12 + 11
        else:                           # the flags and the decision
            nbytes += CH + 3
    res["extract"] = dict(
        T=T, max_abs_err=err,
        ms=time_ms(lambda: be.stack_transition_fused(
            e.old, e.cursor, CH, hz, e.rebuilding, ok_t, present_t, True,
            True), reps, restore_transition),
        plain_ms=time_ms(lambda: probe.transition_plain(
            e.old.key, e.old.val, e.old.state, e.cursor, CH, hz,
            e.rebuilding, ok_t, present_t, True, True), 3,
            restore_transition, queue_ahead=False),
        **bound(nbytes, 0))
    log(f"  stack transition ok: T={T}, decisions {go}; "
        + json.dumps(res["extract"]))

    # -- epoch_swap: on a given go (table 0 swaps and starts, 1 swaps, 5
    #    starts, the rest stay) and on its own decision (table 1 done: swap
    #    and start; the idle tables start; the others stay)
    gos = torch.zeros((T, 2), dtype=torch.bool, device=device)
    gos[0] = True
    gos[1, 0] = True
    gos[5, 1] = True
    err = 0
    for given in (gos, None):
        outs = []
        for fn in (probe.epoch_swap, probe.epoch_swap_plain):
            e = map_tensors(torch.clone, base)
            lo = backend.epoch_leaves(e.old)
            ln = backend.epoch_leaves(e.new)
            go = fn([x for x, _ in lo], [x for x, _ in ln],
                    [s for _, s in lo], e.hazard_live, e.cursor,
                    e.rebuilding, e.epoch, e.lookups, e.expensive, C, True,
                    True, given)
            torch.cuda.synchronize()
            outs.append([go.clone()] + [x for _, x in _leaves(e)])
        err = max(err, *(same(x, y, f"stack epoch_swap given="
                              f"{given is not None} leaf {i}")
                         for i, (x, y) in enumerate(zip(*outs))))
        if given is None:
            check(outs[0][0].tolist() == [[False, False], [True, True]]
                  + [[False, False]] * 3 + [[False, True]] * 3,
                  f"stack epoch_swap: decisions {outs[0][0].tolist()}")
            seeds = backend.epoch_leaves(e.new)[0][0]
            check(len({tuple(r) for r in seeds.tolist()}) == T,
                  "stack epoch_swap: the reseeded tables share seeds")
    e = map_tensors(torch.clone, base)
    lo, ln = backend.epoch_leaves(e.old), backend.epoch_leaves(e.new)
    mut = [x for x, _ in lo + ln] + [e.cursor, e.rebuilding, e.epoch]
    snap = [x.clone() for x in mut]

    def restore_swap():
        for x, y in zip(mut, snap):
            x.copy_(y)
    leaf = sum(x[0].numel() * x.element_size() for x, _ in ln)
    res["epoch_swap"] = dict(
        T=T, max_abs_err=err,
        ms=time_ms(lambda: probe.epoch_swap(
            [x for x, _ in lo], [x for x, _ in ln], [s for _, s in lo],
            e.hazard_live, e.cursor, e.rebuilding, e.epoch, e.lookups,
            e.expensive, C, True, True, gos), reps, restore_swap),
        plain_ms=time_ms(lambda: probe.epoch_swap_plain(
            [x for x, _ in lo], [x for x, _ in ln], [s for _, s in lo],
            e.hazard_live, e.cursor, e.rebuilding, e.epoch, e.lookups,
            e.expensive, C, True, True, gos), 3, restore_swap,
            queue_ahead=False),
        # swap and start: read new, write both; swap: read and write both;
        # start: write new
        **bound(leaf * (3 + 4 + 1), 0))
    log(f"  stack epoch_swap ok: T={T}, on a given go (one table swaps and "
        f"starts, one swaps, one starts) and on its own decision; "
        + json.dumps(res["epoch_swap"]))
    return res


# the two-row backends whose kernels gained the table axis: the insert
# (``tc_insert``, with the kick-out on cuckoo) and the ordered check
# (``tc_probe2``)
TWO_ROW_STACK = ("twochoice", "cuckoo")


def two_row_stack_state(device, cfg, name: str, seed: int):
    """A fused stack of ``STACK_T`` tables of ``name`` at the ``dhash-paper``
    shard's size (capacity 2^20: twochoice 2^18 x 8, cuckoo 2 x 2^17 x 8),
    each offered 2^20 keys of its own (half its slots), a batch of them
    deleted (tombstones), in mixed states: tables 0, 2 and 4 mid-rebuild
    (started 9, 5 and 1 transitions ago: cursors of 5, 3 and 1 chunks, each
    with a live hazard buffer) holding fresh keys in their new tables; 1,
    3, 5 and 6 idle; 7 full (every lane of its old table LIVE).  Returns
    (stack, keys [T, 2^20] offered, fresh [T, 4096] inserted after the
    starts)."""
    from repro_torch.core import dhash
    T, QU = STACK_T, cfg.updates_per_step
    st = dhash.make_stack(T, name, cfg.capacity_per_shard, chunk=cfg.chunk,
                          fused=True, seed=seed, device=device)
    slots = st.old.key[0].numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    keys = torch.randint(1, 1 << 30, (T, slots // 2), generator=gen,
                         device=device, dtype=torch.int32)
    for j in range(0, slots // 2, 1 << 16):
        k = keys[:, j:j + (1 << 16)].contiguous()
        dhash.stack_insert(st, k, k * 3 + 1)
    dhash.stack_delete(st, keys[:, :QU].contiguous())
    full = -(torch.arange(slots, device=device, dtype=torch.int32) + 1)
    st.old.key[7].copy_(full.view(st.old.key[7].shape))
    st.old.val[7].copy_(full.view(st.old.key[7].shape) * 3)
    st.old.state[7].fill_(1)                                # LIVE
    for s in range(9):
        if s in (0, 4, 8):
            m = torch.zeros(T, dtype=torch.bool, device=device)
            m[s // 2] = True
            dhash.stack_autostart(st, m)
        dhash.stack_rebuild_step(st)
    fresh = torch.randint(1 << 30, (1 << 31) - 1, (T, 4096), generator=gen,
                          device=device, dtype=torch.int32)
    dhash.stack_insert(st, fresh, fresh * 7)
    rb = st.rebuilding.tolist()
    live_hz = st.hazard_live.any(-1).tolist()
    want = [t in (0, 2, 4) for t in range(T)]
    check(rb == want and live_hz == want,
          f"{name} stack cases: rebuilding {rb}, live hazard {live_hz}")
    return st, keys, fresh


def two_row_stack_cases(device, cfg, reps: int) -> dict:
    """``tc_probe2`` and ``tc_insert`` (twochoice's eight rounds, cuckoo's
    two and the kick-out in the resolve) with the table axis against their
    plain versions, tolerance 0, at T = 8 tables of the main path's
    two-row shapes in mixed states (``two_row_stack_state``): the idle
    tables on their old rows alone, each table inserting into its target
    by its flag (the new table mid-rebuild, with its new hash functions for
    the kick-out), table 6 under a flood of 2048 keys of one row pair,
    table 7 full; then each timed at T = 8 with its bound for that work;
    and the cuckoo kick-out's crowded case (93 % LIVE, 4096 fresh keys a
    table) at T = 8 against one table of it alone, in turns.  Returns
    {"tc_probe2": {...}, "tc_insert": {...}} keyed by backend."""
    from repro_torch.core import backend, buckets
    from repro_torch.core.struct_utils import map_tensors
    from repro_torch.kernels import probe, ref
    T, CH = STACK_T, cfg.chunk
    Q, QU = cfg.lookups_per_step, cfg.updates_per_step
    rng = np.random.default_rng(31)
    res = {"tc_probe2": {}, "tc_insert": {}}
    for bi, name in enumerate(TWO_ROW_STACK):
        st, keys, fresh = two_row_stack_state(device, cfg, name, 60 + bi)
        be = backend.get(name)
        rows = buckets._tc_rows if name == "twochoice" else buckets._ck_rows
        W, nb = st.old.width, st.old.nbuckets
        B = st.old.key.shape[1]
        old = (st.old.key, st.old.val, st.old.state)
        new = (st.new.key, st.new.val, st.new.state)
        rb = st.rebuilding
        log(f"  {name} stack: {T} tables of {B} x {W}, rebuilding "
            f"{rb.tolist()}, cursors {st.cursor.tolist()}, live hazard "
            f"entries {st.hazard_live.sum(-1).tolist()}, table 7 full")

        # -- tc_probe2: a quarter old keys, a quarter hazard keys (old ones
        #    where a table has none live), a quarter fresh keys (in the new
        #    tables mid-rebuild), the rest misses; table 6's first 2048
        #    queries on one row pair
        q4 = Q // 4
        kh = keys.cpu().numpy()
        fh = fresh.cpu().numpy()
        qrows = []
        for t in range(T):
            hz = st.hazard_key[t][st.hazard_live[t]].cpu().numpy()
            src = hz if hz.size else kh[t]
            qrows.append(np.concatenate([
                rng.choice(kh[t], q4), rng.choice(src, q4),
                rng.choice(fh[t], q4),
                rng.integers(-(1 << 31), -(1 << 30) - 1, Q - 3 * q4)]))
            rng.shuffle(qrows[-1])
        qk = _tt(np.stack(qrows).astype(np.int32), device)
        rao, rbo = rows(st.old, qk)
        ran, rbn = rows(st.new, qk)
        rao[6, :2048], rbo[6, :2048] = 5, rbo[6, 0]
        args = (old, new, st.hazard_key, st.hazard_val, st.hazard_live,
                rao.contiguous(), rbo.contiguous(), ran, rbn, qk, rb)
        before = probe.launch_counts()["tc_probe2"]
        out_k = probe.tc_probe2(*args)
        torch.cuda.synchronize()
        check(probe.launch_counts()["tc_probe2"] - before == 1,
              f"{name} stack tc_probe2: not one launch for {T} tables")
        out_p = probe.tc_probe2_plain(*args)
        err = max(same(x, y, f"{name} stack tc_probe2 {n}")
                  for x, y, n in zip(out_k, out_p, OUTPUTS))
        found, _, f_old, _, hz_idx, loc_new = out_k
        idle = ~rb
        check(not bool(((hz_idx >= 0) | (loc_new >= 0))[idle].any()),
              f"{name} stack tc_probe2: an idle table looked past its old "
              f"rows")
        check(all(int((hz_idx[t] >= 0).sum()) > 0
                  and int((loc_new[t] >= 0).sum()) > 0 for t in (0, 2, 4)),
              f"{name} stack tc_probe2: the rebuilding tables must hit "
              f"hazard and new")
        r_old = sum(rows_read(ref, *(x[t] for x in old), rao[t], qk[t])
                    for t in range(T))
        r_new = sum(rows_read(ref, *(x[t] for x in new), ran[t], qk[t],
                              ~f_old[t] & (hz_idx[t] < 0))
                    for t in (0, 2, 4))
        hz_lookups = int((~f_old[:5:2]).sum())
        res["tc_probe2"][name] = dict(
            T=T, max_abs_err=err,
            ms=time_ms(lambda: probe.tc_probe2(*args), reps),
            plain_ms=time_ms(lambda: probe.tc_probe2_plain(*args), 3,
                             queue_ahead=False),
            # as the single table's: in, four rows and a key a query, the
            # rows read, the live hazard buffers, a value a hit; out, six
            # outputs; operations, a set lookup a query the old rows did
            # not resolve (rebuilding tables) and two a lane read
            **bound(T * Q * 20 + (r_old + r_new) * W * 8 + 3 * CH * 9
                    + int(found.sum()) * 4 + T * Q * 18,
                    SET_LOOKUP_OPS * hz_lookups + (r_old + r_new) * W * 2))
        log(f"  {name} stack tc_probe2 ok: T={T} Q={Q} a table, idle tables "
            f"on their old rows alone; rows read old={r_old} new={r_new}; "
            + json.dumps(res["tc_probe2"][name]))

        # -- tc_insert: each table into its target by its flag (an eighth
        #    of the keys present there, duplicates, a random mask), table
        #    6's first 2048 keys on one row pair, table 7 full
        k = rng.integers(-(1 << 31), -(1 << 30) - 1, (T, QU)).astype(
            np.int32)
        for t in range(T):
            k[t, :QU // 8] = rng.choice(fh[t] if rb[t] else kh[t], QU // 8)
        k[:, QU // 4:QU // 4 + QU // 8] = k[:, QU // 2:QU // 2 + QU // 8]
        k = _tt(k, device)
        m = buckets.batch_winners(k, _tt(rng.random((T, QU)) < 0.9, device,
                                         torch.bool))
        ta, tb = rows(st.old, k)
        na, nb_ = rows(st.new, k)
        ra = torch.where(rb[:, None], na, ta)
        rb2 = torch.where(rb[:, None], nb_, tb)
        ra[6, :2048], rb2[6, :2048] = 9, rb2[6, 0]
        ins = (ra.contiguous(), rb2.contiguous(), k, k * 5 + 2, m)
        if name == "cuckoo":
            fa = backend._pick_fn(rb, st.new.hfn_a, st.old.hfn_a)
            fb = backend._pick_fn(rb, st.new.hfn_b, st.old.hfn_b)

            def kern(tab, plain=False):
                fn = probe.cuckoo_insert_plain if plain else \
                    probe.cuckoo_insert
                return fn(*tab[:3], *ins[:2], fa, fb, nb, *ins[2:],
                          st.old.max_kick, None if plain else st.old.claim,
                          alt=tuple(tab[3:]), use_alt=rb)
        else:
            def kern(tab, plain=False):
                fn = probe.tc_insert_plain if plain else probe.tc_insert
                return fn(*tab[:3], *ins, st.old.max_rounds,
                          None if plain else st.old.claim,
                          alt=tuple(tab[3:]), use_alt=rb)
        copies = [[x.clone() for x in old + new] for _ in range(2)]
        before = probe.launch_counts()["tc_insert"]
        tally0 = probe.kick_tally(device)
        ok_k, pr_k = kern(copies[0])
        torch.cuda.synchronize()
        tally = {n: v - tally0[n] for n, v in probe.kick_tally(device).items()}
        check(probe.launch_counts()["tc_insert"] - before == 1,
              f"{name} stack tc_insert: not one launch for {T} tables")
        check(bool((st.old.claim == probe.CLAIM_FREE).all()),
              f"{name} stack tc_insert: claim words left behind")
        ok_p, pr_p = kern(copies[1], plain=True)
        err = max(same(ok_k, ok_p, f"{name} stack tc_insert ok"),
                  same(pr_k, pr_p, f"{name} stack tc_insert present"),
                  *(same(x, y, f"{name} stack tc_insert table {i}")
                    for i, (x, y) in enumerate(zip(*copies))))
        for t in range(T):          # only the target table changed
            kept = copies[0][:3] if rb[t] else copies[0][3:]
            orig = old if rb[t] else new
            check(all(torch.equal(x[t], y[t]) for x, y in zip(kept, orig)),
                  f"{name} stack tc_insert: table {t} wrote its other table")
        flood = int(ok_k[6, :2048].sum())
        check(int(ok_k[7].sum()) == 0 and 0 < flood < 2048
              and int(pr_k.sum()) > 0,
              f"{name} stack tc_insert: full table placed "
              f"{int(ok_k[7].sum())}, flood placed {flood}")

        def restore():
            for x, y in zip(copies[0], old + new):
                x.copy_(y)
        nrows = pend = 0
        for t in range(T):
            tgt = new if rb[t] else old
            nrows += rows_read(ref, *(x[t] for x in tgt), ins[0][t], k[t],
                               m[t])
            pend += int((m[t] & ~pr_k[t]).sum())
        # the single table's count, table by table, and the rows the
        # kick-out's plans read (two a key it takes)
        nbytes = T * QU * 17 + nrows * W * 8 + pend * W * 4 \
            + int(ok_k.sum()) * 12 + T * QU * 2 + tally["keys"] * 2 * W * 8
        res["tc_insert"][name] = dict(
            T=T, max_abs_err=err, placed=int(ok_k.sum()),
            present=int(pr_k.sum()), flood_placed=flood, kick=tally,
            ms=time_ms(lambda: kern(copies[0]), reps, restore),
            plain_ms=time_ms(lambda: kern(copies[0], plain=True), 2,
                             restore, queue_ahead=False),
            **bound(nbytes, nrows * W * 2 + pend * W))
        log(f"  {name} stack tc_insert ok: T={T} Q={QU} a table, each into "
            f"its target by its flag; " + json.dumps(res["tc_insert"][name]))
        del st, copies

    # -- the kick-out's crowded case at T = 8: eight tables of 2 x 2^10 x 8
    #    rows, 93 % LIVE, 4096 fresh keys a table; against table 0 alone
    tabs = [cuckoo_table(device, 1 << 10, int(2 * 8 * (1 << 10) * 0.93),
                         rng, 80 + t) for t in range(T)]
    crowd = map_tensors(lambda *xs: torch.stack(xs), *tabs)
    k = torch.as_tensor(np.stack([
        rng.permutation(np.unique(rng.integers(-(1 << 31), -(1 << 30),
                                               8192))[:4096])
        for _ in range(T)]).astype(np.int32), device=device)
    ra, rb2 = buckets._ck_rows(crowd, k)
    win = torch.ones_like(k, dtype=torch.bool)
    cargs = (ra, rb2, crowd.hfn_a, crowd.hfn_b, crowd.nbuckets, k, k * 7 + 3,
             win, crowd.max_kick)
    pre = [x.clone() for x in (crowd.key, crowd.val, crowd.state)]
    a = [x.clone() for x in pre]
    b = [x.clone() for x in pre]
    tally0 = probe.kick_tally(device)
    ok_k, pr_k = probe.cuckoo_insert(*a, *cargs, crowd.claim)
    torch.cuda.synchronize()
    tally = {n: v - tally0[n] for n, v in probe.kick_tally(device).items()}
    ok_p, pr_p = probe.cuckoo_insert_plain(*b, *cargs)
    for x, y, n in zip((*a, ok_k, pr_k), (*b, ok_p, pr_p),
                       ("key", "val", "state", "ok", "present")):
        same(x, y, f"crowded stack cuckoo insert {n}")
    one = [x[0] for x in a]
    oargs = (ra[0], rb2[0], tabs[0].hfn_a, tabs[0].hfn_b, tabs[0].nbuckets,
             k[0], k[0] * 7 + 3, win[0], tabs[0].max_kick)

    def restore():
        for x, y in zip(a, pre):
            x.copy_(y)
    t = {"stack": [], "one": []}
    for who in ("one", "stack", "stack", "one"):
        t[who].append(time_ms(
            (lambda: probe.cuckoo_insert(*a, *cargs, crowd.claim))
            if who == "stack" else
            (lambda: probe.cuckoo_insert(*one, *oargs, tabs[0].claim)),
            reps, restore))
    res["tc_insert"]["crowded"] = dict(
        T=T, placed=int(ok_k.sum()), kick=tally, ms_T8=t["stack"],
        ms_one_table=t["one"])
    log(f"  crowded cuckoo insert at T={T} ok (equal to the plain version): "
        + json.dumps(res["tc_insert"]["crowded"]))
    return res


def stack_batches(oracle, cfg, step: int, masks=None):
    """One step's [T, Q] batches from the stack's oracle: the index tensors
    (look, ins, vals, dele) on the device, and the step's arguments as the
    host sends them (numpy: the keys, the insert mask ``~present`` and-ed
    with ``masks[0]``, the delete mask ``masks[1]``, else all set)."""
    look, ins, vals, dele = oracle.batch(cfg.lookups_per_step,
                                         cfg.updates_per_step, step)
    im = ~oracle.present.gather(1, ins)
    dm = torch.ones_like(im)
    if masks is not None:
        im &= masks[0]
        dm = masks[1]
    dev = (look, ins, vals, dele, im, dm)
    args = tuple(x.cpu().numpy() for x in (
        oracle.key(look), oracle.key(ins), vals, oracle.key(dele), im, dm))
    return dev, args


def stack_check(oracle, dev, out, step: int) -> None:
    """Every table's answers against the oracle (on the device)."""
    look, ins, vals, dele, im, dm = dev
    oracle.step(look, ins, vals, im, dele, dm, out, step)


def twin_step(s, args, t: int):
    """One step of table ``t``'s twin: the port's single-table device-flag
    ops on its batches, as the stack engine's step runs them (lookup,
    insert, the ordered delete, the transition, the swap)."""
    from repro_torch.core import dhash
    from repro_torch.core.struct_utils import assign_
    lk, ik, iv, dk, im, dm = (torch.as_tensor(a[t]).to(s.device)
                              for a in args)
    f, v = dhash.lookup_by_flag(s, lk)
    _, ok_i = dhash.insert_by_flag(s, ik, iv, im)
    s2, ok_d = dhash.delete(s, dk, dm, rebuilding=True)
    assign_(s, s2)
    dhash.finish_same_shape_(s, go=dhash.rebuild_step_(s, swap=True))
    return f, v, ok_i, ok_d


def phase_stack(device, cfg, max_steps: int = 1500, twin=(900, 1200),
                timed: int = 100, later_at: int = 300) -> dict:
    """3h: a linear stack on the card.  ``DHashStackEngine``, fused, T = 8
    tables of the ``dhash-paper`` shard unreduced (capacity 2^20, 2^21
    slots, chunk 4096), populated to 2^20 keys a table; a step is each
    table's main-path traffic (65536 lookups, half hits, 8192 inserts, 8192
    deletes).  Staggered epochs: rebuilds requested on tables 0, 2, 4, 6 at
    step 0 and on 1, 3 at step ``later_at``; 5 and 7 stay steady.  Every answer
    against a dense oracle a table, every step; over ``twin`` the tables'
    copies stepped by the single-table device-flag ops (answers equal every
    step, every state tensor equal at the end); the launches a replayed
    step credits against the profiler's kernels; then the replayed stacked
    step timed against eight single-table ``DHashEngine``s stepped in turn,
    steady and mid-rebuild.  The launch counts are set to 0 just before the
    engine's steps and read just after (the twins' taken back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dhash
    from repro_torch.core.engine import DHashEngine, DHashStackEngine
    from repro_torch.kernels import probe
    T = STACK_T
    st, oracle = stack_state(device, cfg, 30)
    eng = DHashStackEngine(st)
    del st
    first = np.array([t % 2 == 0 for t in range(T)])
    later = np.isin(np.arange(T), (1, 3))
    started = first | later
    probe.reset_launches()
    twins, spread, times = None, False, []
    for s in range(max_steps):
        if s == 0:
            eng.request_rebuild(first)
        elif s == later_at:
            eng.request_rebuild(later)
        dev, args = stack_batches(oracle, cfg, s)
        if s == twin[0]:
            twins = dhash.unstack(eng.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step(*args[:4], ins_mask=args[4], del_mask=args[5])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        stack_check(oracle, dev, out, s)
        if twins is not None and s < twin[1]:
            before = probe.launch_counts()
            for t in range(T):
                for a, b, n in zip(out, twin_step(twins[t], args, t),
                                   ("found", "vals", "ok_i", "ok_d")):
                    check(torch.equal(a[t], b), f"stack step {s}: table "
                          f"{t}'s {n} differs from its twin's")
            after = probe.launch_counts()
            probe.add_launches({k: after[k] - before[k] for k in after}, -1)
        if twins is not None and s == twin[1] - 1:
            for t in range(T):
                pairs = list(zip(_leaves(dhash._table(eng.state, t)),
                                 _leaves(twins[t])))
                for (p, a), (_, b) in pairs:
                    check(torch.equal(a, b), f"stack: table {t}'s state{p} "
                          f"differs from its twin's after step {s}")
            twin_leaves = len(pairs)
            twins = None
        if s % eng.poll_every == eng.poll_every - 1:
            oracle.verify("stack")                  # the harness's reads
            ep = eng.state.epoch.cpu().numpy()
            spread |= len(set(ep[started].tolist())) > 1
        if eng._stats.rebuilds_completed >= int(started.sum()) \
                and s >= twin[1]:
            break
    n_steps = s + 1
    launches = probe.launch_counts()
    epochs = eng.state.epoch.tolist()
    check(epochs == started.astype(int).tolist(),
          f"stack: epochs {epochs}, want {started.astype(int).tolist()}")
    check(spread, "stack: the started tables' epochs never spread mid-run")
    no_slot = int(oracle.no_slot)
    check(no_slot <= 64, f"stack: {no_slot} inserts found no slot")
    polls = n_steps // eng.poll_every
    check(eng._stats.host_syncs == polls,
          f"stack: {eng._stats.host_syncs} host reads in {polls} polls")
    check(len(eng._step_keys) == 1 and eng._step_cache_size() == 1,
          f"stack: {len(eng._step_keys)} keys captured")
    # a step's launches, and the two requests' exchanges (each one launch
    # for the whole stack)
    want = {k: STACK_KERNELS.get(k, 0) * n_steps + 2 * (k == "epoch_swap")
            for k in launches}
    check(launches == want, f"stack: launches {launches} in {n_steps} "
          f"steps, want {want}: {STACK_KERNELS} a step and the requests")
    ts = sorted(times[1:])
    log(f"  {n_steps} steps of {T} tables; epochs {epochs} (spread across "
        f"the started tables mid-run), every answer equal to the oracles', "
        f"{eng._stats.host_syncs} host reads in {polls} polls, one key; "
        f"twins over steps {twin[0]}-{twin[1] - 1}: answers equal every "
        f"step, all {twin_leaves} state tensors of each table equal; "
        f"launches {launches} ({STACK_KERNELS} a step, whatever T); step "
        f"ms with the harness's synchronise: median "
        f"{statistics.median(ts):.3f} p99 {ts[int(0.99 * (len(ts) - 1))]:.3f}")

    # the replayed step's credited launches against the profiler's kernels
    oracle.verify("stack")
    host_reads = eng._stats.host_syncs
    extra = [stack_batches(oracle, cfg, 10_000 + i)[1] for i in range(10)]

    def ten():
        for a in extra:
            eng.step(*a[:4], ins_mask=a[4], del_mask=a[5])
    credited, seen = credited_against_profiler(ten, 10, "stack")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ten()
        torch.cuda.synchronize()
    busy_steady = sum(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3 / 10

    # the stacked step against eight single-table engines stepped in turn,
    # on the same batches: steady, then mid-rebuild
    singles = [DHashEngine(s) for s in dhash.unstack(eng.state)]
    out = dict(steps=n_steps, epochs=epochs, host_reads=host_reads,
               polls=polls, launches_a_step=STACK_KERNELS,
               profiler_replays_seen=seen, twin_steps=list(twin),
               step_ms=statistics.median(ts),
               step_p99_ms=ts[int(0.99 * (len(ts) - 1))])
    for label in ("steady", "rebuild"):
        if label == "rebuild":
            eng.request_rebuild()
            for e1 in singles:
                e1.request_rebuild()
        t_stack, t_single = [], []
        for i in range(timed + 2):
            a = stack_batches(oracle, cfg, 20_000 + i)[1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step(*a[:4], ins_mask=a[4], del_mask=a[5])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t, e1 in enumerate(singles):
                e1.step(a[0][t], a[1][t], a[2][t], a[3][t], ins_mask=a[4][t],
                        del_mask=a[5][t])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:          # the first steps of a key capture
                t_stack.append((t1 - t0) * 1e3)
                t_single.append((t2 - t1) * 1e3)
        a, b = sorted(t_stack), sorted(t_single)
        p99 = int(0.99 * (len(a) - 1))
        out[label] = dict(stack_ms=statistics.median(a), stack_p99_ms=a[p99],
                          singles_ms=statistics.median(b),
                          singles_p99_ms=b[p99],
                          ratio=statistics.median(a) / statistics.median(b))
        if label == "rebuild":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ten()
                torch.cuda.synchronize()
            out[label]["stack_busy_ms"] = sum(
                getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / 1e3 / 10
        else:
            out[label]["stack_busy_ms"] = busy_steady
        out[label]["single_step_launches"] = {
            k: v for k, v in singles[0]._steps[
                singles[0]._step_keys[-1]].credit.items() if v}
        log(f"  {label}: replayed stacked step against 8 single-table "
            f"engines in turn, ms: " + json.dumps(out[label]))
    check(all(eng.state.rebuilding.tolist()),
          "stack: the timed rebuild did not start on every table")
    out["launches"] = launches
    del singles
    return out


def phase_stack_policy(device, cfg, tomb_load: float = 0.1,
                       max_steps: int = 1600) -> dict:
    """3i: the policy's stack arm on the card.  The same 8-table stack
    under ``policy.make(in_place=True, tomb_load=0.1)``: deletes drain
    tables 1 (8192 a step, 30 steps) and 5 (4096 a step, 60 steps) only,
    the others take lookups alone; each crosses 0.1 x 2^21 tombstones and
    fires its rehash on the device at its own step, between polls.  Every
    answer against the oracles every step, until both rehashes finish."""
    from repro_torch.core import policy as elastic
    from repro_torch.core.engine import DHashStackEngine
    from repro_torch.kernels import probe
    T, QU = STACK_T, cfg.updates_per_step
    st, oracle = stack_state(device, cfg, 40)
    eng = DHashStackEngine(st, policy=elastic.make(
        in_place=True, tomb_load=tomb_load, device=device))
    del st
    slots = eng.state.old.capacity
    limit = int(slots * tomb_load)
    rates = {1: (QU, 30), 5: (QU // 2, 60)}
    hot = np.isin(np.arange(T), list(rates))
    probe.reset_launches()
    tombs = np.zeros(T, np.int64)
    fire_at = {}
    for s in range(max_steps):
        im = torch.zeros((T, QU), dtype=torch.bool, device=device)
        dm = torch.zeros((T, QU), dtype=torch.bool, device=device)
        for t, (rate, until) in rates.items():
            if s < until:
                dm[t, :rate] = True
        dev, args = stack_batches(oracle, cfg, s, (im, dm))
        out = eng.step(*args[:4], ins_mask=args[4], del_mask=args[5])
        stack_check(oracle, dev, out, s)
        if s % eng.poll_every == eng.poll_every - 1:
            oracle.verify("stack policy")
        ok_d = out[3].cpu().numpy()
        for t in rates:
            if t not in fire_at:
                tombs[t] += int(ok_d[t].sum())
                if tombs[t] > limit:
                    fire_at[t] = s
        if len(fire_at) == 2 and s > max(fire_at.values()) + 8 \
                and s % eng.poll_every == eng.poll_every - 1 \
                and eng._stats.rebuilds_completed == 2:
            break
    n_steps = s + 1
    launches = probe.launch_counts()
    oracle.verify("stack policy")
    fires = eng.policy.fires.tolist()
    epochs = eng.state.epoch.tolist()
    want = hot.astype(int).tolist()
    check(fires == want and epochs == want,
          f"stack policy: fires {fires}, epochs {epochs}, want {want}")
    check(not any(eng.state.rebuilding.tolist()),
          "stack policy: a rehash did not finish")
    polls = n_steps // eng.poll_every
    check(eng._stats.host_syncs == polls,
          f"stack policy: {eng._stats.host_syncs} host reads in {polls} "
          f"polls")
    between = {t: s % eng.poll_every != eng.poll_every - 1
               for t, s in fire_at.items()}
    check(int(oracle.no_slot) <= 64, "stack policy: inserts found no slot")
    check(all(between.values()) and fire_at[1] != fire_at[5],
          f"stack policy: fires at steps {fire_at}")
    check(all(launches[k] > 0 for k in STACK_KERNELS)
          and all(v == 0 for k, v in launches.items()
                  if k not in STACK_KERNELS),
          f"stack policy: launches {launches}")
    out = dict(steps=n_steps, tomb_load=tomb_load, tomb_limit=limit,
               fire_steps=fire_at, fires=fires, epochs=epochs,
               host_reads=eng._stats.host_syncs, polls=polls,
               launches=launches)
    log(f"  tomb_load {tomb_load} ({limit} tombstones of {slots} slots): "
        f"table 1 fired at step {fire_at[1]}, table 5 at step {fire_at[5]} "
        f"(on the device, between polls); fires {fires}, epochs {epochs} "
        f"after {n_steps} steps, every answer equal to the oracles', "
        f"{eng._stats.host_syncs} host reads in {polls} polls; launches "
        f"{launches}")
    return out


# ---------------------------------------------------------------------------
# 3j and 3k: the router on one card
# ---------------------------------------------------------------------------

ROUTED_S = 4            # 3j: the shards of a four-GPU node, in one process
# one routed service step's launches (then the harness's epoch swap, which
# decides on its own: two epoch_swap kernels): the lookup's and the
# delete's probe2, the insert's and the landing's probe_insert, the
# transition's extract, whatever S
ROUTED_STEP = {"probe2": 2, "probe_insert": 2, "extract": 1, "epoch_swap": 2}
GRID_S, GRID_T = 2, 8   # 3k: 2 shards x 8 tenants
GRID_LOOKUP = {"linear": "probe2", "cuckoo": "tc_probe2"}
GRID_SLACK = 0.375      # the compact slab of the T = 8 arm of the
                        # reference's routed-stack benchmark


class Graphed:
    """``fn()`` captured in one CUDA graph: its first call runs eagerly (a
    real step, its outputs in ``first``), the capture runs nothing, and
    each ``replay`` credits the launch counters with the launches the
    capture recorded (the capture's own counts taken back)."""

    def __init__(self, fn):
        from repro_torch.kernels import probe
        self.first = fn()
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        before = probe.launch_counts()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = probe.launch_counts()
        self.credit = {k: after[k] - before[k] for k in after}
        probe.add_launches(self.credit, -1)

    def replay(self):
        from repro_torch.kernels import probe
        self.graph.replay()
        probe.add_launches(self.credit)
        return self.out


def zipf_owners(rng, q: int, n: int, a: float = 1.2) -> np.ndarray:
    """Zipf-skewed owner ids in [0, n): rank r carries mass ~ 1/r^a, the
    ranks shuffled so the hot owner is not always id 0 (the reference
    suite's skew source, ``benchmarks/common.py``)."""
    ranks = np.minimum(rng.zipf(a, size=q) - 1, n - 1).astype(np.int64)
    perm = rng.permutation(n)
    return perm[ranks].astype(np.int32)


def host_route(owner: np.ndarray, n: int, cap: int, spill_cap: int):
    """The capped layout's accounting on the host, one source row at a
    time, by a stable sort (not the router's counting pass): each key's
    rank within its owner, the keys past the cap, their global spill rank.
    Returns (overflow [S, n], dropped [S, n], served [S, Q])."""
    over, drop, served = [], [], []
    for o in owner:
        order = np.argsort(o, kind="stable")
        so = o[order]
        rank = np.empty(o.size, np.int64)
        rank[order] = np.arange(o.size) - np.searchsorted(so, so)
        spilled = rank >= cap
        sv = ~spilled | (np.cumsum(spilled) - 1 < spill_cap)
        over.append(np.maximum(np.bincount(o, minlength=n) - cap, 0))
        drop.append(np.bincount(o[~sv], minlength=n))
        served.append(sv)
    return np.stack(over), np.stack(drop), np.stack(served)


def device_served(owner: torch.Tensor, cap: int | None) -> torch.Tensor:
    """Which keys a capped route without a slab serves, on the device, by
    a stable sort (not the router's counting pass): rank within the owner
    below ``cap``."""
    q = owner.shape[-1]
    if cap is None or cap >= q:
        return torch.ones(owner.shape, dtype=torch.bool, device=owner.device)
    so, order = torch.sort(owner, dim=-1, stable=True)
    rank_sorted = torch.arange(q, device=owner.device) - torch.searchsorted(
        so, so)
    return torch.empty_like(order).scatter_(-1, order, rank_sorted) < cap


class RouteOracle:
    """The dense oracle of a routed deployment, on the device: ``present``
    and ``value`` [R, U] over a key universe ``[-U/2, U/2)`` for each of R
    key spaces (1 for 3j; a tenant each for 3k), a spare last column
    masked-off writes land in.  The first served occurrence of a key in a
    batch wins, in (source shard, position) order, as the routed buffers
    deliver them.  Checks accumulate on the device (``first_bad``);
    ``verify`` reads them."""

    def __init__(self, rows: int, universe: int, seed: int, device):
        self.rows, self.u, self.dev = rows, universe, device
        self.present = torch.zeros((rows, universe + 1), dtype=torch.bool,
                                   device=device)
        self.value = torch.zeros((rows, universe + 1), dtype=torch.int32,
                                 device=device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.first_bad = torch.full((), -1, dtype=torch.int64, device=device)
        self._pos = torch.full((rows * (universe + 1),), 1 << 30,
                               dtype=torch.int32, device=device)
        self.refused = torch.zeros((), dtype=torch.int64, device=device)

    def key(self, idx: torch.Tensor) -> torch.Tensor:
        return (idx - self.u // 2).to(torch.int32)

    def _lin(self, r, idx):
        return r * (self.u + 1) + idx

    def sample(self, r: torch.Tensor, want_present: bool) -> torch.Tensor:
        """Key indices shaped as ``r`` (the key space of each) that are
        (not) present, the first of 32 candidates that qualifies: at a
        quarter of the universe present, all 32 fail with odds 1e-4
        (present) and below 1e-19 (absent).  A failed present sample is
        the spare index ``U`` (key U/2, outside the universe, never
        inserted: a lookup that misses, a delete that finds nothing, never
        a key the step inserts); an insert must not re-insert a live key
        during a rebuild (the ordered check allows it), and deletes must
        keep up with the inserts, or the tables fill."""
        cand = torch.randint(0, self.u, (*r.shape, 32), generator=self.gen,
                             device=self.dev)
        ok = self.present.view(-1)[self._lin(r[..., None], cand)] \
            == want_present
        idx = cand.gather(-1, ok.to(torch.uint8).argmax(-1, keepdim=True)
                          )[..., 0]
        return torch.where(ok.any(-1), idx, self.u) if want_present else idx

    def _first(self, lin, mask):
        flat, m = lin.reshape(-1), mask.reshape(-1)
        pos = torch.arange(flat.numel(), dtype=torch.int32, device=self.dev)
        col = torch.where(m, flat, self.u)
        self._pos.scatter_reduce_(0, col, pos, "amin")
        first = m & (self._pos[col] == pos)
        self._pos.scatter_(0, col, 1 << 30)
        return first.view(mask.shape)

    def lookup(self, r, idx, served):
        lin = self._lin(r, idx)
        f = served & self.present.view(-1)[lin]
        return f, torch.where(f, self.value.view(-1)[lin], 0)

    def insert(self, r, idx, vals, served, got=None):
        """The inserts the oracle acknowledges (the first served
        occurrence of each absent key), applied; with ``got`` (the port's
        acknowledgements) only those it made are applied, and the
        refusals (inserts that found no slot: not acknowledged, so not
        lost) are counted.  Returns (want, bad): ``bad`` where the port
        acknowledged an insert the oracle would not."""
        lin = self._lin(r, idx)
        want = self._first(lin, served) & ~self.present.view(-1)[lin]
        ok, bad = want, torch.zeros((), dtype=torch.bool, device=self.dev)
        if got is not None:
            ok, bad = want & got, (got & ~want).any()
            self.refused += (want & ~got).sum()
        col = torch.where(ok, lin, self.u)
        self.present.view(-1).scatter_(0, col.view(-1), True)
        self.value.view(-1).scatter_(0, col.view(-1), vals.reshape(-1))
        self.present[0, self.u] = False
        return want, bad

    def delete(self, r, idx, served) -> torch.Tensor:
        lin = self._lin(r, idx)
        ok = self._first(lin, served) & self.present.view(-1)[lin]
        self.present.view(-1).scatter_(
            0, torch.where(ok, lin, self.u).view(-1), False)
        return ok

    def fail(self, bad: torch.Tensor, step: int) -> None:
        self.first_bad.copy_(torch.where(bad & (self.first_bad < 0), step,
                                         self.first_bad))

    def verify(self, where: str) -> None:
        s = int(self.first_bad)
        check(s == -1, f"{where}: step {s}'s answers differ from the oracle's")

    def owned(self, owner_of) -> np.ndarray:
        """Live keys by the owner ``owner_of(r, keys)`` gives them."""
        r, idx = self.present[:, :self.u].nonzero(as_tuple=True)
        return owner_of(r, self.key(idx))


def routed_batch(orc, shape_l, shape_u, step: int):
    """One step's batches for 3j: lookups half present, fresh inserts with
    duplicates (1/64 of them), present deletes; index tensors."""
    r_l = torch.zeros(shape_l, dtype=torch.int64, device=orc.dev)
    r_u = torch.zeros(shape_u, dtype=torch.int64, device=orc.dev)
    h = shape_l[-1] // 2
    look = torch.cat([orc.sample(r_l[:, :h], True),
                      orc.sample(r_l[:, h:], False)], 1)
    perm = torch.rand(shape_l, generator=orc.gen, device=orc.dev).argsort(1)
    look = look.gather(1, perm)
    ins = orc.sample(r_u, False)
    d = shape_u[-1] // 64
    ins[:, :d] = ins[:, d:2 * d]
    dele = orc.sample(r_u, True)
    return look, ins, (ins * 3 + step).to(torch.int32), dele


def phase_routed(device, cfg, twin: tuple = (1000, 1048),
                 starts=(0, 100, 200, 300), capped_steps: int = 100,
                 tight_steps: int = 20, max_steps: int = 1500) -> dict:
    """3j: the routed service step of ``dhash-paper`` on one card, S = 4
    shards in one process (``distributed.InProcess``): each shard the
    unreduced shard (linear, capacity 2^20, 2^21 slots, chunk 4096),
    populated to 2^20 keys through routed inserts; each source shard's
    65536 lookups (half hits), 8192 inserts and 8192 deletes a step, keys
    uniform over 4x the deployment's capacity, owners by ``shard_of`` under
    the fixed owner hash ``fresh("tabulation", 7)``.  The step
    (``routed_service_step`` and the epoch swap) is replayed from one CUDA
    graph; rebuilds start on shard s at step ``starts[s]`` and the run goes
    on until every shard has swapped.  Every step against a dense oracle on
    the device (answers, stats, and every later lookup sees the inserts and
    deletes it acknowledged); over ``twin`` a copy of the state stepped
    eagerly must give the same outputs every step and every state tensor
    at the end; the tables' counts at quiescence.  Then ``capped_steps`` at
    cap_factor 2.0 (their own graph, two shards rebuilding again) and
    ``tight_steps`` eager ones at cap_factor 1.0, where the capped route
    drops keys: the oracle serves exactly the keys a sort-based rank puts
    below the cap.  The replayed step's launches held to the profiler; the
    step's times, its device busy time and the router's own device time by
    op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dhash, hashing
    from repro_torch.core import distributed as tdd
    from repro_torch.core.struct_utils import map_tensors
    from repro_torch.kernels import probe
    t0 = time.perf_counter()
    S, cap = ROUTED_S, cfg.capacity_per_shard
    Q, QU = cfg.lookups_per_step, cfg.updates_per_step
    axis = tdd.InProcess(S)
    owner_fn = hashing.fresh("tabulation", 7, device)
    probe.reset_launches()
    st = tdd.make_stacked(S, "linear", cap, chunk=cfg.chunk, fused=True,
                          seed=40, device=device)
    orc = RouteOracle(1, 4 * S * cap, 41, device)
    # populate: S x 2^20 distinct keys, 2^16 a source shard a call
    n = min(1 << 16, cap)
    perm = torch.randperm(orc.u, generator=orc.gen, device=device)
    perm = perm[:S * cap].view(-1, S, n)
    ones = torch.ones((S, n), dtype=torch.bool, device=device)
    zero = torch.zeros((S, n), dtype=torch.int64, device=device)
    for i, idx in enumerate(perm):
        k = orc.key(idx)
        _, ok = tdd.routed_update(st, k, k * 3 - 1, ones, axis, owner_fn)
        orc.fail((ok != orc.insert(zero, idx, k * 3 - 1, ones)[0]).any(),
                 -1 - i)
    populate_calls = perm.shape[0]
    orc.verify("routed populate")
    t_pop = time.perf_counter() - t0
    check(bool((st.old.state == 1).sum() == S * cap),
          "routed populate: not every key placed")
    zl = torch.zeros((S, Q), dtype=torch.int64, device=device)
    zu = torch.zeros((S, QU), dtype=torch.int64, device=device)
    lk = torch.empty((S, Q), dtype=torch.int32, device=device)
    ik, iv, dk = (torch.empty((S, QU), dtype=torch.int32, device=device)
                  for _ in range(3))

    def step_fn(cf, d=st):
        _, out = tdd.routed_service_step(d, lk, ik, iv, dk, axis, owner_fn,
                                         cap_factor=cf)
        dhash.stack_finish_same_shape_(d)
        return out

    def load(s, cf=0.0):
        look, ins, vals, dele = routed_batch(orc, (S, Q), (S, QU), s)
        for x, y in ((lk, orc.key(look)), (ik, orc.key(ins)), (iv, vals),
                     (dk, orc.key(dele))):
            x.copy_(y)
        caps = [tdd.route_cap(cf, n, S) if cf > 0 else None for n in (Q, QU)]
        served = [device_served(tdd.shard_of(x, S, owner_fn), c)
                  for x, c in ((lk, caps[0]), (ik, caps[1]), (dk, caps[1]))]
        return look, ins, vals, dele, served

    def check_step(batch, out, s):
        """The step's outputs against the oracle.  The step reports its
        inserts only as a count, so the harness looks the insert keys up
        after the step (a routed lookup outside the main path's counts): a
        key found that was absent before it is one the step placed; the
        count of those must be the step's count, and a refusal (no slot in
        the window) is counted, not lost."""
        look, ins, vals, dele, (sl, si, sd) = batch
        f, v, stats = out
        ef, ev = orc.lookup(zl, look, sl)
        bad = (f != ef).any() | (v != ev).any()
        before = probe.launch_counts()
        placed, _ = tdd.routed_lookup(st, orc.key(ins), axis, owner_fn)
        after = probe.launch_counts()
        probe.add_launches({k: after[k] - before[k] for k in after}, -1)
        want_i, _ = orc.insert(zu, ins, vals, si, got=placed)
        got_i = placed & want_i
        ed = orc.delete(zu, dele, sd)
        want = torch.stack([ef.sum(1), got_i.sum(1), ed.sum(1)], 1)
        orc.fail(bad | (stats != want).any(), s)

    def start(s):
        m = torch.zeros(S, dtype=torch.bool, device=device)
        m[starts.index(s)] = True
        dhash.stack_autostart(st, m)

    start(0)
    batch = load(0)
    graph = Graphed(lambda: step_fn(0.0))
    check_step(batch, graph.first, 0)
    check(graph.credit == {k: ROUTED_STEP.get(k, 0) for k in graph.credit},
          f"routed: a captured step launches {graph.credit}, want "
          f"{ROUTED_STEP}")
    replay_ev, eager_ev, copy = [], [], None
    for s in range(1, max_steps):
        if s in starts:
            start(s)
        batch = load(s)
        if s == twin[0]:
            copy = map_tensors(torch.clone, st)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        out = graph.replay()
        b.record()
        replay_ev.append((a, b))
        if copy is not None:
            before = probe.launch_counts()
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            got = step_fn(0.0, copy)
            b.record()
            eager_ev.append((a, b))
            after = probe.launch_counts()
            probe.add_launches({k: after[k] - before[k] for k in after}, -1)
            for x, y, n in zip(out, got, ("found", "vals", "stats")):
                check(torch.equal(x, y), f"routed step {s}: the replayed "
                      f"step's {n} differs from the eager step's")
            if s == twin[1] - 1:
                for (p, x), (_, y) in zip(_leaves(st), _leaves(copy)):
                    check(torch.equal(x, y), f"routed: state{p} of the "
                          f"replayed step differs from the eager one's")
                twin_leaves = len(list(_leaves(st)))
                copy = None
        check_step(batch, out, s)
        if s % 100 == 99:
            orc.verify("routed")
            if s >= twin[1] and all(e >= 1 for e in st.epoch.tolist()):
                break
    n_steps = s + 1
    orc.verify("routed")
    epochs = st.epoch.tolist()
    check(epochs == [1] * S and not any(st.rebuilding.tolist()),
          f"routed: epochs {epochs} after {n_steps} steps")
    live = np.bincount(orc.owned(lambda r, k: tdd.shard_of(
        k, S, owner_fn)).cpu().numpy(), minlength=S)
    counts = dhash.stack_count_items(st).tolist()
    check(counts == live.tolist(), f"routed: the shards hold {counts}, the "
          f"oracle {live.tolist()}")
    torch.cuda.synchronize()
    rt = sorted(a.elapsed_time(b) for a, b in replay_ev)
    et = sorted(a.elapsed_time(b) for a, b in eager_ev)

    def p99(x):
        return x[int(0.99 * (len(x) - 1))]
    refused = int(orc.refused)
    check(refused <= 64, f"routed: {refused} inserts found no slot")
    out = dict(shards=S, steps=n_steps, epochs=epochs, shard_keys=counts,
               refused=refused, populate_s=t_pop,
               main_loop_s=time.perf_counter() - t0 - t_pop,
               twin_steps=list(twin), twin_leaves=twin_leaves,
               replay_ms=statistics.median(rt), replay_p99_ms=p99(rt),
               eager_ms=statistics.median(et), eager_p99_ms=p99(et))
    log(f"  {n_steps} replayed steps of {S} shards, epochs {epochs}, every "
        f"answer and stats row equal to the oracle's; eager twin over steps "
        f"{twin[0]}-{twin[1] - 1}: outputs equal every step, all "
        f"{twin_leaves} state tensors equal; shard keys {counts} equal to "
        f"the oracle's")

    # the capped stretch: its own graph, shards 0 and 2 rebuilding again
    dhash.stack_autostart(st, torch.tensor([True, False, True, False],
                                           device=device))
    batch = load(n_steps, 2.0)
    capped = Graphed(lambda: step_fn(2.0))
    check_step(batch, capped.first, n_steps)
    for i in range(1, capped_steps):
        batch = load(n_steps + i, 2.0)
        check_step(batch, capped.replay(), n_steps + i)
    orc.verify("routed capped 2.0")
    dropped = 0
    for i in range(tight_steps):        # cap 1.0: keys past the cap drop
        batch = load(n_steps + capped_steps + i, 1.0)
        check_step(batch, step_fn(1.0), n_steps + capped_steps + i)
        dropped += sum(int((~x).sum()) for x in batch[4])
    orc.verify("routed capped 1.0")
    check(dropped > 0, "routed: the tight cap dropped nothing")
    out.update(capped_steps=capped_steps, tight_steps=tight_steps,
               tight_dropped=dropped)
    log(f"  cap_factor 2.0: {capped_steps} steps replayed (shards 0 and 2 "
        f"rebuilding), cap_factor 1.0: {tight_steps} eager steps, "
        f"{dropped} keys past the cap, answers and stats equal to the "
        f"oracle's (served exactly where a sort-based rank is below the cap)")
    launches = probe.launch_counts()

    # the replayed step's launches against the profiler, its busy time:
    # replays alone (the oracle's own lookups would be seen too; it checks
    # nothing after this)
    extra = [load(10_000 + i)[:4] for i in range(10)]

    def ten():
        for bt in extra:
            for x, y in ((lk, orc.key(bt[0])), (ik, orc.key(bt[1])),
                         (iv, bt[2]), (dk, orc.key(bt[3]))):
                x.copy_(y)
            graph.replay()
    credited, seen = credited_against_profiler(ten, 10, "routed")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ten()
        torch.cuda.synchronize()
    out["busy_ms"] = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA) / 1e3 / 10
    out["profiler_replays_seen"] = seen

    # the router's own device time, by op, at the step's shapes
    def router_ms(cf):
        own = [tdd.shard_of(x, S, owner_fn) for x in (lk, ik)]
        caps = [tdd.route_cap(cf, n, S) if cf > 0 else None for n in (Q, QU)]
        rl = tdd._route(lk, own[0], S, caps[0])
        ru = tdd._route(ik, own[1], S, caps[1])
        t = {"shard_of": [time_ms(lambda: tdd.shard_of(lk, S, owner_fn),
                                  20),
                          time_ms(lambda: tdd.shard_of(ik, S, owner_fn),
                                  20)],
             "_route": [time_ms(lambda: tdd._route(lk, own[0], S, caps[0]),
                                20),
                        time_ms(lambda: tdd._route(ik, own[1], S, caps[1]),
                                20)],
             "_route_payload": [None, time_ms(
                 lambda: tdd._route_payload(iv, ru), 20)],
             "_unroute": [time_ms(lambda: tdd._unroute(rl.send, rl), 20),
                          time_ms(lambda: tdd._unroute(ru.send, ru), 20)]}
        # a step: three routes (one at Q, two at QU), four payloads (QU),
        # two unroutes at Q and two at QU
        t["step"] = (t["shard_of"][0] + 2 * t["shard_of"][1]
                     + t["_route"][0] + 2 * t["_route"][1]
                     + 4 * t["_route_payload"][1]
                     + 2 * t["_unroute"][0] + 2 * t["_unroute"][1])
        return t
    out["router_ms"] = {"cap_factor 0.0": router_ms(0.0),
                        "cap_factor 2.0": router_ms(2.0)}
    log(f"  router device ms by op ([Q={Q}, QU={QU}] a source row, S={S}): "
        + json.dumps(out["router_ms"]))
    check(launches == {k: ROUTED_STEP.get(k, 0) * (n_steps + capped_steps
                                                   + tight_steps)
                       + (len(starts) + 1) * (k == "epoch_swap")
                       + populate_calls * (k == "probe_insert")
                       for k in launches},
          f"routed: launches {launches} in {n_steps + capped_steps + tight_steps} "
          f"steps, {ROUTED_STEP} a step, {len(starts) + 1} starts and "
          f"{populate_calls} populating inserts")
    out["launches_a_step"] = ROUTED_STEP
    out["launches"] = launches
    del st, copy, graph, capped
    return out


def phase_grid(device, cfg, later: int = 40, max_steps: int = 300) -> dict:
    """3k: the S x T grid on one card, S = 2 shards x T = 8 tenants in one
    process (one stack of 16 tables, shard-major), a linear stack of 2^18
    slots a table, then a cuckoo stack of 2 x 2^14 x 8; each tenant
    populated to 2^17 keys; a step is each source shard's flat batch of
    65536 lookups (half hits), 8192 inserts and 8192 deletes, tenants
    zipf(1.2), routed at cap_factor 2.0, the arm turning each step: the
    overflow-proof slab, the compact slab (``spill_slack`` 0.375), a
    100%-one-tenant batch through the overflow-proof slab and through the
    compact one.  Rebuilds start on the even tables at step 0 and on the
    odd ones at ``later``; every table completes a live swap.  Every step:
    answers and ok against a dense oracle a tenant (served exactly where a
    host-side stable sort puts a key), ``overflow`` and ``dropped`` equal
    to a host histogram, the served lookups equal to a full-width routed
    lookup's (arms with a cap in force), and ONE launch of the lookup
    kernel a routed stack lookup (``probe2`` / ``tc_probe2``) whatever
    S·T, held to the profiler once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dhash, hashing
    from repro_torch.core import distributed as tdd
    from repro_torch.kernels import probe
    S, T = GRID_S, GRID_T
    Q, QU = cfg.lookups_per_step, cfg.updates_per_step
    axis = tdd.InProcess(S)
    owner_fn = hashing.fresh("tabulation", 7, device)
    rng = np.random.default_rng(77)
    probe.reset_launches()
    out = {}
    for bi, name in enumerate(("linear", "cuckoo")):
        kern = GRID_LOOKUP[name]
        g = dhash.make_stack(S * T, name, 1 << 17, chunk=cfg.chunk,
                             fused=True, seed=90 + bi, device=device)
        orc = RouteOracle(T, 8 * (1 << 17), 91 + bi, device)
        # populate: 2^17 keys a tenant, full width
        for t in range(T):
            idx = torch.randperm(orc.u, generator=orc.gen,
                                 device=device)[:1 << 17].view(-1, S, 1 << 15)
            for x in idx:
                r = torch.full_like(x, t)
                k = orc.key(x)
                ones = torch.ones_like(k, dtype=torch.bool)
                _, ok, _ = tdd.routed_stack_update(
                    g, k, k * 3 - 1, ones, r.to(torch.int32), axis, owner_fn,
                    cap_factor=0.0)
                orc.fail((ok != orc.insert(r, x, k * 3 - 1, ones)[0]).any(),
                         -1)
        orc.verify(f"grid {name} populate")
        dhash.stack_autostart(g, torch.arange(S * T, device=device) % 2 == 0)
        arms = ("zipf, overflow-proof slab", "zipf, compact slab",
                "one tenant, overflow-proof slab",
                "one tenant, compact slab")
        stats = {a: {"overflow": 0, "dropped": 0, "steps": 0} for a in arms}
        for s in range(max_steps):
            if s == later:
                dhash.stack_autostart(
                    g, torch.arange(S * T, device=device) % 2 == 1)
            arm = arms[s % 4]
            slack = GRID_SLACK if "compact" in arm else None
            hot = (s // 4) % T

            def tenants(n):
                if "one tenant" in arm:
                    return np.full((S, n), hot, np.int32)
                return np.stack([zipf_owners(rng, n, T) for _ in range(S)])
            tl, ti, td = (_tt(tenants(n), device) for n in (Q, QU, QU))
            h = Q // 2
            rl = tl.long()
            look = torch.cat([orc.sample(rl[:, :h], True),
                              orc.sample(rl[:, h:], False)], 1)
            ins = orc.sample(ti.long(), False)
            dele = orc.sample(td.long(), True)
            vals = (ins * 3 + s).to(torch.int32)
            kl, ki, kd = orc.key(look), orc.key(ins), orc.key(dele)
            served = []
            for k, tn in ((kl, tl), (ki, ti), (kd, td)):
                own = tdd.grid_owner(k, tn, S, T, owner_fn)
                c = tdd.route_cap(2.0, k.shape[1], S * T)
                sc = tdd.route_spill_cap(k.shape[1], c, slack)
                ov_h, dr_h, sv_h = host_route(own.cpu().numpy(), S * T, c,
                                              sc)
                rt = tdd._route(k, own, S * T, c, sc)
                check(np.array_equal(rt.dropped.cpu().numpy(), dr_h)
                      and np.array_equal(rt.overflow.cpu().numpy(), ov_h),
                      f"grid {name} step {s} ({arm}): the router's overflow "
                      f"or dropped differs from the host histogram")
                stats[arm]["overflow"] += int(ov_h.sum())
                stats[arm]["dropped"] += int(dr_h.sum())
                served.append((_tt(sv_h, device, torch.bool), ov_h))
            stats[arm]["steps"] += 1
            before = probe.launch_counts()
            f, v, ov = tdd.routed_stack_lookup(g, kl, tl, axis, owner_fn,
                                               cap_factor=2.0,
                                               spill_slack=slack)
            after = probe.launch_counts()
            got = {k: after[k] - before[k] for k in after
                   if after[k] > before[k]}
            check(got == {kern: 1}, f"grid {name} step {s}: a routed stack "
                  f"lookup launched {got}")
            check(np.array_equal(ov.cpu().numpy(), served[0][1]),
                  f"grid {name} step {s}: lookup overflow")
            ef, ev = orc.lookup(rl, look, served[0][0])
            bad = (f != ef).any() | (v != ev).any()
            if slack is not None or "one tenant" in arm:
                f0, v0, _ = tdd.routed_stack_lookup(g, kl, tl, axis,
                                                    owner_fn, cap_factor=0.0)
                sv = served[0][0]
                bad |= ((f != f0) & sv).any() | ((v != v0) & sv).any()
            _, ok_i, ov_i = tdd.routed_stack_update(
                g, ki, vals, torch.ones_like(ki, dtype=torch.bool), ti, axis,
                owner_fn, cap_factor=2.0, spill_slack=slack)
            _, ok_d, ov_d = tdd.routed_stack_update(
                g, kd, kd, torch.ones_like(kd, dtype=torch.bool), td, axis,
                owner_fn, op=dhash.stack_delete, cap_factor=2.0,
                spill_slack=slack)
            check(np.array_equal(ov_i.cpu().numpy(), served[1][1])
                  and np.array_equal(ov_d.cpu().numpy(), served[2][1]),
                  f"grid {name} step {s}: update overflow")
            bad |= orc.insert(ti.long(), ins, vals, served[1][0],
                              got=ok_i)[1]
            bad |= (ok_d != orc.delete(td.long(), dele, served[2][0])).any()
            orc.fail(bad, s)
            go = dhash.stack_rebuild_step_(g, swap=True)
            dhash.stack_finish_same_shape_(g, go=go)
            if s % 50 == 49:
                orc.verify(f"grid {name}")
                if s > later and all(e >= 1 for e in g.epoch.tolist()) \
                        and not any(g.rebuilding.tolist()):
                    break
        orc.verify(f"grid {name}")
        epochs = g.epoch.tolist()
        check(all(e == 1 for e in epochs) and not any(g.rebuilding.tolist()),
              f"grid {name}: epochs {epochs} after {s + 1} steps")
        live = np.bincount(orc.owned(lambda r, k: tdd.grid_owner(
            k, r.to(torch.int32), S, T, owner_fn)).cpu().numpy(),
            minlength=S * T)
        counts = dhash.stack_count_items(g).tolist()
        check(counts == live.tolist(), f"grid {name}: the tables hold "
              f"{counts}, the oracle {live.tolist()}")
        # one routed stack lookup under the profiler: one kernel of the port
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tdd.routed_stack_lookup(g, kl, tl, axis, owner_fn,
                                    cap_factor=2.0)
            torch.cuda.synchronize()
        sources = port_kernel_sources()
        seen = {}
        for e in prof.events():
            m = re.match(r"(?:void )?(\w+)", e.name)
            if e.device_type == DeviceType.CUDA and m \
                    and m.group(1) in sources:
                seen[sources[m.group(1)]] = seen.get(sources[m.group(1)],
                                                     0) + 1
        check(seen == {kern: 1}, f"grid {name}: the profiler saw {seen} in "
              f"one routed stack lookup")
        refused = int(orc.refused)
        check(refused <= 64, f"grid {name}: {refused} inserts found no slot")
        out[name] = dict(steps=s + 1, tables=S * T, epochs=epochs,
                         table_keys=counts, arms=stats, refused=refused,
                         lookup_launches={kern: 1}, profiler=seen)
        log(f"  grid {name}: {S} shards x {T} tenants, {s + 1} steps, epochs "
            f"{epochs}, every answer and ok equal to the oracle's, overflow "
            f"and dropped equal to the host histogram every step; one "
            f"{kern} launch a routed stack lookup (profiler: {seen}); "
            + json.dumps(stats))
        del g, orc
    out["launches"] = probe.launch_counts()
    return out


def phase_lockstep(device, backend: str, max_steps: int):
    """fused=True against the port's plain path, same ops, one epoch (the
    fused engine replaying its step, the plain one eager).  The
    fused cuckoo insert (claim kernel, then kick-out) is a linearisation of
    its own, and the fused chain compacts its arena where the plain path
    never does, so for those two the whole key -> value map is compared at
    the end; otherwise both tables slot for slot.  A two-row lookup's value
    is compared where found: the plain two-row lookup's value of a miss is
    unspecified.  Chain starts a quarter full (a half elsewhere): the plain
    path reclaims no tombstone within an epoch, and its new arena must not
    run out of nodes before the fused one does."""
    from repro_torch import convert
    from repro_torch.core import dhash
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.engine import DHashEngine
    exact = backend in ("linear", "twochoice")
    cap, chunk, nl, nu = 1 << 16, 4096, 8192, 1024
    engs = [DHashEngine(dhash.make(backend, capacity=cap, chunk=chunk,
                                   fused=f, seed=5, device=device),
                        continuous_rebuild=True) for f in (True, False)]
    oracle = Oracle(4 * cap, seed=9)
    empty = np.zeros(0, np.int32)
    ins = oracle._sample(cap // 4 if backend == "chain" else cap // 2, False)
    oracle.present[ins] = True
    with eng_mod._eager():
        for e in engs:
            e.step(empty, oracle.key(ins), (ins * 3).astype(np.int32), empty)
    steps = 0
    while steps < max_steps and min(e.stats.rebuilds_completed
                                    for e in engs) < 1:
        look, ins, vals, dele = oracle.batch(nl, nu, steps)
        mask = ~oracle.present[ins]
        outs = [e.step(oracle.key(look), oracle.key(ins), vals,
                       oracle.key(dele), ins_mask=mask) for e in engs[:1]]
        with eng_mod._eager():      # the plain path: the reference, eager
            outs.append(engs[1].step(oracle.key(look), oracle.key(ins), vals,
                                     oracle.key(dele), ins_mask=mask))
        (fa, va, ia, da), (fb, vb, ib, db) = outs
        if backend in ("twochoice", "cuckoo"):
            va, vb = torch.where(fa, va, 0), torch.where(fb, vb, 0)
        for a, b, n in ((fa, fb, "found"), (va, vb, "vals"),
                        (ia, ib, "ok_i"), (da, db, "ok_d")):
            check(torch.equal(a, b), f"lockstep {backend} step {steps}: {n} "
                                     f"differs between fused and plain")
        ok_i = np.asarray(ia.cpu())
        oracle.present[ins[ok_i]] = True
        ok_d = np.asarray(da.cpu())
        oracle.present[dele[ok_d]] = False
        steps += 1
    check(all(e.stats.rebuilds_completed >= 1 for e in engs),
          f"lockstep {backend}: no epoch completed in {steps} steps")
    a, b = (convert.state_to_numpy(e.state) for e in engs)
    check(_content(a) == _content(b), f"lockstep {backend}: the key -> "
          f"value maps differ at the end")
    check(set(_content(a)) == set(oracle.key(np.flatnonzero(
        oracle.present)).tolist()), f"lockstep {backend}: keys differ from "
        f"the oracle at the end")
    if exact:
        for side in ("old", "new"):
            for f in a[side]:
                x, y = a[side][f], b[side][f]
                if isinstance(x, dict):
                    x, y = x["seeds"], y["seeds"]
                check(np.array_equal(x, y),
                      f"lockstep {backend}: {side}.{f} differs at the end")
        for f in ("cursor", "rebuilding", "epoch"):
            check(a[f] == b[f], f"lockstep {backend}: {f} differs")
    log(f"  {backend}: {steps} steps in lock step, outputs equal every step, "
        + ("both tables slot for slot, seeds, cursor, epoch" if exact else
           "the key -> value map (and the oracle's keys)")
        + f" equal at the end (capacity {cap}, chunk {chunk})")


def phase_big(device, cfg, n_steps: int, reps: int, cap: int = 1 << 24):
    from repro_torch.core import dhash, hashing
    from repro_torch.core.engine import DHashEngine
    from repro_torch.kernels import probe
    state = dhash.make("linear", capacity=cap, chunk=cfg.chunk, fused=True,
                       seed=2, device=device)
    oracle = Oracle(4 * cap, seed=4)
    eng = DHashEngine(state, continuous_rebuild=False)
    n_pop = populate(eng, oracle, cap, min(cap, 1 << 20), "big")
    log(f"  populated {int(oracle.present.sum())} keys in {n_pop} steps; "
        f"{state.old.capacity} slots a table "
        f"({state.old.capacity * 12 / 2**20:.0f} MiB a table)")
    eng.continuous_rebuild = True
    times, in_rb, _, _ = drive(eng, oracle, n_steps, cfg.lookups_per_step,
                               cfg.updates_per_step, "big")
    check(in_rb >= n_steps - 1, "big: the steps must lie in a rebuild epoch")
    ts = sorted(times)
    ops_step = cfg.lookups_per_step + 2 * cfg.updates_per_step
    log(f"  {n_steps} steps ({in_rb} in a rebuild epoch): step ms median "
        f"{statistics.median(ts):.3f} max {ts[-1]:.3f}; "
        f"{ops_step * len(ts) / (sum(ts) / 1e3) / 1e6:.2f} M operations/s; "
        f"inserts that found no slot: {oracle.no_slot}")
    check(oracle.no_slot <= 256, "big: too many inserts found no slot")
    # the two read kernels on this table, a fresh batch of keys every launch
    # so that the slots they touch are not in L2 from the launch before
    d = eng.state
    old = (d.old.key, d.old.val, d.old.state)
    new = (d.new.key, d.new.val, d.new.state)
    batches = []
    for s in range(reps + 2):
        k = torch.as_tensor(oracle.key(oracle.batch(
            cfg.lookups_per_step, cfg.updates_per_step, s)[0]), device=device)
        batches.append((hashing.bucket_of(d.old.hfn, k, d.old.capacity),
                        hashing.bucket_of(d.new.hfn, k, d.new.capacity), k))
    it = iter(batches)

    def lookup():
        h0o, _, k = next(it)
        probe.probe_lookup(*old, h0o, k, d.old.max_probes)
    t_lookup = time_ms(lookup, reps)
    it = iter(batches)

    def ordered():
        h0o, h0n, k = next(it)
        probe.probe2(old, new, d.hazard_key, d.hazard_val, d.hazard_live,
                     h0o, h0n, k, d.old.max_probes)
    t_probe2 = time_ms(ordered, reps)
    log(f"  kernels on this table, Q={cfg.lookups_per_step}, new keys every "
        f"launch: probe_lookup {t_lookup:.4f} ms, probe2 {t_probe2:.4f} ms "
        f"({int(d.hazard_live.sum())} live hazard entries)")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1200,
                    help="continuous-rebuild steps of the linear main path")
    ap.add_argument("--tc-steps", type=int, default=1100,
                    help="continuous-rebuild steps of the twochoice and "
                    "chain main paths (one epoch takes ~1030 and ~385)")
    ap.add_argument("--cuckoo-steps", type=int, default=2200,
                    help="continuous-rebuild steps of the cuckoo main path "
                    "(its flood and the complete swap after it take ~1900)")
    ap.add_argument("--big-steps", type=int, default=64,
                    help="steps on the table larger than L2")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches a kernel")
    ap.add_argument("--baseline", default="", metavar="DIR",
                    help="the build directory of another tree of this repo "
                    "(build/repro_torch_kernels there, after its own run): "
                    "phase 2 also holds that tree's probe_lookup, probe2, "
                    "probe_insert, tc_lookup, tc_insert, tc_probe2, "
                    "chain_probe, "
                    "chain_probe2 and chain_compact against their plain "
                    "versions on the timed inputs and times each in turns "
                    "with this tree's, its tc_insert and cuckoo_kick against "
                    "this tree's cuckoo insert, and "
                    "its rebuild transition and epoch exchange (extract, "
                    "epoch_swap and the PyTorch ops around them) against "
                    "this tree's transition and exchange")
    ap.add_argument("--profile", default="", metavar="FILE",
                    help="also run 40 steps of each main path under "
                    "torch.profiler and write the kernel tables to FILE "
                    "(linear) and FILE with _twochoice / _cuckoo / _chain "
                    "before its extension (after the main path's counts "
                    "are read), and 40 steady-state steps of linear, "
                    "twochoice and cuckoo, on an engine populated as the "
                    "main path's, to FILE with _steady / _twochoice_steady "
                    "/ _cuckoo_steady")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs.dhash_paper import CONFIG
    from repro_torch.kernels import build, probe

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    log("== 1. environment")
    card = card_line()
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    log("  nvcc: " + next((ln.strip() for ln in nvcc.splitlines()
                           if "release" in ln), "unknown"))
    log(f"  card: {card}")
    build.load()
    log(f"  kernels built in {build.build_seconds:.1f} s -> "
        f"{build.build_dir()}")
    for line in build.build_log.splitlines():
        if "registers" in line or "error" in line or "warning" in line \
                or line.startswith("=="):
            log("   ", line.strip())

    def elapsed():
        log(f"  ({time.perf_counter() - t_start:.0f} s since the start)")

    log("== 2. kernels against their plain versions (tolerance 0): linear "
        f"C=2^21, max_probes=64; two-row 2^18 x 8; chain arena 2^20 nodes, "
        f"2^16 buckets, max_chain=64; "
        f"Q={CONFIG.lookups_per_step}/{CONFIG.updates_per_step}, "
        f"chunk={CONFIG.chunk}")
    baseline = load_baseline(args.baseline) if args.baseline else None
    kres = phase_kernels(device, CONFIG, args.reps, baseline)
    kres.update(phase_tc_kernels(device, CONFIG, args.reps, baseline))
    kres.update(phase_chain_kernels(device, CONFIG, args.reps, baseline))
    kres.update(phase_guard_kernels(device, CONFIG, args.reps, baseline))
    resize_transition_cases(device, CONFIG)
    # the main path launches extract as the transition: its time, bound and
    # plain time on linear are the kernel's; the extract form's stay beside
    tr, ext = kres.pop("transition"), kres["extract"]
    ext.update(extract_form=dict(ms=ext["ms"], plain_ms=ext["plain_ms"],
                                 bound_ms=ext["bound_ms"],
                                 idle_ms=ext.pop("guarded_idle_ms")),
               max_abs_err=max(ext["max_abs_err"], tr.pop("max_abs_err")),
               transition=tr)
    ext.update({k: tr["linear"][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")})
    # the cuckoo insert launches tc_insert with the kick-out in its resolve
    kres["tc_insert"]["cuckoo_insert"] = kres.pop("cuckoo_insert")
    log(f"  the table axis: {STACK_T} linear tables of 2^21 slots, "
        f"main-path batches a table")
    for name, r in stack_kernel_cases(device, CONFIG, args.reps).items():
        kres[name]["stack"] = r
        kres[name]["max_abs_err"] = max(kres[name]["max_abs_err"],
                                        r["max_abs_err"])
    log(f"  the two-row table axis: {STACK_T} twochoice tables of 2^18 x 8 "
        f"and {STACK_T} cuckoo tables of 2 x 2^17 x 8, main-path batches a "
        f"table")
    for name, r in two_row_stack_cases(device, CONFIG, args.reps).items():
        kres[name]["stack"] = r
        kres[name]["max_abs_err"] = max(
            [kres[name]["max_abs_err"]]
            + [v["max_abs_err"] for v in r.values() if "max_abs_err" in v])

    by_path = {}
    for i, name in enumerate(BACKENDS):
        cfg = dataclasses.replace(CONFIG, backend=name)
        linear = name == "linear"
        elapsed()
        log(f"== 3{'abcd'[i]}. main path, {name}: {cfg.arch_id} unreduced, "
            f"capacity {cfg.capacity_per_shard}, chunk {cfg.chunk}, "
            f"{cfg.lookups_per_step}+{cfg.updates_per_step}+"
            f"{cfg.updates_per_step} operations a step")
        prof = args.profile
        if prof and not linear:
            root, ext = os.path.splitext(prof)
            prof = f"{root}_{name}{ext}"
        steps = {"linear": args.steps,
                 "cuckoo": args.cuckoo_steps}.get(name, args.tc_steps)
        by_path[name] = phase_main(device, cfg, steps,
                                   min_epochs=2 if steps >= 2100 else 1,
                                   profile_to=prof,
                                   flood=Flood(2048, after_swap=1, delay=400)
                                   if name == "cuckoo" else None)
    elapsed()
    log(f"== 3e. collision flood, chain: {CONFIG.arch_id} unreduced (arena "
        f"{CONFIG.capacity_per_shard} nodes), 2048 keys into one bucket, "
        f"max_chain 2112")
    phase_chain_flood(device, CONFIG, args.reps)
    elapsed()
    log(f"== 3f. one rebuild-epoch step in a CUDA graph, replayed across a "
        f"live swap against the eager engine ({CONFIG.arch_id} unreduced)")
    graphs = {}
    for name in BACKENDS:
        graphs[name] = phase_graph(
            device, dataclasses.replace(CONFIG, backend=name))
    log(f"  {card}; replayed step against eager, ms: " + "; ".join(
        f"{k} {v['replay_ms']:.3f} / {v['eager_ms']:.3f} (busy "
        f"{v['replay_busy_ms']:.3f})" for k, v in graphs.items()))
    elapsed()
    log(f"== 3g. the elastic policy on the card: linear, {CONFIG.arch_id} "
        f"unreduced, a burst past the high watermark (grow to 2^22 slots), "
        f"a drain below the low one (a reclaim rehash fired on the device, "
        f"then the shrink to 2^20)")
    policy_run = phase_policy(device, CONFIG)
    log(f"  {card}; " + json.dumps(policy_run))
    elapsed()
    log(f"== 3h. a linear table stack on the card: DHashStackEngine, "
        f"{STACK_T} tables of {CONFIG.arch_id} unreduced (capacity "
        f"{CONFIG.capacity_per_shard}, chunk {CONFIG.chunk}), "
        f"{CONFIG.lookups_per_step}+{CONFIG.updates_per_step}+"
        f"{CONFIG.updates_per_step} operations a table a step, staggered "
        f"epochs")
    stack_run = phase_stack(device, CONFIG)
    by_path["stack"] = stack_run.pop("launches")
    log(f"  {card}; " + json.dumps(stack_run))
    elapsed()
    log(f"== 3i. the policy's stack arm on the card: the same {STACK_T}-table "
        f"stack, in-place policy, deletes draining tables 1 and 5")
    stack_policy_run = phase_stack_policy(device, CONFIG)
    by_path["stack_policy"] = stack_policy_run.pop("launches")
    log(f"  {card}; " + json.dumps(stack_policy_run))
    elapsed()
    t_router = time.perf_counter()
    log(f"== 3j. the routed service step on one card: {ROUTED_S} shards of "
        f"{CONFIG.arch_id} unreduced in one process (linear, capacity "
        f"{CONFIG.capacity_per_shard}, chunk {CONFIG.chunk}), "
        f"{CONFIG.lookups_per_step}+{CONFIG.updates_per_step}+"
        f"{CONFIG.updates_per_step} operations a source shard a step, "
        f"replayed from one CUDA graph through a live swap of every shard")
    routed_run = phase_routed(device, CONFIG)
    by_path["routed"] = routed_run.pop("launches")
    log(f"  {card}; " + json.dumps(routed_run))
    elapsed()
    log(f"== 3k. the S x T grid on one card: {GRID_S} shards x {GRID_T} "
        f"tenants, linear tables of 2^18 slots, then cuckoo 2 x 2^14 x 8; "
        f"zipf(1.2) tenants, cap_factor 2.0, overflow-proof and compact "
        f"slabs, 100% one tenant")
    grid_run = phase_grid(device, CONFIG)
    by_path["grid"] = grid_run.pop("launches")
    log(f"  {card}; " + json.dumps(grid_run))
    log(f"  3j and 3k took {time.perf_counter() - t_router:.1f} s")

    elapsed()
    log("== 4. fused engine against the plain path in lock step")
    for name in BACKENDS:
        phase_lockstep(device, name, 200)
    elapsed()
    log("== 5. a table larger than L2 (linear, capacity 2^24, 2^25 slots)")
    phase_big(device, CONFIG, args.big_steps, args.reps)

    kernels = []
    for name in probe.KERNELS:
        src, rep = KERNEL_INFO[name]
        paths = {b: counts[name] for b, counts in by_path.items()}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(paths.values()),
                        "launches_by_path": paths, **kres[name],
                        "library_ms": None})
    log(f"  no single PyTorch call computes any of these twelve functions "
        f"(a probe sequence, a two-row lane match, a lock-step claim, an "
        f"ordered three-way check, a compacting scan, a segment scan with a "
        f"bounded walk, a cuckoo kick-out, a guarded two-table exchange, a "
        f"guarded arena compaction), "
        f"so library_ms is null; times are medians of {args.reps} launches, "
        f"tables warm in L2; launches are summed over the eight main paths "
        f"(launches_by_path: each path's own count: the four backends, the "
        f"table stack and its policy arm, the routed service step and the "
        f"grid); \"stack\" gives the six kernels with the table axis at "
        f"T = {STACK_T}")
    log(f"  total {time.perf_counter() - t_start:.0f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
