"""Engine: interleaves full-rate op batches with rebuild transitions.

This is the batched rendering of the paper's concurrency: "worker threads"
(batched lookup/insert/delete steps) run at full rate while a rebuild makes
incremental progress — one extract or land transition per engine step, with
the hazard window genuinely observable by the ops interleaved between the two
halves.

A step is, in the reference's order: lookup, insert, delete, one rebuild
transition (``rebuild_step``), the epoch swap (``finish_same_shape``, when
old/new share shapes — every default rebuild) and, in continuous-rebuild
mode, the next rebuild start (``rebuild_autostart``, which reseeds the hash
function on the device); with an elastic ``policy``, the lookup is
``lookup_counted`` and one ``policy_step`` follows the swap.  With a
``fused`` state every op in the step is a hand-written CUDA kernel launch
plus plain tensor glue.

Host synchronisations.  A step is split as the reference's is: the host
converts the inputs, ``_device_step`` (the counterpart of the reference's
jitted step) runs the whole step on the device, and the host keeps its
books and, one step in ``poll_every``, polls.  Every ``lax.cond`` the
reference puts on the step is a decision taken on the device: the transition
is ``dhash.rebuild_step_`` (the landing runs every step and inserts nothing
when no hazard entry is live; one transition launch then does the landing's
bookkeeping, scans only where the device flags allow and decides the epoch
swap and the next rebuild's start), the swap and the start are one
``epoch_swap`` exchange on that decision (``dhash.finish_same_shape_``), the
policy's rehash is the same exchange on its own decision, and the cuckoo
kick-out is a kernel with its own guard.  ``_device_step`` reads nothing
from the device and writes every field of the state in place.  The host
keeps ``rebuilding`` as a flag of its own: in continuous-rebuild mode the
swap and the next start happen in one step, so it is true at every step
boundary; otherwise a rebuild epoch that ends on the device between polls
leaves it stale until the poll, and the epoch's inserts pick their table on
the device (``dhash.insert_by_flag``), while lookups and deletes stay right
on the epoch path (the standby holds nothing LIVE).  A policy engine's flag
can go stale the other way too — a tombstone-reclaim rehash starts on the
device between polls — so its step takes no host flag at all: the lookup is
``dhash.lookup_counted_`` (both of the reference's branches, the device
flag picks the answers and whether to sample), the inserts go through
``insert_by_flag``, the delete is the ordered one (right in either state)
and the transition runs every step (it does nothing where no rebuild runs).
The poll is the one read: ``(epoch, rebuilding, done)`` — and the policy's
``(want_grow, want_shrink, target_capacity)`` — in one small tensor, counted
in ``EngineStats.host_syncs``.  Steps between polls read nothing.

The step replayed (the counterpart of the reference's jit cache).  On a CUDA
device ``step`` keeps one captured ``torch.cuda.CUDAGraph`` a key: the host
flags ``_device_step`` branches on, whether a policy runs, the batch sizes,
and the shape, dtype and storage of every tensor of the state and the
policy (with the tables' configuration), so that any rebinding of a field
captures anew and no graph writes into a buffer it does not own.  The first
step of a new key runs eagerly (the warm-up) and is then captured on the
engine's own input buffers; later steps copy their inputs in, replay, and
return clones of the outputs (a caller's results of step n survive step
n+1, as the reference's fresh arrays do).  Masks are always copied, ones
where none was given.  A replay credits the kernel-launch counters of
``kernels/probe.py`` with the launches its capture recorded.  A key whose
tensors are gone (a resized-away table) is dropped.  A failed capture or
replay raises: nothing falls back to the eager step.  ``_eager()`` (the
counterpart of ``jax.disable_jit``) runs steps eagerly on the card, for
comparisons.  On a CPU device every key maps to the eager step.

Only a *shape-changing* rebuild (a user-supplied ``new_table`` with a
different capacity, or a policy resize) is finished by the K-step poll, as
in the reference — up to K-1 steps late, which is safe because a
completed-but-unswapped rebuild still answers every op correctly through the
ordered check; its transitions run on the device all the same.  After a
policy resize finishes, the dead table is replaced by a fresh standby of the
new shape, so that the swap and the reclaim rehash return to the device.

Ownership: the engine CLONES the state (and the policy) it is given and then
owns the clone: a fused state's tables are updated in place, step after
step.  Read ``engine.state`` freely; never write it or pass it to a mutating
``dhash`` function.

``DHashStackEngine`` drives a table stack (``dhash.make_stack``): T
independent tables, [T, Q] operands, each table on its own rebuild epoch.
Every decision of its step is a per-table device flag (the stack ops pick
each table's branch on the device), so its key holds no host flag: one
captured graph a batch shape and mode, replayed by the same cache as
``DHashEngine``'s (``_Replayed``).  Its poll is one read of ``epoch[T]``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import dhash
from repro_torch.core import policy as elastic
from repro_torch.core.struct_utils import assign_, map_tensors, replace

I32 = torch.int32

DEFAULT_POLL_EVERY = 32

_EAGER = False


@contextlib.contextmanager
def _eager():
    """Run every engine step eagerly inside the block, on the card too (the
    counterpart of ``jax.disable_jit``): for comparisons with the replay."""
    global _EAGER
    was, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = was


@dataclass
class EngineStats:
    steps: int = 0
    ops: int = 0
    hits: int = 0
    rebuilds_completed: int = 0
    rebuild_transitions: int = 0
    host_syncs: int = 0         # engine-internal device->host reads
    grows: int = 0              # policy-applied capacity increases
    shrinks: int = 0            # policy-applied capacity decreases


def _clone_tree(obj):
    """Deep copy of a state container: every tensor cloned, nothing shared."""
    return map_tensors(torch.clone, obj)


def _signature(obj, tensors: list) -> tuple:
    """What a captured step bakes in of a container: each tensor's shape,
    dtype and storage, each other field's value; the tensors are appended
    to ``tensors``."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return (tuple(obj.shape), obj.dtype, obj.data_ptr())
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _signature(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj))
    return obj


def _packed(specs, flat=None, **kw):
    """One byte buffer laid out for a tensor of each (shape, dtype) in
    ``specs``, each at a 16-byte boundary (made with ``kw`` unless
    ``flat`` is given), and the tensors as views of it."""
    offs, n = [], 0
    for shape, dt in specs:
        offs.append(n)
        n += -(-math.prod(shape) * dt.itemsize // 16) * 16
    if flat is None:
        flat = torch.empty(max(n, 16), dtype=torch.uint8, **kw)
    return flat, [flat[o:o + math.prod(shape) * dt.itemsize].view(dt)
                  .view(shape) for o, (shape, dt) in zip(offs, specs)]


def _weak(obj):
    """A weak reference to ``obj`` (a callable returning None for None)."""
    return (lambda: None) if obj is None else weakref.ref(obj)


class _Step:
    """One key's step: on CUDA its captured graph, static inputs and outputs
    and the launches it credits; on the CPU nothing but the key's tensors.
    Holds weak references to the tensors of its key."""

    def __init__(self, refs: list):
        self.refs = refs
        self.graph = None

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


class _Replayed:
    """What both engines share: their inputs, their counted reads, and the
    step replayed from CUDA graphs (the counterpart of the reference's jit
    cache), one captured graph a key.  An engine supplies ``state``,
    ``policy``, ``device``, ``_stats``, the cache's fields ``_steps``,
    ``_step_keys`` and ``_sig``, ``_device_step`` (the step on the device,
    no host read, every field written in place), ``_host_flags`` and
    ``_sig_extra`` (what its key adds)."""

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _read(self, t: torch.Tensor) -> list:
        """One counted device->host read."""
        self._stats.host_syncs += 1
        return t.tolist()

    def _inputs(self, lookup_keys, ins_keys, ins_vals, del_keys, ins_mask,
                del_mask) -> list:
        """The six inputs as tensors (a host array stays on the host),
        masks ones where none was given."""
        xs = [torch.as_tensor(x, dtype=dt) for x, dt in (
            (lookup_keys, I32), (ins_keys, I32), (ins_vals, I32),
            (del_keys, I32))]
        for i, m in ((1, ins_mask), (3, del_mask)):
            xs.append(torch.ones(xs[i].shape, dtype=torch.bool)
                      if m is None else torch.as_tensor(m, dtype=torch.bool))
        if not (xs[1].shape == xs[2].shape == xs[4].shape
                and xs[3].shape == xs[5].shape):
            raise ValueError("insert keys, values and mask (and delete keys "
                             "and mask) must have one shape")
        return xs

    def _key(self, sizes: tuple, fresh: bool = False) -> tuple:
        """Everything ``_device_step`` branches on or a graph bakes in, and
        weak references to the tensors it names: the host flags, what the
        engine adds of its containers (``_sig_extra``), the batch sizes, the
        containers' signature.  The signature is kept until ``state`` or
        ``policy`` is rebound (a frozen container changes only by being
        replaced), unless ``fresh``."""
        sig = self._sig
        if fresh or sig is None or sig[0]() is not self.state \
                or sig[1]() is not self.policy:
            tensors: list = []
            sig = (_weak(self.state), _weak(self.policy),
                   _signature(self.state, tensors),
                   _signature(self.policy, tensors),
                   self._sig_extra(), [weakref.ref(t) for t in tensors])
            self._sig = sig
        key = (*self._host_flags(), sig[4], sizes, sig[2], sig[3])
        return key, sig[5]

    def _run_step(self, xs: list):
        """The step on inputs ``xs``: eager inside ``_eager()``, else this
        key's replay (captured at its first step on the card)."""
        if _EAGER:
            return self._device_step(*(x.to(self.device) for x in xs))
        return self._cached_step(xs)

    def _cached_step(self, xs: list):
        """The step of this key: replayed where it was captured, else run
        eagerly and (on the card) captured for the next time."""
        key, refs = self._key(tuple(x.numel() for x in xs[:4]))
        entry = self._steps.get(key)
        if entry is not None and entry.alive():
            if entry.graph is None:
                return self._device_step(*(x.to(self.device) for x in xs))
            return self._replay(entry, xs)
        self._steps = {k: e for k, e in self._steps.items() if e.alive()}
        dev_xs = [x.to(self.device) for x in xs]
        out = self._device_step(*dev_xs)
        entry = _Step(refs)
        if self._key(key[4], fresh=True)[0] != key:
            raise RuntimeError("an engine step rebound a state tensor: it "
                               "cannot be replayed")
        if self.device.type == "cuda":
            self._capture(entry, dev_xs)
        self._steps[key] = entry
        self._step_keys.append(key)
        return out

    def _capture(self, entry: _Step, dev_xs: list) -> None:
        """Capture ``_device_step`` on static copies of this step's inputs
        (the step itself has just run eagerly: the warm-up).  The inputs lie
        in one device buffer, with a pinned host buffer of the same layout
        that a replay stages host inputs in (one copy in); the graph ends by
        copying the outputs into one buffer of its own (one clone out).
        The capture runs nothing, so the launches it counted are taken back
        and kept as what each replay credits."""
        from repro_torch.kernels import probe
        specs = [(x.shape, x.dtype) for x in dev_xs]
        entry.flat, entry.inputs = _packed(specs, device=self.device)
        entry.staged, entry.staged_views = _packed(specs, pin_memory=True)
        entry.staged_np = [v.numpy() for v in entry.staged_views]
        for dst, x in zip(entry.inputs, dev_xs):
            dst.copy_(x)
        entry.copied = torch.cuda.Event()
        entry.copied.record()
        before = probe.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outs = self._device_step(*entry.inputs)
                entry.out_specs = [(o.shape, o.dtype) for o in outs]
                entry.out_flat, views = _packed(entry.out_specs,
                                                device=self.device)
                for dst, o in zip(views, outs):
                    dst.copy_(o)
        finally:
            after = probe.launch_counts()
            entry.credit = {k: after[k] - before[k] for k in after}
            probe.add_launches(entry.credit, -1)
        # the epoch exchange's decision buffers the graph writes: kept alive
        # with it, whatever the wrappers' cache drops later
        entry.keep = list(probe._EPOCH_DESC.values())
        entry.graph = graph

    def _replay(self, entry: _Step, xs: list):
        """Stage host inputs in the key's pinned buffer (once the device has
        taken the last step's copy from it), copy them in without a
        synchronisation, replay, and clone the outputs (one buffer: the
        four results are views of it)."""
        from repro_torch.kernels import probe
        entry.copied.synchronize()
        if all(x.device.type == "cpu" for x in xs):
            # numpy's copy: one thread (a large host ``copy_`` wakes
            # PyTorch's thread pool, which costs more than the copy)
            for staged, x in zip(entry.staged_np, xs):
                np.copyto(staged, x.numpy())
            entry.flat.copy_(entry.staged, non_blocking=True)
        else:
            for dst, staged, x in zip(entry.inputs, entry.staged_views, xs):
                if x.device.type == "cpu":
                    staged.copy_(x)
                    x = staged
                dst.copy_(x, non_blocking=True)
        entry.copied.record()
        entry.graph.replay()
        probe.add_launches(entry.credit)
        return tuple(_packed(entry.out_specs, flat=entry.out_flat.clone())[1])

    def _step_cache_size(self) -> int:
        """Keys held (one captured graph each on the card); a key whose
        tensors are gone is dropped first."""
        self._steps = {k: e for k, e in self._steps.items() if e.alive()}
        return len(self._steps)


@dataclass
class DHashEngine(_Replayed):
    """Drives a DHashState: user op batches + background rebuild progress."""

    state: dhash.DHashState
    continuous_rebuild: bool = False   # paper Fig 2: rebuild forever
    rebuild_seed: int = 1234
    poll_every: int = DEFAULT_POLL_EVERY   # host polls 1 of every K steps
    policy: elastic.ElasticPolicy | None = None   # elastic capacity decisions
    _stats: EngineStats = field(default_factory=EngineStats, repr=False)
    _rebuilding: bool = field(default=False, init=False, repr=False)
    _epoch0: int = field(default=0, init=False, repr=False)
    _last_poll_step: int = field(default=0, init=False, repr=False)
    _steps: dict = field(default_factory=dict, init=False, repr=False)
    _step_keys: list = field(default_factory=list, init=False, repr=False)
    _sig: tuple | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.policy is not None and self.continuous_rebuild:
            raise ValueError("policy and continuous_rebuild are exclusive: "
                             "the policy decides when to rebuild")
        # take ownership: the fused ops write the tables in place, so the
        # engine must not share a tensor with the caller
        self.state = _clone_tree(self.state)
        if self.policy is not None:
            if self.policy.device != self.state.device:
                raise ValueError(f"the policy lies on {self.policy.device}, "
                                 f"the state on {self.state.device}")
            self.policy = _clone_tree(self.policy)
        self._rebuilding = bool(self.state.rebuilding)
        self._epoch0 = int(self.state.epoch)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def rebuilding(self) -> bool:
        """Whether a rebuild epoch is in progress, as the host last knew it
        (no read; it may be stale for up to ``poll_every - 1`` steps: after
        an epoch that ended on the device, and on a policy engine after a
        rehash the policy started there)."""
        return self._rebuilding

    def _flag_known(self) -> bool:
        """Whether the host flag equals the device's: right after a poll,
        or where nothing can change the device's between polls."""
        if self._last_poll_step == self._stats.steps:
            return True
        if self.policy is not None:
            return False
        return not (self._rebuilding and self._swap_on_device()
                    and not self.continuous_rebuild)

    # -- the step ------------------------------------------------------------

    def _swap_on_device(self) -> bool:
        """True iff old/new share shapes, so the epoch swap and the autostart
        run inside the step (host metadata only — no device read)."""
        old, new = self.state.old, self.state.new
        if type(old) is not type(new):
            return False
        return all(
            getattr(a, "shape", None) == getattr(b, "shape", None)
            and getattr(a, "dtype", None) == getattr(b, "dtype", None)
            for a, b in ((getattr(old, f.name), getattr(new, f.name))
                         for f in dataclasses.fields(old)
                         if isinstance(getattr(old, f.name), torch.Tensor)))

    def _host_flags(self) -> tuple:
        """The host flags ``_device_step`` branches on (the first part of a
        step's key)."""
        return (None if self.policy is not None else self._rebuilding,
                self.continuous_rebuild, self.policy is not None)

    def _sig_extra(self):
        return self._swap_on_device()

    def step(self, lookup_keys, ins_keys, ins_vals, del_keys,
             ins_mask=None, del_mask=None):
        """One engine step; returns (found, vals, ok_insert, ok_delete) as
        tensors on the engine's device (the caller's to keep)."""
        xs = self._inputs(lookup_keys, ins_keys, ins_vals, del_keys,
                          ins_mask, del_mask)
        self._stats.rebuild_transitions += self._rebuilding
        out = self._run_step(xs)
        if self._swap_on_device() and self.continuous_rebuild:
            self._rebuilding = True     # swapped and restarted, or running
        self._stats.steps += 1
        self._stats.ops += xs[0].numel() + xs[1].numel() + xs[3].numel()
        if self.poll_every <= 1 or self._stats.steps % self.poll_every == 0:
            self._poll()
        return out

    def _device_step(self, lk, ik, iv, dk, im, dm):
        """The step on the device — lookup, insert, delete, one rebuild
        transition, the epoch swap and (continuous rebuild) the next start,
        or (policy) the policy's evaluation — with no host read and every
        state field written in place: the counterpart of the reference's
        jitted step and the unit a CUDA graph captures.  Which kernels it
        launches depends only on host flags (``rebuilding`` as the host
        knows it, the mode, the tables' shapes).
        Returns (found, vals, ok_insert, ok_delete)."""
        if self.policy is not None:
            return self._policy_device_step(lk, ik, iv, dk, im, dm)
        d, rb = self.state, self._rebuilding
        swap = self._swap_on_device()
        found, vals = dhash.lookup(d, lk, rebuilding=rb)
        if rb and swap and not self.continuous_rebuild:
            _, ok_i = dhash.insert_by_flag(d, ik, iv, im)
        else:
            d2, ok_i = dhash.insert(d, ik, iv, im, rebuilding=rb)
            assign_(d, d2)
        d2, ok_d = dhash.delete(d, dk, dm, rebuilding=rb)
        assign_(d, d2)
        go = None
        if rb:
            go = dhash.rebuild_step_(d, swap=swap,
                                     start=self.continuous_rebuild)
        if swap and (rb or self.continuous_rebuild):
            dhash.finish_same_shape_(d, autostart=self.continuous_rebuild,
                                     go=go)
        return found, vals, ok_i, ok_d

    def _policy_device_step(self, lk, ik, iv, dk, im, dm):
        """The reference's ``_policy_engine_step`` with every op routed by
        the DEVICE flag (see the module docstring): counted lookup, insert,
        delete, the transition, the same-shape swap, ``policy_step``."""
        d, pol = self.state, self.policy
        swap = self._swap_on_device()
        found, vals = dhash.lookup_counted_(d, lk, probe_hi=pol.probe_hi)
        _, ok_i = dhash.insert_by_flag(d, ik, iv, im)
        # the ordered delete is the steady one where no rebuild runs: the
        # hazard buffer is dead and the standby holds nothing LIVE
        d2, ok_d = dhash.delete(d, dk, dm, rebuilding=True)
        assign_(d, d2)
        go = dhash.rebuild_step_(d, swap=swap)
        if swap:
            dhash.finish_same_shape_(d, go=go)
        elastic.policy_step(pol, d, allow_autostart=swap)
        return found, vals, ok_i, ok_d

    # -- host-side polling (1 of every K steps) ------------------------------

    def _poll(self):
        """One read of (epoch, rebuilding, done) and the policy's plan:
        refresh the host flag and ``rebuilds_completed``; finish a
        shape-changing rebuild; (re)start a rebuild in continuous mode if
        the in-step autostart could not (shape-changing tables); apply the
        policy's published resize plan."""
        d, pol = self.state, self.policy
        flags = [d.epoch, d.rebuilding.to(I32), dhash.rebuild_done(d).to(I32)]
        if pol is not None:
            flags += [pol.want_grow.to(I32), pol.want_shrink.to(I32),
                      pol.target_capacity]
        epoch, rebuilding, done, *plan = self._read(torch.stack(flags))
        wg, ws, tgt = plan or (0, 0, 0)
        if done:
            # only reachable when the in-step swap was not applicable
            self.state = dhash.rebuild_finish(d, done=True)
            epoch, rebuilding = epoch + 1, False
            # the published plan predates the swap just applied: the
            # device policy re-evaluates against the new geometry first
            wg = ws = 0
            if pol is not None:
                # the dead table is the standby: a fresh one of the new
                # shape brings the swap and the reclaim rehash back on the
                # device
                be = backends.get(self.state.backend)
                self.state = replace(self.state, new=be.fresh_like(
                    self.state.old, self.rebuild_seed))
                self.rebuild_seed += 1
        self._rebuilding = bool(rebuilding)
        self._stats.rebuilds_completed = epoch - self._epoch0
        self._last_poll_step = self._stats.steps
        if self.continuous_rebuild and not self._rebuilding:
            self.request_rebuild()
        if pol is not None and not self._rebuilding and (wg or ws):
            self._apply_resize(grow=bool(wg), target_entries=tgt)

    def _apply_resize(self, *, grow: bool, target_entries: int):
        """Materialise the policy's published plan, as the reference's: size
        the new table (``resolve_slots``; a probe-triggered grow that rounds
        to the current size is bumped to the next one), begin the live
        migration, and consume the plan and the probe sample window in
        place.  Plans that round to the current slot count are skipped."""
        be = backends.get(self.state.backend)
        cur_slots = int(be.capacity_of(self.state.old))
        tgt = int(target_entries)
        new_slots = elastic.resolve_slots(be, tgt)
        if grow and new_slots <= cur_slots:
            tgt = int(cur_slots * 0.75) + 1
            new_slots = elastic.resolve_slots(be, tgt)
        if new_slots == cur_slots or (not grow and new_slots > cur_slots):
            return
        nres = elastic.adapt_nres_cap(self.policy, cur_slots, new_slots,
                                      base=be.nres_cap)
        new_table = be.make(tgt, self.rebuild_seed, device=self.device)
        if not self.request_rebuild(new_table=new_table):
            return   # lost the trylock (a reclaim rehash is mid-flight)
        self.state = replace(self.state, nres_cap=nres)
        for t in (self.state.lookups, self.state.expensive,
                  self.policy.want_grow, self.policy.want_shrink):
            t.zero_()
        if grow:
            self._stats.grows += 1
        else:
            self._stats.shrinks += 1

    @property
    def stats(self) -> EngineStats:
        """Engine statistics.  As the reference's: reading them performs a
        refresh-only device read (counted) if the engine stepped since the
        last poll, so that ``rebuilds_completed`` is current; it never
        finishes or starts a rebuild, and ``step()`` itself stays free of
        reads between polls."""
        if self._stats.steps != self._last_poll_step:
            epoch, rebuilding = self._read(torch.stack([
                self.state.epoch, self.state.rebuilding.to(I32)]))
            self._rebuilding = bool(rebuilding)
            self._stats.rebuilds_completed = epoch - self._epoch0
            self._last_poll_step = self._stats.steps
        return self._stats

    def request_rebuild(self, *, seed: int | None = None, new_table=None):
        """Begin a live rebuild (fails like the paper's trylock if one is
        already in progress).  Where the host flag may be stale the device's
        flag is read, counted.  ``new_table`` is cloned: the engine owns
        what it writes."""
        if not self._flag_known():
            self._rebuilding = bool(self._read(self.state.rebuilding))
        if self._rebuilding:
            return False  # -EBUSY
        if new_table is not None:
            new_table = _clone_tree(new_table)
        self.state = dhash.rebuild_start(
            self.state, new_table,
            seed=self.rebuild_seed if seed is None else seed)
        self.rebuild_seed += 1
        self._rebuilding = True
        return True

    def lookup(self, keys):
        """Lookup outside the step (never writes).  Where the host flag may
        be stale it takes the ordered check, which is right in either
        state."""
        return dhash.lookup(self.state, self._tensor(keys, I32),
                            rebuilding=self._rebuilding
                            or not self._flag_known())

    def count(self) -> int:
        return int(self._read(dhash.count_items(self.state)))


@dataclass
class DHashStackEngine(_Replayed):
    """Drives a ``dhash.make_stack`` state: T independent tables stepped
    together (the multi-tenant serving loop).

    Per step, every table runs its op batch ([T, Q] operands), one rebuild
    transition and its own epoch swap, each decided on the device: epochs
    are INDEPENDENT across the stack.  ``request_rebuild(mask)`` starts
    rebuilds on any subset of tables (``dhash.stack_autostart`` under the
    mask, on the device), and in ``continuous_rebuild`` mode every table
    that finishes an epoch opens the next.  With a ``policy`` (in-place
    mode; a single policy is broadcast with ``policy.stack``) the lookup is
    counted and each table fires its own same-shape rehash.  Stacks take
    same-shape rebuilds only.  On a fused linear stack each op of the step
    is one launch of each kernel for all T tables.  The step is replayed
    from a CUDA graph as ``DHashEngine``'s is (no eager fallback on the
    card; ``_eager()`` runs it eagerly); the host reads the device only at
    its poll, one in ``poll_every`` steps: ``epoch[T]``."""

    state: dhash.DHashState                # stacked: every tensor leads [T]
    continuous_rebuild: bool = False
    poll_every: int = DEFAULT_POLL_EVERY
    policy: elastic.ElasticPolicy | None = None   # in-place mode; [T]
    _stats: EngineStats = field(default_factory=EngineStats, repr=False)
    _epoch0: int = field(default=0, init=False, repr=False)
    _last_poll_step: int = field(default=0, init=False, repr=False)
    _steps: dict = field(default_factory=dict, init=False, repr=False)
    _step_keys: list = field(default_factory=list, init=False, repr=False)
    _sig: tuple | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.state = _clone_tree(self.state)
        self.n_tables = dhash.stack_size(self.state)
        if self.policy is not None:
            if self.continuous_rebuild:
                raise ValueError("policy and continuous_rebuild are "
                                 "exclusive: the policy decides when to "
                                 "rebuild")
            if not self.policy.in_place:
                raise ValueError("stack engines need an in_place policy: "
                                 "the stacked tables cannot change shape")
            if self.policy.device != self.state.device:
                raise ValueError(f"the policy lies on {self.policy.device}, "
                                 f"the state on {self.state.device}")
            if self.policy.armed.dim() == 0:
                self.policy = elastic.stack(self.policy, self.n_tables)
            self.policy = _clone_tree(self.policy)
        self._epoch0 = int(self.state.epoch.sum())

    @property
    def device(self) -> torch.device:
        return self.state.device

    def _host_flags(self) -> tuple:
        return (None, self.continuous_rebuild, self.policy is not None)

    def _sig_extra(self):
        return None

    def step(self, lookup_keys, ins_keys, ins_vals, del_keys,
             ins_mask=None, del_mask=None):
        """One step for all T tables: operands are [T, Q].  Returns (found,
        vals, ok_insert, ok_delete) [T, Q] on the engine's device (the
        caller's to keep)."""
        xs = self._inputs(lookup_keys, ins_keys, ins_vals, del_keys,
                          ins_mask, del_mask)
        if any(x.dim() != 2 or x.shape[0] != self.n_tables for x in xs):
            raise ValueError(f"stack engine operands are [{self.n_tables}, "
                             f"Q]")
        out = self._run_step(xs)
        self._stats.steps += 1
        self._stats.ops += xs[0].numel() + xs[1].numel() + xs[3].numel()
        if self.poll_every <= 1 or self._stats.steps % self.poll_every == 0:
            self._poll()
        return out

    def _device_step(self, lk, ik, iv, dk, im, dm):
        """The step on the device, no host read, every field written in
        place: lookup (counted, with a policy), insert, delete, one rebuild
        transition, the epoch swap (and, continuous, the next start), the
        policy's evaluation."""
        d, pol = self.state, self.policy
        if pol is None:
            found, vals = dhash.stack_lookup(d, lk)
        else:
            found, vals = dhash.stack_lookup_counted_(d, lk,
                                                      probe_hi=pol.probe_hi)
        _, ok_i = dhash.stack_insert(d, ik, iv, im)
        _, ok_d = dhash.stack_delete(d, dk, dm)
        go = dhash.stack_rebuild_step_(d, swap=True,
                                       start=self.continuous_rebuild)
        dhash.stack_finish_same_shape_(d, autostart=self.continuous_rebuild,
                                       go=go)
        if pol is not None:
            elastic.stack_policy_step(pol, d)
        return found, vals, ok_i, ok_d

    def _poll(self):
        """The one read: ``epoch[T]``."""
        epochs = self._read(self.state.epoch)
        self._last_poll_step = self._stats.steps
        self._stats.rebuilds_completed = sum(epochs) - self._epoch0

    @property
    def stats(self) -> EngineStats:
        """Engine statistics; reading them polls (one counted read) if the
        engine stepped since the last poll."""
        if self._stats.steps != self._last_poll_step:
            self._poll()
        return self._stats

    def request_rebuild(self, mask=None) -> None:
        """Start a rebuild on the selected tables ([T] bool; all by
        default), on the device: tables mid-rebuild are untouched (the
        paper's trylock: the request is lost for them)."""
        dhash.stack_autostart(self.state, mask)

    def lookup(self, keys):
        """Lookup outside the step ([T, Q] keys; never writes)."""
        return dhash.stack_lookup(self.state, self._tensor(keys, I32))

    def counts(self) -> np.ndarray:
        """[T] live-entry counts (one counted read)."""
        return np.asarray(self._read(dhash.stack_count_items(self.state)))
