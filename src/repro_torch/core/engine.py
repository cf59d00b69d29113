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
function on the device).  With a ``fused`` state every op in the step is a
hand-written CUDA kernel launch plus plain tensor glue.

Host synchronisations.  A step is split as the reference's is: the host
converts the inputs, ``_device_step`` (the counterpart of the reference's
jitted ``fused``) runs the whole step on the device, and the host keeps its
books and, one step in ``poll_every``, polls.  Every ``lax.cond`` the
reference puts on the step is a decision taken on the device: the transition
is ``dhash.rebuild_step_`` (the landing runs every step and inserts nothing
when no hazard entry is live; one transition launch then does the landing's
bookkeeping, scans only where the device flags allow and decides the epoch
swap and the next rebuild's start), the swap and the start are one
``epoch_swap`` exchange on that decision (``dhash.finish_same_shape_``), and
the cuckoo kick-out is a kernel with its own guard.  ``_device_step`` reads
nothing from the device and writes every field of the state in place, so it
can be captured in a CUDA graph.  The host keeps ``rebuilding`` as a flag of
its own: in continuous-rebuild mode the swap and the next start happen in
one step, so it is true at every step boundary; otherwise a rebuild epoch
that ends on the device between polls leaves it stale until the poll, and
the epoch's inserts pick their table on the device
(``dhash.insert_by_flag``), while lookups and deletes stay right on the
epoch path (the standby holds nothing LIVE).  The poll is the one read:
``(epoch, rebuilding, done)`` in one small tensor, counted in
``EngineStats.host_syncs``, from which ``rebuilds_completed`` is refreshed,
as in the reference.  Steps between polls read nothing.

Only a *shape-changing* rebuild (a user-supplied ``new_table`` with a
different capacity) is finished by the K-step poll, as in the reference — up
to K-1 steps late, which is safe because a completed-but-unswapped rebuild
still answers every op correctly through the ordered check; its transitions
run on the device all the same.

Ownership: the engine CLONES the state it is given and then owns the clone:
a fused state's tables are updated in place, step after step.  Read
``engine.state`` freely; never write it or pass it to a mutating ``dhash``
function.

The elastic policy and ``DHashStackEngine`` of the reference are not ported
yet: ``policy=`` is accepted only as ``None``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from repro_torch.core import dhash
from repro_torch.core.struct_utils import assign_

I32 = torch.int32

DEFAULT_POLL_EVERY = 32


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
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _clone_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


@dataclass
class DHashEngine:
    """Drives a DHashState: user op batches + background rebuild progress."""

    state: dhash.DHashState
    continuous_rebuild: bool = False   # paper Fig 2: rebuild forever
    rebuild_seed: int = 1234
    poll_every: int = DEFAULT_POLL_EVERY   # host polls 1 of every K steps
    policy: None = None                # elastic policy: not ported yet
    _stats: EngineStats = field(default_factory=EngineStats, repr=False)
    _rebuilding: bool = field(default=False, init=False, repr=False)
    _epoch0: int = field(default=0, init=False, repr=False)
    _last_poll_step: int = field(default=0, init=False, repr=False)

    def __post_init__(self):
        if self.policy is not None:
            raise NotImplementedError(
                "the elastic capacity policy (core/policy.py of the "
                "reference) is not ported yet: it comes with the port of "
                "policy_step, its telemetry-driven actions and resizes; "
                "pass policy=None")
        # take ownership: the fused ops write the tables in place, so the
        # engine must not share a tensor with the caller
        self.state = _clone_tree(self.state)
        self._rebuilding = bool(self.state.rebuilding)
        self._epoch0 = int(self.state.epoch)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def rebuilding(self) -> bool:
        """Whether a rebuild epoch is in progress, as the host last knew it
        (no read; in non-continuous mode it may stay True for up to
        ``poll_every - 1`` steps after the epoch ended on the device)."""
        return self._rebuilding

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

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _read(self, t: torch.Tensor) -> list:
        """One counted device->host read."""
        self._stats.host_syncs += 1
        return t.tolist()

    def step(self, lookup_keys, ins_keys, ins_vals, del_keys,
             ins_mask=None, del_mask=None):
        """One engine step; returns (found, vals, ok_insert, ok_delete) as
        tensors on the engine's device."""
        lk = self._tensor(lookup_keys, I32)
        ik = self._tensor(ins_keys, I32)
        iv = self._tensor(ins_vals, I32)
        dk = self._tensor(del_keys, I32)
        im = None if ins_mask is None else self._tensor(ins_mask, torch.bool)
        dm = None if del_mask is None else self._tensor(del_mask, torch.bool)

        self._stats.rebuild_transitions += self._rebuilding
        out = self._device_step(lk, ik, iv, dk, im, dm)
        if self._swap_on_device() and self.continuous_rebuild:
            self._rebuilding = True     # swapped and restarted, or running
        self._stats.steps += 1
        self._stats.ops += lk.numel() + ik.numel() + dk.numel()
        if self.poll_every <= 1 or self._stats.steps % self.poll_every == 0:
            self._poll()
        return out

    def _device_step(self, lk, ik, iv, dk, im=None, dm=None):
        """The step on the device — lookup, insert, delete, one rebuild
        transition, the epoch swap and (continuous rebuild) the next start —
        with no host read and every state field written in place: the
        counterpart of the reference's jitted step and the unit a CUDA graph
        captures.  Which kernels it launches depends only on host flags
        (``rebuilding`` as the host knows it, the mode, the tables' shapes).
        Returns (found, vals, ok_insert, ok_delete)."""
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

    # -- host-side polling (1 of every K steps) ------------------------------

    def _poll(self):
        """One read of (epoch, rebuilding, done): refresh the host flag and
        ``rebuilds_completed``; finish a shape-changing rebuild; (re)start a
        rebuild in continuous mode if the in-step autostart could not
        (shape-changing tables)."""
        d = self.state
        epoch, rebuilding, done = self._read(torch.stack([
            d.epoch, d.rebuilding.to(I32), dhash.rebuild_done(d).to(I32)]))
        if done:
            # only reachable when the in-step swap was not applicable
            self.state = dhash.rebuild_finish(d, done=True)
            epoch, rebuilding = epoch + 1, False
        self._rebuilding = bool(rebuilding)
        self._stats.rebuilds_completed = epoch - self._epoch0
        self._last_poll_step = self._stats.steps
        if self.continuous_rebuild and not self._rebuilding:
            self.request_rebuild()

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
        already in progress).  Where the host flag may be stale (an epoch
        that ended on the device since the last poll) the device's flag is
        read, counted.  ``new_table`` is cloned: the engine owns what it
        writes."""
        if self._rebuilding and self._swap_on_device() \
                and not self.continuous_rebuild:
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
        return dhash.lookup(self.state, self._tensor(keys, I32),
                            rebuilding=self._rebuilding)

    def count(self) -> int:
        return int(self._read(dhash.count_items(self.state)))
