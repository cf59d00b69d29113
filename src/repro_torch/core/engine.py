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

Host synchronisations.  PyTorch runs eagerly, so "land or extract?" and
"swap now?" are host branches.  The engine keeps ``rebuilding`` as a host
flag (every change of it is a decision the engine itself takes) and, on a
step inside a rebuild epoch, reads ONE small flags tensor from the device
(hazard pending, cursor, rebuilding) after the deletes.  ``done`` needs the
hazard state after the transition, so the steps on which the cursor has
reached the end of the table — the last extract and the landing(s) after it,
two or three steps an epoch — read one more flag.  Steps outside a rebuild
epoch read nothing.  Every read is counted in ``EngineStats.host_syncs``.
The reference's budget of zero reads between polls is therefore not met yet.

Only a *shape-changing* rebuild (a user-supplied ``new_table`` with a
different capacity) is finished by the K-step poll, as in the reference — up
to K-1 steps late, which is safe because a completed-but-unswapped rebuild
still answers every op correctly through the ordered check.

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

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def rebuilding(self) -> bool:
        """Whether a rebuild epoch is in progress (host flag, no read)."""
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

        d, rb = self.state, self._rebuilding
        found, vals = dhash.lookup(d, lk, rebuilding=rb)
        d, ok_i = dhash.insert(d, ik, iv, im, rebuilding=rb)
        d, ok_d = dhash.delete(d, dk, dm, rebuilding=rb)
        self.state = d
        swap = self._swap_on_device()
        if rb:
            self._rebuild_transition(swap)
        if swap and self.continuous_rebuild and not self._rebuilding:
            self.state = dhash.rebuild_autostart(self.state, rebuilding=False)
            self._rebuilding = True

        self._stats.steps += 1
        self._stats.ops += lk.numel() + ik.numel() + dk.numel()
        if self.poll_every <= 1 or self._stats.steps % self.poll_every == 0:
            self._poll()
        return found, vals, ok_i, ok_d

    def _rebuild_transition(self, swap: bool):
        """``rebuild_step`` + ``finish_same_shape`` on host-read flags."""
        d = self.state
        pending, cursor, rebuilding = self._read(torch.stack([
            d.hazard_live.any().to(I32), d.cursor, d.rebuilding.to(I32)]))
        if not rebuilding:
            raise RuntimeError("engine.state was changed outside the engine")
        d = dhash.rebuild_step(d, hazard_pending=bool(pending),
                               rebuilding=True)
        self._stats.rebuild_transitions += 1
        if swap:
            cap = dhash._be(d).capacity_of(d.old)
            if not pending:
                cursor = min(cursor + d.chunk, cap)
            # done = cursor at the end AND the hazard buffer empty after the
            # transition: only then is a second flag worth reading
            if cursor >= cap and self._read(dhash.rebuild_done(d)):
                d = dhash.finish_same_shape(d, done=True)
                self._rebuilding = False
                self._stats.rebuilds_completed += 1
        self.state = d

    # -- host-side polling (1 of every K steps) ------------------------------

    def _poll(self):
        """Finish a shape-changing rebuild; (re)start a rebuild in continuous
        mode if the in-step autostart could not (shape-changing tables)."""
        if self._rebuilding and not self._swap_on_device():
            if self._read(dhash.rebuild_done(self.state)):
                self.state = dhash.rebuild_finish(self.state, done=True)
                self._rebuilding = False
                self._stats.rebuilds_completed += 1
        if self.continuous_rebuild and not self._rebuilding:
            self.request_rebuild()

    @property
    def stats(self) -> EngineStats:
        """Engine statistics; kept on the host, so reading them costs no
        device read."""
        return self._stats

    def request_rebuild(self, *, seed: int | None = None, new_table=None):
        """Begin a live rebuild (fails like the paper's trylock if one is
        already in progress).  ``new_table`` is cloned: the engine owns what
        it writes."""
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
