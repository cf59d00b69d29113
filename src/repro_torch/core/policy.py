"""ElasticPolicy: watermark-driven grow/shrink decisions for DHash tables.

The rebuild machinery can *execute* a capacity change (live migration,
Lemma 4.1 ordered check); this module *decides* it, with the trigger set of
``small_hash.c``:

* **Load-factor watermarks with hysteresis.**  Grow when
  ``live > grow_load * slots``, shrink when
  ``live < grow_load / (expand_headroom * shrink_factor) * slots``.  The
  resize target is ``live * expand_headroom`` entries, which lands the
  post-resize load strictly between the watermarks for every power-of-two
  slot rounding the backends' ``make`` applies.
* **Expensive-lookup counter.**  ``DHashState`` carries ``lookups`` /
  ``expensive``, fed by ``dhash.lookup_counted`` (or the engine's in-place
  ``dhash.lookup_counted_``) from the probe-length telemetry of the
  backend's loc-emitting lookup; ``policy_step`` fires the growth trigger
  when the expensive fraction crosses ``enlarge_after / report_every``.
* **Adaptive nres_cap** (``adapt_nres_cap``), kept for parity with the
  reference: the Hopper kernels gather a grown new table in place, whatever
  its size, so the value is carried and unused.

Two execution modes:

* **resize mode** (``in_place=False``, single tables): ``policy_step``
  publishes a *plan* (``want_grow`` / ``want_shrink`` /
  ``target_capacity``) that the engine's host poll turns into a rebuild into
  a re-sized table; tombstone pressure alone fires a same-shape rehash on
  the device.
* **in-place mode** (``in_place=True``): every trigger fires the same-shape
  rehash, with an ``armed`` latch as the hysteresis.

The configuration is plain Python; the device state (``armed``,
``want_grow``, ``want_shrink``, ``target_capacity``, ``fires``) is scalar
tensors on one device, written IN PLACE by ``policy_step``, which reads
nothing on the host: the reference's ``lax.cond(fire, rebuild_autostart,
...)`` is the ``epoch_swap`` exchange on the device decision ``go = (False,
fire)`` (``dhash._epoch_``), so a step that runs it can be captured in a
CUDA graph.

A table stack takes a [T]-stacked policy (``stack``): ``stack_policy_step``
is the same arithmetic elementwise over [T], each table's fire one row of
one stacked ``epoch_swap`` call (in-place mode).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend as backends
from repro_torch.core import dhash
from repro_torch.core.distributed import route_cap, route_spill_cap
from repro_torch.core.struct_utils import map_tensors, state_dataclass

I32 = torch.int32

# small_hash.c trigger constants
MIN_EXPAND_WATERMARK_FACTOR = 2.0
SHRINK_WATERMARK_FACTOR = 4.0
EXPENSIVE_LOOKUP_THRESHOLD = 7
ENLARGE_DUE_TO_EXPENSIVE_LOOKUP_AFTER = 2
BETWEEN_LOOKUP_REPORT_COUNT = 10

@state_dataclass
class ElasticPolicy:
    """Elastic-capacity policy: configuration as plain values, decisions as
    scalar tensors on the table's device."""

    # -- configuration --
    grow_load: float        # high watermark as a load factor over slots
    expand_headroom: float  # MIN_EXPAND_WATERMARK_FACTOR: resize target is
                            # live * headroom entries
    shrink_factor: float    # SHRINK_WATERMARK_FACTOR: low watermark is
                            # high / (headroom * shrink_factor)
    probe_hi: int           # EXPENSIVE_LOOKUP_THRESHOLD (probe hops)
    enlarge_after: int      # ENLARGE_DUE_TO_EXPENSIVE_LOOKUP_AFTER
    report_every: int       # BETWEEN_LOOKUP_REPORT_COUNT
    min_lookups: int        # sample floor before the probe trigger may fire
    tomb_load: float        # tombstone fraction that fires a reclaim rehash
    min_capacity: int       # entries floor for shrink targets
    max_capacity: int       # entries ceiling for grow targets
    nres_cap_max: int       # adapt_nres_cap upper bound
    in_place: bool          # True: triggers fire same-shape rehashes only
    place_headroom: float   # in-place liveness guard for bounded-placement
                            # backends: a same-shape rehash only fires while
                            # live <= place_headroom * slots
    # -- device state --
    armed: torch.Tensor            # bool: hysteresis latch for fires
    want_grow: torch.Tensor        # bool: plan published for the host poll
    want_shrink: torch.Tensor      # bool
    target_capacity: torch.Tensor  # i32 entries (be.make units)
    fires: torch.Tensor            # i32: on-device autostart rehashes fired

    @property
    def device(self) -> torch.device:
        return self.fires.device


def make(*, grow_load: float = 0.7,
         expand_headroom: float = MIN_EXPAND_WATERMARK_FACTOR,
         shrink_factor: float = SHRINK_WATERMARK_FACTOR,
         probe_hi: int = EXPENSIVE_LOOKUP_THRESHOLD,
         enlarge_after: int = ENLARGE_DUE_TO_EXPENSIVE_LOOKUP_AFTER,
         report_every: int = BETWEEN_LOOKUP_REPORT_COUNT,
         min_lookups: int = 256, tomb_load: float = 0.25,
         min_capacity: int = 64, max_capacity: int = 1 << 22,
         nres_cap_max: int = 64, in_place: bool = False,
         place_headroom: float = 0.85,
         device: torch.device | str = "cuda") -> ElasticPolicy:
    """Fresh policy with the small_hash.c defaults (armed, no plan), its
    device state on ``device`` (the GPU unless the caller asks for the
    CPU)."""
    if not 0.0 < grow_load <= 1.0:
        raise ValueError(f"grow_load must be in (0, 1], got {grow_load}")
    if expand_headroom <= 1.0 or shrink_factor <= 1.0:
        raise ValueError("expand_headroom and shrink_factor must exceed 1 "
                         "(the hysteresis band would be empty)")
    if not 0.0 < place_headroom <= 1.0:
        raise ValueError(f"place_headroom must be in (0, 1], "
                         f"got {place_headroom}")

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=device)

    return ElasticPolicy(
        grow_load=grow_load, expand_headroom=expand_headroom,
        shrink_factor=shrink_factor, probe_hi=probe_hi,
        enlarge_after=enlarge_after, report_every=report_every,
        min_lookups=min_lookups, tomb_load=tomb_load,
        min_capacity=min_capacity, max_capacity=max_capacity,
        nres_cap_max=nres_cap_max, in_place=in_place,
        place_headroom=place_headroom,
        armed=scalar(True, torch.bool),
        want_grow=scalar(False, torch.bool),
        want_shrink=scalar(False, torch.bool),
        target_capacity=scalar(min_capacity, I32),
        fires=scalar(0, I32))


def stack(pol: ElasticPolicy, n_tables: int) -> ElasticPolicy:
    """A [T]-stacked copy of a policy (one latch and plan a table), for a
    ``dhash.make_stack`` state."""
    return map_tensors(lambda x: torch.stack([x] * n_tables), pol)


def watermarks(pol: ElasticPolicy, slots: int) -> tuple[int, int]:
    """(high, low) live-entry watermarks for a table with ``slots`` slots —
    the small_hash.c ``set_watermarks`` math in load-factor terms."""
    high = int(slots * pol.grow_load)
    low = int(slots * pol.grow_load / (pol.expand_headroom * pol.shrink_factor))
    return high, low


@torch.no_grad()
def policy_step(pol: ElasticPolicy, d: dhash.DHashState, *,
                allow_autostart: bool = True):
    """One policy evaluation on the device, IN PLACE on ``pol`` and ``d``,
    with no host read.  Returns ``(pol, d)`` (the same containers).

    Reads the table's occupancy (live / tombstones, exact O(C) reductions)
    and the probe counters, evaluates the trigger set, and either fires a
    same-shape rebuild start (in-place mode, or tombstone reclaim in resize
    mode) or publishes a grow/shrink plan for the engine's host poll.  All
    decisions are gated on ``~d.rebuilding``.  The fire is the
    ``epoch_swap`` exchange on ``go = (False, fire)``: the reference's
    ``rebuild_autostart`` under its ``lax.cond``, decided on the device.

    ``allow_autostart=False`` suppresses the rebuild start (plan only) —
    the engine passes it while old/new differ in shape mid-resize; with
    ``True`` the two tables must share shapes."""
    fire = _evaluate(pol, d)
    if allow_autostart:
        dhash._epoch_(d, swap=False, start=True,
                      go=torch.stack([torch.zeros_like(fire), fire]))
    return pol, d


@torch.no_grad()
def stack_policy_step(pol: ElasticPolicy, d: dhash.DHashState):
    """``policy_step`` over a [T] table stack and a [T] policy stack
    (``stack``), IN PLACE, in-place mode: each table fires its own
    same-shape rehash under its own latch, the fires one stacked
    ``epoch_swap`` on go[:, 1] = fire.  Returns ``(pol, d)``."""
    dhash.stack_autostart(d, _evaluate(pol, d))
    return pol, d


def _evaluate(pol: ElasticPolicy, d: dhash.DHashState) -> torch.Tensor:
    """The trigger set over one table or a stack (elementwise over [T]):
    writes the policy's state and the consumed probe window in place and
    returns ``fire``, for the caller to start the rehash on."""
    be = backends.get(d.backend)
    slots = be.capacity_of(d.old)          # host int (table metadata)
    live = be.count_live(d.old).to(I32)
    tombs = be.count_tomb(d.old).to(I32)
    high, low = watermarks(pol, slots)

    idle = ~d.rebuilding
    over = live > high
    under = live < low
    sampled = d.lookups >= pol.min_lookups
    # expensive/lookups >= enlarge_after/report_every, in int32 (wrapping as
    # the reference's does)
    probe_hot = sampled & (d.expensive * pol.report_every
                           >= d.lookups * pol.enlarge_after)
    tomb_hot = tombs > int(slots * pol.tomb_load)
    # re-arm once the load has drained back inside the band (and the probe
    # telemetry is quiet); gated on idle: mid-epoch extraction empties the
    # OLD table, and that transient low count must not re-arm the latch
    rearm = idle & (live <= int(high / pol.expand_headroom)) & ~probe_hot
    armed = pol.armed | rearm

    # the reference computes the target in float32
    target = torch.clamp(
        torch.ceil(live.to(torch.float32) * pol.expand_headroom).to(I32),
        pol.min_capacity, pol.max_capacity)

    if pol.in_place:
        fire = idle & armed & (over | probe_hot | tomb_hot)
        if be.bounded_placement:
            # liveness guard: a same-shape rehash of a near-saturated
            # bounded-placement table can strand keys in the hazard buffer
            fire = fire & (live <= int(slots * pol.place_headroom))
        want_grow = idle & (over | probe_hot)
        want_shrink = idle & under
    else:
        # grow/shrink are host-applied resizes (the plan); only tombstone
        # pressure fires the on-device same-shape rehash
        fire = idle & armed & tomb_hot & ~over & ~under
        want_grow = idle & (over | probe_hot)
        want_shrink = idle & under & ~probe_hot

    # a fire consumes the probe sample window
    d.lookups.copy_(torch.where(fire, 0, d.lookups))
    d.expensive.copy_(torch.where(fire, 0, d.expensive))
    pol.armed.copy_(armed & ~fire)
    pol.want_grow.copy_(want_grow)
    pol.want_shrink.copy_(want_shrink)
    pol.target_capacity.copy_(target)
    pol.fires.add_(fire.to(I32))
    return fire


# ---------------------------------------------------------------------------
# host-side helpers (plain Python / numpy — used at poll boundaries)
# ---------------------------------------------------------------------------

def adapt_nres_cap(pol: ElasticPolicy, old_slots: int, new_slots: int, *,
                   base: int) -> int:
    """Tile-map residency for a rebuild into ``new_slots``: ~``new/old``
    new-table blocks a query tile (+1 for window straddle), bounded by the
    policy's ``nres_cap_max``, never below ``base``.  Carried in
    ``DHashState.nres_cap`` for parity with the reference."""
    ratio = -(-int(new_slots) // max(int(old_slots), 1))
    return int(min(max(base, ratio + 1), pol.nres_cap_max))


def resolve_slots(be: backends.BucketBackend, target_entries: int) -> int:
    """Host: slot count ``be.make(target_entries)`` would allocate."""
    if be.slots_for is not None:
        return int(be.slots_for(int(target_entries)))
    probe = be.make(int(target_entries), 0, device="cpu")
    return int(be.capacity_of(probe))


def rehash_wanted(live_load, tomb_load, armed, rebuilding, *,
                  grow_load: float,
                  expand_headroom: float = MIN_EXPAND_WATERMARK_FACTOR,
                  tomb_load_hi: float = 0.25):
    """Host-side armed rehash trigger over load factors (numpy arrays or
    scalars).  Returns ``(want, armed')``: fire when armed and either the
    live load crossed ``grow_load`` or tombstones crossed ``tomb_load_hi``;
    re-arm only once the live load drains below
    ``grow_load / expand_headroom``."""
    live_load = np.asarray(live_load)
    tomb_load = np.asarray(tomb_load)
    armed = np.asarray(armed, bool)
    rebuilding = np.asarray(rebuilding, bool)
    hot = (live_load > grow_load) | (tomb_load > tomb_load_hi)
    want = armed & hot & ~rebuilding
    rearm = live_load <= grow_load / expand_headroom
    return want, (armed | rearm) & ~want


class RouteCapController:
    """Spill-feedback adaptive routing cap (host-side, poll boundaries): an
    EWMA of slab occupancy (spill per poll over the slab width the current
    cap implies at the reference batch ``q_ref``) walks ``cap_factor`` along
    a geometric ladder — up by ``step`` above ``occ_hi`` (held for
    ``cooldown`` consecutive polls) or at once on any drop, down below
    ``occ_lo`` — with ``cooldown`` quiet polls after a move.
    ``occ_hi / occ_lo`` must exceed ``step`` (no flap by construction)."""

    def __init__(self, *, n_shards: int, q_ref: int,
                 cap_factor: float = 2.0, spill_slack: float = 1.0,
                 occ_hi: float = 0.85, occ_lo: float = 0.15,
                 ewma: float = 0.5, step: float = 1.5,
                 cap_min: float = 1.0, cap_max: float | None = None,
                 cooldown: int = 2):
        if not 0.0 < occ_lo < occ_hi <= 1.0:
            raise ValueError(f"need 0 < occ_lo < occ_hi <= 1, "
                             f"got ({occ_lo}, {occ_hi})")
        if step <= 1.0:
            raise ValueError(f"ladder step must exceed 1, got {step}")
        if occ_hi / occ_lo <= step:
            raise ValueError("watermark band occ_hi/occ_lo must exceed the "
                             "ladder step or moves could flap")
        self.n_shards = int(n_shards)
        self.q_ref = int(q_ref)
        self.cap_factor = float(cap_factor)
        self.spill_slack = float(spill_slack)
        self.occ_hi, self.occ_lo = float(occ_hi), float(occ_lo)
        self.ewma_alpha = float(ewma)
        self.step = float(step)
        self.cap_min = float(cap_min)
        # cap_factor = S means cap = Q: the overflow-proof full width
        self.cap_max = float(n_shards if cap_max is None else cap_max)
        self.cooldown = int(cooldown)
        self.occ = 0.0              # slab-occupancy EWMA (reseeds on a move)
        self.grows = self.shrinks = self.flaps = 0
        self._seeded = False
        self._spill_prev = self._drop_prev = 0
        self._since_move = self.cooldown + 1    # free to move at first poll
        self._last_dir = 0
        self._hi_streak = self._lo_streak = 0   # consecutive beyond-watermark

    def _slab_width(self) -> int:
        cap = route_cap(self.cap_factor, self.q_ref, self.n_shards)
        return route_spill_cap(self.q_ref, cap, self.spill_slack)

    def update(self, spill_total, dropped_total=0) -> float:
        """Feed one poll of the CUMULATIVE spill/drop counters; returns the
        cap_factor to run with."""
        spill_total, dropped_total = int(spill_total), int(dropped_total)
        d_spill = spill_total - self._spill_prev
        d_drop = dropped_total - self._drop_prev
        self._spill_prev, self._drop_prev = spill_total, dropped_total
        occ = d_spill / max(self._slab_width(), 1)
        a = self.ewma_alpha
        self.occ = occ if not self._seeded else (1 - a) * self.occ + a * occ
        self._seeded = True
        self._since_move += 1

        if self.occ > self.occ_hi:
            self._hi_streak += 1
            self._lo_streak = 0
        elif self.occ < self.occ_lo:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = self._lo_streak = 0

        direction = 0
        if d_drop > 0:
            direction = +1                       # bypasses cooldown + streak
        elif self._since_move > self.cooldown:
            if self._hi_streak >= max(self.cooldown, 1):
                direction = +1
            elif self._lo_streak >= max(self.cooldown, 1):
                direction = -1
        if direction > 0:
            new = min(self.cap_factor * self.step, self.cap_max)
        elif direction < 0:
            new = max(self.cap_factor / self.step, self.cap_min)
        else:
            new = self.cap_factor
        if new != self.cap_factor:
            # a flap is a REVERSAL at the first eligible poll after a move
            if direction == -self._last_dir and \
                    self._since_move <= self.cooldown + 1:
                self.flaps += 1
            if direction > 0:
                self.grows += 1
            else:
                self.shrinks += 1
            self._last_dir = direction
            self._since_move = 0
            self._hi_streak = self._lo_streak = 0
            self._seeded = False   # occupancy is defined by the NEW widths
            self.cap_factor = new
        return self.cap_factor

    def in_band(self) -> bool:
        """The occupancy EWMA sits inside the watermark band."""
        return self.occ_lo <= self.occ <= self.occ_hi
