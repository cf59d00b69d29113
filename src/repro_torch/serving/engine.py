"""Serving engine: continuous batching over a DHash-paged KV cache.

Host-side driver, as the reference's:

* fixed-slot continuous batching: finished sequences free their pages and
  the slot is re-admitted from the queue on the same step boundary;
* prefix-cache admission: the longest cached block prefix is reused;
* live rehash: when the page table's load or tombstone share crosses the
  trigger (``core.policy.rehash_wanted``), the engine starts a DHash
  rebuild and every decode step advances it one transition;
* multi-tenant page tables (``ServeConfig.n_tenants > 1``): a per-tenant
  table stack (tenant = seq_id % n_tenants) whose rehash epochs run and
  swap independently on the device.

The step is eager (the reference jits it): ``paged_decode_step`` runs the
layers in a host loop, writes each layer's K/V into the page pool and
attends over DHash-resolved pages.  It rotates with ``apply_rope`` where
the reference's does, on an M-RoPE configuration (qwen2-vl) too: a text
token's three position streams are equal, so this is ``apply_mrope``
exactly (ROADMAP C).  The engine serves attention stacks only: mamba2,
RWKV6 and zamba2's shared block raise ``NotImplementedError``, as do
experts (ROADMAP C).  The engine's work runs under
``torch.inference_mode`` (no autograd bookkeeping: a host-bound step's
dispatch cost falls by about a quarter); tensors it makes are inference
tensors, which a caller may read but not write in place outside that
mode.  Neither it nor ``kvcache.rehash_step``
reads the host.  The engine's host reads are the reference's: the argmax of
a sampling step and one poll a step (``host_reads`` counts them), plus
admission's with the prefix cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dhash
from repro_torch.core import policy as elastic
from repro_torch.models import transformer
from repro_torch.models.attention import project_qkv
from repro_torch.models.layers import (apply_rope, embed, rms_norm,
                                      rope_angles, swiglu)
from repro_torch.serving import kvcache, prefix_cache
from repro_torch.serving.kvcache import PagedKV

F32 = torch.float32
I32 = torch.int32


@dataclass(frozen=True)
class ServeConfig:
    max_seqs: int = 8
    page_size: int = 16
    n_pages: int = 512
    max_blocks: int = 64          # per-seq block bound (= max_len / page_size)
    max_new_tokens: int = 32
    rehash_load_factor: float = 0.7
    n_tenants: int = 1            # > 1: per-tenant page-table stack
    cap_factor: float = 2.0       # tenant-router cap c (<= 0: full width)
    spill_slack: float = 1.0      # spill-slab budget (kvcache.make)
    adaptive_cap: bool = False    # a RouteCapController adapts cap_factor
                                  # at poll boundaries (multi-tenant only)
    prefix_cache: bool = False    # block-prefix reuse + LRU page eviction
    prefix_backend: str = "linear"  # fingerprint-index backend
    prefix_capacity: int = 0      # fingerprint-index capacity (0: 4*n_pages)
    evict_batch: int = 8          # max victims per evict-on-pressure pass
    prefix_kw: tuple = ()         # extra backend kwargs as (key, value) pairs


@torch.inference_mode()
def paged_decode_step(params: dict, cfg: ArchConfig, kv: PagedKV,
                      seq_ids: torch.Tensor, tokens: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor,
                      n_blocks: int):
    """One decode step for all slots. tokens/lengths/active: [B].
    Returns (logits [B, V] float32, kv'); the pools and tables are written
    in place.  Reads nothing from the host."""
    x = embed(tokens[:, None], params["embed"], scale=cfg.embed_scale)
    positions = lengths[:, None]                            # [B,1]
    layers = transformer.layer_params(params["attn_stack"])
    flags = transformer._attn_flags(cfg)
    safe_ids = torch.where(active, seq_ids, 0)

    # page-table work is layer-independent: allocate the new block (if the
    # position opens one) and resolve the write target ONCE
    ps = kv.page_size
    blk, off = lengths // ps, lengths % ps
    kv, _ = kvcache.alloc_pages(kv, safe_ids, blk, active & (off == 0))
    pages_w, found_w = kvcache.resolve_blocks_at(kv, safe_ids, blk)
    # an inactive slot writes the sink page, never a live one
    pg = torch.where(found_w & active, pages_w, kv.n_pages).long()
    off = off.long()
    angles = {th: rope_angles(positions, th, cfg.head_dim)
              for th in set(flags["theta"])}

    for layer, (window, theta) in enumerate(zip(flags["window"],
                                                flags["theta"])):
        p = layers[layer]
        h = rms_norm(x, p["ln1"])
        qkn = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else None
        q, k, v = project_qkv(h, p["wq"], p["wk"], p["wv"], qk_norm_scale=qkn)
        q = apply_rope(q, positions, theta, angles[theta])
        k = apply_rope(k, positions, theta, angles[theta])
        kv.pool_k[layer, pg, off] = k[:, 0]
        kv.pool_v[layer, pg, off] = v[:, 0]
        o = kvcache.paged_decode_attention(
            kv, layer, q[:, 0], safe_ids, lengths + 1, n_blocks,
            window=window, softcap=cfg.attn_softcap)
        x = x + transformer.out_proj(o, p["wo"])[:, None]
        h2 = rms_norm(x, p["ln2"])
        x = x + swiglu(h2, p["wg"], p["wu"], p["wd"])
    x = rms_norm(x, params["final_norm"])
    w = transformer.unembed_matrix(params, cfg)
    logits = (x @ w).to(F32)[:, 0]
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, kv


@dataclass
class ServingEngine:
    params: dict
    cfg: ArchConfig
    sc: ServeConfig
    kv: PagedKV = None
    queue: list = field(default_factory=list)     # [(seq_id, prompt array)]
    finished: dict = field(default_factory=dict)  # seq_id -> list[int]
    rehashes: int = 0
    router_spills: int = 0        # cumulative tenant-router overflow keys
    router_drops: int = 0         # cumulative keys a compact slab dropped
    cap_ctl: elastic.RouteCapController | None = None  # adaptive cap loop
    cache_lookups: int = 0        # prefix cache: blocks probed at admission
    cache_hits: int = 0           # prefix cache: blocks adopted
    publishes: int = 0            # prefix cache: blocks published
    host_reads: int = 0           # device -> host reads the engine made
    _next_id: int = 1

    def __post_init__(self):
        c, s = self.cfg, self.sc
        transformer.check_supported(c)
        if set(c.blocks) - {"attn", "local"} or c.shared_attn_every:
            # mamba2 / RWKV6 states are not paged, and a shared block's
            # caches follow the mamba groups: no attention stack to page
            raise NotImplementedError(
                f"{c.arch_id}: the paged engine pages an attention stack; "
                f"blocks {sorted(set(c.blocks))}"
                + (" with a shared attention block" if c.shared_attn_every
                   else "")
                + "; decode them with model.decode_logits")
        if c.n_experts:
            # the reference's paged step applies the dense MLP in every
            # layer and so serves no experts (ROADMAP C)
            raise NotImplementedError(
                f"{c.arch_id}: the paged decode step has no expert block; "
                f"decode it with model.decode_logits (ROADMAP C)")
        self.device = self.params["embed"].device
        self.kv = kvcache.make(c.n_layers, s.page_size, s.n_pages,
                               c.n_kv_heads, c.head_dim,
                               max_blocks=s.max_blocks,
                               dtype=transformer.dtype_of(c.dtype),
                               n_tenants=s.n_tenants, cap_factor=s.cap_factor,
                               spill_slack=s.spill_slack,
                               prefix_cache=s.prefix_cache,
                               prefix_backend=s.prefix_backend,
                               prefix_capacity=s.prefix_capacity or None,
                               evict_batch=s.evict_batch,
                               prefix_kw=dict(s.prefix_kw),
                               device=self.device)
        self._tenant_epochs0 = (np.array(self.kv.table.epoch.cpu())
                                if s.n_tenants > 1 else None)
        # armed hysteresis latches for the elastic rehash trigger
        self._armed = True
        self._tenant_armed = np.ones((s.n_tenants,), bool)
        if s.n_tenants > 1 and s.adaptive_cap:
            # q_ref is the worst routed batch the engine issues
            # (free_sequences routes max_blocks keys a finished sequence)
            self.cap_ctl = elastic.RouteCapController(
                n_shards=s.n_tenants, q_ref=s.max_seqs * s.max_blocks,
                cap_factor=s.cap_factor, spill_slack=s.spill_slack)
        b = s.max_seqs
        self.seq_ids = np.zeros((b,), np.int32)
        self.lengths = np.zeros((b,), np.int32)
        self.active = np.zeros((b,), bool)
        self.cur_tok = np.zeros((b,), np.int32)
        self.new_count = np.zeros((b,), np.int32)
        self.outputs: dict[int, list[int]] = {}

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _read(self, x: torch.Tensor) -> np.ndarray:
        """One device -> host read (counted); a copy, never a view of a
        tensor the engine goes on writing in place."""
        self.host_reads += 1
        return np.array(x.cpu())

    # -- request lifecycle ---------------------------------------------------
    def submit(self, prompt: list[int], tenant: int | None = None) -> int:
        """Queue a prompt; an optional ``tenant`` pins the request to a
        tenant by advancing the id to the right residue class."""
        sid = self._next_id
        if tenant is not None and self.sc.n_tenants > 1:
            sid += (tenant - sid) % self.sc.n_tenants
        self._next_id = sid + 1
        self.queue.append((sid, np.asarray(prompt, np.int32)))
        return sid

    @torch.inference_mode()
    def _admit(self):
        for slot in np.where(~self.active)[0]:
            if not self.queue:
                break
            sid, prompt = self.queue.pop(0)
            self._prefill(slot, sid, prompt)

    def _prefill(self, slot: int, sid: int, prompt: np.ndarray):
        """Prefill token by token through the paged step, only THIS slot
        active.  With the prefix cache, admission first adopts the longest
        cached block prefix and publishes the freshly prefilled full blocks
        at the end (only blocks covered by ``prompt[:-1]``)."""
        self.seq_ids[slot] = sid
        self.new_count[slot] = 0
        self.outputs[sid] = []
        start, fps, valid = 0, None, None
        if self.kv.prefix is not None:
            ps = self.sc.page_size
            n_pub = (len(prompt) - 1) // ps
            pad = np.zeros((self.sc.max_blocks * ps,), np.int32)
            pad[:len(prompt)] = prompt
            fps = prefix_cache.prefix_fingerprints(self._dev(pad)[None], ps)[0]
            valid = torch.arange(self.sc.max_blocks,
                                 device=self.device) < n_pub
            sid_t = self._dev(np.int32(sid))
            self.kv, n_adopt, _ = kvcache.adopt_prefix(self.kv, sid_t, fps,
                                                       valid)
            n_adopt = int(self._read(n_adopt))
            self.cache_lookups += n_pub
            self.cache_hits += n_adopt
            start = n_adopt * ps
        self.lengths[slot] = start
        saved = self.active.copy()
        self.active[:] = False
        self.active[slot] = True
        for t in prompt[start:-1]:
            self.cur_tok[slot] = t
            self._run_slots(sample=False)
        if self.kv.prefix is not None:
            self.kv, n_ok = kvcache.publish_blocks(self.kv, sid_t, fps, valid)
            self.publishes += int(self._read(n_ok))
        self.active = saved
        self.active[slot] = True
        self.cur_tok[slot] = prompt[-1]

    # -- stepping -------------------------------------------------------------
    @torch.inference_mode()
    def _run_slots(self, sample: bool = True):
        logits, self.kv = paged_decode_step(
            self.params, self.cfg, self.kv, self._dev(self.seq_ids),
            self._dev(self.cur_tok), self._dev(self.lengths),
            self._dev(self.active), self.sc.max_blocks)
        self.lengths = np.where(self.active, self.lengths + 1, self.lengths)
        self.kv = kvcache.rehash_step(self.kv)    # background rebuild progress
        if sample:
            return self._read(torch.argmax(logits, -1).to(I32))
        return None

    @torch.inference_mode()
    def step(self):
        """One engine step: decode all active slots, harvest, admit."""
        self._admit()
        if not self.active.any():
            return False
        nxt = self._run_slots(sample=True)
        for slot in np.where(self.active)[0]:
            sid = int(self.seq_ids[slot])
            self.outputs[sid].append(int(nxt[slot]))
            self.cur_tok[slot] = nxt[slot]
            self.new_count[slot] += 1
            done = (self.new_count[slot] >= self.sc.max_new_tokens
                    or int(self.lengths[slot])
                    >= self.sc.max_blocks * self.sc.page_size - 1)
            if done:
                self.finished[sid] = self.outputs.pop(sid)
                self.kv = kvcache.free_sequences(
                    self.kv, self._dev(np.asarray([sid], np.int32)),
                    self.sc.max_blocks)
                self.active[slot] = False
        self._maybe_rehash()
        return True

    @torch.inference_mode()
    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self.active.any()) and steps < max_steps:
            self.step()
            steps += 1
        return steps

    # -- live rehash ----------------------------------------------------------
    def _maybe_rehash(self):
        """Elastic rehash trigger (``core.policy.rehash_wanted``), latched
        by an armed-hysteresis bit so a hot table rehashes once per
        excursion.  One poll, one host read."""
        if self.sc.n_tenants > 1:
            return self._maybe_rehash_tenants()
        t = self.kv.table
        live, tomb = kvcache.table_health(self.kv)
        live, tomb, rebuilding, done = self._read(torch.stack([
            live.to(F32), tomb.to(F32), t.rebuilding.to(F32),
            dhash.rebuild_done(t).to(F32)])).tolist()
        if rebuilding:
            if done:
                self.kv = kvcache.replace(
                    self.kv, table=dhash.rebuild_finish(t, done=True))
                self.rehashes += 1
            return
        want, self._armed = elastic.rehash_wanted(
            live, tomb, self._armed, False,
            grow_load=self.sc.rehash_load_factor)
        if want:
            self.kv = kvcache.replace(
                self.kv, table=dhash.rebuild_start(t, seed=self.rehashes + 1))

    def _maybe_rehash_tenants(self):
        """Per-tenant elastic rehash over the page-table stack: each tenant
        has its own armed latch; completed epochs swap on the device inside
        ``kvcache.rehash_step``.  ``rehashes`` counts completions (epoch
        deltas).  The same poll surfaces the router's spill / drop counters
        and, with ``sc.adaptive_cap``, feeds the ``RouteCapController``."""
        n = self.sc.n_tenants
        t = self.kv.table
        loads, tombs = kvcache.table_health(self.kv)
        poll = self._read(torch.cat([
            loads.to(torch.float64), tombs.to(torch.float64),
            self.kv.route_spill.to(torch.float64),
            self.kv.route_drop.to(torch.float64),
            t.rebuilding.to(torch.float64), t.epoch.to(torch.float64)]))
        loads, tombs, spill, drop, rebuilding, epochs = poll.reshape(6, n)
        self.router_spills = int(spill.sum())
        self.router_drops = int(drop.sum())
        self.rehashes = int((epochs.astype(np.int64)
                             - self._tenant_epochs0).sum())
        if self.cap_ctl is not None:
            new_cap = self.cap_ctl.update(self.router_spills,
                                          self.router_drops)
            if new_cap != self.kv.cap_factor:
                self.kv = kvcache.replace(self.kv, cap_factor=new_cap)
        # the loads stay float32, as the reference's compare them
        want, self._tenant_armed = elastic.rehash_wanted(
            loads.astype(np.float32), tombs.astype(np.float32),
            self._tenant_armed, rebuilding.astype(bool),
            grow_load=self.sc.rehash_load_factor)
        if want.any():
            self.kv = kvcache.start_rehash(self.kv, self._dev(want))

    # -- prefix cache ---------------------------------------------------------
    @torch.inference_mode()
    def prefix_rehash(self, seed: int | None = None):
        """Start a live re-seed rehash of the fingerprint index; decode
        steps drive it (``kvcache.rehash_step``) and the epoch swaps on the
        device when done."""
        self.kv = kvcache.start_prefix_rehash(self.kv, seed=seed)

    @property
    def prefix_epoch(self) -> int:
        """Completed fingerprint-index rehash epochs."""
        return int(self.kv.prefix.table.epoch)

    @property
    def evictions(self) -> int:
        """Cumulative prefix-cache pages evicted under pool pressure."""
        return int(self.kv.prefix.evictions)

    @property
    def alloc_fails(self) -> int:
        """Masked page allocations that found no free page."""
        return int(self.kv.alloc_fail)
