"""The DHash router state of a hash-router MoE model: the override table
(``make_router_table``) and the host-level rebalance on expert-load skew
(``rebalance_router``).

The reference threads the table through its train step, which advances
one rebuild transition a step, so that a live router rebalance never
blocks training.  The optimizer, ``init_state`` and ``train_step`` wait
for the port's training framework (ROADMAP A10); a decode step takes the
table directly (``model.decode_logits(..., router_table=)``).

On a CUDA device the table runs DHash's kernels (``fused``), never their
plain versions, by the serving tables' rule (``eviction.table_fused``);
elsewhere ``fused`` follows ``DHASH_FUSED``, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dhash
from repro_torch.serving.eviction import table_fused


def make_router_table(cfg: ArchConfig, *, capacity: int = 4096,
                      device: torch.device | str = "cuda"
                      ) -> dhash.DHashState | None:
    """An empty override table (token id -> packed expert ids) for a hash
    router on ``device``, else None."""
    if not (cfg.n_experts and cfg.use_hash_router):
        return None
    return dhash.make("linear", capacity=capacity, chunk=256, seed=17,
                      fused=table_fused(device), device=device)


def rebalance_router(state: dict, expert_load, cfg: ArchConfig,
                     *, hot_frac: float = 2.0) -> dict:
    """Host-level reaction to expert-load skew (the paper's attack
    response): when the hottest expert's load exceeds ``hot_frac`` times
    the mean (at least 1) and no rebuild runs, start a rebuild of the
    override table with a fresh seed drawn from the loads.  Reads the loads
    and the table's flag to the host."""
    rt = state.get("router_table")
    if rt is None:
        return state
    if isinstance(expert_load, torch.Tensor):
        expert_load = expert_load.cpu().numpy()
    load = np.asarray(expert_load, dtype=np.float64)
    mean = max(load.mean(), 1.0)
    if load.max() > hot_frac * mean and not bool(rt.rebuilding):
        state = dict(state, router_table=dhash.rebuild_start(
            rt, seed=int(load.sum()) % (2**31 - 1) + 1))
    return state
