"""Mixture-of-Experts: top-k learned routing and DHash-backed hash routing.

Hash routing assigns token -> expert by seeded hashes (Roller et al. hash
layers).  Token-frequency drift makes experts hot — the paper's
hash-collision scenario — so the router consults a DHash *override table*
first: ``lookup(token_id)`` returning a packed expert assignment.
Rebalancing inserts overrides or rebuilds the table with a new seed
**live**, while steps keep routing; the rebuild never blocks a step (the
paper's non-blocking property).

Dispatch is capacity-based gather/scatter, computed per batch row as in the
reference: a stable sort by expert, each assignment's rank within its
expert, ``keep = rank < cap``; two small int scatters give slot -> token and
assignment -> slot (an extra column absorbs dropped slots), and the heavy
movement is gathers.  The expert products are three einsums over the
``[B, E, cap, D]`` dispatch tensor, so they read every expert's weights,
as the reference's do.  The reference's sharding constraints are no-ops
off a mesh and are left out (ROADMAP A7 g).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dhash, hashing

F32 = torch.float32
I32 = torch.int32


def topk_route(x: torch.Tensor, w_router: torch.Tensor, k: int):
    """x: [T,D] -> (expert_id [T,k] int32, gate [T,k], aux_loss scalar)."""
    logits = (x @ w_router).to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_id = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    e = w_router.shape[1]
    # Switch-style load-balance loss
    frac_tokens = F.one_hot(expert_id[:, 0], e).to(F32).mean(0)
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return expert_id.to(I32), gate.to(x.dtype), aux


def hash_route(token_ids: torch.Tensor, table: dhash.DHashState | None,
               seeds: torch.Tensor, n_experts: int, k: int):
    """DHash-backed hash routing. token_ids: [T] int32; seeds: [k, 2] u32
    words (int64).

    Default: expert_j = mix32(token, seed_j) % E.  The override table maps
    token -> packed assignment (15 bits per slot, k <= 2).  aux = 0."""
    token_ids = token_ids.to(I32).contiguous()
    outs = []
    for j in range(k):
        fn = hashing.HashFn(kind="mix32", seeds=seeds[j])
        outs.append((hashing.hash_u32(fn, token_ids) % n_experts).to(I32))
    expert_id = torch.stack(outs, dim=-1)                  # [T,k]
    if table is not None:
        found, packed = dhash.lookup(table, token_ids)
        expert_id = apply_override(expert_id, found, packed)
    gate = torch.full(expert_id.shape, 1.0 / k, dtype=F32,
                      device=expert_id.device)
    return expert_id, gate, torch.zeros((), dtype=F32,
                                        device=expert_id.device)


def apply_override(expert_id: torch.Tensor, found: torch.Tensor,
                   packed: torch.Tensor) -> torch.Tensor:
    """``expert_id`` [T,k] where the override table has no entry, the
    unpacked override where it has one."""
    k = expert_id.shape[-1]
    ov = torch.stack([packed & 0x7FFF, (packed >> 15) & 0x7FFF], dim=-1)
    return torch.where(found[:, None], ov[:, :k].to(I32), expert_id)


def pack_assignment(e1: torch.Tensor, e2: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Pack up to two expert ids into the DHash value payload."""
    v = e1.to(I32)
    if e2 is not None:
        v = v | (e2.to(I32) << 15)
    return v


def moe_ffn(x: torch.Tensor, expert_id: torch.Tensor, gate: torch.Tensor,
            wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
            *, capacity_factor: float = 1.25):
    """Capacity-based sparse expert FFN, capacity per batch row.

    x: [B,S,D]; expert_id/gate: [B,S,K]; wg/wu: [E,D,F]; wd: [E,F,D].
    Returns (out [B,S,D], load [E] int32: the kept assignments an expert).
    Assignments over a row's capacity ``ceil(S*K/E*capacity_factor)`` are
    dropped (at decode S = 1, so a token whose two ids name one expert
    keeps only the first)."""
    b, s, d = x.shape
    k = expert_id.shape[-1]
    e = wg.shape[0]
    cap = int(np.ceil(s * k / e * capacity_factor))
    t = s * k
    ecap = e * cap
    dev = x.device
    flat_e = expert_id.reshape(b, t).to(I32)                 # [B,T]
    tok = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(t)

    # sort assignments by expert per row; rank within expert group
    se, order = torch.sort(flat_e, dim=1, stable=True)       # [B,T]
    ar = torch.arange(t, dtype=I32, device=dev).expand(b, t)
    run_start = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=dev),
         se[:, 1:] != se[:, :-1]], dim=1)
    start_idx = torch.cummax(torch.where(run_start, ar, 0), dim=1).values
    rank = ar - start_idx                                    # [B,T]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, ecap).long()   # sorted order

    # small int scatters only: slot -> token (for the dispatch gather) and
    # assignment -> slot (for the combine gather); column ecap absorbs the
    # dropped assignments
    slot_tok = torch.full((b, ecap + 1), t, dtype=torch.long,
                          device=dev).scatter_(1, slot, order)
    asg_slot = torch.full((b, t), ecap, dtype=torch.long,
                          device=dev).scatter_(1, order, slot)

    # heavy movement is gathers
    zero = torch.zeros((b, 1, d), dtype=x.dtype, device=dev)
    xs = torch.cat([x[:, tok], zero], dim=1)                  # [B,T+1,D]
    src = torch.gather(xs, 1, slot_tok[:, :ecap, None].expand(b, ecap, d))
    disp = src.reshape(b, e, cap, d)
    h = torch.einsum("becd,edf->becf", disp, wg)
    u = torch.einsum("becd,edf->becf", disp, wu)
    h = F.silu(h.to(F32)).to(x.dtype) * u
    y_e = torch.einsum("becf,efd->becd", h, wd)              # [B,E,cap,D]
    y_flat = torch.cat([y_e.reshape(b, ecap, d), zero], dim=1)
    contrib = torch.gather(y_flat, 1, asg_slot[..., None].expand(b, t, d))
    contrib = contrib * gate.reshape(b, t, 1).to(x.dtype)
    out = contrib.reshape(b, s, k, d).sum(dim=2)
    load = torch.zeros((e + 1,), dtype=I32, device=dev).index_add_(
        0, torch.where(keep, se, e).reshape(-1).long(),
        torch.ones((b * t,), dtype=I32, device=dev))[:e]
    return out, load
