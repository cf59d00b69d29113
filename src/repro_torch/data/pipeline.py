"""Deterministic, stateless, elastic synthetic LM data pipeline.

Every batch is a pure function of (seed, step, shard_index) via
counter-mode hashing: resuming from a step reproduces the exact token
stream on any number of hosts, with no iterator state to persist.
Documents with power-law-ish lengths are separated by EOS, token ids are
zipf-distributed (so the hash router and the dedup table see realistic
frequency skew).  The hashing is ``core.hashing``'s, bit for bit the
reference's, so ``synth_batch`` gives the reference's tokens.

The DHash tie-in: ``dedup_batch`` drops repeated documents using a DHash
fingerprint table — a data-pipeline client of the paper's structure.

Entry points make their tensors on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import dhash, hashing

I32 = torch.int32
F32 = torch.float32


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2          # token frequency skew
    eos_id: int = 0


def _u01(fn: hashing.HashFn, x: torch.Tensor) -> torch.Tensor:
    return hashing.hash_u32(fn, x).to(F32) / np.float32(2 ** 32)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the reference's int32 wrap-around."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(I32)


def synth_batch(cfg: DataConfig, step: int | torch.Tensor, *, shard: int = 0,
                nshards: int = 1, mrope: bool = False,
                device: torch.device | str = "cuda") -> dict:
    """Batch for (step, shard). Local batch = global_batch // nshards."""
    b = cfg.global_batch // nshards
    s = cfg.seq_len
    fn = hashing.HashFn(kind="mix32", seeds=torch.tensor(
        [cfg.seed * 2654435761 % 2**32 or 1, 0x9E3779B9], dtype=torch.int64,
        device=device))
    # the reference's int32 index arithmetic, wrapped once at the end (the
    # wrap is a ring map mod 2^32, so one wrap equals one a product)
    step64 = _wrap_i32(torch.as_tensor(step, device=device).to(
        torch.int64)).to(torch.int64)
    base = (step64 * cfg.global_batch + shard * b) * s
    idx = _wrap_i32(base + torch.arange(b, device=device)[:, None] * s
                    + torch.arange(s, device=device)[None, :])
    # zipf-ish token ids: u^( -1/(a-1) ) rank transform, clipped to vocab;
    # clipped before the cast, which the reference's saturates
    u = torch.clamp(_u01(fn, idx), 1e-6, 1.0)
    rank = torch.pow(u, np.float32(-1.0 / (cfg.zipf_a - 1.0)))
    tokens = torch.clamp(rank, 0, cfg.vocab_size - 1).to(I32)
    # document structure: EOS roughly every mean_doc_len tokens
    is_eos = _u01(fn, _wrap_i32(idx.to(torch.int64) + 0x5BD1E995)) \
        < np.float32(1.0 / cfg.mean_doc_len)
    tokens = torch.where(is_eos, cfg.eos_id, tokens).to(I32)
    labels = torch.cat([tokens[:, 1:], torch.full(
        (b, 1), cfg.eos_id, dtype=I32, device=device)], dim=1)
    batch = {"tokens": tokens, "labels": labels,
             "loss_mask": torch.ones((b, s), dtype=torch.bool,
                                     device=device)}
    if mrope:
        pos = torch.arange(s, dtype=I32, device=device).expand(b, s)
        batch["positions"] = torch.stack([pos, pos, pos])  # t/h/w streams
    return batch


def synth_embeds(cfg: DataConfig, step: int, d_model: int, *, shard: int = 0,
                 nshards: int = 1, dtype=torch.bfloat16,
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """Stub modality frontend: precomputed frame/patch embeddings, a pure
    function of (seed, step, shard), for the [audio]/[vlm] architectures.
    The stream is the port's own (a ``torch.Generator`` seeded from seed,
    step and shard), not the reference's ``jax.random.normal`` one: only
    its shape, dtype and distribution match."""
    b = cfg.global_batch // nshards
    gen = torch.Generator(device=device).manual_seed(
        (cfg.seed * 1_000_003 + step * 1000 + shard) % 2**63)
    return torch.randn((b, cfg.seq_len, d_model), generator=gen, dtype=F32,
                       device=device).to(dtype)


# ---------------------------------------------------------------------------
# DHash client: streaming dedup
# ---------------------------------------------------------------------------

def doc_fingerprints(tokens: torch.Tensor, *, block: int = 128
                     ) -> torch.Tensor:
    """Rolling content hash per block of tokens: [B, S//block] int32 (the
    sign bit cleared, so no fingerprint is a negative sentinel)."""
    b, s = tokens.shape
    n = s // block
    blocks = tokens[:, : n * block].reshape(b * n, block)
    h = torch.full((b * n,), 0x811C9DC5, dtype=torch.int64,
                   device=tokens.device)
    for i in range(block):
        h = hashing.hash_combine(h, blocks[:, i])
    return (h & 0x7FFFFFFF).to(I32).reshape(b, n)


def dedup_batch(table: dhash.DHashState, tokens: torch.Tensor, *,
                block: int = 128):
    """Mask out token blocks whose fingerprint was already seen; insert the
    fresh ones.  Returns (table', keep_mask [B, S]).  ``seen`` is read
    before the insert, so a fingerprint repeated within one batch is kept
    at each of its places (and inserted once).  A fused table is written
    in place."""
    fps = doc_fingerprints(tokens, block=block)            # [B, n]
    flat = fps.reshape(-1)
    seen, _ = dhash.lookup(table, flat)
    table, _ = dhash.insert(table, flat, torch.zeros_like(flat), ~seen)
    keep = ~seen.reshape(fps.shape)                        # [B, n]
    b, s = tokens.shape
    n = s // block
    keep_tok = keep.repeat_interleave(block, dim=1)
    if n * block < s:
        keep_tok = torch.cat([keep_tok, torch.ones(
            (b, s - n * block), dtype=torch.bool, device=tokens.device)],
            dim=1)
    return table, keep_tok
