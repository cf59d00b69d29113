"""Prefix cache: content hash -> cached KV page, backed by DHash.

Block-granular prefix reuse: the fingerprint of token block i is
hash(fingerprint(i-1), tokens[i*ps:(i+1)*ps]), so a chain of fingerprints
identifies a unique prefix (bit for bit the reference's, on the port's
``hashing.hash_combine``).  Admission looks up the longest cached prefix;
published prefixes insert their (fingerprint -> page) pairs.  The table ops
are DHash's device-flag forms: no host read, and a table mid-rebuild
answers through the ordered old -> hazard -> new check.
"""
from __future__ import annotations

import torch

from repro_torch.core import dhash, hashing

I32 = torch.int32
FP_SEED = 0x811C9DC5


def prefix_fingerprints(tokens: torch.Tensor, page_size: int) -> torch.Tensor:
    """tokens: [B, S] -> chained block fingerprints [B, S // page_size]
    (int32, the low 31 bits of the running hash)."""
    b, s = tokens.shape
    n = s // page_size
    blocks = tokens[:, : n * page_size].reshape(b, n, page_size)
    h = torch.full((b,), FP_SEED, dtype=torch.int64, device=tokens.device)
    fps = []
    for j in range(n):
        for i in range(page_size):
            h = hashing.hash_combine(h, blocks[:, j, i])
        fps.append((h & 0x7FFFFFFF).to(I32))
    if not fps:
        return torch.zeros((b, 0), dtype=I32, device=tokens.device)
    return torch.stack(fps, dim=1)


def match_prefix(table: dhash.DHashState, fps: torch.Tensor):
    """Longest cached prefix per row. fps: [B, n].
    Returns (n_hit [B], pages [B, n] with -1 past the hit length).

    A row whose FIRST block misses is a clean miss (``n_hit == 0``, every
    page -1); a zero-block batch short-circuits without touching the
    table."""
    b, n = fps.shape
    if n == 0:
        return (torch.zeros((b,), dtype=I32, device=fps.device),
                torch.full((b, 0), -1, dtype=I32, device=fps.device))
    found, pages = dhash.lookup_by_flag(table, fps.reshape(-1))
    found = found.reshape(b, n)
    pages = pages.reshape(b, n)
    run = torch.cumprod(found.to(I32), dim=1, dtype=I32)   # 1 while contiguous
    n_hit = run.sum(dim=1, dtype=I32)
    return n_hit, torch.where(run.bool(), pages, -1)


def publish_prefix(table: dhash.DHashState, fps: torch.Tensor,
                   pages: torch.Tensor, mask: torch.Tensor):
    """Insert fingerprint -> page pairs for freshly computed blocks (the
    table is written in place).  Returns (table, ok [fps.shape])."""
    t, ok = dhash.insert_by_flag(table, fps.reshape(-1), pages.reshape(-1),
                                 mask.reshape(-1))
    return t, ok.reshape(fps.shape)
