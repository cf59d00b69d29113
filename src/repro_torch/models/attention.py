"""GQA attention for one-token decode, and the QKV projection.

``decode_attention`` is the dense decode the paged engine is held to: one
query token a sequence against a [B, Smax] cache, positions at or past
``cache_len`` masked, and with a ``window`` > 0 positions older than
``cache_len - window``.  Scores are the product in the storage dtype, then
float32; the softmax's probabilities go back to the storage dtype for the
value product, as in the reference.  The blockwise ``attention`` of the
training forward is not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import rms_norm

F32 = torch.float32
NEG_INF = -2.0e38


def _proj(x, w):
    """x [..., D] @ w [D, H, hd] -> [..., H, hd] (the reference's einsum
    ``"bsd,dhk->bshk"``, as one matmul)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def project_qkv(x, wq, wk, wv, *, qk_norm_scale=None):
    """x: [B,S,D]; wq: [D,Hq,hd]; wk/wv: [D,Hkv,hd]."""
    q = _proj(x, wq)
    k = _proj(x, wk)
    v = _proj(x, wv)
    if qk_norm_scale is not None:  # qwen3: per-head RMS on q and k
        qs, ks = qk_norm_scale
        q = rms_norm(q, qs)
        k = rms_norm(k, ks)
    return q, k, v


def decode_attention(q1, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token decode: q1 [B,1,Hq,hd] vs cache [B,Smax,Hkv,hd]."""
    b, smax, hkv, hd = k_cache.shape
    hq = q1.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(hd)
    qg = q1.reshape(b, 1, hkv, g, hd)
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k_cache).to(F32) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(smax, dtype=torch.int32, device=q1.device)[None, :]
    valid = pos < cache_len[:, None]
    if window > 0:
        valid &= pos >= cache_len[:, None] - window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgcs,bshd->bchgd", p, v_cache)
    return out.reshape(b, 1, hq, hd)
