"""Shared neural layers: norms, rotary embeddings (M-RoPE too), the
SwiGLU MLP and token embeddings.  Each casts where the reference casts:
norms and the SiLU gate compute in float32 and return the input's
dtype."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the ``1 + scale`` gain, in float32."""
    dt = x.dtype
    x = x.to(F32)
    var = (x * x).mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.to(F32))
    return y.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return h @ w_down


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def _rope_angle(positions: torch.Tensor, theta: float,
                head_dim: int) -> torch.Tensor:
    """positions [...] (ints) -> rotary angles [..., hd/2] in float32."""
    exp = torch.arange(0, head_dim, 2, dtype=F32,
                       device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=F32,
                                       device=positions.device), exp)
    return positions[..., None].to(F32) * freqs


def rope_angles(positions: torch.Tensor, theta: float, head_dim: int):
    """(sin, cos) [..., S, 1, hd/2] of the rotary angles at ``positions``
    [..., S] for ``theta`` (a float: the layer's, from
    ``transformer._attn_flags``), in float32.  Layers that share a theta
    share them within a step."""
    ang = _rope_angle(positions, theta, head_dim)           # [..., S, hd/2]
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]


def mrope_angles(positions: torch.Tensor, theta: float, head_dim: int,
                 sections: tuple[int, int, int]):
    """Qwen2-VL's multimodal rotary angles: ``positions`` [3, ..., S] (the
    t / h / w streams); ``sections`` split the hd/2 frequency pairs among
    the three streams, in order.  Returns (sin, cos) [..., S, 1, hd/2] as
    ``rope_angles``: with three equal streams, the same values."""
    ang = _rope_angle(positions, theta, head_dim)       # [3, ..., S, hd/2]
    s0, s1, _ = sections
    sec = torch.full((head_dim // 2,), 2, dtype=torch.int64,
                     device=positions.device)
    sec[:s0 + s1] = 1
    sec[:s0] = 0
    ang = torch.gather(ang, 0, sec.expand(1, *ang.shape[1:]))[0]
    return torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               angles=None) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (ints).  ``angles`` is
    ``rope_angles(positions, theta, hd)`` when the caller has it."""
    hd = x.shape[-1]
    sin, cos = angles or rope_angles(positions, theta, hd)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int], angles=None) -> torch.Tensor:
    """M-RoPE: x [..., S, H, hd]; positions [3, ..., S].  ``angles`` is
    ``mrope_angles(positions, theta, hd, sections)`` when the caller has
    it."""
    return apply_rope(x, positions, theta, angles or mrope_angles(
        positions, theta, x.shape[-1], sections))


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor, *,
          scale: bool) -> torch.Tensor:
    x = table[tokens.long()]
    if scale:
        # sqrt(d) rounded to the table's dtype first, as the reference's
        # jnp.asarray(np.sqrt(d), x.dtype)
        s = torch.tensor(np.sqrt(table.shape[1]), dtype=F32).to(x.dtype)
        x = x * s.item()
    return x
