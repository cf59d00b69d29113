"""RWKV6 ("Finch") block: data-dependent per-channel decay, as the
reference's ``models/rwkv.py``.

The time mix runs the exact recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T,
out_t = r_t (S_{t-1} + diag(u) k_t v_t^T), a host loop over time,
vectorised over batch x heads, with the state [B, NH, HS, HS] in float32.
Decode is the same recurrence for one step.  The reference's
simplifications are kept: a static token-shift lerp for r / k / v / g (the
decay keeps its data-dependent LoRA) and a per-head RMS norm in place of
GroupNorm on the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

F32 = torch.float32


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None):
    """x: [B,S,D] -> x shifted right by one (first position gets ``prev``
    or 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddw(xm: torch.Tensor, p: dict) -> torch.Tensor:
    """Data-dependent decay: log w = -exp(w0 + tanh(x @ w1) @ w2) (<= 0)."""
    lora = xm @ p["w_lora_a"]
    wraw = p["w0"].to(F32) + torch.tanh(lora.to(F32)) @ p["w_lora_b"].to(F32)
    return -torch.exp(torch.clamp(wraw, -10.0, 4.0))


def wkv_scan(r, k, v, logw, u, s0=None):
    """r/k/v/logw: [B,S,NH,HS]; u: [NH,HS].
    Returns out [B,S,NH,HS] and the final state [B,NH,HS,HS] (float32)."""
    b, s, nh, hs = r.shape
    state = (torch.zeros((b, nh, hs, hs), dtype=F32, device=r.device)
             if s0 is None else s0)
    uu = u[None, :, :, None]
    outs = []
    for t in range(s):
        rt, kt, vt, lwt = (z[:, t].to(F32) for z in (r, k, v, logw))
        kv = kt[..., :, None] * vt[..., None, :]            # [B,NH,HS,HS]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + uu * kv))
        state = torch.exp(lwt)[..., None] * state + kv
    return torch.stack(outs, 1), state


def wkv_scan_chunked(r, k, v, logw, u, s0=None, *, chunk: int = 128):
    """The same recurrence run a chunk of ``chunk`` steps at a time, with
    the same numerics as ``wkv_scan``.  The reference rematerialises each
    chunk (``jax.checkpoint``), which only shapes a backward pass (ROADMAP
    A10); this forward threads the state from chunk to chunk."""
    s = r.shape[1]
    if s % chunk != 0 or s <= chunk:
        return wkv_scan(r, k, v, logw, u, s0)
    outs, state = [], s0
    for i in range(0, s, chunk):
        out, state = wkv_scan(*(z[:, i:i + chunk] for z in (r, k, v, logw)),
                              u, state)
        outs.append(out)
    return torch.cat(outs, 1), state


def rwkv6_time_mix(x: torch.Tensor, p: dict, *, n_heads: int, head_size: int,
                   prev_token: torch.Tensor | None = None, s0=None,
                   chunk: int = 0, tp_state: str = ""):
    """x: [B,S,D] -> (y [B,S,D], state [B,NH,HS,HS]).  ``prev_token`` [B,1,D]
    and ``s0`` carry a decode.  ``tp_state`` only places sharding
    constraints in the reference; it waits for ROADMAP A7 g and is
    ignored."""
    b, s, d = x.shape
    xs = _token_shift(x, prev_token)

    def mix(m):   # lerp toward the shifted input
        return x + (xs - x) * m.to(x.dtype)
    xr, xk, xv, xg, xw = (mix(p[f"mu_{n}"]) for n in "rkvgw")
    if "w_rkvg" in p:
        # the reference's stacked [4, D, D] projection, one product
        rkvg = torch.einsum("bskd,kde->bske",
                            torch.stack([xr, xk, xv, xg], dim=2), p["w_rkvg"])
        r, k, v = (rkvg[:, :, i].reshape(b, s, n_heads, head_size)
                   for i in range(3))
        g = F.silu(rkvg[:, :, 3].to(F32))
    else:
        r, k, v = ((xi @ p[w]).reshape(b, s, n_heads, head_size)
                   for xi, w in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
        g = F.silu((xg @ p["w_g"]).to(F32))
    logw = _ddw(xw, p).reshape(b, s, n_heads, head_size)
    uu = p["u"].reshape(n_heads, head_size)
    if chunk > 0:
        out, state = wkv_scan_chunked(r, k, v, logw, uu, s0, chunk=chunk)
    else:
        out, state = wkv_scan(r, k, v, logw, uu, s0)
    out = rms_norm(out, p["ln_x"]).reshape(b, s, d)
    out = (out.to(F32) * g).to(x.dtype)
    return out @ p["w_o"], state


def rwkv6_channel_mix(x: torch.Tensor, p: dict, prev_token=None):
    xs = _token_shift(x, prev_token)
    xk = x + (xs - x) * p["cmu_k"].to(x.dtype)
    xr = x + (xs - x) * p["cmu_r"].to(x.dtype)
    kk = torch.square(F.relu((xk @ p["c_k"]).to(F32))).to(x.dtype)
    rr = torch.sigmoid((xr @ p["c_r"]).to(F32)).to(x.dtype)
    return rr * (kk @ p["c_v"])


def rwkv6_init(init, n: int, d_model: int, d_ff: int, *, n_heads: int,
               head_size: int, lora_r: int = 64, dtype: torch.dtype,
               device, fused_rkvg: bool = False) -> dict:
    """``n`` stacked RWKV6 layers.  ``init(shape, scale)`` draws N(0,
    scale^2) weights in ``dtype`` on ``device`` from the caller's generator
    (``transformer._init``); the other leaves are the reference's
    constants."""
    d = d_model

    def full(width, value, dt=F32):
        return torch.full((n, width), value, dtype=dt, device=device)
    p = {f"mu_{c}": full(d, 0.5) for c in "rkvgw"}
    p |= {"cmu_k": full(d, 0.5), "cmu_r": full(d, 0.5)}
    if fused_rkvg:
        p["w_rkvg"] = init((n, 4, d, d), d ** -0.5)
    else:
        p |= {f"w_{c}": init((n, d, d), d ** -0.5) for c in "rkvg"}
    p |= {
        "w_o": init((n, d, d), d ** -0.5),
        "w0": full(d, -2.0),
        "w_lora_a": init((n, d, lora_r), d ** -0.5),
        "w_lora_b": init((n, lora_r, d), lora_r ** -0.5),
        "u": full(d, 0.0),
        "ln_x": full(head_size, 0.0, dtype),
        "c_k": init((n, d, d_ff), d ** -0.5),
        "c_v": init((n, d_ff, d), d_ff ** -0.5),
        "c_r": init((n, d, d), d ** -0.5),
    }
    return p
