"""Mamba2 (SSD) block: the chunked scan of the training forward and the
O(1) single-token decode, as the reference's ``models/ssm.py``.

Chunking keeps every decay term as exp(L_i - L_j) with i >= j (<= 1, safe
in float32), the upper triangle masked BEFORE the exp (it would be
exp(+large) = inf); the state [B, NH, DS, HP] stays float32 across chunks,
which a host loop carries where the reference's ``lax.scan`` does.  The
card holds the decode against the chunked forward (``chip_smoke.py``
phase 8d); the training forward that calls it in the reference waits for
ROADMAP A7 f.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

F32 = torch.float32


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B,S,C], w: [K,C]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 128,
                h0: torch.Tensor | None = None):
    """SSD scan.

    xh:   [B,S,NH,HP]   per-head inputs
    dt:   [B,S,NH]      softplus'd step sizes
    a_log:[NH]          A = -exp(a_log)
    bmat: [B,S,DS]      input projection (n_groups=1, shared across heads)
    cmat: [B,S,DS]      output projection
    Returns y [B,S,NH,HP] (xh's dtype) and the final state [B,NH,DS,HP]
    (float32).
    """
    b, s, nh, hp = xh.shape
    ds = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    n = s // chunk
    a = -torch.exp(a_log.to(F32))                          # [NH]
    lam = dt.to(F32) * a                                   # log-decay (<= 0)

    def ck(t):
        return t.reshape(b, n, chunk, *t.shape[2:]).transpose(0, 1)

    xh_c, dt_c, b_c, c_c = ck(xh), ck(dt.to(F32)), ck(bmat), ck(cmat)
    cum = torch.cumsum(ck(lam), dim=2)                     # [n,B,C,NH]
    h = (torch.zeros((b, nh, ds, hp), dtype=F32, device=xh.device)
         if h0 is None else h0)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    ys = []
    for xc, dtc, bc, cc, cumc in zip(xh_c, dt_c, b_c, c_c, cum):
        xc, bc, cc = xc.to(F32), bc.to(F32), cc.to(F32)
        # intra-chunk: scores[i,j] = (C_i . B_j) exp(L_i - L_j) dt_j, i >= j
        cb = torch.einsum("bis,bjs->bij", cc, bc)
        diff = cumc[:, :, None, :] - cumc[:, None, :, :]   # [B,C,C,NH]
        # mask BEFORE exp: the upper triangle would be exp(+large) -> inf
        dec = torch.exp(torch.where(mask, diff, -1e30))
        w = cb[..., None] * dec * dtc[:, None, :, :]       # [B,i,j,NH]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        # from the previous state: y_i += exp(L_i) C_i @ h
        y = y + torch.einsum("bis,bih,bhsp->bihp", cc, torch.exp(cumc), h)
        # h' = exp(L_last) h + sum_j exp(L_last - L_j) dt_j B_j x_j^T
        decl = torch.exp(cumc[:, -1:, :] - cumc)           # [B,C,NH]
        h = (torch.exp(cumc[:, -1, :])[:, :, None, None] * h
             + torch.einsum("bjs,bjh,bjhp->bhsp", bc, decl * dtc, xc))
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, s, nh, hp)
    return y.to(xh.dtype), h


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int):
    """in_proj's output -> (z, xbc, dt): widths d_inner, d_inner + 2 DS,
    NH."""
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state,
                                zxbcdt.shape[-1] - 2 * d_inner
                                - 2 * d_state], dim=-1)


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: dict) -> torch.Tensor:
    """rms_norm(y * silu(z)) @ out_proj, in y's dtype."""
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["norm"])
    return y @ p["out_proj"]


def mamba2_forward(x: torch.Tensor, p: dict, *, d_inner: int, n_heads: int,
                   headdim: int, d_state: int, conv_k: int,
                   chunk: int = 128, final_state: bool = False):
    """Full mamba2 block. x: [B,S,D]. p holds in_proj / conv_w / a_log /
    d_skip / dt_bias / norm / out_proj. Returns y [B,S,D]; with
    ``final_state``, (y, state): the ``mamba2_decode`` state after the last
    token (the SSD state and the conv window's last K-1 inputs), from which
    a decode continues."""
    b, s, d = x.shape
    z, xbc_in, dt = _split_proj(x @ p["in_proj"], d_inner, d_state)
    xbc = F.silu(causal_conv1d(xbc_in, p["conv_w"]).to(F32)).to(x.dtype)
    xs, bmat, cmat = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))     # [B,S,NH]
    xh = xs.reshape(b, s, n_heads, headdim)
    y, h = ssd_chunked(xh, dt, p["a_log"], bmat, cmat, chunk=chunk)
    y = y + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = _gate_out(y.reshape(b, s, d_inner), z, p)
    if not final_state:
        return y
    conv = F.pad(xbc_in, (0, 0, conv_k - 1, 0))[:, s:]
    return y, {"h": h, "conv": conv}


def mamba2_decode(x1: torch.Tensor, state: dict, p: dict, *, d_inner: int,
                  n_heads: int, headdim: int, d_state: int, conv_k: int):
    """One-token step. x1: [B,1,D]; state: {"h": [B,NH,DS,HP] float32,
    "conv": [B,K-1,convdim]}. Returns (y1, state')."""
    b = x1.shape[0]
    z, xbc, dt = _split_proj(x1 @ p["in_proj"], d_inner, d_state)
    window = torch.cat([state["conv"], xbc], dim=1)        # [B,K,convdim]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"])
    xbc = F.silu(conv_out.to(F32)).to(x1.dtype)
    xs, bmat, cmat = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt[:, 0].to(F32) + p["dt_bias"].to(F32))   # [B,NH]
    decay = torch.exp(dt * -torch.exp(p["a_log"].to(F32)))
    xh = xs.reshape(b, n_heads, headdim).to(F32)
    h = state["h"] * decay[:, :, None, None] + torch.einsum(
        "bs,bh,bhp->bhsp", bmat.to(F32), dt, xh)
    y = torch.einsum("bs,bhsp->bhp", cmat.to(F32), h)
    y = y + xh * p["d_skip"][None, :, None].to(F32)
    y = _gate_out(y.reshape(b, 1, d_inner).to(x1.dtype), z, p)
    return y, {"h": h, "conv": window[:, 1:]}


def mamba2_init(init, n: int, d_model: int, *, d_inner: int, n_heads: int,
                d_state: int, conv_k: int, dtype: torch.dtype,
                device) -> dict:
    """``n`` stacked mamba2 layers.  ``init(shape, scale)`` draws N(0,
    scale^2) weights in ``dtype`` on ``device`` from the caller's generator
    (``transformer._init``); the other leaves are the reference's
    constants."""
    convdim = d_inner + 2 * d_state
    proj_out = 2 * d_inner + 2 * d_state + n_heads
    # log(linspace(1, 16)) in float64, rounded once: the reference's XLA
    # float32 linspace and log are not correctly rounded, so its values
    # lie within a few float32 ulps of these
    a_log = np.log(np.linspace(1.0, 16.0, n_heads)).astype(np.float32)

    def const(v, dt=F32):
        return torch.as_tensor(v, dtype=dt, device=device).expand(
            n, *np.shape(v)).clone()
    return {
        "in_proj": init((n, d_model, proj_out), d_model ** -0.5),
        "conv_w": init((n, conv_k, convdim), conv_k ** -0.5),
        "a_log": const(a_log),
        "d_skip": const(np.ones((n_heads,), np.float32)),
        "dt_bias": const(np.zeros((n_heads,), np.float32)),
        "norm": const(np.zeros((d_inner,), np.float32), dtype),
        "out_proj": init((n, d_inner, d_model), d_inner ** -0.5),
    }
