"""Model assembly, the decode half, for every decoder family of the
reference: attention blocks (``attn`` / ``local``, rotary or M-RoPE) with
a SwiGLU MLP or experts (``models/moe.py``); mamba2 blocks
(``models/ssm.py``) with zamba2's weight-SHARED attention block between
groups of them; RWKV6 blocks (``models/rwkv.py``).  Weights are stacked on
a leading layer axis, as in the reference.

The reference scans each stack with ``lax.scan`` and carries per-layer
window / rope-theta arrays as scanned flags; here the layer loop runs on
the host, so ``_attn_flags`` gives those per-layer values as Python lists
and no step creates a tensor from host data.  ``forward_decode`` writes
the new token's K/V and every recurrent state (``ssm_h``, ``ssm_conv``,
``wkv``, ``tm_prev``, ``cm_prev``) into the caller's cache IN PLACE (the
returned cache shares its tensors) and returns the hidden state before
the unembedding.  It takes the reference's branches in the reference's
order: a shared block (groups of mamba2 layers, then the shared block
with its own K/V cache each time it is applied), else mamba2, else RWKV6,
else attention.  So a pattern that mixes ``attn`` with ``mamba2`` or
``rwkv6`` and has no shared block decodes its recurrent stack only, as
the reference's does (ROADMAP C).

Random initialisation takes an explicit ``torch.Generator`` and fills each
weight stack a block of layers at a time in float32 before the cast, so no
float32 copy of a whole bf16 model is ever made.  Its random streams are
the port's own: a test that compares the two packages converts the
reference's weights (``convert.params_from_numpy``).  The constant leaves
(``a_log``, ``d_skip``, ``dt_bias``, ``mu_*``, ``cmu_*``, ``w0``, ``u``)
are the reference's values.

Hash-routed experts (``use_hash_router``): the reference draws each
layer's hash seeds inside the step, ``jax.random.randint(PRNGKey(0),
(n_attn, top_k, 2), 0, 2**31 - 1)``.  The port carries them as data
instead, like weights: ``init_params`` draws them from its generator into
``params["hash_seeds"]`` ([n_attn, top_k, 2] u32 words held as int64), and
a test that compares the two packages passes the reference's seeds across
with its weights (``convert.params_from_numpy``).  The override table
(``router_table``) is looked up ONCE a step for the step's token ids and
applied in every layer.

Not ported yet: the training forward (ROADMAP A7 f), and with it the
encoder-only ``hubert-xlarge``, which has no decode step; such a
configuration raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dhash
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, embed, mrope_angles,
                                      rms_norm, rope_angles, swiglu)

F32 = torch.float32
I32 = torch.int32
# float32 elements drawn at once by ``_init`` (1 GiB)
_INIT_CHUNK = 1 << 28


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port cannot
    decode yet; never take another path."""
    if cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.arch_id}: an encoder-only model has no decode step; it "
            f"waits for the training forward (ROADMAP A7 f)")
    unknown = set(cfg.blocks) - {"attn", "local", "mamba2", "rwkv6"}
    if unknown:
        raise NotImplementedError(
            f"{cfg.arch_id}: blocks {sorted(unknown)} unknown (ROADMAP A7)")


def _counts(cfg: ArchConfig) -> tuple[int, int, int]:
    """Layers of each stack: (attention, mamba2, RWKV6)."""
    kinds = cfg.blocks
    return (sum(k in ("attn", "local") for k in kinds),
            kinds.count("mamba2"), kinds.count("rwkv6"))


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _mamba_kw(cfg: ArchConfig) -> dict:
    di = d_inner(cfg)
    return dict(d_inner=di, n_heads=di // cfg.ssm_headdim,
                headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                conv_k=cfg.ssm_conv)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def _init(gen: torch.Generator, shape: tuple, scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) weights of ``shape`` in ``dtype``, drawn in float32 a
    block of leading rows at a time."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill(out, gen, scale)
    return out


def _fill(out: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill ``out`` a block of leading rows at a time, each block at most
    ``_INIT_CHUNK`` elements where a row allows it; a row larger than that
    (one layer's experts) is filled row by row of its own."""
    row = math.prod(out.shape[1:])
    if row > _INIT_CHUNK and out.dim() > 2:
        for r in out:
            _fill(r, gen, scale)
        return
    per = max(1, _INIT_CHUNK // max(1, row))
    for i in range(0, out.shape[0], per):
        blk = out[i:i + per]
        blk.copy_(torch.randn(blk.shape, generator=gen, dtype=F32,
                              device=gen.device) * scale)


def _zeros(shape: tuple, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _attn_block_init(gen, cfg: ArchConfig, n: int, dtype) -> dict:
    """n stacked attention + MLP (or experts) blocks."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s = d ** -0.5
    p = {
        "ln1": _zeros((n, d), dtype, gen),
        "wo": _init(gen, (n, hq, hd, d), (hq * hd) ** -0.5, dtype),
        "ln2": _zeros((n, d), dtype, gen),
    }
    if cfg.fused_qkv:
        p["wqkv"] = _init(gen, (n, d, hq + 2 * hkv, hd), s, dtype)
    else:
        p["wq"] = _init(gen, (n, d, hq, hd), s, dtype)
        p["wk"] = _init(gen, (n, d, hkv, hd), s, dtype)
        p["wv"] = _init(gen, (n, d, hkv, hd), s, dtype)
    if cfg.qk_norm:
        p["q_norm"] = _zeros((n, hd), dtype, gen)
        p["k_norm"] = _zeros((n, hd), dtype, gen)
    if cfg.n_experts:
        e, fe = cfg.n_experts, cfg.moe_dff
        p["router"] = _init(gen, (n, d, e), s, dtype)
        p["we_g"] = _init(gen, (n, e, d, fe), s, dtype)
        p["we_u"] = _init(gen, (n, e, d, fe), s, dtype)
        p["we_d"] = _init(gen, (n, e, fe, d), fe ** -0.5, dtype)
        if cfg.dense_ff_residual:
            p |= _mlp_init(gen, cfg, n, d, f, s, dtype)
    else:
        p |= _mlp_init(gen, cfg, n, d, f, s, dtype)
    return p


def _mlp_init(gen, cfg: ArchConfig, n, d, f, s, dtype) -> dict:
    if cfg.fused_gate_up:
        # [2, d, f] stacked, the reference's layout
        return {"wgu": _init(gen, (n, 2, d, f), s, dtype),
                "wd": _init(gen, (n, f, d), f ** -0.5, dtype)}
    return {"wg": _init(gen, (n, d, f), s, dtype),
            "wu": _init(gen, (n, d, f), s, dtype),
            "wd": _init(gen, (n, f, d), f ** -0.5, dtype)}


def _attn_flags(cfg: ArchConfig) -> dict:
    """Per-layer window (int) and rope theta (float32-rounded float) lists
    for the attention stack."""
    kinds = [k for k in cfg.blocks if k in ("attn", "local")]
    tg = cfg.rope_theta_global or cfg.rope_theta
    return {"window": [cfg.window if k == "local" else 0 for k in kinds],
            "theta": [float(np.float32(cfg.rope_theta if k == "local"
                                       else tg)) for k in kinds]}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random weights on ``gen``'s device, the reference's tree:
    ``embed``, ``final_norm``, ``unembed`` when untied, and the stacks the
    block pattern has (``attn_stack``, ``mamba_stack``, ``rwkv_stack``,
    ``shared_attn``); for a hash router the layers' seeds,
    ``hash_seeds``."""
    check_supported(cfg)
    dtype = dtype_of(cfg.dtype)
    d, v = cfg.d_model, cfg.vocab_size
    params: dict[str, Any] = {
        "embed": _init(gen, (v, d), 1.0, dtype),
        "final_norm": _zeros((d,), dtype, gen),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _init(gen, (d, v), d ** -0.5, dtype)
    n_attn, n_mamba, n_rwkv = _counts(cfg)

    def init(shape, scale):
        return _init(gen, shape, scale, dtype)
    if n_attn:
        params["attn_stack"] = _attn_block_init(gen, cfg, n_attn, dtype)
    if n_mamba:
        kw = _mamba_kw(cfg)
        kw.pop("headdim")
        params["mamba_stack"] = dict(
            ssm_lib.mamba2_init(init, n_mamba, d, dtype=dtype,
                                device=gen.device, **kw),
            ln=_zeros((n_mamba, d), dtype, gen))
    if n_rwkv:
        params["rwkv_stack"] = dict(
            rwkv_lib.rwkv6_init(init, n_rwkv, d, cfg.d_ff,
                                n_heads=d // cfg.rwkv_head_size,
                                head_size=cfg.rwkv_head_size, dtype=dtype,
                                device=gen.device,
                                fused_rkvg=cfg.rwkv_fused_rkvg),
            ln1=_zeros((n_rwkv, d), dtype, gen),
            ln2=_zeros((n_rwkv, d), dtype, gen))
    if cfg.shared_attn_every:
        shared = cfg.scaled(n_experts=0, block_pattern=("attn",))
        params["shared_attn"] = {k: t[0] for k, t in _attn_block_init(
            gen, shared, 1, dtype).items()}
    if cfg.n_experts and cfg.use_hash_router:
        # the reference's range, randint(0, 2**31 - 1)
        params["hash_seeds"] = torch.randint(
            0, 2 ** 31 - 1, (n_attn, cfg.top_k, 2), generator=gen,
            dtype=torch.int64, device=gen.device)
    return params


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------

def _mlp_fwd(h: torch.Tensor, p: dict) -> torch.Tensor:
    if "wgu" in p:
        gu = torch.einsum("bsd,kdf->bskf", h, p["wgu"])
        g, u = gu[:, :, 0], gu[:, :, 1]
        act = F.silu(g.to(F32)).to(h.dtype) * u
        return torch.einsum("bsf,fd->bsd", act, p["wd"])
    return swiglu(h, p["wg"], p["wu"], p["wd"])


def _project_qkv_cfg(h: torch.Tensor, p: dict, cfg: ArchConfig):
    if "wqkv" in p:
        qkv = attn_lib._proj(h, p["wqkv"])
        q, k, v = torch.split(qkv, [cfg.n_heads, cfg.n_kv_heads,
                                    cfg.n_kv_heads], dim=2)
        if cfg.qk_norm:
            q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
        return q, k, v
    qkn = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else None
    return attn_lib.project_qkv(h, p["wq"], p["wk"], p["wv"],
                                qk_norm_scale=qkn)


def _ffn_or_moe(h: torch.Tensor, p: dict, cfg: ArchConfig, token_ids,
                router_override, hash_seeds):
    """Feed-forward half of an attention block: the MLP, or the experts
    (plus the MLP where ``dense_ff_residual``).  The decode uses neither
    the router's aux loss nor the experts' load, which the reference's
    training forward sums (ROADMAP A7 f)."""
    b, s, d = h.shape
    if not cfg.n_experts:
        return _mlp_fwd(h, p)
    if cfg.use_hash_router:
        eid, gate, _ = moe_lib.hash_route(token_ids.reshape(-1), None,
                                          hash_seeds, cfg.n_experts,
                                          cfg.top_k)
        if router_override is not None:
            eid = moe_lib.apply_override(eid, *router_override)
    else:
        eid, gate, _ = moe_lib.topk_route(h.reshape(b * s, d), p["router"],
                                          cfg.top_k)
    y, _ = moe_lib.moe_ffn(h, eid.reshape(b, s, -1), gate.reshape(b, s, -1),
                           p["we_g"], p["we_u"], p["we_d"])
    if cfg.dense_ff_residual:
        y = y + _mlp_fwd(h, p)
    return y


def _attn_body(x, p, window: int, theta: float, cfg: ArchConfig, positions,
               decode_cache, cache_len, angles=None, token_ids=None,
               router_override=None, hash_seeds=None):
    """One attention block on its decode branch: the new token's K/V
    written at ``cache_len`` (in place), then attention over the first
    ``cache_len + 1`` positions.  ``positions``: [B, 1], or [3, B, 1] with
    M-RoPE.  ``angles``: the step's ``_step_angles`` entry for ``theta``
    when the caller has it.  ``token_ids``, ``router_override`` (found,
    packed) and the layer's ``hash_seeds`` route an expert block.  Returns
    (x', (k_cache, v_cache))."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _project_qkv_cfg(h, p, cfg)
    angles = angles or _step_angles(cfg, positions, [theta])[theta]
    q = apply_rope(q, positions, theta, angles)
    k = apply_rope(k, positions, theta, angles)
    kc, vc = decode_cache
    idx = cache_len.long()
    bidx = torch.arange(kc.shape[0], device=kc.device)
    kc[bidx, idx] = k[:, 0]
    vc[bidx, idx] = v[:, 0]
    o = attn_lib.decode_attention(q, kc, vc, cache_len + 1, window=window,
                                  softcap=cfg.attn_softcap)
    x = x + out_proj(o, p["wo"])
    h2 = rms_norm(x, p["ln2"])
    return x + _ffn_or_moe(h2, p, cfg, token_ids, router_override,
                           hash_seeds), (kc, vc)


def _step_angles(cfg: ArchConfig, positions: torch.Tensor,
                 thetas) -> dict:
    """The step's rotary (sin, cos) for each theta of ``thetas``.  M-RoPE
    (``mrope_sections``) rotates every attention layer by
    ``cfg.rope_theta`` over the three position streams, as the reference
    does, whatever the layer's theta."""
    if cfg.mrope_sections is not None:
        a = mrope_angles(positions, float(np.float32(cfg.rope_theta)),
                         cfg.head_dim, cfg.mrope_sections)
        return dict.fromkeys(thetas, a)
    return {th: rope_angles(positions, th, cfg.head_dim) for th in thetas}


def _mamba_body(x, p, cfg: ArchConfig, h_cache, conv_cache):
    """One mamba2 block on its decode branch; its state written into
    ``h_cache`` / ``conv_cache`` in place."""
    y, st = ssm_lib.mamba2_decode(
        rms_norm(x, p["ln"]), {"h": h_cache, "conv": conv_cache}, p,
        **_mamba_kw(cfg))
    h_cache.copy_(st["h"])
    conv_cache.copy_(st["conv"])
    return x + y


def _rwkv_body(x, p, cfg: ArchConfig, wkv, tm_prev, cm_prev):
    """One RWKV6 block (time mix, then channel mix) on its decode branch;
    its states written into ``wkv`` / ``tm_prev`` / ``cm_prev`` in
    place."""
    h = rms_norm(x, p["ln1"])
    y, s1 = rwkv_lib.rwkv6_time_mix(
        h, p, n_heads=cfg.d_model // cfg.rwkv_head_size,
        head_size=cfg.rwkv_head_size, prev_token=tm_prev, s0=wkv)
    x = x + y
    h2 = rms_norm(x, p["ln2"])
    y2 = rwkv_lib.rwkv6_channel_mix(h2, p, prev_token=cm_prev)
    wkv.copy_(s1)
    tm_prev.copy_(h)
    cm_prev.copy_(h2)
    return x + y2


def layer_params(stack: dict) -> list:
    """Every layer's weights as a dict of views into the stacked tensors
    (one ``unbind`` a stacked tensor)."""
    names = list(stack)
    return [dict(zip(names, views)) for views in
            zip(*(stack[k].unbind(0) for k in names))]


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o [..., H, hd] @ wo [H, hd, D] -> [..., D] (the reference's einsum
    ``"bshk,hkd->bsd"``, as one matmul)."""
    return o.flatten(-2) @ wo.flatten(0, 1)


def unembed_matrix(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


# ---------------------------------------------------------------------------
# decode (single new token against caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: torch.device | str = "cuda") -> dict:
    """The reference's decode cache: ``len``; ``k`` / ``v`` [n, B, max_len,
    Hkv, hd] for the attention stack, or for a shared block one pair each
    time it is applied (``ceil(n_mamba / shared_attn_every)``); ``ssm_h``
    (float32) and ``ssm_conv`` for mamba2; ``wkv`` (float32), ``tm_prev``
    and ``cm_prev`` for RWKV6."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    n_attn, n_mamba, n_rwkv = _counts(cfg)
    cache = {"len": zeros((batch,), I32)}
    kv = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.shared_attn_every:
        kv = (-(-n_mamba // cfg.shared_attn_every),) + kv[1:]
    if n_attn or cfg.shared_attn_every:
        cache["k"], cache["v"] = zeros(kv), zeros(kv)
    if n_mamba:
        di = d_inner(cfg)
        cache["ssm_h"] = zeros((n_mamba, batch, di // cfg.ssm_headdim,
                                cfg.ssm_state, cfg.ssm_headdim), F32)
        cache["ssm_conv"] = zeros((n_mamba, batch, cfg.ssm_conv - 1,
                                   di + 2 * cfg.ssm_state))
    if n_rwkv:
        hs = cfg.rwkv_head_size
        cache["wkv"] = zeros((n_rwkv, batch, cfg.d_model // hs, hs, hs), F32)
        cache["tm_prev"] = zeros((n_rwkv, batch, 1, cfg.d_model))
        cache["cm_prev"] = zeros((n_rwkv, batch, 1, cfg.d_model))
    return cache


def hash_seeds_of(params: dict, cfg: ArchConfig) -> list:
    """Each layer's [top_k, 2] hash seeds (a hash router), else Nones."""
    if not (cfg.n_experts and cfg.use_hash_router):
        return [None] * _counts(cfg)[0]
    if "hash_seeds" not in params:
        raise KeyError(f"{cfg.arch_id}: a hash router needs "
                       f"params['hash_seeds'] [n_attn, top_k, 2] (drawn "
                       f"by init_params; the reference's through "
                       f"convert.params_from_numpy)")
    return list(params["hash_seeds"].unbind(0))


@torch.inference_mode()
def forward_decode(params: dict, cfg: ArchConfig, tokens1: torch.Tensor,
                   cache: dict, router_table=None):
    """tokens1: [B,1] (or embeds [B,1,D] for stub frontends).
    ``router_table``: the DHash override table of a hash router, looked up
    once for the step's token ids.  Returns (hidden [B,1,D], cache');
    cache' shares ``cache``'s tensors, which are written in place."""
    check_supported(cfg)
    if cfg.frontend == "stub_embed" and tokens1.dim() == 3:
        x = tokens1.to(dtype_of(cfg.dtype))
        token_ids = torch.zeros(x.shape[:2], dtype=I32, device=x.device)
    else:
        token_ids = tokens1.to(I32).contiguous()
        x = embed(tokens1, params["embed"], scale=cfg.embed_scale)
    router_override = None
    if cfg.use_hash_router and router_table is not None:
        router_override = dhash.lookup(router_table, token_ids.reshape(-1))
    clen = cache["len"]
    positions = clen[:, None]
    if cfg.mrope_sections is not None:
        # a text token: the same position on the t / h / w streams
        positions = positions.expand(3, *positions.shape)
    kinds = cfg.blocks
    if cfg.shared_attn_every:
        x = _decode_shared(x, params, cfg, cache, positions)
    elif "mamba2" in kinds:
        for i, p in enumerate(layer_params(params["mamba_stack"])):
            x = _mamba_body(x, p, cfg, cache["ssm_h"][i],
                            cache["ssm_conv"][i])
    elif "rwkv6" in kinds:
        for i, p in enumerate(layer_params(params["rwkv_stack"])):
            x = _rwkv_body(x, p, cfg, cache["wkv"][i], cache["tm_prev"][i],
                           cache["cm_prev"][i])
    else:
        seeds = hash_seeds_of(params, cfg)
        flags = _attn_flags(cfg)
        angles = _step_angles(cfg, positions, set(flags["theta"]))
        layers = layer_params(params["attn_stack"])
        for i, (window, theta) in enumerate(zip(flags["window"],
                                                flags["theta"])):
            x, _ = _attn_body(x, layers[i], window, theta, cfg, positions,
                              (cache["k"][i], cache["v"][i]), clen,
                              angles[theta], token_ids, router_override,
                              seeds[i])
    new_cache = dict(cache, len=clen + 1)
    x = rms_norm(x, params["final_norm"])
    return x, new_cache


def _decode_shared(x, params: dict, cfg: ArchConfig, cache: dict,
                   positions):
    """zamba2: groups of ``shared_attn_every`` mamba2 layers, each group
    followed by the weight-shared attention block (no window, the
    configuration's rope theta) with its own K/V cache."""
    shared_cfg = cfg.scaled(n_experts=0)
    theta = float(np.float32(cfg.rope_theta))
    angles = _step_angles(cfg, positions, [theta])[theta]
    mamba = layer_params(params["mamba_stack"])
    g = cfg.shared_attn_every
    for app, start in enumerate(range(0, len(mamba), g)):
        for i in range(start, min(start + g, len(mamba))):
            x = _mamba_body(x, mamba[i], cfg, cache["ssm_h"][i],
                            cache["ssm_conv"][i])
        x, _ = _attn_body(x, params["shared_attn"], 0, theta, shared_cfg,
                          positions, (cache["k"][app], cache["v"][app]),
                          cache["len"], angles)
    return x
