"""Architecture configuration schema (the port's own copy of the reference's).

One frozen dataclass describes every supported architecture; per-arch modules
in this package export ``CONFIG`` instances with the exact published
hyper-parameters, plus ``smoke()`` reduced variants for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: Family

    # core dims
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads

    # layer pattern: entries cycle to fill n_layers.
    #   "attn"   full-attention block    "local"  sliding-window block
    #   "mamba2" SSD block               "rwkv6"  RWKV time/channel mix
    block_pattern: tuple[str, ...] = ("attn",)
    # hybrid (zamba2): a weight-SHARED attention block is interposed every
    # shared_attn_every scanned blocks (0 = never)
    shared_attn_every: int = 0

    # attention details
    causal: bool = True
    window: int = 4096                   # sliding window for "local" blocks
    attn_softcap: float = 0.0            # gemma2-style tanh cap (0 = off)
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None   # gemma3: different theta for global
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0                     # expert hidden (arctic: 4864)
    dense_ff_residual: bool = False      # arctic: dense FFN in parallel w/ MoE
    router: Literal["topk", "hash"] = "topk"

    # SSM (mamba2)
    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # rwkv6
    rwkv_head_size: int = 64

    # embeddings / output
    logit_softcap: float = 0.0           # gemma2: 30.0
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma*: x * sqrt(d_model)
    encoder_only: bool = False           # hubert
    frontend: Literal["tokens", "stub_embed"] = "tokens"  # vlm/audio stubs

    # numerics / memory policy
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"           # "full" | "dots" (save einsum outs)
    attn_chunk: int = 1024               # blockwise-attention query chunk
    loss_chunk: int = 512                # chunked CE seq chunk
    scan_layers: bool = True

    # beyond-paper perf levers (§Perf hillclimbs; default = faithful baseline)
    fused_qkv: bool = False              # one QKV matmul -> one bwd dx AR
    fused_gate_up: bool = False          # one gate|up matmul -> one bwd dx AR
    rwkv_chunk: int = 0                  # 0 = per-step scan; >0 = remat chunks
    rwkv_tp_state: str = ""              # "" | "value" | "replicated" (§Perf)
    rwkv_fused_rkvg: bool = False        # one stacked r/k/v/g matmul (§Perf)

    # distribution policy
    fsdp: bool = False                   # shard big weight dims over "data" too

    # DHash integration
    use_hash_router: bool = False        # MoE archs: DHash-backed hash routing
    paged_kv: bool = True                # serving: DHash page-table indirection

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- shape helpers -----------------------------------------------------
    @property
    def blocks(self) -> tuple[str, ...]:
        """Full per-layer kind list of length n_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    # parameter count (embedding + blocks), for 6ND model-flops accounting
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_block = {}
        attn = d * hd * (n_q + 2 * n_kv) + n_q * hd * d
        mlp = 3 * d * f
        per_block["attn"] = attn + mlp + 2 * d
        per_block["local"] = per_block["attn"]
        if self.n_experts:
            e = self.top_k if active_only else self.n_experts
            moe = e * 3 * d * self.moe_dff
            if self.dense_ff_residual:
                moe += 3 * d * f
            router = d * self.n_experts
            per_block["attn"] = attn + moe + router + 2 * d
            per_block["local"] = per_block["attn"]
        d_in = self.ssm_expand * d
        per_block["mamba2"] = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_headdim)
                               + d_in * d + 2 * d)
        per_block["rwkv6"] = d * d * 4 + d * f * 2 + 2 * d  # r,k,v,o + channel-mix
        total = sum(per_block[k] for k in self.blocks)
        if self.shared_attn_every:
            total += attn + mlp + 2 * d
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)
