"""arctic-480b [moe]: 128 experts top-2 PLUS parallel dense-FFN residual
[hf:Snowflake/snowflake-arctic-base; hf]. DHash hash-router enabled (live
rebalancing). long_500k SKIPPED (full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    n_experts=128, top_k=2, moe_dff=4864, dense_ff_residual=True,
    use_hash_router=True, fsdp=True,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         n_experts=8, top_k=2, moe_dff=64,
                         dtype="float32", attn_chunk=32, loss_chunk=32,
                         fsdp=False)
