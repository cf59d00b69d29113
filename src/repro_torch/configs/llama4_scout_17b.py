"""llama4-scout-17b-16e [moe]: 16 experts top-1, early-fusion multimodal
(text path only; vision stub shares the qwen2-vl pattern)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. DHash hash-router
enabled. long_500k SKIPPED (full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, moe_dff=8192,
    use_hash_router=True, fsdp=True,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         n_experts=4, top_k=1, moe_dff=64,
                         dtype="float32", attn_chunk=32, loss_chunk=32,
                         fsdp=False)
