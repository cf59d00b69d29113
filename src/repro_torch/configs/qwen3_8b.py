"""qwen3-8b [dense]: qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B; hf].
long_500k SKIPPED (pure full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         dtype="float32", attn_chunk=32, loss_chunk=32)
