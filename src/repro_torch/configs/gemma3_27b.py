"""gemma3-27b [dense]: 5:1 local:global attention, 1024-token window,
dual rope theta, 262k vocab [hf:google/gemma-3; unverified].
long_500k SKIPPED: global layers are full attention (DESIGN.md)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    embed_scale=True, fsdp=True,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512, window=16,
                         dtype="float32", attn_chunk=32, loss_chunk=32,
                         fsdp=False)
