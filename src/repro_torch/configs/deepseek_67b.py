"""deepseek-67b [dense]: llama-architecture, GQA kv=8
[arXiv:2401.02954; hf]. long_500k SKIPPED (pure full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    rope_theta=10_000.0, fsdp=True,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         dtype="float32", attn_chunk=32, loss_chunk=32,
                         fsdp=False)
