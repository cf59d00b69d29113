"""qwen2-vl-2b [vlm]: M-RoPE (t/h/w position streams), dynamic-resolution
vision frontend STUBBED to precomputed patch embeddings per spec
[arXiv:2409.12191; hf]. long_500k SKIPPED (full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    frontend="stub_embed",
)

def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512,
                         mrope_sections=(4, 2, 2),
                         dtype="float32", attn_chunk=32, loss_chunk=32)
