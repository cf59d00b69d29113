"""rwkv6-3b "Finch" [ssm]: attention-free, data-dependent per-channel decay
[arXiv:2404.05892; hf]. long_500k RUNS (O(1) recurrent state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv6",), rwkv_head_size=64, tie_embeddings=False,
)

def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=512, rwkv_head_size=16,
                         dtype="float32", attn_chunk=32, loss_chunk=32)
