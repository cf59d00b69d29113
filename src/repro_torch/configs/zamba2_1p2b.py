"""zamba2-1.2b [hybrid]: Mamba2 backbone + weight-shared attention block
every 6 layers [arXiv:2411.15242; hf]. long_500k RUNS (SSM O(1) state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    block_pattern=("mamba2",), shared_attn_every=6,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
)

def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         head_dim=16, d_ff=128, vocab_size=512,
                         shared_attn_every=2, ssm_state=16, ssm_headdim=16,
                         dtype="float32", attn_chunk=32, loss_chunk=32)
