"""gemma2-2b [dense]: local/global alternating, attn+logit softcaps
[arXiv:2408.00118; hf]. long_500k SKIPPED (global layers full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    block_pattern=("local", "attn"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, embed_scale=True,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab_size=512, window=16,
                         dtype="float32", attn_chunk=32, loss_chunk=32)
