"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, moe_d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    block_pattern=("attn",), tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, moe_d_ff=96, vocab=256, n_experts=8, top_k=2)
