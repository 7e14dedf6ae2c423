"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, moe_d_ff=1408, vocab=151_936,
    n_experts=60, top_k=4, n_shared_experts=4,
    block_pattern=("attn",), tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, moe_d_ff=96, vocab=256, n_experts=8, top_k=2,
    n_shared_experts=1)
