"""recurrentgemma-9b [arXiv:2402.19427]: Griffin — RG-LRU + local
attention, 2 recurrent : 1 local-attention pattern; MQA (kv=1)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12_288, vocab=256_000,
    block_pattern=("rglru", "rglru", "attn"), sliding_window=2048,
    d_rec=4096, act="gelu", tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=256, sliding_window=16, d_rec=64)
