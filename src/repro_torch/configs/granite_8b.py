"""granite-8b [arXiv:2405.04324]: llama-arch code model."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab=49_152,
    tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256)
