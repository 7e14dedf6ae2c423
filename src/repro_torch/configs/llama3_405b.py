"""llama3-405b [arXiv:2407.21783]: GQA, 128k vocab — the largest cell."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53_248, vocab=128_256,
    rope_theta=500_000.0, tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512)
