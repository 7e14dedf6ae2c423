"""olmo-1b [arXiv:2402.00838]: non-parametric LayerNorm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50_304,
    norm_kind="nonparam_ln", tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256)
