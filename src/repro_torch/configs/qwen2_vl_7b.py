"""qwen2-vl-7b [arXiv:2409.12191]: M-RoPE; the vision frontend is a
stub: the model takes precomputed patch embeddings (``embeds``) and their
3-axis positions (``positions3``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18_944, vocab=152_064,
    mrope=True, input_mode="embeds", tie_embeddings=False,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256)
