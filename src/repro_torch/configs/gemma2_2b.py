"""gemma2-2b [arXiv:2408.00118]: local/global alternating attention +
logit soft-capping.

The port follows the reference's model, not Hugging Face's Gemma 2: its
blocks have no post-norms, and attention scales its scores by
``head_dim ** -0.5``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    block_pattern=("attn_local", "attn_global"),
    alt_local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    act="gelu", tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, sliding_window=16)
