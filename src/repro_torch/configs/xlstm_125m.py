"""xlstm-125m [arXiv:2405.04517]: alternating mLSTM / sLSTM blocks,
no separate FFN (d_ff=0)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50_304,
    block_pattern=("mlstm", "slstm"), tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    vocab=256, mlstm_chunk=16)
