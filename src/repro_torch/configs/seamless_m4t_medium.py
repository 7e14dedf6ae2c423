"""seamless-m4t-medium [arXiv:2308.11596]: encoder–decoder transformer
backbone, 12 encoder + 12 decoder layers; the audio frontend is a stub:
the encoder takes precomputed frame embeddings (``src_embeds``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256_206,
    encdec=True, n_enc_layers=12, n_dec_layers=12,
    input_mode="embeds", norm_kind="layernorm", act="gelu",
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)
