"""whisper-base [arXiv:2212.04356]: enc-dec, 6L each side, d=512 8H,
d_ff=2048, vocab 51865. Conv audio frontend is a STUB: input_specs feeds
precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865, use_rope=False, is_encdec=True,
    frontend="audio", tie_embeddings=True,
)
