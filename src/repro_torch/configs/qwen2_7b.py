"""qwen2-7b [arXiv:2407.10671]: 28L d=3584 28H (GQA kv=4), d_ff=18944,
vocab 152064, QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
)
