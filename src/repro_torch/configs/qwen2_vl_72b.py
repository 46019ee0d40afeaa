"""qwen2-vl-72b [arXiv:2409.12191]: 80L d=8192 64H (GQA kv=8),
d_ff=29568, vocab 152064, M-RoPE (t/h/w sections), QKV bias.
Vision frontend is a STUB: input_specs feeds patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
    m_rope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    frontend="vision",
)
