"""olmoe-1b-7b [arXiv:2409.02060]: 16L d=2048 16H (MHA kv=16),
MoE 64 experts top-8, expert d_ff=1024, vocab 50304, qk-norm."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304, qk_norm=True, rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
)
