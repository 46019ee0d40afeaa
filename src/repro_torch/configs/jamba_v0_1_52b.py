"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096, Mamba+attention 1:7
interleave (1 attn layer per 8, offset 4), MoE 16 experts top-2 on every
other layer, 32H (GQA kv=8), d_ff=14336, vocab 65536.

Hardware adaptation (DESIGN.md): the Mamba layers are realized in the
SSD (Mamba-2) chunked-matmul form for MXU friendliness."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, rope_theta=10_000.0, use_rope=False,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, every=2, offset=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=64),
    attn_every=8, attn_offset=4,
)
