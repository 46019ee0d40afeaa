"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small, config.json]:
a 32B-A9B hybrid, 40L d=4096: 36 Mamba-2 mixers (128 heads of 64,
d_state 128, one group, conv 4 with bias, chunk 256) and 4 GQA attention
mixers without positional encoding (32 q heads, 8 KV heads of 128) at
layers 5, 15, 25 and 35; an MoE FFN on every layer, 72 SwiGLU experts of
width 768, top-10 (a softmax over the ten picked logits, which is the
softmax over all, top-10, renormalised), plus one always-on SwiGLU expert
of width 1536; embedding_multiplier 12, residual_multiplier 0.22,
attention_multiplier 1/128 as the softmax scale, logits_scaling 16; tied
embeddings over 100,352 ids, RMSNorm eps 1e-5. Dropless, as published.

A port-only arch (``PortModelConfig``): the JAX package has no twin, so
``registry.list_archs()`` keeps the ten and ``registry.get_config``
resolves this one from ``registry.PORT_ARCH_MODULES``. The load-balance
loss is the port's (0.01 / n_layers), which the config does not give."""
from repro_torch.models.config import MoEConfig, PortModelConfig, SSMConfig

CONFIG = PortModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352, use_rope=False, norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, d_expert=768),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    attn_every=10, attn_offset=5,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0,
    ssm_gate_before_norm=True, shared_expert_width=1536, moe_dropless=True,
)

# one whole period at laptop scale for the CPU tests and --reduced:
# attention_multiplier 1/head_dim as published (1/128 at head_dim 128)
REDUCED = PortModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=256, use_rope=False, norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=32),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8, n_groups=1,
                  chunk=16),
    attn_every=10, attn_offset=5,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0625, logits_scaling=16.0,
    ssm_gate_before_norm=True, shared_expert_width=48, moe_dropless=True,
)
