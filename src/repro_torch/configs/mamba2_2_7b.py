"""mamba2-2.7b [arXiv:2405.21060]: attention-free SSD (state-space
duality), 64L d=2560, d_inner=5120 (expand 2), 80 SSD heads of dim 64,
ssm_state=128, vocab 50280."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=128),
)
