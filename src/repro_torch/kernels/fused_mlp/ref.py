"""Plain PyTorch version of the fused MLP kernel: the core library's MLP."""
from repro_torch.core.mlp import apply_mlp as mlp_ref  # noqa: F401
