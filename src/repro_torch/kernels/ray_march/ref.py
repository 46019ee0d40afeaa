"""Plain PyTorch version of the composite kernel: the core renderer's
composite."""
from repro_torch.core.render import composite as composite_ref  # noqa: F401
