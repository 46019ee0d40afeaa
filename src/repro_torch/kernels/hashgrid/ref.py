"""Plain PyTorch version of the grid encode: the core library's
``grid_encode``, the oracle of the encode inside the fused field kernel."""
from repro_torch.core.encoding import grid_encode as encode_ref  # noqa: F401
