"""Plain PyTorch version of the grid encode: the core library's
``grid_encode``. With ``table_scales`` it dequantizes each gathered corner
row of an int8/fp8 table (``q.float() * scale``) before the lerp, the JAX
package's ``encode_ref_quantized``. It is the oracle of the standalone
encode kernel and of the encode inside the fused field kernels."""
from repro_torch.core.encoding import grid_encode as encode_ref  # noqa: F401
