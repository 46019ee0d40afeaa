"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the JAX
package, each with its wrapper (``ops.py``), its launch code and its plain
PyTorch version (``ref.py``). The CUDA sources are in ``../csrc``."""
from __future__ import annotations

from typing import Dict


def kernels() -> Dict:
    """name -> :class:`~repro_torch.kernels.build.CudaKernel`, every kernel
    of the library."""
    from repro_torch.kernels.fused_field.fused_field import (FIELD_FWD,
                                                             FIELD_FWD_Q)
    from repro_torch.kernels.fused_mlp.fused_mlp import MLP_FWD
    from repro_torch.kernels.hashgrid.hashgrid import ENCODE_FWD
    from repro_torch.kernels.ray_march.ray_march import COMPOSITE_FWD
    return {k.symbol: k for k in (FIELD_FWD, FIELD_FWD_Q, ENCODE_FWD, MLP_FWD,
                                  COMPOSITE_FWD)}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in kernels().items()}


def reset_launch_counts() -> None:
    for k in kernels().values():
        k.launches = 0
