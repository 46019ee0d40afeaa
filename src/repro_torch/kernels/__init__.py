"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the JAX
package, each with its wrapper (``ops.py``), its launch code and its plain
PyTorch version (``ref.py``), plus two terms the JAX package computes in
XLA: the encode's backward scatter-add (its plain twin is
``hashgrid/vjp.py``) and Mamba-2's SSD, its intra-chunk and inter-chunk
terms, forward and backward (``ssd``). The CUDA sources are in ``../csrc``."""
from __future__ import annotations

from typing import Dict


def kernels() -> Dict:
    """name -> :class:`~repro_torch.kernels.build.CudaKernel`, every entry
    point of the library. ``mlp_fwd_head`` launches an instantiation of
    ``mlp_fwd``'s kernel, so its launches count under both names."""
    from repro_torch.kernels.fused_field.fused_field import (FIELD_FWD,
                                                             FIELD_FWD_Q)
    from repro_torch.kernels.fused_mlp.fused_mlp import MLP_FWD, MLP_FWD_HEAD
    from repro_torch.kernels.hashgrid.hashgrid import ENCODE_BWD, ENCODE_FWD
    from repro_torch.kernels.ray_march.ray_march import COMPOSITE_FWD
    from repro_torch.kernels.ssd.ssd import (SSD_INTER_BWD, SSD_INTER_FWD,
                                            SSD_INTRA_BWD, SSD_INTRA_FWD)
    return {k.symbol: k for k in (FIELD_FWD, FIELD_FWD_Q, ENCODE_FWD,
                                  ENCODE_BWD, MLP_FWD, MLP_FWD_HEAD,
                                  COMPOSITE_FWD, SSD_INTRA_FWD,
                                  SSD_INTRA_BWD, SSD_INTER_FWD,
                                  SSD_INTER_BWD)}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in kernels().items()}


def reset_launch_counts() -> None:
    for k in kernels().values():
        k.launches = 0
