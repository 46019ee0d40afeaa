"""Public wrapper of the fused MLP: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.common import on_cpu
from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp_cuda
from repro_torch.kernels.fused_mlp.ref import mlp_ref


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: MLPConfig) -> torch.Tensor:
    """(B, in_dim) -> (B, out_dim) f32."""
    if on_cpu(x, *params.values()):
        return mlp_ref(params, x, cfg)
    return fused_mlp_cuda(x, params["w_in"], params.get("w_hidden"),
                          params["w_out"], cfg)
