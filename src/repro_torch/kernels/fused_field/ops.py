"""Public wrapper of the fused field: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

The app heads around it (NeRF's density pass through this kernel and its
colour pass through ``kernels/fused_mlp``; nvr's sigmoid/exp split) are in
``core.fields.apply_field``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.common import on_cpu
from repro_torch.kernels.fused_field.fused_field import fused_field_cuda
from repro_torch.kernels.fused_field.ref import field_ref


def field(points: torch.Tensor, tables: torch.Tensor,
          mlp_params: Dict[str, torch.Tensor], grid_cfg: GridConfig,
          mlp_cfg: MLPConfig) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, mlp out_dim) f32."""
    if on_cpu(points, tables, *mlp_params.values()):
        return field_ref(points, tables, mlp_params, grid_cfg, mlp_cfg)
    return fused_field_cuda(points, tables, mlp_params["w_in"],
                            mlp_params.get("w_hidden"), mlp_params["w_out"],
                            grid_cfg, mlp_cfg)
