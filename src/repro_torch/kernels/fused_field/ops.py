"""Public wrapper of the fused field: the CUDA kernels for CUDA tensors,
the plain version for CPU tensors.

``table_scales`` (L, 1, 1) f32 routes int8/fp8 tables through the
quantized kernel; a quantized MLP weight dict is dequantized on entry, as
the JAX package's ``fused_field/ops.field`` does. The app heads around it
(NeRF's density pass through this kernel and its colour pass through
``kernels/fused_mlp``; nvr's sigmoid/exp split) are in
``core.fields.apply_field``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.common import check_table_scales, on_cpu
from repro_torch.kernels.fused_field.fused_field import fused_field_cuda
from repro_torch.kernels.fused_field.ref import field_ref
from repro_torch.quant.api import maybe_dequant_mlp


def field(points: torch.Tensor, tables: torch.Tensor,
          mlp_params: Dict[str, torch.Tensor], grid_cfg: GridConfig,
          mlp_cfg: MLPConfig, *, table_scales: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, mlp out_dim) f32."""
    check_table_scales(tables, table_scales)
    mlp_params = maybe_dequant_mlp(mlp_params)
    extra = () if table_scales is None else (table_scales,)
    if on_cpu(points, tables, *extra, *mlp_params.values()):
        return field_ref(points, tables, mlp_params, grid_cfg, mlp_cfg,
                         table_scales)
    return fused_field_cuda(points, tables, mlp_params["w_in"],
                            mlp_params.get("w_hidden"), mlp_params["w_out"],
                            grid_cfg, mlp_cfg, table_scales)
