"""Plain PyTorch version of the fused field kernels: encode -> MLP through
the core library. With ``table_scales`` the encode dequantizes each
gathered row of an int8/fp8 table before the lerp."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.encoding import GridConfig, grid_encode
from repro_torch.core.mlp import MLPConfig, apply_mlp


def field_ref(points: torch.Tensor, tables: torch.Tensor,
              mlp_params: Dict[str, torch.Tensor], grid_cfg: GridConfig,
              mlp_cfg: MLPConfig,
              table_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    return apply_mlp(mlp_params,
                     grid_encode(points, tables, grid_cfg, table_scales),
                     mlp_cfg)
