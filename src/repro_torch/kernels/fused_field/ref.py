"""Plain PyTorch version of the fused field kernel: encode -> MLP through
the core library."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.encoding import GridConfig, grid_encode
from repro_torch.core.mlp import MLPConfig, apply_mlp


def field_ref(points: torch.Tensor, tables: torch.Tensor,
              mlp_params: Dict[str, torch.Tensor], grid_cfg: GridConfig,
              mlp_cfg: MLPConfig) -> torch.Tensor:
    return apply_mlp(mlp_params, grid_encode(points, tables, grid_cfg),
                     mlp_cfg)
