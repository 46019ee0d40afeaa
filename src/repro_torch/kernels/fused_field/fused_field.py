"""Launches the fused encode + MLP kernel (``csrc/field.cu``), the neural
fields processor.

It replaces the JAX package's ``kernels/fused_field/fused_field.py:
fused_field_pallas``. At Table-I nerf_hash width the gathers (1 KiB per
point from a 64 MiB table stack) and the f32 MLP bound it; the source note
in ``csrc/field.cu`` says what the design does about them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import check_kernel_input
from repro_torch.kernels.hashgrid.hashgrid import level_meta

FIELD_FWD = CudaKernel("field_fwd", [PTR, PTR, PTR, INT, INT, INT, INT,
                                     PTR, PTR, PTR, INT, INT, INT, INT,
                                     PTR, I64])
# (dim, n_features) pairs the kernel is instantiated for
SUPPORTED = {(3, 2), (3, 8)}


def fused_field_cuda(points: torch.Tensor, tables: torch.Tensor,
                     w_in: torch.Tensor, w_hidden: Optional[torch.Tensor],
                     w_out: torch.Tensor, grid_cfg: GridConfig,
                     mlp_cfg: MLPConfig) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, out_dim) f32: encode + MLP in one
    kernel, all tensors on one CUDA device."""
    if (grid_cfg.dim, grid_cfg.n_features) not in SUPPORTED:
        raise ValueError(f"no field kernel for dim={grid_cfg.dim}, "
                         f"n_features={grid_cfg.n_features}")
    if mlp_cfg.in_dim != grid_cfg.out_dim:
        raise ValueError(f"MLP in_dim {mlp_cfg.in_dim} != grid out_dim "
                         f"{grid_cfg.out_dim}")
    b = points.shape[0]
    h = mlp_cfg.hidden_dim
    check_kernel_input("points", points, (b, grid_cfg.dim))
    check_kernel_input("tables", tables, (grid_cfg.n_levels,
                                          grid_cfg.table_size,
                                          grid_cfg.n_features))
    check_kernel_input("w_in", w_in, (mlp_cfg.in_dim, h))
    check_kernel_input("w_out", w_out, (h, mlp_cfg.out_dim))
    if mlp_cfg.n_hidden > 1:
        check_kernel_input("w_hidden", w_hidden, (mlp_cfg.n_hidden - 1, h, h))
    else:
        w_hidden = w_in                     # never read
    meta = level_meta(grid_cfg)             # host array, read by the launch
    out = torch.empty((b, mlp_cfg.out_dim), dtype=torch.float32,
                      device=points.device)
    FIELD_FWD(points.device, points.data_ptr(), tables.data_ptr(),
              meta.ctypes.data, grid_cfg.n_levels, grid_cfg.log2_table_size,
              grid_cfg.dim, grid_cfg.n_features, w_in.data_ptr(),
              w_hidden.data_ptr(), w_out.data_ptr(), mlp_cfg.in_dim, h,
              mlp_cfg.n_hidden, mlp_cfg.out_dim, out.data_ptr(), b)
    return out
