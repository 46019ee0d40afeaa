"""Launches the fused encode + MLP kernels (``csrc/field.cu``), the neural
fields processor.

They replace the JAX package's ``kernels/fused_field/fused_field.py:
fused_field_pallas``: ``field_fwd`` for f32 tables, ``field_fwd_q`` for
int8 / fp8-e4m3 tables with per-level f32 scales (the kernel's quantized
branch), which it dequantizes per gathered row. At Table-I nerf_hash width
the gathers (16 levels x 8 corners per point) and the f32 MLP bound them;
the source note in ``csrc/field.cu`` says what the design does about them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import TABLE_DTYPE_CODE, check_kernel_input
from repro_torch.kernels.hashgrid.hashgrid import check_tables, level_meta

_MLP_ARGS = [PTR, PTR, PTR, INT, INT, INT, INT, PTR, I64]
FIELD_FWD = CudaKernel("field_fwd", [PTR, PTR, PTR, INT, INT, INT, INT]
                       + _MLP_ARGS)
FIELD_FWD_Q = CudaKernel("field_fwd_q", [PTR, PTR, PTR, INT, PTR, INT, INT,
                                         INT, INT] + _MLP_ARGS)


def fused_field_cuda(points: torch.Tensor, tables: torch.Tensor,
                     w_in: torch.Tensor, w_hidden: Optional[torch.Tensor],
                     w_out: torch.Tensor, grid_cfg: GridConfig,
                     mlp_cfg: MLPConfig,
                     table_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, out_dim) f32: encode + MLP in one
    kernel, all tensors on one CUDA device. ``tables`` is f32, or int8 /
    fp8-e4m3 with its (L, 1, 1) f32 ``table_scales``, which the kernel
    reads on the device: no scale goes through the host."""
    check_tables(tables, table_scales, grid_cfg)
    if mlp_cfg.in_dim != grid_cfg.out_dim:
        raise ValueError(f"MLP in_dim {mlp_cfg.in_dim} != grid out_dim "
                         f"{grid_cfg.out_dim}")
    b = points.shape[0]
    h = mlp_cfg.hidden_dim
    check_kernel_input("points", points, (b, grid_cfg.dim))
    check_kernel_input("w_in", w_in, (mlp_cfg.in_dim, h))
    check_kernel_input("w_out", w_out, (h, mlp_cfg.out_dim))
    if mlp_cfg.n_hidden > 1:
        check_kernel_input("w_hidden", w_hidden, (mlp_cfg.n_hidden - 1, h, h))
    else:
        w_hidden = w_in                     # never read
    meta = level_meta(grid_cfg)             # host array, read by the launch
    out = torch.empty((b, mlp_cfg.out_dim), dtype=torch.float32,
                      device=points.device)
    grid_args = (meta.ctypes.data, grid_cfg.n_levels,
                 grid_cfg.log2_table_size, grid_cfg.dim, grid_cfg.n_features)
    mlp_args = (w_in.data_ptr(), w_hidden.data_ptr(), w_out.data_ptr(),
                mlp_cfg.in_dim, h, mlp_cfg.n_hidden, mlp_cfg.out_dim,
                out.data_ptr(), b)
    if table_scales is None:
        FIELD_FWD(points.device, points.data_ptr(), tables.data_ptr(),
                  *grid_args, *mlp_args)
    else:
        FIELD_FWD_Q(points.device, points.data_ptr(), tables.data_ptr(),
                    table_scales.data_ptr(), TABLE_DTYPE_CODE[tables.dtype],
                    *grid_args, *mlp_args)
    return out
