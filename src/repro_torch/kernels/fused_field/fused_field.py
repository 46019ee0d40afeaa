"""Launches the fused encode + MLP kernels (``csrc/field.cu``), the neural
fields processor.

They replace the JAX package's ``kernels/fused_field/fused_field.py:
fused_field_pallas``: ``field_fwd`` for f32 or bf16 tables, ``field_fwd_q``
for int8 / fp8-e4m3 tables with per-level f32 scales (the kernel's
quantized branch), which it dequantizes per gathered row. At Table-I
nerf_hash width the gathers (16 levels x 8 corners per point, latency-bound
with the 64 MiB f32 stack) and the MLP bound them. A persistent block per SM
overlaps the two: encode warps gather the next tile into one shared-memory
buffer while MLP warps run the current one on the tensor cores (3xTF32
``mma.sync``); the source note in ``csrc/field.cu`` says more.

:func:`field_plan` is the kernel's shared-memory plan; the wrapper raises
on a width or a plan the kernel does not take.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import TABLE_DTYPE_CODE, check_kernel_input
from repro_torch.kernels.fused_mlp.fused_mlp import (check_hidden, check_smem,
                                                     check_weights, tiles8,
                                                     weight_bytes)
from repro_torch.kernels.hashgrid.hashgrid import check_tables, level_meta

_MLP_ARGS = [PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR, I64]
FIELD_FWD = CudaKernel("field_fwd", [PTR, PTR, INT, PTR, INT, INT, INT, INT]
                       + _MLP_ARGS)
FIELD_FWD_Q = CudaKernel("field_fwd_q", [PTR, PTR, PTR, INT, PTR, INT, INT,
                                         INT, INT] + _MLP_ARGS)
# csrc/field.cu: encode warps, MLP warps (16 rows each), points per tile
ENCODE_WARPS, MLP_WARPS = 8, 8
TILE_ROWS = 16 * MLP_WARPS


def field_plan(mlp_cfg: MLPConfig, check: bool = True) -> Dict[str, int]:
    """The fused field kernel's plan for its MLP ``mlp_cfg`` (in_dim is the
    grid's L*F): hidden widths up to 64, the staged weights plus two
    feature tiles of TILE_ROWS rows in shared memory. Raises if the kernel
    does not take it (``check=False`` returns a plan over the
    shared-memory limit as it is, for ``analysis/budget.py`` to judge)."""
    if min(mlp_cfg.in_dim, mlp_cfg.out_dim, mlp_cfg.n_hidden) < 1:
        raise ValueError(f"no field kernel for {mlp_cfg}")
    hp = check_hidden(mlp_cfg, 64)
    stride = 8 * tiles8(mlp_cfg.in_dim) + 8   # csrc/field.cu feat_stride
    plan = {"hidden_padded": hp, "encode_warps": ENCODE_WARPS,
            "mlp_warps": MLP_WARPS, "tile_rows": TILE_ROWS,
            "smem_bytes": weight_bytes(mlp_cfg, hp)
            + 2 * TILE_ROWS * stride * 4}
    if check:
        check_smem(f"field MLP {mlp_cfg}", plan["smem_bytes"])
    return plan


def fused_field_cuda(points: torch.Tensor, tables: torch.Tensor,
                     w_in: torch.Tensor, w_hidden: Optional[torch.Tensor],
                     w_out: torch.Tensor, grid_cfg: GridConfig,
                     mlp_cfg: MLPConfig,
                     table_scales: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, out_dim) f32: encode + MLP in one
    kernel, all tensors on one CUDA device. ``tables`` is f32 or bf16, or
    int8 / fp8-e4m3 with its (L, 1, 1) f32 ``table_scales``, which the
    kernel reads on the device: no scale goes through the host. Weights
    are f32 or bf16."""
    check_tables(tables, table_scales, grid_cfg)
    if mlp_cfg.in_dim != grid_cfg.out_dim:
        raise ValueError(f"MLP in_dim {mlp_cfg.in_dim} != grid out_dim "
                         f"{grid_cfg.out_dim}")
    field_plan(mlp_cfg)
    b = points.shape[0]
    check_kernel_input("points", points, (b, grid_cfg.dim))
    w_hidden = check_weights(w_in, w_hidden, w_out, mlp_cfg)
    meta = level_meta(grid_cfg)             # host array, read by the launch
    out = torch.empty((b, mlp_cfg.out_dim), dtype=torch.float32,
                      device=points.device)
    grid_args = (meta.ctypes.data, grid_cfg.n_levels,
                 grid_cfg.log2_table_size, grid_cfg.dim, grid_cfg.n_features)
    mlp_args = (w_in.data_ptr(), w_hidden.data_ptr(), w_out.data_ptr(),
                int(w_in.dtype == torch.bfloat16), mlp_cfg.in_dim,
                mlp_cfg.hidden_dim, mlp_cfg.n_hidden, mlp_cfg.out_dim,
                out.data_ptr(), b)
    code = TABLE_DTYPE_CODE[tables.dtype]
    if table_scales is None:
        FIELD_FWD(points.device, points.data_ptr(), tables.data_ptr(), code,
                  *grid_args, *mlp_args)
    else:
        FIELD_FWD_Q(points.device, points.data_ptr(), tables.data_ptr(),
                    table_scales.data_ptr(), code, *grid_args, *mlp_args)
    return out
