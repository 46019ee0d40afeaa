"""Launches the standalone grid-encode kernel (``csrc/encode.cu``), and
builds the level metadata every grid kernel reads.

The kernel replaces the JAX package's ``kernels/hashgrid/hashgrid.py:
hashgrid_encode_pallas``, for f32 and bf16 tables and, with
``table_scales``, for int8 and fp8-e4m3 ones (its quantized variant). Its
body, the JAX package's ``encode_one_level``, is the device function of the
same name in ``csrc/encode.cuh``, whose pieces the fused field kernels
(``csrc/field.cu``) run for every level too. The source note in ``csrc/encode.cu`` says what
bounds it and what its launch order does about that.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import TABLE_DTYPE_CODE, check_kernel_input

ENCODE_FWD = CudaKernel("encode_fwd", [PTR, PTR, PTR, INT, PTR, INT, INT, INT,
                                       INT, PTR, I64])
# (dim, n_features) pairs the grid kernels are instantiated for: 3-D points
# (nerf, nvr, nsdf) and 2-D ones (gia), hash or dense levels (F = 2) and
# tiled ones (F = 8)
SUPPORTED = {(3, 2), (3, 8), (2, 2), (2, 8)}


def level_meta(cfg: GridConfig) -> np.ndarray:
    """(L, 2) int32 [resolution, is_hashed], built on the host. The
    resolutions come from ``GridConfig.level_resolution`` in Python doubles,
    never from f32 arithmetic on the device."""
    return np.ascontiguousarray(
        [[cfg.level_resolution(l), int(cfg.level_is_hashed(l))]
         for l in range(cfg.n_levels)], dtype=np.int32)


def check_tables(tables: torch.Tensor, table_scales: Optional[torch.Tensor],
                 cfg: GridConfig) -> None:
    """Raise unless ``tables`` (and, for codec tables, their (L, 1, 1) f32
    scales) are what the grid kernels take for ``cfg``: each table row must
    be aligned to its own size, since the kernels load a row at once. The
    wrappers have already checked that scales come with codes only
    (``common.check_table_scales``)."""
    if (cfg.dim, cfg.n_features) not in SUPPORTED:
        raise ValueError(f"no grid kernel for dim={cfg.dim}, "
                         f"n_features={cfg.n_features}")
    check_kernel_input("tables", tables, (cfg.n_levels, cfg.table_size,
                                          cfg.n_features),
                       dtypes=tuple(TABLE_DTYPE_CODE))
    if tables.data_ptr() % (cfg.n_features * tables.element_size()):
        raise ValueError("tables: rows are not aligned to their size")
    if table_scales is not None:
        check_kernel_input("table_scales", table_scales,
                           (cfg.n_levels, 1, 1))


def hashgrid_encode_cuda(points: torch.Tensor, tables: torch.Tensor,
                         cfg: GridConfig,
                         table_scales: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, L*F) f32, all tensors on one CUDA
    device. ``tables`` (L, T, F) is f32 or bf16, or int8 / fp8-e4m3 with its
    (L, 1, 1) f32 ``table_scales``, which the kernel reads on the device."""
    check_tables(tables, table_scales, cfg)
    b = points.shape[0]
    check_kernel_input("points", points, (b, cfg.dim))
    meta = level_meta(cfg)                  # host array, read by the launch
    out = torch.empty((b, cfg.out_dim), dtype=torch.float32,
                      device=points.device)
    ENCODE_FWD(points.device, points.data_ptr(), tables.data_ptr(),
               0 if table_scales is None else table_scales.data_ptr(),
               TABLE_DTYPE_CODE[tables.dtype], meta.ctypes.data,
               cfg.n_levels, cfg.log2_table_size, cfg.dim, cfg.n_features,
               out.data_ptr(), b)
    return out
