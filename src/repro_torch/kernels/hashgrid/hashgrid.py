"""Launches the standalone grid-encode kernel (``csrc/encode.cu``), plans
its level groups, and builds the level metadata every grid kernel reads.

The kernel replaces the JAX package's ``kernels/hashgrid/hashgrid.py:
hashgrid_encode_pallas``, for f32 and bf16 tables and, with
``table_scales``, for int8 and fp8-e4m3 ones (its quantized variant). Its
body, the JAX package's ``encode_one_level``, is the device code of
``csrc/encode.cuh``, whose pieces the fused field kernels (``csrc/field.cu``)
run for every level too.

What bounds it on the card is the count of gather requests and their
latency, not the bytes: every gather of a table row is a request of its
own to the SM's L1 and, on a miss, a 32-byte sector from L2 (the source
note in ``csrc/encode.cu`` says more). So a block takes a tile of points
and a group of G levels, issues all the group's gathers before it adds any
up, and writes each point's G*F features as whole 16-byte stores.
:func:`encode_plan` picks G: the largest group whose tables fit
:data:`L2_SHARE_BYTES` and whose rows fit the kernel's register budget,
made smaller while the grid would leave the card's SMs idle.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import TABLE_DTYPE_CODE, check_kernel_input

ENCODE_FWD = CudaKernel("encode_fwd", [PTR, PTR, PTR, INT, PTR, INT, INT, INT,
                                       INT, INT, PTR, I64])
# (dim, n_features) pairs the grid kernels are instantiated for: 3-D points
# (nerf, nvr, nsdf) and 2-D ones (gia), hash or dense levels (F = 2) and
# tiled ones (F = 8)
SUPPORTED = {(3, 2), (3, 8), (2, 2), (2, 8)}
# csrc/encode.cuh kMaxLevels; csrc/encode.cu kEncodeRows (points per block),
# kMaxGroup (levels a group may take) and kGroupRowBytes (G x F x itemsize,
# the bytes of one corner's rows a thread holds across its group)
MAX_LEVELS = 32
ENCODE_ROWS = 128
MAX_GROUP = 8
GROUP_ROW_BYTES = 32
# The share of the H100's 50 MB L2 one level group's tables may take: a
# third, so that the group's tables, the output its blocks write (16 MiB
# at nerf's 131,072-point tile) and the points stay in L2 together.
L2_SHARE_BYTES = 16 << 20
# Blocks per SM below which the grid leaves SMs idle
BLOCKS_PER_SM = 2


def level_meta(cfg: GridConfig) -> np.ndarray:
    """(L, 2) int32 [resolution, is_hashed], built on the host. The
    resolutions come from ``GridConfig.level_resolution`` in Python doubles,
    never from f32 arithmetic on the device."""
    return np.ascontiguousarray(
        [[cfg.level_resolution(l), int(cfg.level_is_hashed(l))]
         for l in range(cfg.n_levels)], dtype=np.int32)


def level_table_bytes(cfg: GridConfig, table_dtype: torch.dtype) -> list:
    """Bytes of each level's table that its gathers can reach: all T rows
    of a hashed level, the (res + 1)^d grid points of a dense one (at most
    T, which the index wraps)."""
    row = cfg.n_features * table_dtype.itemsize
    return [row * (cfg.table_size if cfg.level_is_hashed(l) else
                   min(cfg.table_size, (cfg.level_resolution(l) + 1)
                       ** cfg.dim))
            for l in range(cfg.n_levels)]


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def encode_plan(cfg: GridConfig, table_dtype: torch.dtype, n_points: int,
                n_sms: int) -> Dict:
    """The encode kernel's level groups for ``cfg``'s tables of
    ``table_dtype`` and a batch of ``n_points`` on a card of ``n_sms`` SMs.
    Raises on what the kernel does not take.

    G, the levels a block takes, is a power of two whose G*F floats are
    whole 16-byte stores and whose corner rows (G x F x itemsize bytes)
    fit the kernel's register budget; the largest such G whose every group
    of tables fits ``L2_SHARE_BYTES`` (the smallest if none does), halved
    while the grid has fewer than ``BLOCKS_PER_SM`` blocks per SM. The last
    group holds what is left when G does not divide L."""
    if (cfg.dim, cfg.n_features) not in SUPPORTED:
        raise ValueError(f"no grid kernel for dim={cfg.dim}, "
                         f"n_features={cfg.n_features}")
    if table_dtype not in TABLE_DTYPE_CODE:
        raise TypeError(f"no grid kernel for {table_dtype} tables")
    if not 1 <= cfg.n_levels <= MAX_LEVELS:
        raise ValueError(f"the grid kernels take 1 to {MAX_LEVELS} levels, "
                         f"not {cfg.n_levels}")
    if not 1 <= cfg.log2_table_size <= 31:
        raise ValueError(f"log2_table_size {cfg.log2_table_size} is not in "
                         "1..31")
    n_levels, f = cfg.n_levels, cfg.n_features
    level_bytes = level_table_bytes(cfg, table_dtype)
    row_bytes = f * table_dtype.itemsize
    sizes = [g for g in (1, 2, 4, 8) if g <= MAX_GROUP and (g * f) % 4 == 0
             and g * row_bytes <= GROUP_ROW_BYTES]

    def group_bytes(g):
        return max(sum(level_bytes[l:l + g]) for l in range(0, n_levels, g))

    fits = [g for g in sizes if group_bytes(g) <= L2_SHARE_BYTES]
    i = sizes.index(max(fits) if fits else sizes[0])
    tiles = -(-n_points // ENCODE_ROWS)
    while (i > 0 and tiles * -(-n_levels // sizes[i])
           < BLOCKS_PER_SM * n_sms):
        i -= 1
    g = sizes[i]
    groups = [(l, min(l + g, n_levels)) for l in range(0, n_levels, g)]
    return {"group_levels": g, "n_groups": len(groups), "groups": groups,
            "points_per_block": ENCODE_ROWS, "blocks": tiles * len(groups),
            "store_bytes": g * f * 4, "group_table_bytes": group_bytes(g)}


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
    plan = encode_plan(cfg, tables.dtype, b, sm_count(points.device.index))
    meta = level_meta(cfg)                  # host array, read by the launch
    out = torch.empty((b, cfg.out_dim), dtype=torch.float32,
                      device=points.device)
    ENCODE_FWD(points.device, points.data_ptr(), tables.data_ptr(),
               0 if table_scales is None else table_scales.data_ptr(),
               TABLE_DTYPE_CODE[tables.dtype], meta.ctypes.data,
               cfg.n_levels, cfg.log2_table_size, cfg.dim, cfg.n_features,
               plan["group_levels"], out.data_ptr(), b)
    return out
