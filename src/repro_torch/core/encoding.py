"""Input encodings: the multi-resolution grid (hash, dense, tiled) and the
spherical-harmonics direction encoding.

The plain PyTorch version of the JAX package's ``core/encoding.py``. It is
the route for CPU tensors and the reference the CUDA kernels are held
against. Tables are stored uniformly as (L, T, F); T is a power of two, so
the hash's modulo is a bitwise AND.

The hash multiplies coordinates by primes up to 3,674,653,429 and relies
on uint32 wrap-around. Here it runs in int64 with ``& 0xFFFFFFFF`` after
every product, which gives the uint32 result on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.quant import qtypes

# instant-NGP's spatial hash primes (pi_1 = 1 keeps coherence in x).
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Parameters exactly as in the paper's Table I."""
    dim: int = 3            # input dimensionality d
    n_levels: int = 16      # L
    n_features: int = 2     # F
    log2_table_size: int = 19  # T = 2**log2_table_size
    base_resolution: int = 16  # Nmin
    growth: float = 1.51572    # b
    kind: str = "hash"      # 'hash' | 'dense' | 'tiled'

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_resolution(self, level: int) -> int:
        # in Python doubles, exactly as the JAX package computes it
        return int(math.floor(self.base_resolution * self.growth ** level))

    def level_is_hashed(self, level: int) -> bool:
        """Dense 1:1 mapping while the level's grid fits in T, else hash."""
        if self.kind in ("dense", "tiled"):
            return False
        n = self.level_resolution(level)
        return (n + 1) ** self.dim > self.table_size

    def params_bound(self) -> int:
        return self.table_size * self.n_levels * self.n_features


# Table I rows -> GridConfig
def hashgrid_config(dim=3, growth=1.51572, log2_T=19) -> GridConfig:
    return GridConfig(dim=dim, n_levels=16, n_features=2, log2_table_size=log2_T,
                      base_resolution=16, growth=growth, kind="hash")


def densegrid_config(dim=3, log2_T=19) -> GridConfig:
    return GridConfig(dim=dim, n_levels=8, n_features=2, log2_table_size=log2_T,
                      base_resolution=16, growth=1.405, kind="dense")


def tiledgrid_config(dim=3, log2_T=19) -> GridConfig:
    return GridConfig(dim=dim, n_levels=2, n_features=8, log2_table_size=log2_T,
                      base_resolution=128, growth=1.0, kind="tiled")


def init_grid(cfg: GridConfig, generator: Optional[torch.Generator] = None,
              dtype=torch.float32) -> torch.Tensor:
    """instant-NGP initializes features U(-1e-4, 1e-4). Drawn on the CPU
    from ``generator``."""
    shape = (cfg.n_levels, cfg.table_size, cfg.n_features)
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * 1e-4).to(dtype)


def _corner_offsets(dim: int) -> np.ndarray:
    """(2^d, d) binary corner offsets of the surrounding cell."""
    return np.array(
        [[(c >> i) & 1 for i in range(dim)] for c in range(1 << dim)],
        dtype=np.int64)


def hash_index(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Eq. 1. coords (..., d) integer -> (...,) int64 in [0, T)."""
    coords = coords.to(torch.int64)
    acc = (coords[..., 0] * HASH_PRIMES[0]) & _U32
    for i in range(1, coords.shape[-1]):
        acc = acc ^ ((coords[..., i] * HASH_PRIMES[i]) & _U32)
    return acc & (table_size - 1)


def dense_index(coords: torch.Tensor, resolution: int,
                table_size: int) -> torch.Tensor:
    """1:1 row-major mapping for dense/tiled levels; wraps into T."""
    coords = coords.to(torch.int64)
    stride = 1
    acc = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                      device=coords.device)
    for i in range(coords.shape[-1]):
        acc = (acc + coords[..., i] * stride) & _U32
        stride = (stride * (resolution + 1)) & _U32
    return acc & (table_size - 1)


def level_cell(points: torch.Tensor, res: int):
    """(cell (B, d) int64 clipped to [0, res-1], frac (B, d) f32). ``frac``
    is taken before the clip, so a coordinate of exactly 1.0 weights the
    corner at res-1 with frac 0."""
    pos = points.to(torch.float32) * res
    cell = torch.floor(pos)
    frac = pos - cell
    return cell.to(torch.int64).clamp(0, res - 1), frac


def level_corner_index(cell: torch.Tensor, bits, level: int,
                       cfg: GridConfig) -> torch.Tensor:
    """Table rows of one corner (``bits``, a (d,) 0/1 offset) of ``cell``."""
    corner = cell + torch.as_tensor(bits, dtype=torch.int64,
                                    device=cell.device)
    if cfg.level_is_hashed(level):
        return hash_index(corner, cfg.table_size)
    return dense_index(corner, cfg.level_resolution(level), cfg.table_size)


def encode_level(points: torch.Tensor, table: torch.Tensor, level: int,
                 cfg: GridConfig, scale: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Encode one resolution level: lookup 2^d corners + d-linear interp.

    points: (B, d) in [0, 1]; table: (T, F) -> (B, F) f32. ``scale`` is the
    level's dequant scale of an int8/fp8 table: each gathered row is
    dequantized (``q.float() * scale``) before the lerp, as the JAX
    kernels do; the table itself is never dequantized whole.
    """
    cell, frac = level_cell(points, cfg.level_resolution(level))
    out = torch.zeros((points.shape[0], cfg.n_features), dtype=torch.float32,
                      device=points.device)
    for bits in _corner_offsets(cfg.dim):
        feats = table[level_corner_index(cell, bits, level, cfg)]   # gather
        feats = (feats.to(torch.float32) if scale is None
                 else qtypes.dequantize(feats, scale))
        w = torch.ones_like(frac[:, 0])
        for i in range(cfg.dim):
            w = w * (frac[:, i] if bits[i] else 1.0 - frac[:, i])
        out = out + w[:, None] * feats
    return out


def grid_encode(points: torch.Tensor, tables: torch.Tensor,
                cfg: GridConfig, table_scales: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Full multi-resolution encoding: (B, d) -> (B, L*F). ``table_scales``
    (L, 1, 1) f32 goes with int8/fp8 tables."""
    return torch.cat([encode_level(
        points, tables[l], l, cfg,
        None if table_scales is None else table_scales[l])
        for l in range(cfg.n_levels)], dim=-1)


def sh_encode(dirs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics, degree 4 -> 16 features (instant-NGP's
    direction encoding)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)
