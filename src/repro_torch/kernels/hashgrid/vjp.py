"""Plain PyTorch version of the grid encode's VJP: the JAX package's
``kernels/hashgrid/vjp.encode_bwd``, on the CPU and as the yardstick of the
card's scatter-add kernel (``csrc/encode_bwd.cu``).

The encode is a gather and a d-linear lerp, so its transpose is a
scatter-add: every point adds ``w_corner * g`` into the 2^d table rows it
read at each level (``d_tables``), and the derivative of the weights by the
point gives ``d_points``. As in the JAX VJP, ``frac`` comes from the
unclipped floor (whose own derivative is 0) and the corner rows from the
clipped cell, exactly as the forward (``core.encoding``) addresses them;
``d_points`` takes the explicit product over the other dimensions times
``res``, never a division by ``s_i``, so a point on a cell face gets no 0/0.
``d_tables`` is summed in f32 with ``index_add_`` and cast once to the
tables' dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.encoding import (GridConfig, _corner_offsets,
                                       level_cell, level_corner_index)

# table dtypes the encode backward takes: codes are inference only
GRAD_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def check_grad_tables(tables: torch.Tensor) -> None:
    """Raise unless ``tables`` is of a dtype the backward takes."""
    if tables.dtype not in GRAD_TABLE_DTYPES:
        raise TypeError(f"the encode backward takes f32 or bf16 tables, not "
                        f"{tables.dtype}: quantized tables are inference only")


def encode_bwd(points: torch.Tensor, tables: torch.Tensor, cfg: GridConfig,
               g: torch.Tensor, need_points: bool = True
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Cotangent g (B, L*F) -> (d_points (B, d), or None unless
    ``need_points``; d_tables (L, T, F) in the tables' dtype)."""
    check_grad_tables(tables)
    pts = points.to(torch.float32)
    b, nf = pts.shape[0], cfg.n_features
    d_tables = torch.zeros(tables.shape, dtype=torch.float32,
                           device=tables.device)
    d_points = torch.zeros((b, cfg.dim), dtype=torch.float32,
                           device=points.device)
    for level in range(cfg.n_levels):
        res = cfg.level_resolution(level)
        cell, frac = level_cell(pts, res)
        gl = g[:, level * nf:(level + 1) * nf].to(torch.float32)
        for bits in _corner_offsets(cfg.dim):
            idx = level_corner_index(cell, bits, level, cfg)
            s = [frac[:, i] if bits[i] else 1.0 - frac[:, i]
                 for i in range(cfg.dim)]
            w = s[0]
            for i in range(1, cfg.dim):
                w = w * s[i]
            d_tables[level].index_add_(0, idx, w[:, None] * gl)
            if not need_points:
                continue
            feats = tables[level][idx].to(torch.float32)
            gdot = (feats * gl).sum(dim=-1)
            for i in range(cfg.dim):
                others = torch.ones_like(gdot)
                for k in range(cfg.dim):
                    if k != i:
                        others = others * s[k]
                sign = 1.0 if bits[i] else -1.0
                d_points[:, i] += gdot * sign * others * float(res)
    return (d_points.to(points.dtype) if need_points else None,
            d_tables.to(tables.dtype))
