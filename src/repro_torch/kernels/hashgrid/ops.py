"""Public wrapper of the standalone grid encode, the JAX package's
``kernels/hashgrid/ops.encode``: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

It is forward only. The JAX wrapper's dense route has a VJP (the table
scatter-add of ``vjp.encode_bwd``), which belongs to the training slice of
the port; until then a call that would need a gradient raises rather than
return one that is silently wrong.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.kernels.common import check_table_scales, on_cpu
from repro_torch.kernels.hashgrid.hashgrid import hashgrid_encode_cuda
from repro_torch.kernels.hashgrid.ref import encode_ref


def encode(points: torch.Tensor, tables: torch.Tensor, cfg: GridConfig, *,
           table_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, L*F) f32. ``table_scales`` (L, 1, 1)
    f32 goes with int8/fp8 tables and with nothing else."""
    check_table_scales(tables, table_scales)
    if torch.is_grad_enabled() and (points.requires_grad
                                    or tables.requires_grad):
        raise NotImplementedError(
            "encode has no backward in the port yet (the JAX package's "
            "vjp.encode_bwd is part of the training slice)")
    extra = () if table_scales is None else (table_scales,)
    if on_cpu(points, tables, *extra):
        return encode_ref(points, tables, cfg, table_scales)
    return hashgrid_encode_cuda(points, tables, cfg, table_scales)
