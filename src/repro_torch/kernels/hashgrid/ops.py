"""Public wrapper of the standalone grid encode, the JAX package's
``kernels/hashgrid/ops.encode``: the CUDA kernels for CUDA tensors, the
plain versions for CPU tensors.

It is differentiable for f32 and bf16 tables, as the JAX wrapper's dense
route is: a ``torch.autograd.Function`` whose forward is the encode
(``encode_fwd``) and whose backward is the table scatter-add
(``encode_bwd``, ``csrc/encode_bwd.cu``; its plain twin is ``vjp.py``).
int8 and fp8 tables (with ``table_scales``) are inference only, as in the
JAX package, whose quantized route has no VJP: a call that would need a
gradient raises.

On meta tensors the forward and the VJP record their kernel's work
(``kernels/cost.encode_fwd``, ``encode_bwd``) on the active counter and
return empty meta outputs of the kernels' shapes and dtypes
(``kernels/common.on_meta``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.kernels import cost
from repro_torch.kernels.common import (check_table_scales, needs_grad,
                                        on_cpu, on_meta)
from repro_torch.kernels.hashgrid import vjp
from repro_torch.kernels.hashgrid.hashgrid import (hashgrid_encode_bwd_cuda,
                                                   hashgrid_encode_cuda)
from repro_torch.kernels.hashgrid.ref import encode_ref
from repro_torch.obs.trace import annotate


def _meta_encode(points, tables, cfg, table_scales=None):
    """The meta route of the encode: its work recorded, its empty output."""
    cost.record("encode_fwd", cost.encode_fwd(
        points.shape[0], cfg, tables.element_size(), table_scales is not None))
    return torch.empty((points.shape[0], cfg.out_dim), dtype=torch.float32,
                       device=points.device)


def encode_forward(points: torch.Tensor, tables: torch.Tensor,
                   cfg: GridConfig) -> torch.Tensor:
    """The encode of dense tables, outside autograd: ``encode_fwd`` on
    CUDA, the plain version on the CPU."""
    if on_meta(points, tables):
        return _meta_encode(points, tables, cfg)
    if on_cpu(points, tables):
        return encode_ref(points, tables, cfg)
    return hashgrid_encode_cuda(points, tables, cfg)


def encode_vjp(points: torch.Tensor, tables: torch.Tensor, cfg: GridConfig,
               g: torch.Tensor, need_points: bool
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The encode's VJP: cotangent g (B, L*F) -> (d_points or None,
    d_tables). ``encode_bwd`` on CUDA, the plain twin on the CPU."""
    if on_meta(points, tables, g):
        cost.record("encode_bwd", cost.encode_bwd(
            points.shape[0], cfg, tables.numel(), tables.element_size()))
        return (torch.empty_like(points) if need_points else None,
                torch.empty_like(tables))
    if on_cpu(points, tables, g):
        return vjp.encode_bwd(points, tables, cfg, g, need_points)
    return hashgrid_encode_bwd_cuda(points, tables, cfg, g, need_points)


class _Encode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, tables, cfg):
        ctx.save_for_backward(points, tables)
        ctx.cfg = cfg
        return encode_forward(points, tables, cfg)

    @staticmethod
    def backward(ctx, g):
        points, tables = ctx.saved_tensors
        need_points, need_tables = ctx.needs_input_grad[:2]
        d_points, d_tables = encode_vjp(points, tables, ctx.cfg, g,
                                        need_points)
        return d_points, d_tables if need_tables else None, None


def encode(points: torch.Tensor, tables: torch.Tensor, cfg: GridConfig, *,
           table_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, L*F) f32. ``table_scales`` (L, 1, 1)
    f32 goes with int8/fp8 tables and with nothing else. Runs under the
    ``encode`` phase."""
    with annotate("encode"):
        check_table_scales(tables, table_scales)
        if table_scales is None:
            return _Encode.apply(points, tables, cfg)
        if needs_grad(points, tables, table_scales):
            raise NotImplementedError(
                "quantized (int8/fp8) tables are inference only: the encode "
                "has no gradient for them, as the JAX package's quantized "
                "route has no VJP")
        if on_meta(points, tables, table_scales):
            return _meta_encode(points, tables, cfg, table_scales)
        if on_cpu(points, tables, table_scales):
            return encode_ref(points, tables, cfg, table_scales)
        return hashgrid_encode_cuda(points, tables, cfg, table_scales)
