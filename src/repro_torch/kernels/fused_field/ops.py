"""Public wrapper of the fused field: the CUDA kernels for CUDA tensors,
the plain version for CPU tensors.

``table_scales`` (L, 1, 1) f32 routes int8/fp8 tables through the
quantized kernel; a quantized MLP weight dict is dequantized on entry, as
the JAX package's ``fused_field/ops.field`` does. The app heads around it
(NeRF's density pass through this kernel and its colour pass through
``kernels/fused_mlp``; nvr's sigmoid/exp split) are in
``core.fields.apply_field``.

Dense fields are differentiable, as the JAX package's ``_field`` custom
VJP is: a ``torch.autograd.Function`` whose forward is the fused kernel
(``field_fwd``) and whose backward rematerialises (``_field_bwd``): it
recomputes the features with the encode kernel (``encode_fwd``), the MLP's
activations with f32 matmuls, applies the transposes (``fused_mlp.vjp``)
and sends the features' gradient through the encode's scatter-add
(``encode_bwd``). Quantized tables or weights are inference only, as the
JAX package's quantized route bypasses its VJP: a call that would need a
gradient raises.

On meta tensors the wrapper records the kernel's work
(``kernels/cost.field_fwd``) on the active counter and returns an empty
(B, out) f32 meta tensor (``kernels/common.on_meta``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels import cost
from repro_torch.kernels.common import (check_table_scales, needs_grad,
                                        on_cpu, on_meta)
from repro_torch.kernels.fused_field.fused_field import fused_field_cuda
from repro_torch.kernels.fused_field.ref import field_ref
from repro_torch.kernels.fused_mlp.ops import weight_dict
from repro_torch.kernels.fused_mlp.vjp import mlp_bwd
from repro_torch.kernels.hashgrid.ops import encode_forward, encode_vjp
from repro_torch.obs.trace import annotate
from repro_torch.quant.api import maybe_dequant_mlp


def _meta_field(points, tables, weights, grid_cfg, mlp_cfg, table_scales):
    """The meta route: the kernel's work recorded, its empty output."""
    cost.record("field_fwd" if table_scales is None else "field_fwd_q",
                cost.field_fwd(points.shape[0], grid_cfg, mlp_cfg,
                               tables.element_size(), table_scales is not None,
                               cost.tensor_bytes(weights.values())))
    return torch.empty((points.shape[0], mlp_cfg.out_dim),
                       dtype=torch.float32, device=points.device)


class _Field(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, tables, w_in, w_hidden, w_out, grid_cfg,
                mlp_cfg):
        ctx.save_for_backward(points, tables, w_in, w_hidden, w_out)
        ctx.cfgs = (grid_cfg, mlp_cfg)
        weights = weight_dict(w_in, w_hidden, w_out)
        if on_meta(points, tables, *weights.values()):
            return _meta_field(points, tables, weights, grid_cfg, mlp_cfg,
                               None)
        if on_cpu(points, tables, *weights.values()):
            return field_ref(points, tables, weights, grid_cfg, mlp_cfg)
        return fused_field_cuda(points, tables, w_in, w_hidden, w_out,
                                grid_cfg, mlp_cfg)

    @staticmethod
    def backward(ctx, g):
        points, tables, w_in, w_hidden, w_out = ctx.saved_tensors
        grid_cfg, mlp_cfg = ctx.cfgs
        need = ctx.needs_input_grad
        with torch.no_grad():
            feats = encode_forward(points, tables, grid_cfg)
            d_feats, d_w_in, d_w_hidden, d_w_out = mlp_bwd(
                feats, w_in, w_hidden, w_out, mlp_cfg, g,
                need[0] or need[1])
            d_points, d_tables = (None, None)
            if need[0] or need[1]:
                d_points, d_tables = encode_vjp(points, tables, grid_cfg,
                                                d_feats, need[0])
        return (d_points, d_tables if need[1] else None, d_w_in, d_w_hidden,
                d_w_out, None, None)


def field(points: torch.Tensor, tables: torch.Tensor,
          mlp_params: Dict[str, torch.Tensor], grid_cfg: GridConfig,
          mlp_cfg: MLPConfig, *, table_scales: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """points (B, d) in [0, 1] -> (B, mlp out_dim) f32, under the
    ``encode_mlp`` phase (one kernel covers both phases)."""
    with annotate("encode_mlp"):
        check_table_scales(tables, table_scales)
        quantized = (table_scales is not None
                     or any(k.endswith("_scale") for k in mlp_params))
        if not quantized:
            return _Field.apply(points, tables, mlp_params["w_in"],
                                mlp_params.get("w_hidden"),
                                mlp_params["w_out"], grid_cfg, mlp_cfg)
        if needs_grad(points, tables, table_scales, *mlp_params.values()):
            raise NotImplementedError(
                "quantized tables or weights are inference only: the field "
                "has no gradient for them, as the JAX package's quantized "
                "route bypasses its VJP")
        weights = maybe_dequant_mlp(mlp_params)
        extra = () if table_scales is None else (table_scales,)
        if on_meta(points, tables, *extra, *weights.values()):
            return _meta_field(points, tables, weights, grid_cfg, mlp_cfg,
                               table_scales)
        if on_cpu(points, tables, *extra, *weights.values()):
            return field_ref(points, tables, weights, grid_cfg, mlp_cfg,
                             table_scales)
        return fused_field_cuda(points, tables, weights["w_in"],
                                weights.get("w_hidden"), weights["w_out"],
                                grid_cfg, mlp_cfg, table_scales)
