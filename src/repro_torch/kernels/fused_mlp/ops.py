"""Public wrapper of the fused MLP: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

It is differentiable, as the JAX package's ``fused_mlp/ops.mlp`` is: a
``torch.autograd.Function`` whose forward is the kernel (``mlp_fwd``) and
whose backward rematerialises the activations with f32 matmuls
(``vjp.mlp_bwd``, the JAX package's ``_mlp_bwd``).

On meta tensors the forward records the kernel's work
(``kernels/cost.mlp_fwd``) on the active counter and returns an empty
(B, out) f32 meta tensor (``kernels/common.on_meta``).

NeRF's colour head has two forms here. :func:`plain_head` runs it op by
op around :func:`mlp` (exp, the SH encode, the colour input's concat, the
MLP, sigmoid, the output's concat) and is differentiable. :func:`nerf_head`
is the same function in one launch of the MLP kernel (``mlp_fwd_head``),
which keeps the colour input out of device memory. It has no backward and
refuses a call that needs a gradient; on CPU and meta tensors it runs
:func:`plain_head`, so a meta count is the op-by-op head's."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.encoding import sh_encode
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels import cost
from repro_torch.kernels.common import needs_grad, on_cpu, on_meta
from repro_torch.kernels.fused_mlp.fused_mlp import (fused_mlp_cuda,
                                                     nerf_head_cuda)
from repro_torch.kernels.fused_mlp.ref import mlp_ref
from repro_torch.kernels.fused_mlp.vjp import mlp_bwd
from repro_torch.obs.trace import annotate


def weight_dict(w_in, w_hidden, w_out) -> Dict[str, torch.Tensor]:
    """The weight dict of three tensors (no ``w_hidden`` when it is None)."""
    params = {"w_in": w_in, "w_out": w_out}
    if w_hidden is not None:
        params["w_hidden"] = w_hidden
    return params


class _MLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_in, w_hidden, w_out, cfg):
        ctx.save_for_backward(x, w_in, w_hidden, w_out)
        ctx.cfg = cfg
        weights = weight_dict(w_in, w_hidden, w_out)
        if on_meta(x, *weights.values()):
            cost.record("mlp_fwd", cost.mlp_fwd(
                x.shape[0], cfg, cost.tensor_bytes(weights.values())))
            return torch.empty((x.shape[0], cfg.out_dim),
                               dtype=torch.float32, device=x.device)
        if on_cpu(x, *weights.values()):
            return mlp_ref(weights, x, cfg)
        return fused_mlp_cuda(x, w_in, w_hidden, w_out, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w_in, w_hidden, w_out = ctx.saved_tensors
        d_x, d_w_in, d_w_hidden, d_w_out = mlp_bwd(
            x, w_in, w_hidden, w_out, ctx.cfg, g, ctx.needs_input_grad[0])
        return d_x, d_w_in, d_w_hidden, d_w_out, None


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: MLPConfig) -> torch.Tensor:
    """(B, in_dim) -> (B, out_dim) f32, under the ``mlp`` phase."""
    with annotate("mlp"):
        return _MLP.apply(x, params["w_in"], params.get("w_hidden"),
                          params["w_out"], cfg)


def plain_head(dfeat: torch.Tensor, dirs: torch.Tensor,
               params: Dict[str, torch.Tensor],
               cfg: MLPConfig) -> torch.Tensor:
    """NeRF's colour head op by op: dfeat (B, 16), the density MLP's
    output, and dirs (B, 3) -> (B, 4) [rgb, sigma], sigma = exp(dfeat[:, 0])
    (instant-NGP's exp activation), rgb = sigmoid of the colour MLP
    ``params`` on [SH(dirs), dfeat]. Differentiable."""
    sigma = torch.exp(dfeat[:, :1])
    color_in = torch.cat([sh_encode(dirs), dfeat], dim=-1)
    rgb = torch.sigmoid(mlp(params, color_in, cfg))
    return torch.cat([rgb, sigma], dim=-1)


def nerf_head(dfeat: torch.Tensor, dirs: torch.Tensor,
              params: Dict[str, torch.Tensor],
              cfg: MLPConfig) -> torch.Tensor:
    """:func:`plain_head`'s function in one kernel launch on CUDA tensors
    (``mlp_fwd_head``, under the ``mlp`` phase); :func:`plain_head` itself
    on CPU and meta tensors. Raises where a gradient is needed: the kernel
    has no backward."""
    if needs_grad(dfeat, dirs, *params.values()):
        raise NotImplementedError(
            "the colour-head kernel has no backward: where a gradient is "
            "needed the head runs as plain_head, around the differentiable "
            "MLP")
    if on_meta(dfeat, dirs, *params.values()) or on_cpu(
            dfeat, dirs, *params.values()):
        return plain_head(dfeat, dirs, params, cfg)
    with annotate("mlp"):
        return nerf_head_cuda(dfeat.contiguous(), dirs.contiguous(),
                              params["w_in"], params.get("w_hidden"),
                              params["w_out"], cfg)
