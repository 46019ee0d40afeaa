"""Public wrapper of the fused MLP: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

It is differentiable, as the JAX package's ``fused_mlp/ops.mlp`` is: a
``torch.autograd.Function`` whose forward is the kernel (``mlp_fwd``) and
whose backward rematerialises the activations with f32 matmuls
(``vjp.mlp_bwd``, the JAX package's ``_mlp_bwd``).

On meta tensors the forward records the kernel's work
(``kernels/cost.mlp_fwd``) on the active counter and returns an empty
(B, out) f32 meta tensor (``kernels/common.on_meta``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels import cost
from repro_torch.kernels.common import on_cpu, on_meta
from repro_torch.kernels.fused_mlp.fused_mlp import fused_mlp_cuda
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
