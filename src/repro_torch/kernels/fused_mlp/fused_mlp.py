"""Launches the fully fused MLP kernel (``csrc/mlp.cu``).

It replaces the JAX package's ``kernels/fused_mlp/fused_mlp.py:
fused_mlp_pallas``. f32 arithmetic bounds it on the card (29,056 flops
against 140 bytes per row at NeRF's colour MLP); the source note in
``csrc/mlp.cu`` says what the design does about that.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import check_kernel_input

MLP_FWD = CudaKernel("mlp_fwd", [PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                 PTR, I64])


def fused_mlp_cuda(x: torch.Tensor, w_in: torch.Tensor,
                   w_hidden: Optional[torch.Tensor], w_out: torch.Tensor,
                   cfg: MLPConfig) -> torch.Tensor:
    """x (B, in_dim) -> (B, out_dim) f32, all on one CUDA device."""
    b = x.shape[0]
    h = cfg.hidden_dim
    check_kernel_input("x", x, (b, cfg.in_dim))
    check_kernel_input("w_in", w_in, (cfg.in_dim, h))
    check_kernel_input("w_out", w_out, (h, cfg.out_dim))
    if cfg.n_hidden > 1:
        check_kernel_input("w_hidden", w_hidden, (cfg.n_hidden - 1, h, h))
    else:
        w_hidden = w_in                     # never read
    out = torch.empty((b, cfg.out_dim), dtype=torch.float32, device=x.device)
    MLP_FWD(x.device, x.data_ptr(), w_in.data_ptr(), w_hidden.data_ptr(),
            w_out.data_ptr(), cfg.in_dim, h, cfg.n_hidden, cfg.out_dim,
            out.data_ptr(), b)
    return out
