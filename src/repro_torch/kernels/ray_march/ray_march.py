"""Launches the compositing kernel (``csrc/composite.cu``).

It replaces the JAX package's ``kernels/ray_march/ray_march.py:
composite_pallas``. Memory bounds it on the card (16 bytes per sample
against a few flops); the kernel reads rgb, sigma and dts through their
strides, so the field's packed (R, S, 4) output and a broadcast (1, S) dts
go in without a copy.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import I64, INT, PTR, CudaKernel

COMPOSITE_FWD = CudaKernel("composite_fwd", [PTR, I64, I64, PTR, I64, I64,
                                             PTR, I64, I64, PTR, PTR, I64,
                                             INT])


def composite_cuda(rgb: torch.Tensor, sigma: torch.Tensor, dts: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rgb (R, S, 3), sigma (R, S), dts (R, S) (any strides; rgb's channel
    stride 1), all f32 on one CUDA device -> (pixel (R, 3), opacity (R,))."""
    r, s = sigma.shape
    for name, t, shape in (("rgb", rgb, (r, s, 3)), ("sigma", sigma, (r, s)),
                           ("dts", dts, (r, s))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
    if rgb.stride(2) != 1:
        raise ValueError("rgb: the kernel takes a channel stride of 1")
    pixel = torch.empty((r, 3), dtype=torch.float32, device=sigma.device)
    opacity = torch.empty((r,), dtype=torch.float32, device=sigma.device)
    COMPOSITE_FWD(sigma.device, rgb.data_ptr(), rgb.stride(0), rgb.stride(1),
                  sigma.data_ptr(), sigma.stride(0), sigma.stride(1),
                  dts.data_ptr(), dts.stride(0), dts.stride(1),
                  pixel.data_ptr(), opacity.data_ptr(), r, s)
    return pixel, opacity
