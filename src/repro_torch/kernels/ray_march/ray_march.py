"""Launches the compositing kernel (``csrc/composite.cu``).

It replaces the JAX package's ``kernels/ray_march/ray_march.py:
composite_pallas``. Bytes bound it on the card (16 per sample against a
few flops), and at the served tile (4096 rays x 32 samples, 2.16 MB) that
bound is below one launch's cost, so latency is what it can lose. Each ray
therefore takes a segment of lanes, one lane per sample
(:func:`composite_plan`): the transmittance is a warp-shuffle scan, the
sums a shuffle reduction, and the rgb and sigma columns of the field's
packed (R, S, 4) output are read with one 16-byte load per sample, a
warp's loads contiguous (:func:`is_packed` tells that layout apart). Other
strides take a strided path through the same kernel, and a broadcast
(1, S) dts goes in with ray stride 0; neither is copied.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.build import I64, INT, PTR, CudaKernel

COMPOSITE_FWD = CudaKernel("composite_fwd", [PTR, I64, I64, PTR, I64, I64,
                                             PTR, I64, I64, PTR, PTR, I64,
                                             INT, INT, INT])
# csrc/composite.cu kCompositeWarps: warps per block
WARPS_PER_BLOCK = 8


def composite_plan(n_samples: int) -> Dict[str, int]:
    """Lanes per ray (the next power of two of S, at most 32: S > 32 walks
    32-sample chunks, S < 32 puts 32 / W rays in a warp) and rays per
    block."""
    if n_samples < 0:
        raise ValueError(f"n_samples must be >= 0, got {n_samples}")
    lanes = 1
    while lanes < min(n_samples, 32):
        lanes *= 2
    return {"lanes_per_ray": lanes,
            "rays_per_block": WARPS_PER_BLOCK * (32 // lanes)}


def is_packed(rgb: torch.Tensor, sigma: torch.Tensor) -> bool:
    """True when rgb and sigma are the columns of one (R, S, 4) f32 array
    whose rows start 16 bytes apart on a 16-byte boundary: the kernel then
    reads a sample's (r, g, b, sigma) with one 16-byte load."""
    return (sigma.data_ptr() == rgb.data_ptr() + 12
            and rgb.stride(1) == sigma.stride(1) == 4
            and rgb.stride(0) == sigma.stride(0)
            and rgb.stride(0) % 4 == 0 and rgb.data_ptr() % 16 == 0)


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
    plan = composite_plan(s)
    pixel = torch.empty((r, 3), dtype=torch.float32, device=sigma.device)
    opacity = torch.empty((r,), dtype=torch.float32, device=sigma.device)
    COMPOSITE_FWD(sigma.device, rgb.data_ptr(), rgb.stride(0), rgb.stride(1),
                  sigma.data_ptr(), sigma.stride(0), sigma.stride(1),
                  dts.data_ptr(), dts.stride(0), dts.stride(1),
                  pixel.data_ptr(), opacity.data_ptr(), r, s,
                  plan["lanes_per_ray"], int(is_packed(rgb, sigma)))
    return pixel, opacity
