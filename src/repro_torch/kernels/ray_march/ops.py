"""Public wrapper of the compositing kernel: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import on_cpu
from repro_torch.kernels.ray_march.ray_march import composite_cuda
from repro_torch.kernels.ray_march.ref import composite_ref


def composite(rgb: torch.Tensor, sigma: torch.Tensor, dts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, S, 3), (R, S), (R, S) or (1, S) -> ((R, 3), (R,)).

    Deterministic sampling gives a broadcast (1, S) dts. It is expanded to
    (R, S) as a stride-0 view, which the kernel reads in place."""
    dts = dts.expand(sigma.shape)
    if on_cpu(rgb, sigma, dts):
        return composite_ref(rgb, sigma, dts)
    return composite_cuda(rgb, sigma, dts)
