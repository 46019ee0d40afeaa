"""Public wrapper of the compositing kernel: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

It has no backward, as the JAX package's Pallas composite has none: a call
that would need a gradient raises on every device. Training composites
with the plain, differentiable ``core.render.composite``, as the JAX
package's training route composites in XLA
(``render_rays(use_kernel_composite=False)``).

On meta tensors it records the kernel's work (``kernels/cost.
composite_fwd``) on the active counter and returns empty (R, 3) and (R,)
f32 meta tensors (``kernels/common.on_meta``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.common import needs_grad, on_cpu, on_meta
from repro_torch.kernels.ray_march.ray_march import composite_cuda
from repro_torch.kernels.ray_march.ref import composite_ref
from repro_torch.obs.trace import annotate


def composite(rgb: torch.Tensor, sigma: torch.Tensor, dts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, S, 3), (R, S), (R, S) or (1, S) -> ((R, 3), (R,)).

    Deterministic sampling gives a broadcast (1, S) dts. It is expanded to
    (R, S) as a stride-0 view, which the kernel reads in place."""
    if needs_grad(rgb, sigma, dts):
        raise NotImplementedError(
            "the compositing kernel has no backward (nor has the JAX "
            "package's Pallas composite): composite with "
            "core.render.composite where a gradient is needed, as "
            "render_rays(use_kernel_composite=False) does")
    dts_numel = dts.numel()
    dts = dts.expand(sigma.shape)
    with annotate("composite"):
        if on_meta(rgb, sigma, dts):
            r, s = sigma.shape
            cost.record("composite_fwd", cost.composite_fwd(r, s, dts_numel))
            return (torch.empty((r, 3), dtype=torch.float32,
                                device=sigma.device),
                    torch.empty((r,), dtype=torch.float32,
                                device=sigma.device))
        if on_cpu(rgb, sigma, dts):
            return composite_ref(rgb, sigma, dts)
        return composite_cuda(rgb, sigma, dts)
