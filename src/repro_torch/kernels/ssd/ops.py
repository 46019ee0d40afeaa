"""Public wrapper of Mamba-2's intra-chunk SSD term and its route.

:func:`ssd_intra` takes the kernels (``ssd_intra_fwd``, ``ssd_intra_bwd``)
where the call can see that they fit (``ssd.takes``: CUDA tensors, bf16
activations, a chunk that is a multiple of 16 up to 256, a head dim of 16,
32 or 64), through :class:`_SSDIntra`, and ``ref.ssd_intra_ref``
everywhere else: on the CPU, on meta tensors, with f32 activations, and at
the chunk of 1 that a prime prompt length gets. One algorithm either way.

:class:`_SSDIntra` runs on the card only and saves only its inputs: its
backward recomputes the (q, q) matrices. Its plain twin is
``ref.ssd_intra_bwd_ref``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import ssd_intra_ref
from repro_torch.kernels.ssd.ssd import (dims, ssd_intra_bwd_cuda,
                                        ssd_intra_fwd_cuda, takes)


class _SSDIntra(torch.autograd.Function):
    @staticmethod
    def forward(ctx, CB, cums, dtc, xc):
        ctx.save_for_backward(CB, cums, dtc, xc)
        return ssd_intra_fwd_cuda(CB, cums, dtc, xc)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_bwd_cuda(dy, *ctx.saved_tensors)


def ssd_intra(CB: torch.Tensor, cums: torch.Tensor, dtc: torch.Tensor,
              xc: torch.Tensor) -> torch.Tensor:
    """y_intra (b, nc, q, h, p) of ``ref.ssd_intra_ref``'s arguments: the
    kernels where they fit, the plain term elsewhere."""
    _, _, q, _, p, _ = dims(CB, cums, dtc, xc)
    if (takes(xc.device, xc.dtype, q, p) and CB.dtype == torch.bfloat16
            and cums.dtype == dtc.dtype == torch.float32):
        return _SSDIntra.apply(CB, cums, dtc, xc)
    return ssd_intra_ref(CB, cums, dtc, xc)
