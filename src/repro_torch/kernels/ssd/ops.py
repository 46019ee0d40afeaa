"""Public wrappers of Mamba-2's SSD terms and their routes.

:func:`ssd_intra` takes the kernels (``ssd_intra_fwd``, ``ssd_intra_bwd``)
where the call can see that they fit (``ssd.takes``: CUDA tensors, bf16
activations, a chunk that is a multiple of 16 up to 256, a head dim of 16,
32 or 64), through :class:`_SSDIntra`, and ``ref.ssd_intra_ref``
everywhere else: on the CPU, on meta tensors, with f32 activations, and at
the chunk of 1 that a prime prompt length gets. One algorithm either way.

:class:`_SSDIntra` runs on the card only and saves only its inputs: its
backward recomputes the (q, q) matrices. Its plain twin is
``ref.ssd_intra_bwd_ref``.

:func:`ssd_inter` takes the inter-chunk kernels (``ssd_inter_fwd``,
``ssd_inter_bwd``) where ``ssd.inter_takes`` holds (the intra test and a
d_state of 16 or 128), through :class:`_SSDInter`, and
``ref.ssd_inter_ref`` everywhere else. :class:`_SSDInter` saves its inputs
and the (b, nc, h, p, n) states before each chunk; its plain twin is
``ref.ssd_inter_bwd_ref``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd.ref import ssd_inter_ref, ssd_intra_ref
from repro_torch.kernels.ssd.ssd import (dims, inter_dims, inter_takes,
                                        ssd_inter_bwd_cuda,
                                        ssd_inter_fwd_cuda,
                                        ssd_intra_bwd_cuda,
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


class _SSDInter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cums, dtc, xc, Bc, Cc):
        y, state, prev, _ = ssd_inter_fwd_cuda(cums, dtc, xc, Bc, Cc)
        ctx.save_for_backward(cums, dtc, xc, Bc, Cc, prev)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        cums, dtc, xc, Bc, Cc, prev = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xc)
        dcums, ddt, dx, dB, dC = ssd_inter_bwd_cuda(dy, dstate, cums, dtc,
                                                    xc, Bc, Cc, prev)
        return dcums, ddt, dx, dB, dC


def ssd_inter(cums: torch.Tensor, dtc: torch.Tensor, xc: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_inter (b, nc, q, h, p), the final state (b, h, p, n)) of
    ``ref.ssd_inter_ref``'s arguments: the kernels where they fit, the
    plain term elsewhere."""
    _, _, q, _, p, _, n = inter_dims(cums, dtc, xc, Bc, Cc)
    if (inter_takes(xc.device, xc.dtype, q, p, n)
            and Bc.dtype == Cc.dtype == torch.bfloat16
            and cums.dtype == dtc.dtype == torch.float32):
        return _SSDInter.apply(cums, dtc, xc, Bc, Cc)
    return ssd_inter_ref(cums, dtc, xc, Bc, Cc)
