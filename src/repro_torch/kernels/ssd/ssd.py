"""Launches Mamba-2's intra-chunk SSD kernels (``csrc/ssd.cu``).

``ssd_intra_fwd`` takes the quadratic term of ``models/ssm.ssd_chunked``
(the masked decay, C.B times it, rounded to bf16, times x) with the
chunk's (q, q) matrices kept on chip; ``ssd_intra_bwd`` recomputes them
from the same inputs and dy and gives every input's gradient. The JAX
package has no kernel for this term (XLA takes it). The source notes in
``csrc/ssd.cu`` say more.

:func:`takes` is the route's test: the kernels take bf16 activations on a
CUDA device, a chunk that is a multiple of 16 up to 256 and a head dim
of 16, 32 or 64 (the head dims the card tests hold against the plain
term). The wrappers raise on anything else.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import check_kernel_input

SSD_INTRA_FWD = CudaKernel("ssd_intra_fwd", [PTR, PTR, PTR, PTR, PTR, I64,
                                             INT, INT, INT, INT])
SSD_INTRA_BWD = CudaKernel("ssd_intra_bwd", [PTR] * 9 + [I64, INT, INT, INT,
                                                         INT, INT])
MAX_CHUNK = 256
HEAD_DIMS = (16, 32, 64)
# heads of one group a backward block runs, at most: its dCB partials are
# summed over them on chip, and the wrapper adds the rep / R partials
MAX_HEADS_PER_BLOCK = 8
BF16 = (torch.bfloat16,)
F32 = (torch.float32,)


def takes(device: torch.device, act_dtype: torch.dtype, chunk: int,
          head_dim: int) -> bool:
    """True where the kernels take a call: a CUDA device, bf16
    activations, a chunk that is a multiple of 16 up to 256 and a head
    dim in HEAD_DIMS."""
    return (device.type == "cuda" and act_dtype == torch.bfloat16
            and chunk % 16 == 0 and 16 <= chunk <= MAX_CHUNK
            and head_dim in HEAD_DIMS)


def heads_per_block(rep: int) -> int:
    """R: the largest divisor of a group's ``rep`` heads up to
    MAX_HEADS_PER_BLOCK."""
    return next(r for r in range(min(rep, MAX_HEADS_PER_BLOCK), 0, -1)
                if rep % r == 0)


def dims(CB: torch.Tensor, cums: torch.Tensor, dtc: torch.Tensor,
         xc: torch.Tensor) -> Tuple[int, ...]:
    """(b, nc, q, h, p, g) of consistent shapes: CB (b, nc, q, q, g), cums
    and dtc (b, nc, q, h), xc (b, nc, q, h, p), h divisible by g; raises
    otherwise."""
    if xc.ndim != 5 or CB.ndim != 5:
        raise ValueError(f"xc {tuple(xc.shape)}, CB {tuple(CB.shape)}: "
                         "want 5-D (b, nc, q, h, p) and (b, nc, q, q, g)")
    b, nc, q, h, p = xc.shape
    g = CB.shape[-1]
    if (tuple(CB.shape) != (b, nc, q, q, g) or g < 1 or h % g
            or tuple(cums.shape) != (b, nc, q, h)
            or tuple(dtc.shape) != (b, nc, q, h)):
        raise ValueError(f"inconsistent shapes: CB {tuple(CB.shape)}, cums "
                         f"{tuple(cums.shape)}, dtc {tuple(dtc.shape)}, xc "
                         f"{tuple(xc.shape)}")
    return b, nc, q, h, p, g


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels read rows 16 bytes
    at a time): a copy where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _inputs(CB, cums, dtc, xc):
    """((C.B as the kernels read it, (b, nc, g, q, q): a view where g is 1;
    cums; dtc; xc), all contiguous and aligned, and (b, nc, q, h, p, g));
    raises where the kernels do not take the call."""
    b, nc, q, h, p, g = dims(CB, cums, dtc, xc)
    if not takes(xc.device, xc.dtype, q, p):
        raise ValueError(f"ssd kernels: xc {xc.dtype} on {xc.device}, chunk "
                         f"{q}, head dim {p}: they take bf16 on CUDA, chunks "
                         f"that are multiples of 16 up to {MAX_CHUNK} and "
                         f"head dims in {HEAD_DIMS}")
    ins = (_aligned(CB.permute(0, 1, 4, 2, 3)), cums.contiguous(),
           dtc.contiguous(), _aligned(xc))
    for name, t, dt in zip(("CB", "cums", "dtc"), ins, (BF16, F32, F32)):
        check_kernel_input(name, t, dtypes=dt)
    return ins, (b, nc, q, h, p, g)


def ssd_intra_fwd_cuda(CB: torch.Tensor, cums: torch.Tensor,
                       dtc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """``ref.ssd_intra_ref`` in one launch: CB (b, nc, q, q, g) bf16, cums
    and dtc (b, nc, q, h) f32, xc (b, nc, q, h, p) bf16, all on one CUDA
    device -> y_intra (b, nc, q, h, p) bf16."""
    (CB, cums, dtc, xc), (b, nc, q, h, p, g) = _inputs(CB, cums, dtc, xc)
    y = torch.empty_like(xc)
    SSD_INTRA_FWD(xc.device, xc.data_ptr(), CB.data_ptr(), cums.data_ptr(),
                  dtc.data_ptr(), y.data_ptr(), b * nc, q, h, p, g)
    return y


def ssd_intra_bwd_cuda(dy: torch.Tensor, CB: torch.Tensor,
                       cums: torch.Tensor, dtc: torch.Tensor,
                       xc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``ref.ssd_intra_bwd_ref`` in one launch, then the sum of each
    group's rep / R f32 dCB partials: (dCB (b, nc, q, q, g) bf16, dcums
    and ddt (b, nc, q, h) f32, dx (b, nc, q, h, p) bf16)."""
    (CB, cums, dtc, xc), (b, nc, q, h, p, g) = _inputs(CB, cums, dtc, xc)
    dy = _aligned(dy)
    check_kernel_input("dy", dy, tuple(xc.shape), dtypes=BF16)
    r = heads_per_block(h // g)
    dx = torch.empty_like(xc)
    dcums = torch.empty_like(cums)
    ddt = torch.empty_like(dtc)
    part = torch.empty((b, nc, g, h // g // r, q, q), dtype=torch.float32,
                       device=xc.device)
    SSD_INTRA_BWD(xc.device, dy.data_ptr(), xc.data_ptr(), CB.data_ptr(),
                  cums.data_ptr(), dtc.data_ptr(), dx.data_ptr(),
                  dcums.data_ptr(), ddt.data_ptr(), part.data_ptr(), b * nc,
                  q, h, p, g, r)
    dcb = part.sum(dim=3).to(torch.bfloat16).permute(0, 1, 3, 4, 2)
    return dcb, dcums, ddt, dx
