"""Launches Mamba-2's SSD kernels (``csrc/ssd.cu``, ``csrc/ssd_inter.cu``).

``ssd_intra_fwd`` takes the quadratic term of ``models/ssm.ssd_chunked``
(the masked decay, C.B times it, rounded to bf16, times x) with the
chunk's (q, q) matrices kept on chip; ``ssd_intra_bwd`` recomputes them
from the same inputs and dy and gives every input's gradient.
``ssd_inter_fwd`` takes the inter-chunk term (each chunk's state, the
recurrence over the chunks, the carried state's contribution y_inter) in
three kernels that read B and C once per group, and ``ssd_inter_bwd`` its
gradients in five. The JAX package has no kernel for either term (XLA
takes them). The source notes in ``csrc/ssd.cu`` and ``csrc/ssd_inter.cu``
say more.

:func:`takes` is the intra term's test: the kernels take bf16 activations
on a CUDA device, a chunk that is a multiple of 16 up to 256 and a head dim
of 16, 32 or 64 (the head dims the card tests hold against the plain
term). :func:`inter_takes` adds the d_states the inter kernels are built
for, 16 and 128. The wrappers raise on anything else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import check_kernel_input

SSD_INTRA_FWD = CudaKernel("ssd_intra_fwd", [PTR, PTR, PTR, PTR, PTR, I64,
                                             INT, INT, INT, INT])
SSD_INTRA_BWD = CudaKernel("ssd_intra_bwd", [PTR] * 9 + [I64, INT, INT, INT,
                                                         INT, INT])
SSD_INTER_FWD = CudaKernel("ssd_inter_fwd", [PTR] * 9 + [I64] * 3 + [INT] * 8)
SSD_INTER_BWD = CudaKernel("ssd_inter_bwd", [PTR] * 18 + [I64] * 3
                           + [INT] * 8)
MAX_CHUNK = 256
HEAD_DIMS = (16, 32, 64)
# the d_states the inter kernels are instantiated for, those the card tests
# hold: granite-4.0-h-small's and mamba2-2.7b's 128, jamba's 16
D_STATES = (16, 128)
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


def inter_takes(device: torch.device, act_dtype: torch.dtype, chunk: int,
                head_dim: int, d_state: int) -> bool:
    """True where the inter-chunk kernels take a call: :func:`takes` and a
    d_state in D_STATES."""
    return takes(device, act_dtype, chunk, head_dim) and d_state in D_STATES


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


def inter_dims(cums: torch.Tensor, dtc: torch.Tensor, xc: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor) -> Tuple[int, ...]:
    """(b, nc, q, h, p, g, n) of consistent shapes: cums and dtc (b, nc, q,
    h), xc (b, nc, q, h, p), Bc and Cc (b, nc, q, g, n), h divisible by g;
    raises otherwise."""
    if xc.ndim != 5 or Bc.ndim != 5:
        raise ValueError(f"xc {tuple(xc.shape)}, Bc {tuple(Bc.shape)}: want "
                         "5-D (b, nc, q, h, p) and (b, nc, q, g, n)")
    b, nc, q, h, p = xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    if (tuple(Bc.shape[:3]) != (b, nc, q) or g < 1 or h % g
            or tuple(Cc.shape) != tuple(Bc.shape)
            or tuple(cums.shape) != (b, nc, q, h)
            or tuple(dtc.shape) != (b, nc, q, h)):
        raise ValueError(f"inconsistent shapes: cums {tuple(cums.shape)}, dtc "
                         f"{tuple(dtc.shape)}, xc {tuple(xc.shape)}, Bc "
                         f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    return b, nc, q, h, p, g, n


def rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(t, its row stride) for a (b, nc, q, k, w) tensor the inter kernels
    read as b * nc * q rows of k * w values at one row stride: the view
    itself where its last two dims are contiguous, its positions one stride
    apart (a multiple of 8 elements) and its start 16-byte aligned, as the
    in-projection's split gives x, B and C; else a contiguous copy."""
    b, nc, q, k, w = t.shape
    ld = t.stride(2)
    if (t.stride(4) == 1 and (k == 1 or t.stride(3) == w) and ld >= k * w
            and ld % 8 == 0 and t.data_ptr() % 16 == 0
            and (nc == 1 or t.stride(1) == q * ld)
            and (b == 1 or t.stride(0) == nc * q * ld)):
        return t, ld
    return _aligned(t), k * w


def _inter_inputs(cums, dtc, xc, Bc, Cc):
    """((cums, dtc, (x, ldx), (B, ldb), (C, ldc)), dims) as the inter
    kernels read them; raises where they do not take the call."""
    b, nc, q, h, p, g, n = inter_dims(cums, dtc, xc, Bc, Cc)
    if not inter_takes(xc.device, xc.dtype, q, p, n):
        raise ValueError(f"ssd inter kernels: xc {xc.dtype} on {xc.device}, "
                         f"chunk {q}, head dim {p}, d_state {n}: they take "
                         f"bf16 on CUDA, chunks that are multiples of 16 up to "
                         f"{MAX_CHUNK}, head dims in {HEAD_DIMS} and d_states "
                         f"in {D_STATES}")
    if Bc.dtype not in BF16 or Cc.dtype not in BF16:
        raise TypeError(f"Bc {Bc.dtype}, Cc {Cc.dtype}: the kernels take "
                        f"{list(BF16)}")
    cums, dtc = cums.contiguous(), dtc.contiguous()
    check_kernel_input("cums", cums, dtypes=F32)
    check_kernel_input("dtc", dtc, dtypes=F32)
    return (cums, dtc, rows(xc), rows(Bc), rows(Cc)), (b, nc, q, h, p, g, n)


def ssd_inter_fwd_cuda(cums: torch.Tensor, dtc: torch.Tensor,
                       xc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """``ref.ssd_inter_ref`` in three launches: cums and dtc (b, nc, q, h)
    f32, xc (b, nc, q, h, p), Bc and Cc (b, nc, q, g, n) bf16, on one CUDA
    device -> (y_inter (b, nc, q, h, p), the final state (b, h, p, n), the
    states before each chunk and the chunk states (b, nc, h, p, n)), bf16."""
    (cums, dtc, (x, ldx), (B, ldb), (C, ldc)), dims_ = _inter_inputs(
        cums, dtc, xc, Bc, Cc)
    b, nc, q, h, p, g, n = dims_
    states = torch.empty((b, nc, h, p, n), dtype=x.dtype, device=x.device)
    prev = torch.empty_like(states)
    final = torch.empty((b, h, p, n), dtype=x.dtype, device=x.device)
    y = torch.empty((b, nc, q, h, p), dtype=x.dtype, device=x.device)
    SSD_INTER_FWD(x.device, x.data_ptr(), B.data_ptr(), C.data_ptr(),
                  cums.data_ptr(), dtc.data_ptr(), states.data_ptr(),
                  prev.data_ptr(), final.data_ptr(), y.data_ptr(), ldx, ldb,
                  ldc, b, nc, q, h, p, g, n, heads_per_block(h // g))
    return y, final, prev, states


def ssd_inter_bwd_cuda(dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                       cums: torch.Tensor, dtc: torch.Tensor,
                       xc: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                       prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``ref.ssd_inter_bwd_ref`` in five launches: dy (b, nc, q, h, p) and
    the final state's gradient dfinal (b, h, p, n, or None for zero) bf16,
    the forward's inputs and its ``prev`` -> (dcums, ddt f32, dx, dB, dC
    bf16), in the inputs' shapes."""
    (cums, dtc, (x, ldx), (B, ldb), (C, ldc)), dims_ = _inter_inputs(
        cums, dtc, xc, Bc, Cc)
    b, nc, q, h, p, g, n = dims_
    dy = _aligned(dy)
    check_kernel_input("dy", dy, (b, nc, q, h, p), dtypes=BF16)
    prev = _aligned(prev)
    check_kernel_input("prev", prev, (b, nc, h, p, n), dtypes=BF16)
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        check_kernel_input("dfinal", dfinal, (b, h, p, n), dtypes=BF16)
    dprev = torch.empty_like(prev)
    dstates = torch.empty_like(prev)
    dw = torch.empty_like(cums)
    dout = torch.empty_like(cums)
    ddecay = torch.empty((b, nc, h), dtype=torch.float32, device=x.device)
    dx = torch.empty((b, nc, q, h, p), dtype=x.dtype, device=x.device)
    dB = torch.empty((b, nc, q, g, n), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    dcums = torch.empty_like(cums)
    ddt = torch.empty_like(cums)
    SSD_INTER_BWD(x.device, dy.data_ptr(),
                  0 if dfinal is None else dfinal.data_ptr(), x.data_ptr(),
                  B.data_ptr(), C.data_ptr(), cums.data_ptr(),
                  dtc.data_ptr(), prev.data_ptr(), dprev.data_ptr(),
                  dstates.data_ptr(), dw.data_ptr(), dout.data_ptr(),
                  ddecay.data_ptr(), dx.data_ptr(), dB.data_ptr(),
                  dC.data_ptr(), dcums.data_ptr(), ddt.data_ptr(), ldx, ldb,
                  ldc, b, nc, q, h, p, g, n, heads_per_block(h // g))
    return dcums, ddt, dx, dB, dC
