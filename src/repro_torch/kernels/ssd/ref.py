"""Plain PyTorch versions of the intra-chunk SSD kernels.

:func:`ssd_intra_ref` is the quadratic term of ``models/ssm.ssd_chunked``
as that function computed it op by op, unchanged: the masked segment sums,
their exp, the decay L, C.B repeated over each group's heads, the products
``(CBh * L)`` cast to the activation dtype and their product with x. It is
differentiable through autograd, and the route for every call the kernels
do not take (CPU and meta tensors, f32 activations, other chunks and head
dims).

:func:`ssd_intra_bwd_ref` is the backward kernel's arithmetic in plain f32
ops: dM = dy x^T kept in f32, m recomputed, and the sums the kernel takes.
It is the twin the kernel is held to.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _decay(cums: torch.Tensor) -> torch.Tensor:
    """exp(cums_i - cums_j) for j <= i and 0 above the diagonal, (b, nc, q,
    q, h). The segments above the diagonal are set to -inf before the exp:
    they can overflow once training grows dt, and an overflowed exp
    selected away still gives NaN gradients."""
    chunk = cums.shape[2]
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # (b,nc,q,q,h)
    qi = torch.arange(chunk, device=cums.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    return torch.exp(torch.where(causal, seg, torch.tensor(
        float("-inf"), dtype=seg.dtype, device=cums.device)))


def ssd_intra_ref(CB: torch.Tensor, cums: torch.Tensor, dtc: torch.Tensor,
                  xc: torch.Tensor) -> torch.Tensor:
    """The intra-chunk term: CB (b, nc, q, q, g) = C.B of each chunk and
    group; cums (b, nc, q, h) f32, the within-chunk cumsum of dt A; dtc
    (b, nc, q, h) f32; xc (b, nc, q, h, p) -> y_intra (b, nc, q, h, p) in
    xc's dtype: y_i = sum_{j <= i} CB[i, j] exp(cums_i - cums_j) dt_j x_j,
    the products rounded to xc's dtype before their sum."""
    rep = xc.shape[3] // CB.shape[-1]
    # L[i,j] = exp(cums_i - cums_j) * dt_j  for j <= i
    L = _decay(cums) * dtc[:, :, None, :, :]
    CBh = torch.repeat_interleave(CB, rep, dim=-1)    # (b,nc,q,q,h)
    return torch.einsum("bcijh,bcjhp->bcihp", (CBh * L).to(xc.dtype), xc)


def ssd_intra_bwd_ref(dy: torch.Tensor, CB: torch.Tensor, cums: torch.Tensor,
                      dtc: torch.Tensor, xc: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssd_intra_ref` as ``ssd_intra_bwd`` takes
    them, for dy (b, nc, q, h, p): (dCB in CB's dtype, dcums f32, ddt f32,
    dx in xc's dtype). With e = exp(cums_i - cums_j), l = e dt_j and dM = dy
    x^T in f32: dx = m^T dy (m rounded as the forward rounds it), dCB = the
    sum of dM l over each group's heads, dcums = the row sums minus the
    column sums of dM CB l, ddt = the column sums of dM CB e. The rounding
    of the products to xc's dtype counts as the identity, as autograd takes
    a cast."""
    b, nc, q, h, p = xc.shape
    g = CB.shape[-1]
    rep = h // g
    e = _decay(cums)
    l = e * dtc[:, :, None, :, :]
    cbh = torch.repeat_interleave(CB, rep, dim=-1).float()
    m = (cbh * l).to(xc.dtype).float()
    dm = torch.einsum("bcihp,bcjhp->bcijh", dy.float(), xc.float())
    dx = torch.einsum("bcijh,bcihp->bcjhp", m, dy.float()).to(xc.dtype)
    dmcb = dm * cbh
    ds = dmcb * l
    dcums = ds.sum(dim=3) - ds.sum(dim=2)
    ddt = (dmcb * e).sum(dim=2)
    dcb = (dm * l).reshape(b, nc, q, q, g, rep).sum(dim=-1).to(CB.dtype)
    return dcb, dcums, ddt, dx
