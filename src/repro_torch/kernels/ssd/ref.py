"""Plain PyTorch versions of Mamba-2's SSD kernels.

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

:func:`ssd_inter_ref` is the inter-chunk term of ``ssd_chunked`` as that
function computed it, unchanged: each chunk's state from B and x repeated
over each group's heads, a Python loop over the chunks carrying the state,
and the carried state's contribution y_inter through C. It is the route
for every call the inter kernels do not take. :func:`ssd_inter_bwd_ref` is
their backward's arithmetic in plain ops: autograd's through
:func:`ssd_inter_ref`, the bf16 tensors rounded where autograd rounds them,
each sum in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssd_inter_ref(cums: torch.Tensor, dtc: torch.Tensor, xc: torch.Tensor,
                  Bc: torch.Tensor, Cc: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk term: cums and dtc (b, nc, q, h) f32, xc (b, nc, q,
    h, p), Bc and Cc (b, nc, q, g, n) -> (y_inter (b, nc, q, h, p), the
    final state (b, h, p, n)) in xc's dtype. Each chunk's state is sum_j
    exp(cums_last - cums_j) dt_j B_j x_j; the state before chunk c is the
    one before c - 1 times exp(cums_last) of c - 1 plus that chunk's; y_inter
    at position q is exp(cums_q) C_q times the state before its chunk. The
    weights, the products with B and C, the states and each step of the
    recurrence are rounded to xc's dtype."""
    b, nc, _, h, p = xc.shape
    n = Bc.shape[-1]
    rep = h // Bc.shape[-2]
    xd = xc.dtype
    decay_chunk = torch.exp(cums[:, :, -1]).to(xd)    # (b, nc, h)
    # each chunk's state: sum_j exp(cums_last - cums_j) dt_j B_j x_j
    w = (torch.exp(cums[:, :, -1:, :] - cums) * dtc).to(xd)   # (b,nc,q,h)
    Bh = torch.repeat_interleave(Bc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * Bh, xc)

    state = torch.zeros((b, h, p, n), dtype=xd, device=xc.device)
    prev = []
    for c in range(nc):                               # state BEFORE chunk c
        prev.append(state)
        state = state * decay_chunk[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)            # (b, nc, h, p, n)

    # --- contribution of carried state to each position ---
    Ch = torch.repeat_interleave(Cc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    outw = torch.exp(cums).to(xd)                             # (b,nc,q,h)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch * outw[..., None],
                           prev_states)
    return y_inter, state


def ssd_inter_bwd_ref(dy: torch.Tensor, dfinal: Optional[torch.Tensor],
                      cums: torch.Tensor, dtc: torch.Tensor, xc: torch.Tensor,
                      Bc: torch.Tensor, Cc: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssd_inter_ref` as ``ssd_inter_bwd`` takes
    them, for dy (b, nc, q, h, p) and the final state's gradient dfinal (b,
    h, p, n; None for zero): (dcums, ddt f32, dx, dB, dC in xc's dtype).
    ``r`` rounds to xc's dtype where autograd's tensors are of it: the
    states before each chunk (recomputed), their gradient d prev = r(v^T
    dy), the reverse recurrence g = r(r(g decay) + d prev) from g = dfinal
    with d decay = r(sum r(g prev)), dv = r(dy prev) and du = r(x dS), dC
    and dB the group's sums of r(dv outw) and r(du w), d outw and dw the
    sums over n of r(dv C) and r(du B), dx = r(u dS); then dcums and ddt in
    f32 through the exps, as autograd takes them."""
    b, nc, q, h, p = xc.shape
    g, n = Bc.shape[-2], Bc.shape[-1]
    rep = h // g
    xd = xc.dtype

    def r(t):
        return t.to(xd).float()
    cl = cums[:, :, -1]                                       # (b, nc, h)
    e = torch.exp(cl[:, :, None, :] - cums)                   # (b,nc,q,h)
    w = r(e * dtc)
    eout = torch.exp(cums)
    outw = r(eout)
    decay = r(torch.exp(cl))
    Bh = torch.repeat_interleave(Bc.float(), rep, dim=-2)     # (b,nc,q,h,n)
    Ch = torch.repeat_interleave(Cc.float(), rep, dim=-2)
    u = r(w[..., None] * Bh)
    v = r(outw[..., None] * Ch)
    x = xc.float()
    states = r(torch.einsum("bcqhn,bcqhp->bchpn", u, x))
    s = torch.zeros((b, h, p, n), device=xc.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = r(r(s * decay[:, c, :, None, None]) + states[:, c])
    prev = torch.stack(prev, dim=1)                           # (b,nc,h,p,n)

    dy = dy.float()
    dprev = r(torch.einsum("bcqhn,bcqhp->bchpn", v, dy))
    gs = (torch.zeros_like(s) if dfinal is None else dfinal.float())
    dstates, ddecay = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        dstates[c] = gs
        ddecay[c] = r(r(gs * prev[:, c]).sum(dim=(-2, -1)))
        gs = r(r(gs * decay[:, c, :, None, None]) + dprev[:, c])
    dstates = torch.stack(dstates, dim=1)
    ddecay = torch.stack(ddecay, dim=1)                       # (b, nc, h)

    def group_sum(t):
        return t.reshape(b, nc, q, g, rep, n).sum(dim=4)
    dv = r(torch.einsum("bcqhp,bchpn->bcqhn", dy, prev))
    dC = group_sum(r(dv * outw[..., None]))
    dout = r(r(dv * Ch).sum(dim=-1))
    du = r(torch.einsum("bcqhp,bchpn->bcqhn", x, dstates))
    dB = group_sum(r(du * w[..., None]))
    dw = r(r(du * Bh).sum(dim=-1))
    dx = torch.einsum("bcqhn,bchpn->bcqhp", u, dstates)
    ddt = dw * e
    t = (dw * dtc) * e
    dcums = dout * eout - t
    dcums[:, :, -1] += t.sum(dim=2) + ddecay * torch.exp(cl)
    return dcums, ddt, dx.to(xd), dB.to(xd), dC.to(xd)
