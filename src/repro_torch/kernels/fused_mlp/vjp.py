"""The fused MLP's VJP by rematerialisation, the JAX package's
``kernels/fused_mlp/ops._mlp_bwd`` (and the MLP half of
``fused_field/ops._field_bwd``): the activations are cheaper to recompute
than to keep, the fully-fused-MLP training argument. The JAX package leaves
these products to XLA, so here they are plain f32 ``torch.matmul``s,
held in true f32 on the card (``common.f32_matmuls``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.common import f32_matmuls


def mlp_bwd(x: torch.Tensor, w_in: torch.Tensor,
            w_hidden: Optional[torch.Tensor], w_out: torch.Tensor,
            cfg: MLPConfig, g: torch.Tensor, need_x: bool = True
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                       Optional[torch.Tensor], torch.Tensor]:
    """Cotangent g (B, out_dim) of the bias-free ReLU MLP at x (B, in_dim)
    -> (d_x or None unless ``need_x``, d_w_in, d_w_hidden or None when
    ``n_hidden == 1``, d_w_out), each weight's gradient in its dtype."""
    with torch.no_grad(), f32_matmuls():
        ws = [w_in.float()] + [w_hidden[k].float()
                               for k in range(cfg.n_hidden - 1)]
        hs = [x.float()]                       # each layer's input
        for w in ws:
            hs.append(torch.relu(hs[-1] @ w))
        g = g.float()
        d_w_out = hs[-1].T @ g
        d = g @ w_out.float().T
        d_ws = [None] * len(ws)
        for k in reversed(range(len(ws))):
            d = torch.where(hs[k + 1] > 0, d, 0.0)    # through the ReLU
            d_ws[k] = hs[k].T @ d
            d = d @ ws[k].T if (k > 0 or need_x) else None
    d_w_hidden = (torch.stack(d_ws[1:]).to(w_hidden.dtype)
                  if cfg.n_hidden > 1 else None)
    return (None if d is None else d.to(x.dtype), d_ws[0].to(w_in.dtype),
            d_w_hidden, d_w_out.to(w_out.dtype))
