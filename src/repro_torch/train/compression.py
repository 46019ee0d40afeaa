"""Gradient compression with error feedback: the JAX package's
``train/compression.py``.

Two schemes, each keeping what it did not send in an error-feedback
buffer that the next step adds back, so nothing is lost, only delayed:

  * ``topk``: keep the top ``frac`` of the entries by magnitude (ties at
    the threshold are kept, as the JAX package keeps them); the rest goes
    to the buffer. ``kept + efb_new == g + efb_old`` exactly.
  * ``int8``: per-tensor symmetric int8 (scale = max|g| / 127) through the
    port's field codec, ``repro_torch.quant.qtypes``, so gradient
    compression and field quantization share one formula.

The training engine (``train/loop.py``) applies :func:`apply_inline`
after the gradient and before Adam, to the ``"grid"`` leaf, with the
buffer in the engine's ``state["efb"]``. Everything here is plain tensor
ops on the gradient's device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.quant import qtypes
from repro_torch.train.optim import tree_map


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Boolean mask of the top-``frac`` fraction of |g|'s entries: those at
    or above the k-th largest magnitude, k = max(1, int(numel * frac))."""
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return g.abs() >= thresh


def compress_topk(g: torch.Tensor, efb: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sent, new error feedback) of ``g`` plus the old feedback."""
    acc = g + efb
    kept = torch.where(topk_mask(acc, frac), acc, 0.0)
    return kept, acc - kept


def compress_int8(g: torch.Tensor, efb: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized wire tensor, new error feedback): ``g`` plus the old
    feedback quantized per tensor by the shared codec."""
    acc = g + efb
    scale = qtypes.absmax_scale(acc, "int8")
    q = qtypes.quantize(acc, scale, "int8")
    deq = qtypes.dequantize(q, scale).to(acc.dtype)
    return deq, acc - deq


def apply_inline(grads: Dict, state: Dict, train_cfg) -> Tuple[Any, Dict]:
    """Compress a dict tree of gradients with the error feedback in
    ``state["efb"]`` (zeros when absent); ``train_cfg`` gives
    ``compression`` ("topk" or "int8") and ``compression_topk``. Returns
    (the sent gradients, the state with the new feedback)."""
    efb = state.get("efb")
    if efb is None:
        efb = tree_map(torch.zeros_like, grads)
    if train_cfg.compression == "topk":
        frac = train_cfg.compression_topk
        out = tree_map(lambda g, e: compress_topk(g, e, frac), grads, efb)
    elif train_cfg.compression == "int8":
        out = tree_map(compress_int8, grads, efb)
    else:
        raise ValueError(train_cfg.compression)

    def pick(tree, i):
        return {k: (pick(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}
    return pick(out, 0), {**state, "efb": pick(out, 1)}
