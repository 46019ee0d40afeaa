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

A sharded gradient (``parallel/sharded.Sharded``, the LM steps on a mesh)
is compressed as its whole tensor would be: top-k keeps the entries at or
above the k-th largest magnitude of the whole leaf (each distinct slice's
own top k, gathered, hold it), and int8 scales by the whole leaf's
abs-max; each shard then compresses locally, copies of a replicated slice
alike.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel.sharded import Sharded, map_sharded
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


def _owner_parts(g: Sharded):
    home = g.shards[0].device
    return home, [g.shards[p] for p in g.owners()]


def _compress_sharded(g: Sharded, efb: Sharded, scheme: str, frac: float
                      ) -> Tuple[Sharded, Sharded]:
    acc = map_sharded(torch.add, g, efb)
    home, parts = _owner_parts(acc)
    if scheme == "topk":
        k = max(1, int(acc.numel() * frac))
        cand = torch.cat([torch.topk(p.reshape(-1).abs(), min(k, p.numel()),
                                     sorted=False).values.to(home)
                          for p in parts])
        thresh = torch.topk(cand, k, sorted=False).values.min()

        def one(a):
            kept = torch.where(a.abs() >= thresh.to(a.device), a, 0.0)
            return kept, a - kept
    else:
        maxes = torch.stack([p.float().abs().amax().to(home) for p in parts])
        scale = qtypes.absmax_scale(maxes, "int8").reshape(
            (1,) * acc.ndim)

        def one(a):
            q = qtypes.quantize(a, scale.to(a.device), "int8")
            deq = qtypes.dequantize(q, scale.to(a.device)).to(a.dtype)
            return deq, a - deq
    pairs = [one(a) for a in acc.shards]
    return (Sharded(acc.sharding, acc.shape, [p[0] for p in pairs]),
            Sharded(acc.sharding, acc.shape, [p[1] for p in pairs]))


def apply_inline(grads: Dict, state: Dict, train_cfg) -> Tuple[Any, Dict]:
    """Compress a dict tree of gradients with the error feedback in
    ``state["efb"]`` (zeros when absent); ``train_cfg`` gives
    ``compression`` ("topk" or "int8") and ``compression_topk``. Returns
    (the sent gradients, the state with the new feedback)."""
    efb = state.get("efb")
    if efb is None:
        efb = tree_map(lambda g: map_sharded(torch.zeros_like, g), grads)
    scheme, frac = train_cfg.compression, train_cfg.compression_topk
    if scheme not in ("topk", "int8"):
        raise ValueError(scheme)

    def one(g, e):
        if isinstance(g, Sharded):
            return _compress_sharded(g, e, scheme, frac)
        return (compress_topk(g, e, frac) if scheme == "topk"
                else compress_int8(g, e))
    out = tree_map(one, grads, efb)

    def pick(tree, i):
        return {k: (pick(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}
    return pick(out, 0), {**state, "efb": pick(out, 1)}
