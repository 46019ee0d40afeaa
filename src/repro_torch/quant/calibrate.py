"""Post-training calibration: trained params -> scale (and zero) leaves.
The port of the JAX package's ``quant/calibrate.py``.

Granularity follows the traffic the kernels see:

  * grid tables ``(L, T, F)`` — one scale PER LEVEL, shape ``(L, 1, 1)``:
    levels differ in magnitude by orders, and a kernel reads one scale per
    (point, level) task.
  * MLP weights — per tensor ``(1, 1)`` for ``w_in`` / ``w_out``, per layer
    ``(n, 1, 1)`` for the stacked ``w_hidden``.

``percentile < 100`` clips outlier table ROWS (a row = one table entry's
F features) into saturation instead of letting one hot row inflate its
level's scale.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.quant import qtypes

# MLP weight leaves, as ``core/mlp.init_mlp`` emits them; w_hidden is a
# stacked (n_hidden - 1, h, h) tensor -> per-layer scales.
MLP_WEIGHT_KEYS = ("w_in", "w_hidden", "w_out")


def table_scales(tables: torch.Tensor, spec: qtypes.QuantSpec
                 ) -> torch.Tensor:
    """Per-level scales ``(L, 1, 1)`` f32 for an ``(L, T, F)`` table stack."""
    if tables.ndim != 3:
        raise ValueError(f"expected (L, T, F) tables, got {tuple(tables.shape)}")
    return qtypes.absmax_scale(tables, spec.table_qtype, axis=(1, 2),
                               percentile=spec.percentile)


def mlp_scales(mlp_params: Dict[str, torch.Tensor], spec: qtypes.QuantSpec
               ) -> Dict[str, torch.Tensor]:
    """The NEW sibling leaves for one MLP param dict, keyed ``w_*_scale``
    (and ``w_*_zero`` for affine); the caller merges them in."""
    out: Dict[str, torch.Tensor] = {}
    for key in MLP_WEIGHT_KEYS:
        if key not in mlp_params:
            continue
        w = mlp_params[key]
        axis = (-2, -1) if w.ndim == 3 else None
        if spec.mlp_qtype == "int8_affine":
            scale, zero = qtypes.affine_range_scale(w, axis=axis)
            out[key + "_scale"] = scale
            out[key + "_zero"] = zero
        else:
            out[key + "_scale"] = qtypes.absmax_scale(
                w, spec.mlp_qtype, axis=axis, percentile=spec.percentile)
    return out
