"""Field-level quantization: param tree in, param tree out. The port of the
JAX package's ``quant/api.py``.

``quantize_field(params, spec)`` returns a NEW dict with the same keys plus
the sibling scale leaves (``qtypes`` module docstring):

    {"grid": (L,T,F) f32, "mlp": {...}}
      -> {"grid": (L,T,F) int8, "grid_scale": (L,1,1) f32, "mlp": {...}}

Pair it with ``cfg.with_quant(spec)``: the serve engine checks that the two
agree and buckets the scene apart from dense ones. The field kernels gather
the int8/fp8 codes and dequantize each gathered row; MLP weights are
dequantized on entry (:func:`maybe_dequant_mlp`).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.quant import calibrate, qtypes
from repro_torch.quant.qtypes import QuantSpec

# params keys holding an MLP weight dict (nerf has both)
MLP_KEYS = ("mlp", "density_mlp")


def _quantize_mlp(mlp_params: Dict, spec: QuantSpec) -> Dict:
    out = dict(mlp_params)
    out.update(calibrate.mlp_scales(mlp_params, spec))
    for key in calibrate.MLP_WEIGHT_KEYS:
        if key not in mlp_params:
            continue
        w = mlp_params[key]
        if spec.mlp_qtype == "int8_affine":
            out[key] = qtypes.quantize_affine(
                w, out[key + "_scale"], out[key + "_zero"])
        else:
            out[key] = qtypes.quantize(w, out[key + "_scale"], spec.mlp_qtype)
    return out


def maybe_dequant_mlp(mlp_params: Dict) -> Dict:
    """Dense f32 view of a (possibly) quantized MLP weight dict. Dense input
    returns unchanged; scale/zero sibling leaves are consumed."""
    if not any(k.endswith("_scale") for k in mlp_params):
        return mlp_params
    out = {}
    for key, w in mlp_params.items():
        if key.endswith("_scale") or key.endswith("_zero"):
            continue
        scale = mlp_params.get(key + "_scale")
        if scale is None:
            out[key] = w
        elif key + "_zero" in mlp_params:
            out[key] = qtypes.dequantize_affine(w, scale,
                                                mlp_params[key + "_zero"])
        else:
            out[key] = qtypes.dequantize(w, scale)
    return out


def quantize_field(params: Dict, spec: QuantSpec) -> Dict:
    """Post-training quantization of a field's params, on their device:
    calibrates scales, encodes the tables and/or MLP weights per ``spec``
    and returns a new tree with codec-dtype leaves plus f32 scale siblings."""
    out = dict(params)
    if spec.table_qtype is not None:
        tables = params["grid"]
        if qtypes.is_quantized(tables):
            raise ValueError("params['grid'] is already quantized")
        scale = calibrate.table_scales(tables, spec)
        out["grid"] = qtypes.quantize(tables, scale, spec.table_qtype)
        out["grid_scale"] = scale
    if spec.mlp_qtype is not None:
        for key in MLP_KEYS:
            if key in params:
                out[key] = _quantize_mlp(params[key], spec)
    return out


def dequantize_field(qparams: Dict) -> Dict:
    """Dense f32 twin of a quantized param tree (scale leaves consumed)."""
    out = {}
    for key, leaf in qparams.items():
        if key.endswith("_scale"):
            continue
        if key in MLP_KEYS and isinstance(leaf, dict):
            out[key] = maybe_dequant_mlp(leaf)
        elif key + "_scale" in qparams:
            out[key] = qtypes.dequantize(leaf, qparams[key + "_scale"])
        else:
            out[key] = leaf
    return out


def is_quantized_field(params: Dict) -> bool:
    """True if the table or any MLP leaf is stored in a codec dtype."""
    grid = params.get("grid")
    if grid is not None and qtypes.is_quantized(grid):
        return True
    return any(isinstance(params.get(key), dict)
               and any(qtypes.is_quantized(v) for v in params[key].values())
               for key in MLP_KEYS)
