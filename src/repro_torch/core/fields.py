"""The four neural-graphics applications (paper Fig. 4, Table I).

Each app is ``encoding -> fully-fused MLP(s)``; NeRF adds the
spherical-harmonics direction encoding to a second (colour) MLP. All apps
support the three encodings (hash / dense / tiled grid): app x encoding =
the 12 configurations of Table I.

``apply_field`` routes encode + MLP through the fused field kernel's
wrapper (``kernels/fused_field``) and NeRF's colour MLP through the fused
MLP kernel's wrapper (``kernels/fused_mlp``): the CUDA kernels for CUDA
tensors, their plain versions (the core library's encode and MLP) for CPU
tensors. A quantized scene (``repro_torch.quant``) carries its per-level
table scales in a ``grid_scale`` leaf, which goes into the field kernel,
and its MLP weights are dequantized on entry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import encoding as enc
from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig, init_mlp
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.quant.api import maybe_dequant_mlp
from repro_torch.quant.calibrate import MLP_WEIGHT_KEYS
from repro_torch.quant.qtypes import QuantSpec


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """One row of Table I."""
    app: str                      # 'nerf' | 'nsdf' | 'gia' | 'nvr'
    grid: GridConfig
    density_mlp: Optional[MLPConfig] = None   # NeRF only
    mlp: MLPConfig = None                     # main model MLP
    name: str = ""
    # post-training quantization recipe (repro_torch.quant); None = dense
    # params. Part of the frozen config, so serve buckets key on it.
    quant: Optional[QuantSpec] = None

    @property
    def in_dim(self) -> int:
        return self.grid.dim

    @property
    def out_dim(self) -> int:
        return {"nerf": 4, "nvr": 4, "gia": 3, "nsdf": 1}[self.app]

    def with_grid(self, grid: GridConfig) -> "FieldConfig":
        """Replace the grid and recompute every MLP dim derived from it: the
        grid-facing MLP's ``in_dim`` is ``grid.out_dim`` (= L*F). For nerf
        that is the density MLP (the colour MLP's input is SH(16) + density
        feats, grid-independent); for every other app the main MLP."""
        cfg = dataclasses.replace(self, grid=grid)
        if self.app == "nerf":
            return dataclasses.replace(
                cfg, density_mlp=dataclasses.replace(
                    self.density_mlp, in_dim=grid.out_dim))
        return dataclasses.replace(
            cfg, mlp=dataclasses.replace(self.mlp, in_dim=grid.out_dim))

    def with_quant(self, quant: Optional[QuantSpec]) -> "FieldConfig":
        """The config twin of ``repro_torch.quant.quantize_field``: pair
        the quantized param tree with ``cfg.with_quant(spec)``."""
        return dataclasses.replace(self, quant=quant)


def _grid_for(encoding_kind: str, dim: int, growth_hash: float,
              log2_T: int) -> GridConfig:
    if encoding_kind == "hash":
        return enc.hashgrid_config(dim=dim, growth=growth_hash, log2_T=log2_T)
    if encoding_kind == "dense":
        return enc.densegrid_config(dim=dim, log2_T=log2_T)
    if encoding_kind == "tiled":
        return enc.tiledgrid_config(dim=dim, log2_T=log2_T)
    raise ValueError(encoding_kind)


def make_field_config(app: str, encoding_kind: str) -> FieldConfig:
    """Exact Table I parameterizations."""
    growth = {"nerf": 1.51572, "nsdf": 1.38191,
              "nvr": 1.275, "gia": 1.25992}[app]
    log2_T = 24 if app == "gia" else 19
    dim = 2 if app == "gia" else 3
    grid = _grid_for(encoding_kind, dim, growth, log2_T)
    if app == "nerf":
        # Density: enc -> MLP(64; layers=3) -> 16 (sigma = feat[0], as in
        # instant-NGP; Table I's '->1' is the sigma channel).
        # Colour: SH(dir) 16 + density feats 16 -> MLP(64; layers=4) -> 3.
        return FieldConfig(
            app=app, grid=grid,
            density_mlp=MLPConfig(in_dim=grid.out_dim, n_hidden=3, out_dim=16),
            mlp=MLPConfig(in_dim=32, n_hidden=4, out_dim=3),
            name=f"nerf_{encoding_kind}")
    out = {"nsdf": 1, "gia": 3, "nvr": 4}[app]
    return FieldConfig(
        app=app, grid=grid,
        mlp=MLPConfig(in_dim=grid.out_dim, n_hidden=4, out_dim=out),
        name=f"{app}_{encoding_kind}")


def _mlp_shapes(m: MLPConfig, mlp_qtype: Optional[str] = None
                ) -> Dict[str, tuple]:
    shapes = {"w_in": (m.in_dim, m.hidden_dim),
              "w_out": (m.hidden_dim, m.out_dim)}
    if m.n_hidden > 1:
        shapes["w_hidden"] = (m.n_hidden - 1, m.hidden_dim, m.hidden_dim)
    if mlp_qtype is not None:     # per-tensor / per-layer sibling scales
        for key in MLP_WEIGHT_KEYS:
            if key in shapes:
                s = (1, 1) if len(shapes[key]) == 2 else (shapes[key][0], 1, 1)
                shapes[key + "_scale"] = s
                if mlp_qtype == "int8_affine":
                    shapes[key + "_zero"] = s
    return shapes


def param_shapes(cfg: FieldConfig) -> Dict:
    """The param tree's leaf shapes, keyed as the JAX package keys them,
    with the scale (and zero) leaves that ``cfg.quant`` says exist."""
    g = cfg.grid
    mlp_qtype = cfg.quant.mlp_qtype if cfg.quant else None
    shapes = {"grid": (g.n_levels, g.table_size, g.n_features),
              "mlp": _mlp_shapes(cfg.mlp, mlp_qtype)}
    if cfg.quant and cfg.quant.table_qtype:
        shapes["grid_scale"] = (g.n_levels, 1, 1)
    if cfg.density_mlp is not None:
        shapes["density_mlp"] = _mlp_shapes(cfg.density_mlp, mlp_qtype)
    return shapes


def init_field(cfg: FieldConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Dict:
    """Param tree {'grid': (L, T, F), 'mlp': {...}[, 'density_mlp': {...}]}
    with the JAX package's distributions: tables U(-1e-4, 1e-4), weights
    normal / sqrt(fan_in). Drawn on the CPU from ``generator``, then moved
    to ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    params = {"grid": enc.init_grid(cfg.grid, generator),
              "mlp": init_mlp(cfg.mlp, generator)}
    if cfg.density_mlp is not None:
        params["density_mlp"] = init_mlp(cfg.density_mlp, generator)
    return to_device(params, dev)


def to_device(params: Mapping, device: torch.device) -> Dict:
    return {k: (to_device(v, device) if isinstance(v, Mapping)
                else v.to(device))
            for k, v in params.items()}


def leaf_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """One leaf, carried bit for bit: int8 stays int8; fp8-e4m3 and bf16
    (which ``torch.from_numpy`` refuses) keep their dtype through a uint8
    or uint16 view; every other float leaf becomes f32."""
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, dtype=np.float32).copy())


def _occupancy_from_numpy(occ: Mapping, device: torch.device) -> Dict:
    """A JAX occupancy grid (``bits`` uint32 words, ``sigma`` f32) as the
    port's: the same 32 bits per word as int32 (``core/occupancy.py``)."""
    if not isinstance(occ, Mapping) or set(occ) != {"bits", "sigma"}:
        raise ValueError("params/occupancy: a grid is a dict of 'bits' and "
                         f"'sigma', got {type(occ).__name__} "
                         f"{sorted(occ) if isinstance(occ, Mapping) else ''}")
    sigma = np.asarray(occ["sigma"], np.float32)
    bits = np.asarray(occ["bits"])
    res = round(sigma.size ** (1.0 / 3.0))
    if sigma.shape != (res ** 3,) or res % 4 or bits.shape != (
            res ** 3 // 32,) or bits.dtype.itemsize != 4 \
            or bits.dtype.kind not in "ui":
        raise ValueError(f"params/occupancy: sigma {sigma.shape} and bits "
                         f"{bits.shape} {bits.dtype} are not a grid of "
                         "res^3 cells (res % 4 == 0) and res^3 / 32 "
                         "32-bit words")
    return {"bits": torch.from_numpy(bits.view(np.int32).copy()).to(device),
            "sigma": torch.from_numpy(sigma.copy()).to(device)}


def from_jax_params(np_params: Mapping, cfg: FieldConfig,
                    device: DeviceLike = None) -> Dict:
    """The JAX package's unboxed param tree, with every leaf as a numpy
    array, as the port's tensors on ``device``: int8 and fp8-e4m3 codes
    and bf16 leaves keep their dtype, every other leaf becomes f32, and
    the quantization scale leaves come along where ``cfg.quant`` says they
    exist; an attached occupancy grid (``core/occupancy.py``) comes along
    too. Raises, naming its path, on a missing leaf, a leaf ``cfg`` does
    not give, or a shape it does not give."""
    dev = resolve_device(device)
    if "occupancy" in np_params:
        rest = {k: v for k, v in np_params.items() if k != "occupancy"}
        return {**from_jax_params(rest, cfg, dev),
                "occupancy": _occupancy_from_numpy(np_params["occupancy"],
                                                   dev)}

    def conv(tree, shapes, path):
        if isinstance(shapes, dict):
            extra = sorted(set(tree) - set(shapes))
            if extra:
                raise ValueError(f"{path}/{extra[0]}: a leaf the config does "
                                 f"not give (it gives {sorted(shapes)})")
            missing = sorted(set(shapes) - set(tree))
            if missing:
                raise ValueError(f"{path}/{missing[0]}: missing; the config "
                                 "gives it")
            return {k: conv(tree[k], s, f"{path}/{k}")
                    for k, s in shapes.items()}
        arr = np.asarray(tree)
        if arr.shape != shapes:
            raise ValueError(f"{path}: shape {arr.shape}, config gives "
                             f"{shapes}")
        return leaf_from_numpy(arr).to(dev)
    return conv(np_params, param_shapes(cfg), "params")


def apply_field(params: Dict, cfg: FieldConfig, points: torch.Tensor,
                dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate the field at points (B, d) [+ dirs (B, 3) for nerf].

    Returns: nerf/nvr -> (B, 4) [rgb, sigma]; gia -> (B, 3); nsdf -> (B, 1).
    """
    tscale = params.get("grid_scale")
    if cfg.app == "nerf":
        dfeat = ff_ops.field(points, params["grid"], params["density_mlp"],
                             cfg.grid, cfg.density_mlp, table_scales=tscale)
        sigma = torch.exp(dfeat[:, :1])        # instant-NGP exp activation
        color_in = torch.cat([enc.sh_encode(dirs), dfeat], dim=-1)
        rgb = torch.sigmoid(mlp_ops.mlp(maybe_dequant_mlp(params["mlp"]),
                                        color_in, cfg.mlp))
        return torch.cat([rgb, sigma], dim=-1)

    out = ff_ops.field(points, params["grid"], params["mlp"], cfg.grid,
                       cfg.mlp, table_scales=tscale)
    if cfg.app == "gia":
        return torch.sigmoid(out)
    if cfg.app == "nvr":
        return torch.cat([torch.sigmoid(out[:, :3]), torch.exp(out[:, 3:])],
                         dim=-1)
    return out  # nsdf: signed distance


def field_param_count(cfg: FieldConfig) -> int:
    n = cfg.grid.params_bound()

    def mlp_n(m: MLPConfig):
        return (m.in_dim * m.hidden_dim
                + (m.n_hidden - 1) * m.hidden_dim * m.hidden_dim
                + m.hidden_dim * m.out_dim)
    n += mlp_n(cfg.mlp)
    if cfg.density_mlp is not None:
        n += mlp_n(cfg.density_mlp)
    return n
