"""The neural field in plain PyTorch: the multi-resolution grid encoding,
the bias-free ReLU MLPs and the degree-4 spherical harmonics of Table I.

Frozen from ``src/repro_torch/core/encoding.py`` (the index arithmetic of
``hash_index``, ``dense_index``, ``level_cell``, ``level_is_hashed`` and
``level_resolution``) and ``src/repro_torch/core/mlp.py``, written afresh
over all levels and corners at once. The counts (``ngbench/counts.py``)
read the same index arithmetic to find the distinct table rows an input
gathers.

``Grid`` and ``Mlp`` are read from a configuration file's ``grid`` and
``*mlp`` objects. ``precision="tf32"`` rounds both operands of every
matrix product to TF32 (10 explicit mantissa bits, round to nearest),
which is what a tensor core does to f32 inputs: the control of the
benchmark's correctness checks. ``"f32"`` runs true f32 products.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)
U32 = 0xFFFFFFFF
# points a block of the encode: (block, levels, 8 corners) int64 per axis
BLOCK = 131072


@dataclasses.dataclass(frozen=True)
class Grid:
    kind: str
    dim: int
    n_levels: int
    n_features: int
    log2_table_size: int
    base_resolution: int
    growth: float

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_resolution(self, level: int) -> int:
        return int(math.floor(self.base_resolution * self.growth ** level))

    def level_is_hashed(self, level: int) -> bool:
        if self.kind in ("dense", "tiled"):
            return False
        return (self.level_resolution(level) + 1) ** self.dim \
            > self.table_size


@dataclasses.dataclass(frozen=True)
class Mlp:
    in_dim: int
    hidden_dim: int
    n_hidden: int
    out_dim: int

    def flops_per_row(self) -> int:
        """Products per row, a multiply-add counted as 2."""
        return 2 * (self.in_dim * self.hidden_dim
                    + (self.n_hidden - 1) * self.hidden_dim ** 2
                    + self.hidden_dim * self.out_dim)


def grid_of(cfg: Dict) -> Grid:
    return Grid(**cfg["grid"])


def mlp_of(cfg: Dict, key: str) -> Optional[Mlp]:
    return Mlp(**cfg[key]) if cfg.get(key) else None


def corner_offsets(dim: int) -> torch.Tensor:
    """(2^d, d) 0/1 corner offsets, corner c's bit i is (c >> i) & 1."""
    return torch.tensor([[(c >> i) & 1 for i in range(dim)]
                         for c in range(1 << dim)], dtype=torch.int64)


class Levels:
    """Per-level constants of a grid on one device."""

    def __init__(self, g: Grid, device):
        res = [g.level_resolution(l) for l in range(g.n_levels)]
        self.g = g
        self.res_f = torch.tensor(res, dtype=torch.float32, device=device)
        self.res_max = torch.tensor([r - 1 for r in res], dtype=torch.int64,
                                    device=device)
        self.hashed = torch.tensor([g.level_is_hashed(l)
                                    for l in range(g.n_levels)],
                                   device=device)
        # dense strides (res + 1)^i, i < d, per level: exact in int64
        self.strides = torch.tensor([[(r + 1) ** i for i in range(g.dim)]
                                     for r in res], dtype=torch.int64,
                                    device=device)
        self.offs = corner_offsets(g.dim).to(device)
        self.level_base = (torch.arange(g.n_levels, device=device,
                                        dtype=torch.int64) * g.table_size)


def corner_rows(points: torch.Tensor, lv: Levels):
    """(rows (B, L, C) int64 into the (L*T) flat table, weights (B, L, C)
    f32) of the d-linear interpolation of every level."""
    g = lv.g
    pos = points.to(torch.float32)[:, None, :] * lv.res_f[None, :, None]
    cell = torch.floor(pos)
    frac = pos - cell
    icell = torch.minimum(cell.to(torch.int64).clamp_min(0),
                          lv.res_max[None, :, None])
    hashed = dense = None
    w = None
    for i in range(g.dim):
        c = icell[:, :, i, None] + lv.offs[None, None, :, i]     # (B, L, C)
        h = (c * HASH_PRIMES[i]) & U32
        hashed = h if hashed is None else hashed ^ h
        d = c * lv.strides[None, :, i, None]
        dense = d if dense is None else dense + d
        f = frac[:, :, i, None]
        bit = lv.offs[None, None, :, i].bool()
        wi = torch.where(bit, f, 1.0 - f)
        w = wi if w is None else w * wi
    idx = torch.where(lv.hashed[None, :, None], hashed, dense & U32)
    idx = idx & (g.table_size - 1)
    return idx + lv.level_base[None, :, None], w


def encode(points: torch.Tensor, tables: torch.Tensor, lv: Levels
           ) -> torch.Tensor:
    """(B, d) unit-cube points, (L, T, F) f32 tables -> (B, L*F) f32."""
    g = lv.g
    flat = tables.reshape(g.n_levels * g.table_size, g.n_features)
    out = []
    for s in range(0, points.shape[0], BLOCK):
        rows, w = corner_rows(points[s:s + BLOCK], lv)
        feats = flat[rows]                                  # (b, L, C, F)
        out.append((w[..., None] * feats).sum(dim=2).reshape(
            rows.shape[0], g.out_dim))
    if not out:
        return tables.new_zeros((0, g.out_dim))
    return torch.cat(out) if len(out) > 1 else out[0]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest (ties away),
    as a tensor core converts f32 inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """A product on TF32 operands, forward and backward, as a tensor core
    computes an f32 product and its two transposed products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).transpose(-1, -2), tf32(a).transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    if precision != "f32":
        raise ValueError(f"precision {precision!r}: f32 or tf32")
    return a @ b


def mlp(w: Dict[str, torch.Tensor], x: torch.Tensor, m: Mlp,
        precision: str = "f32") -> torch.Tensor:
    """(B, in) -> (B, out): ReLU hidden layers, no biases, linear out."""
    h = torch.relu(matmul(x, w["w_in"], precision))
    for k in range(m.n_hidden - 1):
        h = torch.relu(matmul(h, w["w_hidden"][k], precision))
    return matmul(h, w["w_out"], precision)


def sh_encode(dirs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 -> 16 features."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


SH_FLOPS = 31          # the products and sums of sh_encode, per direction


class Field:
    """A configuration's field on one device: ``nerf(points, dirs)`` ->
    (B, 4) [rgb, sigma]; ``sdf(points)`` -> (B, 1)."""

    def __init__(self, cfg: Dict, params: Dict, precision: str = "f32"):
        self.grid = grid_of(cfg)
        self.mlp_cfg = mlp_of(cfg, "mlp")
        self.density_cfg = mlp_of(cfg, "density_mlp")
        self.params = params
        self.precision = precision
        self.levels = Levels(self.grid, params["grid"].device)

    def head(self, points: torch.Tensor) -> torch.Tensor:
        """The grid's MLP on the encoding: the density MLP where the
        configuration has one (nerf), else the main one."""
        key, m = (("density_mlp", self.density_cfg) if self.density_cfg
                  else ("mlp", self.mlp_cfg))
        feats = encode(points, self.params["grid"], self.levels)
        return mlp(self.params[key], feats, m, self.precision)

    def nerf(self, points: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        dfeat = self.head(points)
        sigma = torch.exp(dfeat[:, :1])
        color_in = torch.cat([sh_encode(dirs), dfeat], dim=-1)
        rgb = torch.sigmoid(mlp(self.params["mlp"], color_in, self.mlp_cfg,
                                self.precision))
        return torch.cat([rgb, sigma], dim=-1)

    def sdf(self, points: torch.Tensor) -> torch.Tensor:
        return self.head(points)
