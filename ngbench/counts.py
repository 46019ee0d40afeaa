"""The work of the served tiles and the training steps, from their shapes
and inputs: the yardstick of the roofline shares and ``mfu`` metrics.

Frozen from ``src/repro_torch/kernels/cost.py`` (each kernel's bytes and
FLOPs) and from ``chip_smoke.py``'s ``touched_rows`` (the distinct table
rows an input gathers, here by a bitmap over the rows in place of a
sort), with one change of source: the matrix products are counted once
each (the program computes an f32 product as three TF32 passes; that is
how it works, not the work). ``mma_flops`` are the products (a
multiply-add counts 2), ``flops`` every other f32 operation, ``bytes``
each input byte read once and each output byte written once.

Work that depends on the data is counted for these inputs: the distinct
table rows of each call's points (``distinct_rows``), the live samples of
a culled tile.
"""
from __future__ import annotations

from typing import Dict

import torch

from ngbench.reference.field import BLOCK, SH_FLOPS, Grid, Levels, Mlp, \
    corner_rows

F32 = 4
COMPOSITE_FLOPS = 16      # a sample: -sigma dt, 2 exp, 1 - alpha, scan, 4 fma
ADAM_FLOPS = 12           # a parameter: both moments, the update


def add(*works: Dict[str, float]) -> Dict[str, float]:
    out = {"mma_flops": 0.0, "flops": 0.0, "bytes": 0.0}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v
    return out


def distinct_rows(points: torch.Tensor, g: Grid) -> int:
    """The distinct table rows the encode of ``points`` (B, d) gathers,
    summed over the levels."""
    lv = Levels(g, points.device)
    seen = torch.zeros(g.n_levels * g.table_size, dtype=torch.bool,
                       device=points.device)
    for s in range(0, points.shape[0], BLOCK):
        rows, _ = corner_rows(points[s:s + BLOCK], lv)
        seen[rows.reshape(-1)] = True
    return int(seen.sum())


def encode_flops(n_points: int, g: Grid) -> float:
    """Per point, level and corner: the d-linear weight (d multiplies) and
    F multiply-adds."""
    return float(n_points * g.n_levels * (1 << g.dim) * (g.dim + 2 * g.n_features))


def mlp_weight_bytes(m: Mlp) -> int:
    return F32 * (m.in_dim * m.hidden_dim + (m.n_hidden - 1) * m.hidden_dim
                  ** 2 + m.hidden_dim * m.out_dim)


def field_fwd(n_points: int, g: Grid, m: Mlp, rows: int) -> Dict[str, float]:
    """``field_fwd``: points and ``rows`` distinct table rows in, the
    weights once, (B, out) f32 out; the encode's operations and the MLP's
    products."""
    return {"mma_flops": float(n_points * m.flops_per_row()),
            "flops": encode_flops(n_points, g),
            "bytes": float(n_points * g.dim * F32 + rows * g.n_features * F32
                           + mlp_weight_bytes(m) + n_points * m.out_dim * F32)}


def mlp_fwd(n_rows: int, m: Mlp) -> Dict[str, float]:
    return {"mma_flops": float(n_rows * m.flops_per_row()), "flops": 0.0,
            "bytes": float(n_rows * (m.in_dim + m.out_dim) * F32
                           + mlp_weight_bytes(m))}


def encode_bwd(n_points: int, g: Grid) -> Dict[str, float]:
    """``encode_bwd``: points and the (B, L*F) cotangent in, the whole
    table gradient out; per corner d weight multiplies, F products and F
    adds."""
    return {"mma_flops": 0.0, "flops": encode_flops(n_points, g),
            "bytes": float(n_points * (g.dim + g.out_dim) * F32
                           + g.n_levels * g.table_size * g.n_features * F32)}


def field_eval_compute(n_points: int, g: Grid, m: Mlp) -> Dict[str, float]:
    """The FLOPs of one field evaluation of ``n_points`` points: the encode
    and the grid's MLP."""
    return {"mma_flops": float(n_points * m.flops_per_row()),
            "flops": encode_flops(n_points, g)}


def nerf_tile_compute(n_rays: int, n_samples: int, n_field: int, g: Grid,
                      density: Mlp, colour: Mlp) -> Dict[str, float]:
    """A nerf tile's FLOPs: the field (encode, density MLP, SH, colour MLP,
    exp and sigmoid) at ``n_field`` samples (every sample dense; the live
    ones culled) and the composite over every sample of every ray."""
    return add(field_eval_compute(n_field, g, density),
               {"mma_flops": float(n_field * colour.flops_per_row()),
                "flops": float(n_field * (SH_FLOPS + 4)
                               + n_rays * n_samples * COMPOSITE_FLOPS)})


def nsdf_tile_compute(n_rays: int, steps: int, g: Grid, m: Mlp,
                      extra_evals: int) -> Dict[str, float]:
    """An nsdf tile's FLOPs: ``steps + extra_evals`` field evaluations a
    ray."""
    return field_eval_compute(n_rays * (steps + extra_evals), g, m)


def nerf_train_step_compute(n_rays: int, n_samples: int, g: Grid,
                            density: Mlp, colour: Mlp,
                            n_params: int) -> Dict[str, float]:
    """A nerf training step's FLOPs: the forward tile, the backward (each
    MLP product's two transposes, the encode's scatter) and Adam."""
    n = n_rays * n_samples
    fwd = nerf_tile_compute(n_rays, n_samples, n, g, density, colour)
    bwd = {"mma_flops": 2.0 * n * (density.flops_per_row()
                                   + colour.flops_per_row()),
           "flops": encode_flops(n, g) + n * COMPOSITE_FLOPS}
    return add(fwd, bwd, {"flops": float(n_params * ADAM_FLOPS)})


def n_params(params) -> int:
    return sum(n_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())
