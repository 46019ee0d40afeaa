"""nerf in a serving cell: the reference's tile (rays, samples, the field,
the composite; culled, the mask, the budget's selection and the scatter),
the port's kernel calls a tile and their counted work."""
from __future__ import annotations

from typing import Dict, Optional

from ngbench import counts
from ngbench.reference import render as ref
from ngbench.reference.field import grid_of, mlp_of

HEAD = "density_mlp"          # the MLP that field_fwd runs on the encoding


def reference_tile(field, cam, ids, engine: Dict, occ, seen):
    """The tile's (R, 3) pixels and the live samples its budget dropped."""
    rgb, n = ref.nerf_tile(field, cam, ids, engine, occ,
                           engine.get("sample_budget"), seen)
    return rgb, (n["dropped"] if n is not None else 0)


def calls_per_tile(engine: Dict) -> Dict[str, int]:
    return {"field_fwd": 1, "mlp_fwd": 1, "composite_fwd": 1}


def tile_compute(cfg: Dict, engine: Dict,
                 live: Optional[float]) -> Dict[str, float]:
    """FLOPs of one tile: every sample dense; culled, the window's mean
    live samples a tile (``live``)."""
    tp, n_s = engine["tile_pixels"], engine["n_samples"]
    n_field = tp * n_s if live is None else live
    return counts.nerf_tile_compute(tp, n_s, n_field, grid_of(cfg),
                                    mlp_of(cfg, "density_mlp"),
                                    mlp_of(cfg, "mlp"))


def tile_work(cfg: Dict, engine: Dict) -> Dict[str, Dict[str, float]]:
    """Counted work of each call a tile of the kernels, other than
    ``field_fwd``, whose work the inputs do not change: ``mlp_fwd`` on
    every sample, or on the budget's rows culled."""
    n = engine["sample_budget"] if engine["occupancy"] and engine.get(
        "sample_budget") else engine["tile_pixels"] * engine["n_samples"]
    return {"mlp_fwd": counts.mlp_fwd(n, mlp_of(cfg, "mlp"))}
