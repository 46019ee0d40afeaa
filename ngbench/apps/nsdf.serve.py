"""nsdf in a serving cell: the reference's tile (rays, the sphere trace,
the normal and the shading), the port's kernel calls a tile and their
counted work."""
from __future__ import annotations

from typing import Dict, Optional

from ngbench import counts
from ngbench.reference import render as ref
from ngbench.reference.field import grid_of, mlp_of

HEAD = "mlp"                  # the MLP that field_fwd runs on the encoding


def reference_tile(field, cam, ids, engine: Dict, occ, seen):
    """The tile's (R, 3) pixels; sphere tracing drops no sample."""
    return ref.nsdf_tile(field, cam, ids, engine, seen), 0


def calls_per_tile(engine: Dict) -> Dict[str, int]:
    return {"field_fwd": engine["sphere_steps"] + ref.NSDF_EXTRA_EVALS}


def tile_compute(cfg: Dict, engine: Dict,
                 live: Optional[float]) -> Dict[str, float]:
    """FLOPs of one tile: ``sphere_steps + NSDF_EXTRA_EVALS`` field
    evaluations a ray."""
    return counts.nsdf_tile_compute(engine["tile_pixels"],
                                    engine["sphere_steps"], grid_of(cfg),
                                    mlp_of(cfg, "mlp"), ref.NSDF_EXTRA_EVALS)


def tile_work(cfg: Dict, engine: Dict) -> Dict[str, Dict[str, float]]:
    """No kernel but ``field_fwd`` runs a tile."""
    return {}
