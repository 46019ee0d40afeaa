"""Finds a culled serving cell's ``sample_budget``: the smallest of 1/2,
1/4 and 1/8 of a tile's dense sample count under which no tile of any
camera of the cell's orbit drops a live sample.

    python3 ngbench/budget_search.py --workload <cell> [--device cpu]

For every orbit position of the cell's mix and every tile of its frame it
counts the live samples (the occupancy grid the cell builds, the early
termination of its engine settings: ``reference/render.cull_mask``) and
prints, for each fraction, the live share and the samples that would be
dropped, as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ngbench import scenes, spec                          # noqa: E402
from ngbench.reference import render as ref               # noqa: E402
from ngbench.traffic.viewers import camera_at              # noqa: E402

FRACTIONS = (2, 4, 8)


def live_counts(cell, device) -> torch.Tensor:
    """(positions, tiles) live samples."""
    e, tr, o = (cell.workload["engine"], cell.traffic,
                cell.workload["occupancy"])
    occ = scenes.analytic_occupancy(o["res"], o["threshold"], device)
    tp, n_s = e["tile_pixels"], e["n_samples"]
    n_pix = tr["height"] * tr["width"]
    out = torch.zeros((tr["orbit_positions"], n_pix // tp), dtype=torch.int64)
    for pos in range(tr["orbit_positions"]):
        cam = camera_at(tr["height"], tr["width"], tr["orbit_positions"], pos)
        for j, start in enumerate(range(0, n_pix, tp)):
            ids = torch.arange(start, start + tp, device=device)
            origins, dirs = ref.make_rays(cam, ids)
            pts, dts = ref.sample_along_rays(origins, dirs, e["near"],
                                             e["far"], n_s)
            unit = ref.normalize_to_unit(pts.reshape(-1, 3)).reshape(
                tp, n_s, 3)
            out[pos, j] = int(ref.cull_mask(occ, unit, dts,
                                            e["early_term_eps"]).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    live = live_counts(cell, torch.device(args.device))
    e = cell.workload["engine"]
    dense = e["tile_pixels"] * e["n_samples"]
    rows = {}
    for f in FRACTIONS:
        budget = dense // f
        rows[f"1/{f}"] = {"budget": budget,
                          "dropped": int((live - budget).clamp_min(0).sum()),
                          "tiles_over": int((live > budget).sum())}
    ok = [r["budget"] for r in rows.values() if r["dropped"] == 0]
    print(json.dumps({"workload": args.workload,
                      "positions": live.shape[0], "tiles": live.shape[1],
                      "dense_per_tile": dense,
                      "live_share": float(live.sum()) / (live.numel() * dense),
                      "live_per_tile_max": int(live.max()),
                      "live_per_tile_mean": float(live.float().mean()),
                      "fractions": rows,
                      "sample_budget": min(ok) if ok else dense}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
