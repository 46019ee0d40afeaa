"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, with the configurations' tables and the frames cut down. Only the
tests use it."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

NGBENCH = Path(__file__).resolve().parents[1]
ROOT = NGBENCH.parent

# the tiny cells keep the MLPs' widths of Table I and cut the grid to 4
# levels of 2^13 rows (level 0 stays dense, as nsdf's baked sphere needs,
# the finer levels hash) and the frames to a few tiles
TINY_GRID = {"n_levels": 4, "log2_table_size": 13}
TINY_FRAME = {"height": 16, "width": 24, "orbit_positions": 36}
TINY_TILE = 96
TINY_POOL = {"rays": 64, "pool": 4, "gt_samples": 16, "height": 32,
             "width": 32, "orbit_positions": 8}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_copy(dest: Path) -> Path:
    """A tiny copy of BENCHMARK.json and ngbench/ under ``dest``; returns
    the copy's ngbench directory."""
    here = dest / "ngbench"
    shutil.copytree(NGBENCH, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for f in (here / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["grid"].update(TINY_GRID)
        key = "density_mlp" if cfg.get("density_mlp") else "mlp"
        cfg[key]["in_dim"] = TINY_GRID["n_levels"] * cfg["grid"]["n_features"]
        _write(f, cfg)
    for f in (here / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(TINY_FRAME if mix["generator"] == "viewers" else TINY_POOL)
        _write(f, mix)
    for f in (here / "workloads").glob("*.json"):
        wl = json.loads(f.read_text())
        if wl["kind"] == "serve":
            wl["engine"]["tile_pixels"] = TINY_TILE
            wl["engine"]["sphere_steps"] = 8
            if wl["engine"]["occupancy"]:
                wl["engine"]["sample_budget"] = TINY_TILE * \
                    wl["engine"]["n_samples"] // 2
            wl["check"]["from_first"] = 3
            wl["check"]["frames_per_viewer"] = 1
        else:
            wl["train"]["chunk_steps"] = 2
        _write(f, wl)
    return here
