"""The frozen counts against a hand count for one tile, and against the
arithmetic they were frozen from."""
import numpy as np
import torch

from ngbench import counts, peaks, scenes, spec
from ngbench.reference import render as ref
from ngbench.reference.field import grid_of, mlp_of
from repro_torch.core import encoding as penc
from repro_torch.kernels import cost as pcost
from ngbench import program


def _tile_points(tiny):
    cell = spec.find_cell("nerf_hash.frames_720p", tiny)
    e = cell.workload["engine"]
    cam = scenes.orbit_camera(cell.traffic["height"], cell.traffic["width"],
                              1.3)
    origins, dirs = ref.make_rays(cam, torch.arange(e["tile_pixels"]))
    pts, _ = ref.sample_along_rays(origins, dirs, e["near"], e["far"],
                                   e["n_samples"])
    return cell, ref.normalize_to_unit(pts.reshape(-1, 3))


def test_distinct_rows_by_hand(tiny):
    cell, pts = _tile_points(tiny)
    pcfg = program.field_config(cell.config).grid
    hand = 0
    for level in range(pcfg.n_levels):
        cell_l, _ = penc.level_cell(pts, pcfg.level_resolution(level))
        rows = set()
        for bits in penc._corner_offsets(pcfg.dim):
            rows.update(penc.level_corner_index(cell_l, bits, level, pcfg)
                        .tolist())
        hand += len(rows)
    assert counts.distinct_rows(pts, grid_of(cell.config)) == hand


def _table1():
    """The published nerf_hash configuration (no data is needed)."""
    cell = spec.find_cell("nerf_hash.frames_720p")
    return cell, (grid_of(cell.config), mlp_of(cell.config, "density_mlp"),
                  mlp_of(cell.config, "mlp"))


def test_field_and_mlp_work_by_hand():
    cell, (g, d, c) = _table1()
    n, rows = 61440 * 32, 4_861_740
    w = counts.field_fwd(n, g, d, rows)
    # by hand: 32 -> 64 -> 64 -> 64 -> 16, each product once
    assert w["mma_flops"] == n * 2 * (32 * 64 + 2 * 64 * 64 + 64 * 16)
    assert w["flops"] == n * 16 * 8 * (3 + 2 * 2)
    weights = 4 * (32 * 64 + 2 * 64 * 64 + 64 * 16)
    assert w["bytes"] == n * 3 * 4 + rows * 2 * 4 + weights + n * 16 * 4
    # the source it was frozen from: the same bytes and operations
    src = pcost.field_fwd(n, program.field_config(cell.config).grid,
                          program.field_config(cell.config).density_mlp,
                          4, False, weights, rows)
    assert (src["bytes"], src["flops"], src["mlp_flops"]) == \
        (w["bytes"], w["flops"], w["mma_flops"])
    m = counts.mlp_fwd(n, c)
    assert m["mma_flops"] == n * 2 * (32 * 64 + 3 * 64 * 64 + 64 * 3)
    assert m["bytes"] == n * (32 + 3) * 4 + 4 * (32 * 64 + 3 * 64 * 64
                                                 + 64 * 3)
    b = counts.encode_bwd(n, g)
    src = pcost.encode_bwd(n, program.field_config(cell.config).grid,
                           g.n_levels * g.table_size * g.n_features, 4)
    assert (src["bytes"], src["flops"]) == (b["bytes"], b["flops"])


def test_least_time_takes_the_largest_term():
    w = {"mma_flops": 495e12, "flops": 67e12 / 2, "bytes": 3.35e12 / 4}
    assert peaks.least_time_s(w) == 1.0
    assert peaks.compute_time_s({"flops": 67e12 * 3}) == 3.0
    assert peaks.least_time_s({"bytes": 3.35e12 * 2}) == 2.0


def test_tile_compute_by_hand():
    cell, (g, d, c) = _table1()
    r, s = 96, 32
    w = counts.nerf_tile_compute(r, s, r * s, g, d, c)
    n = r * s
    assert w["mma_flops"] == n * (d.flops_per_row() + c.flops_per_row())
    assert w["flops"] == n * (16 * 8 * 7 + 31 + 4) + n * 16
    t = counts.nerf_train_step_compute(r, s, g, d, c, 1000)
    assert t["mma_flops"] == 3 * w["mma_flops"]
    assert t["flops"] == w["flops"] + n * (16 * 8 * 7 + 16) + 12 * 1000
    assert np.isclose(counts.nsdf_tile_compute(10, 48, g, d, 7)["mma_flops"],
                      10 * 55 * d.flops_per_row())
