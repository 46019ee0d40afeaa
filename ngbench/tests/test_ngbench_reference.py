"""The plain reference agrees with the port on the CPU at tiny sizes (the
port's plain versions run there), and a whole run of each tiny cell
comes out correct."""
import time

import numpy as np
import pytest
import torch

from ngbench import bench, program, scenes, spec
from ngbench.reference import render as ref
from ngbench.reference.field import Field, Levels, encode, grid_of
from repro_torch.core import encoding as penc
from repro_torch.core import pipeline as ppipe
from repro_torch.core import train as ptrain
from repro_torch.train import loop as ploop

CPU = torch.device("cpu")
CELLS = ["nerf_hash.frames_720p", "nsdf_hash.frames_720p",
         "nerf_hash.train_32k_rays", "nerf_hash.frames_720p_culled"]


def _cell(tiny, name):
    return spec.find_cell(name, tiny)


def _params(cell, seed=5):
    return scenes.make_weights(cell.config, cell.workload["weights"],
                               scenes.generator(seed, 0, CPU), CPU)


def _settings(e):
    return ppipe.RenderSettings(
        tile_pixels=e["tile_pixels"], n_samples=e["n_samples"],
        near=e["near"], far=e["far"], sphere_steps=e["sphere_steps"],
        occupancy=e["occupancy"], sample_budget=e.get("sample_budget"),
        early_term_eps=e["early_term_eps"])


def test_encode_matches_the_port(tiny):
    cell = _cell(tiny, "nerf_hash.frames_720p")
    g = grid_of(cell.config)
    pcfg = program.field_config(cell.config).grid
    gen = torch.Generator().manual_seed(3)
    pts = torch.rand((3000, 3), generator=gen)
    pts[:5] = torch.tensor([0.0, 1.0, 0.5])          # the cube's faces
    tables = torch.rand((g.n_levels, g.table_size, g.n_features),
                        generator=gen) * 2 - 1
    got = encode(pts, tables, Levels(g, CPU))
    want = penc.grid_encode(pts, tables, pcfg)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["nerf_hash.frames_720p",
                                  "nerf_hash.frames_720p_culled",
                                  "nsdf_hash.frames_720p"])
def test_tile_matches_the_port(tiny, name):
    cell = _cell(tiny, name)
    e = cell.workload["engine"]
    params = _params(cell)
    if e["occupancy"]:
        params["occupancy"] = scenes.analytic_occupancy(
            cell.workload["occupancy"]["res"],
            cell.workload["occupancy"]["threshold"], CPU)
    cam = scenes.orbit_camera(cell.traffic["height"], cell.traffic["width"],
                              0.7)
    ids = torch.arange(e["tile_pixels"])
    tile = ppipe.make_tile_fn(program.field_config(cell.config),
                              _settings(e), with_aux=True)
    with torch.no_grad():
        want, aux = tile(params, program.camera(cam), ids)
        field = Field(cell.config, params)
        got, dropped = spec.app(cell, tiny).reference_tile(
            field, cam, ids, e, params.get("occupancy"), None)
        if e["occupancy"]:
            _, counts = ref.nerf_tile(field, cam, ids, e,
                                      params["occupancy"],
                                      e.get("sample_budget"))
            assert counts["live"] == int(aux[0, 0])
            assert counts["dropped"] == int(aux[0, 2]) == dropped
            assert 0 < counts["live"] < e["tile_pixels"] * e["n_samples"]
    assert torch.allclose(got, want, rtol=0, atol=1e-5)
    assert float(got.abs().max()) > 0.05


def test_train_loss_and_gradients_match_the_port(tiny):
    cell = _cell(tiny, "nerf_hash.train_32k_rays")
    kind = spec.kind(cell, tiny)
    tc = kind.make(cell, 9, CPU, program, tiny)
    tree_items = kind.tree_items
    want = tc.reference("f32")
    fcfg = program.field_config(cell.config)
    batch = tc.pool[0]
    loss, grads = ploop.value_and_grad(
        lambda p, b: ptrain.field_loss(p, fcfg, b, n_samples=32), tc.p0,
        batch)
    assert abs(float(loss) - want["losses"][0]) <= 1e-6 * want["losses"][0]
    for k, g in tree_items(grads):
        ref_g = want["grad1"][k]
        scale = float(ref_g.abs().max())
        assert scale > 0, k
        assert float((g - ref_g).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(tiny, name):
    r = bench.run_cell(name, 2**31 + 17, 5.0, False, time.perf_counter(),
                       device="cpu", here=tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in spec.end_to_end(name, tiny)}
    assert set(r["metrics"]) == names
    assert all(np.isfinite(m["value"]) and m["value"] > 0
               for m in r["metrics"].values())
