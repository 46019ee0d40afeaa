"""The slice as a whole: repro_torch's RenderEngine against the JAX
package's render_frame, plus the port's isolation and device rules.

The engine runs on ``device="cpu"``, where every kernel wrapper runs its
plain version; the JAX side renders each scene with
``RenderSettings(use_pallas=True)`` (Pallas in interpret mode). Parameters
are made with numpy from a seed (tables U(-1, 1)). Tolerance 1e-5 (f32):
the same operations on both sides, rounded differently only where XLA
contracts or reorders.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.core import render as jrender
from repro.quant import QuantSpec as JQuantSpec
from repro.quant import api as japi
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpipeline
from repro_torch.data import scenes as tscenes
from repro_torch.quant import QuantSpec, quantize_field
from repro_torch.serve import RenderEngine, RenderRequest
from tests.conftest import small_field_config

TOL = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _cfgs(app, log2_T=12, n_levels=4):
    cj = small_field_config(app, "hash", log2_T=log2_T, n_levels=n_levels)
    ct = tfields.make_field_config(app, "hash")
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=log2_T,
                                          n_levels=n_levels))
    return cj, ct


def _np_params(ct, seed):
    rng = np.random.default_rng(seed)

    def draw(shapes, grid=False):
        if isinstance(shapes, dict):
            return {k: draw(s, k == "grid") for k, s in shapes.items()}
        if grid:
            return rng.uniform(-1, 1, shapes).astype(np.float32)
        return (rng.normal(size=shapes) / np.sqrt(shapes[-2])).astype(
            np.float32)
    return draw(tfields.param_shapes(ct))


def _jax_cam(tcam):
    return jrender.Camera(height=tcam.height, width=tcam.width,
                          focal=tcam.focal, c2w=jnp.asarray(tcam.c2w))


def _engine(ct, params, settings):
    engine = RenderEngine(settings, device="cpu")
    for s, p in enumerate(params):
        engine.add_scene(f"s{s}", ct, tfields.from_jax_params(p, ct, "cpu"))
    engine.warmup()
    return engine


@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_engine_matches_jax_render_frame_per_scene(app):
    """2 scenes x mixed cameras (one resolution not a multiple of the
    tile: the last tile carries masked pad lanes)."""
    cj, ct = _cfgs(app)
    params = [_np_params(ct, s) for s in range(2)]
    settings = tpipeline.RenderSettings(tile_pixels=64, n_samples=8)
    jsettings = jpipeline.RenderSettings(tile_pixels=64, n_samples=8,
                                         use_pallas=True)
    engine = _engine(ct, params, settings)
    cams = [tscenes.orbit_camera(16, 16, 0.3), tscenes.orbit_camera(12, 12, 2.5)]
    for s in range(2):
        cam = cams[s]
        got = engine.render_frame(f"s{s}", cam)
        ref = jpipeline.render_frame(jax.tree.map(jnp.asarray, params[s]), cj,
                                     _jax_cam(cam), jsettings)
        assert got.shape == (*cam.resolution, 3)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("app,table_qtype,mlp_qtype", [
    ("nerf", "int8", None), ("nerf", "fp8_e4m3", "int8"),
    ("nvr", "fp8_e4m3", None), ("nvr", "int8", "int8_affine")])
def test_quantized_engine_matches_jax_render_frame(app, table_qtype,
                                                   mlp_qtype):
    """A JAX quantize_field tree served through the port's engine equals
    the JAX Pallas render of the same tree."""
    cj, ct = _cfgs(app)
    jspec = JQuantSpec(table_qtype, mlp_qtype)
    jq = japi.quantize_field(jax.tree.map(jnp.asarray, _np_params(ct, 4)),
                             jspec)
    qcfg = ct.with_quant(QuantSpec(table_qtype, mlp_qtype))
    settings = tpipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = RenderEngine(settings, device="cpu")
    engine.add_scene("q", qcfg, tfields.from_jax_params(
        jax.tree.map(np.asarray, jq), qcfg, "cpu"))
    engine.warmup()
    cam = tscenes.orbit_camera(12, 12, 1.3)
    got = engine.render_frame("q", cam)
    ref = jpipeline.render_frame(
        jq, cj.with_quant(jspec), _jax_cam(cam),
        jpipeline.RenderSettings(tile_pixels=64, n_samples=8,
                                 use_pallas=True))
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


def test_quantized_and_dense_scenes_never_share_a_bucket():
    _, ct = _cfgs("nerf", log2_T=10, n_levels=2)
    dense = tfields.from_jax_params(_np_params(ct, 0), ct, "cpu")
    engine = RenderEngine(tpipeline.RenderSettings(tile_pixels=64,
                                                   n_samples=8), device="cpu")
    keys = [engine.add_scene("dense", ct, dense)]
    for name, spec in (("i8", QuantSpec("int8")),
                       ("f8", QuantSpec("fp8_e4m3", mlp_qtype="int8")),
                       ("i8b", QuantSpec("int8"))):
        keys.append(engine.add_scene(name, ct.with_quant(spec),
                                     quantize_field(dense, spec)))
    assert len(set(keys)) == 3 and keys[1] == keys[3]
    names = list(engine.stats()["buckets"])
    assert [n.split("/q-")[-1] if "/q-" in n else n[-2:] for n in names] \
        == ["#0", "t:int8#1", "t:fp8_e4m3+m:int8#2"]
    engine.warmup()
    cam = tscenes.orbit_camera(8, 8, 0.4)
    rgb_d = engine.render_frame("dense", cam)
    for name in ("i8", "f8"):
        err = np.abs(engine.render_frame(name, cam) - rgb_d).max()
        assert 0.0 < err < 0.2                 # same scene, small error


@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_bf16_scene_gets_its_own_bucket_and_matches_render_frame(app):
    """A scene with bf16 tables, carried from a JAX tree, is bucketed apart
    from f32 scenes of the same config, as the JAX engine buckets it by its
    leaf dtypes, and its frame equals the JAX render_frame of that tree."""
    cj, ct = _cfgs(app)
    np_p = _np_params(ct, 8)
    jtree = jax.tree.map(jnp.asarray, np_p)
    jtree["grid"] = jtree["grid"].astype(jnp.bfloat16)
    settings = tpipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = RenderEngine(settings, device="cpu")
    k_f32 = engine.add_scene("f32", ct, tfields.from_jax_params(np_p, ct,
                                                                 "cpu"))
    k_bf16 = engine.add_scene("bf16", ct, tfields.from_jax_params(
        jax.tree.map(np.asarray, jtree), ct, "cpu"))
    assert k_f32 != k_bf16 and k_bf16.cfg == k_f32.cfg
    assert k_bf16.dtype.split(",")[0] == "torch.bfloat16"
    assert len(engine.stats()["buckets"]) == 2
    engine.warmup()
    cam = tscenes.orbit_camera(12, 12, 0.8)
    got = engine.render_frame("bf16", cam)
    ref = jpipeline.render_frame(jtree, cj, _jax_cam(cam),
                                 jpipeline.RenderSettings(tile_pixels=64,
                                                          n_samples=8))
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)
    assert np.abs(got - engine.render_frame("f32", cam)).max() > 0


def test_engine_rejects_quant_config_param_drift():
    _, ct = _cfgs("nvr", log2_T=8, n_levels=2)
    spec = QuantSpec("int8")
    params = tfields.from_jax_params(_np_params(ct, 0), ct, "cpu")
    engine = RenderEngine(tpipeline.RenderSettings(tile_pixels=16,
                                                   n_samples=4), device="cpu")
    with pytest.raises(ValueError, match="cfg.quant is None"):
        engine.add_scene("a", ct, quantize_field(params, spec))
    with pytest.raises(ValueError, match="grid_scale"):
        engine.add_scene("b", ct.with_quant(spec), params)
    assert engine.scenes() == []


def test_random_pixel_requests_match_frames():
    """A mixed stream (2 scenes x 3 cameras, random pixels) through
    submit/flush returns exactly those pixels of each scene's frame."""
    _, ct = _cfgs("nerf")
    params = [_np_params(ct, 10 + s) for s in range(2)]
    settings = tpipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = _engine(ct, params, settings)
    cams = [tscenes.orbit_camera(8, 8, a) for a in (0.0, 2.1)] + [
        tscenes.orbit_camera(12, 10, 4.2)]
    frames = {(s, c): tpipeline.render_frame(
        tfields.from_jax_params(params[s], ct, "cpu"), ct, cams[c], settings,
        device="cpu").reshape(-1, 3).numpy()
        for s in range(2) for c in range(3)}
    rng = np.random.default_rng(0)
    jobs = []
    for r in range(8):
        s, c = r % 2, r % 3
        h, w = cams[c].resolution
        ids = rng.integers(0, h * w, 40)
        jobs.append((s, c, ids, engine.submit(
            RenderRequest(f"s{s}", cams[c], ids))))
    engine.flush()
    for s, c, ids, ticket in jobs:
        assert ticket.is_ready()
        np.testing.assert_allclose(ticket.result(), frames[(s, c)][ids],
                                   atol=TOL)
    st = engine.stats()
    assert st["n_requests"] == 8 and st["pixels"] == 8 * 40
    assert np.isfinite(st["p50_ms"]) and st["p99_ms"] >= st["p50_ms"]
    assert list(st["buckets"].values()) == [{"n_scenes": 2}]


def test_engine_rejects_oversized_unknown_and_duplicate():
    _, ct = _cfgs("nvr", log2_T=10, n_levels=2)
    settings = tpipeline.RenderSettings(tile_pixels=16, n_samples=4)
    engine = _engine(ct, [_np_params(ct, 0)], settings)
    cam = tscenes.default_camera(8, 8)
    with pytest.raises(ValueError, match="tile_pixels"):
        engine.submit(RenderRequest("s0", cam, np.arange(17)))
    with pytest.raises(KeyError, match="nope"):
        engine.submit(RenderRequest("nope", cam, np.arange(4)))
    with pytest.raises(ValueError, match="already"):
        engine.add_scene("s0", ct, tfields.from_jax_params(
            _np_params(ct, 1), ct, "cpu"))
    with pytest.raises(ValueError, match="unknown app"):
        engine.add_scene("x", dataclasses.replace(ct, app="volume"), {})
    # every app of the paper is served: gia and nsdf get buckets of their own
    keys = [engine.add_scene(app, c, tfields.from_jax_params(
        _np_params(c, 2), c, "cpu"))
        for app in ("gia", "nsdf") for c in [_cfgs(app, log2_T=10)[1]]]
    assert [k.app for k in keys] == ["gia", "nsdf"]
    assert all(k.n_samples == settings.n_samples for k in keys)
    assert len(engine.stats()["buckets"]) == 3
    assert engine.scenes() == ["s0", "gia", "nsdf"]
    assert engine.stats()["n_requests"] == 0         # warmup not counted


def test_scenes_stack_as_views():
    _, ct = _cfgs("nerf", log2_T=10, n_levels=2)
    ps = [tfields.from_jax_params(_np_params(ct, s), ct, "cpu")
          for s in range(3)]
    stacked = tpipeline.stack_scene_params(ps)
    assert stacked["grid"].shape == (3, *ps[0]["grid"].shape)
    one = tpipeline.select_scene(stacked, 2)
    assert one["grid"].data_ptr() == stacked["grid"][2].data_ptr()
    assert torch.equal(one["density_mlp"]["w_in"],
                       ps[2]["density_mlp"]["w_in"])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serve.engine' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("entry", ["init_field", "from_jax_params",
                                   "render_frame", "RenderEngine"])
def test_entry_points_never_fall_back_to_cpu(monkeypatch, entry):
    """Without a GPU, an entry point called without ``device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ct = _cfgs("nvr", log2_T=8, n_levels=2)
    cpu_params = tfields.from_jax_params(_np_params(ct, 0), ct, "cpu")
    calls = {
        "init_field": lambda: tfields.init_field(ct),
        "from_jax_params": lambda: tfields.from_jax_params(
            _np_params(ct, 0), ct),
        "render_frame": lambda: tpipeline.render_frame(
            cpu_params, ct, tscenes.default_camera(4, 4)),
        "RenderEngine": lambda: RenderEngine(),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
