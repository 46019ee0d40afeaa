"""repro_torch's gia and nsdf apps against the JAX package: the analytic
scenes, sphere tracing, nsdf shading, the tile functions, render_frame and
two-scene engine frames.

Parameters are made with numpy from a seed and handed to both packages;
the port runs its kernel wrappers, which run their plain versions on CPU
tensors. The JAX side runs its XLA route or, at small tables, its Pallas
route in interpret mode (``use_pallas=True``).

gia's tables are U(-1, 1). gia at ``log2_T=14, n_levels=12`` has dense
levels 0-9 (level 9's 128^2 grid fills the table exactly) and hashed
levels 10-11; at Table-I width no level hashes.

nsdf feeds each field value into the next sample point for 48 steps, so a
random field would amplify a last-bit difference without bound: its
tests use ``scenes.baked_sdf_params`` (``sdf_sphere`` in level 0's dense
table, passed through the MLP; every other level and weight adds a small
perturbation), on which sphere tracing converges. Level 0 (17^3 rows) is
dense only from ``log2_T=13``, so nsdf's Pallas cases take ``log2_T=13``.

Tolerance 1e-5 (f32): the same operations on both sides, rounded
differently only where XLA contracts a multiply-add or orders a sum
otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipeline
from repro.core import render as jrender
from repro.data import scenes as jscenes
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpipeline
from repro_torch.data import scenes as tscenes
from repro_torch.serve import RenderEngine, RenderRequest
from tests.conftest import small_field_config

TOL = 1e-5


def _cfgs(app, encoding="hash", log2_T=12, n_levels=4):
    cj = small_field_config(app, encoding, log2_T=log2_T, n_levels=n_levels)
    ct = tfields.make_field_config(app, encoding)
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=log2_T,
                                          n_levels=n_levels))
    return cj, ct


def _np_params(ct, seed):
    """gia: U(-1, 1) tables and normal/sqrt(fan_in) weights; nsdf: the
    baked sphere."""
    if ct.app == "nsdf":
        return tscenes.baked_sdf_params(ct, seed)
    rng = np.random.default_rng(seed)

    def draw(shapes, grid=False):
        if isinstance(shapes, dict):
            return {k: draw(s, k == "grid") for k, s in shapes.items()}
        if grid:
            return rng.uniform(-1, 1, shapes).astype(np.float32)
        return (rng.normal(size=shapes) / np.sqrt(shapes[-2])).astype(
            np.float32)
    return draw(tfields.param_shapes(ct))


def _jax_tree(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _jax_cam(tcam):
    return jrender.Camera(height=tcam.height, width=tcam.width,
                          focal=tcam.focal, c2w=jnp.asarray(tcam.c2w))


def _jax_rays(tcam):
    h, w = tcam.resolution
    return jrender.make_rays(_jax_cam(tcam), jnp.arange(h * w,
                                                        dtype=jnp.int32))


# ------------------------------------------------------------- scenes
def test_analytic_scenes_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(size=(500, 2)).astype(np.float32)
    p = rng.uniform(-1.2, 1.2, size=(500, 3)).astype(np.float32)
    for tfn, jfn, x in ((tscenes.gigapixel_image, jscenes.gigapixel_image,
                         xy),
                        (tscenes.sdf_sphere, jscenes.sdf_sphere, p),
                        (tscenes.sdf_torus, jscenes.sdf_torus, p),
                        (tscenes.sdf_scene, jscenes.sdf_scene, p)):
        got = tfn(torch.from_numpy(x)).numpy()
        ref = np.asarray(jfn(jnp.asarray(x)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert np.asarray(jscenes.gigapixel_image(jnp.asarray(xy))).std() > 0.1


def test_baked_sdf_field_is_the_sphere():
    """At the level-0 vertices the baked field is the sphere's SDF plus a
    perturbation under 5e-3; off the vertices the trilinear interpolation
    of the cone |p| near the origin, in cells 0.125 wide, adds up to a few
    1e-2. (A coordinate of exactly 1 reads the
    vertex before it, as the encoding clips its cell, so the vertices
    tested stop short of 1.)"""
    _, ct = _cfgs("nsdf", log2_T=14)
    p = tfields.from_jax_params(_np_params(ct, 0), ct, "cpu")
    g = torch.arange(16, dtype=torch.float32) / 16
    verts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1
                        ).reshape(-1, 3)
    for x, tol in ((verts, 5e-3),
                   (torch.rand(2000, 3, generator=torch.Generator()
                               .manual_seed(1)), 0.05)):
        got = tfields.apply_field(p, ct, x)
        ref = tscenes.sdf_sphere(x * 2 - 1)
        assert float((got - ref).abs().max()) < tol
    with pytest.raises(ValueError, match="dense level 0"):
        tscenes.baked_sdf_params(_cfgs("nsdf", log2_T=12)[1], 0)


# ------------------------------------------------------- sphere tracing
def test_sphere_trace_matches_jax_on_the_analytic_scene():
    """Hit masks equal; hit points (and the end points of rays that stop
    within t < 6) within 1e-5. A ray that misses the analytic scene about
    doubles its t every step, to 1e13 after 48: there both sides only
    agree that it ran past t = 6. Both trace the same rays (the two
    make_rays may differ in the last bit, which a grazing ray carries
    through 48 steps to about 1e-5)."""
    jo, jd = _jax_rays(tscenes.orbit_camera(16, 16, 0.7))
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    got_p, got_hit = tpipeline.sphere_trace(tscenes.sdf_scene, o, d, 48)
    ref_p, ref_hit = jpipeline.sphere_trace(jscenes.sdf_scene, jo, jd, 48)
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(ref_hit))
    got_t = np.linalg.norm(got_p.numpy() - o.numpy(), axis=-1)
    ref_t = np.linalg.norm(np.asarray(ref_p - jo), axis=-1)
    near = ref_t < 6.0
    np.testing.assert_array_equal(got_t < 6.0, near)
    np.testing.assert_allclose(got_p.numpy()[near], np.asarray(ref_p)[near],
                               atol=TOL, rtol=TOL)
    assert 0 < int(got_hit.sum()) < 256 and near.sum() > got_hit.sum() / 2


@pytest.mark.parametrize("use_pallas,log2_T", [(False, 14), (True, 13)])
def test_shade_nsdf_matches_jax_on_the_baked_scene(use_pallas, log2_T):
    cj, ct = _cfgs("nsdf", log2_T=log2_T)
    p = _np_params(ct, 1)
    jo, jd = _jax_rays(tscenes.orbit_camera(12, 12, 2.0))
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    got = tpipeline.shade_nsdf(tfields.from_jax_params(p, ct, "cpu"), ct, o,
                               d, tpipeline.RenderSettings())
    ref = jpipeline.shade_nsdf(_jax_tree(p), cj, jo, jd,
                               jpipeline.RenderSettings(use_pallas=use_pallas))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    hit = got.numpy().sum(-1) > 0
    assert 0 < hit.sum() < 144


# --------------------------------------------------------- tile functions
@pytest.mark.parametrize("app,encoding,log2_T,n_levels,use_pallas", [
    ("gia", "hash", 14, 12, False), ("gia", "hash", 10, 4, True),
    ("gia", "dense", 12, 8, False), ("gia", "tiled", 12, 2, False),
    ("gia", "tiled", 10, 2, True),
    ("nsdf", "hash", 14, 4, False), ("nsdf", "hash", 13, 4, True)])
def test_tile_fn_matches_jax(app, encoding, log2_T, n_levels, use_pallas):
    """One tile of random pixels of a 20x24 camera (gia's coordinates
    divide by two different sides)."""
    cj, ct = _cfgs(app, encoding, log2_T=log2_T, n_levels=n_levels)
    p = _np_params(ct, 2)
    cam = tscenes.orbit_camera(20, 24, 1.1)
    ids = np.random.default_rng(3).integers(0, 20 * 24, 96)
    got = tpipeline.make_tile_fn(ct, tpipeline.RenderSettings(
        tile_pixels=96))(tfields.from_jax_params(p, ct, "cpu"), cam,
                         torch.from_numpy(ids))
    ref = jpipeline.make_tile_fn(cj, jpipeline.RenderSettings(
        tile_pixels=96, use_pallas=use_pallas))(
            _jax_tree(p), _jax_cam(cam), jnp.asarray(ids, jnp.int32))
    assert got.shape == (96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_gia_pixel_coords_match_jax_bit_for_bit():
    """gia's sample points: integer division and one f32 divide per
    coordinate, as the JAX tile computes them."""
    cam = tscenes.orbit_camera(37, 53, 0.0)
    ids = np.arange(37 * 53)
    got = tpipeline.pixel_coords(cam, torch.from_numpy(ids)).numpy()
    jcam = _jax_cam(cam)
    w_i = jcam.intrinsics[1].astype(jnp.int32)
    ids_j = jnp.asarray(ids, jnp.int32)
    ref = np.stack([np.asarray((ids_j % w_i).astype(jnp.float32)
                               / jcam.width),
                    np.asarray((ids_j // w_i).astype(jnp.float32)
                               / jcam.height)], -1)
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------- frames, engine
@pytest.mark.parametrize("app,log2_T,n_levels", [("gia", 14, 12),
                                                 ("nsdf", 14, 4)])
def test_render_frame_matches_jax(app, log2_T, n_levels):
    """A 10x14 frame in tiles of 64 pixels: the last tile carries masked
    pad lanes."""
    cj, ct = _cfgs(app, log2_T=log2_T, n_levels=n_levels)
    p = _np_params(ct, 5)
    cam = tscenes.orbit_camera(10, 14, 0.4)
    got = tpipeline.render_frame(tfields.from_jax_params(p, ct, "cpu"), ct,
                                 cam, tpipeline.RenderSettings(tile_pixels=64),
                                 device="cpu")
    ref = jpipeline.render_frame(_jax_tree(p), cj, _jax_cam(cam),
                                 jpipeline.RenderSettings(tile_pixels=64))
    assert got.shape == (10, 14, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("app,log2_T", [("gia", 10), ("nsdf", 13)])
def test_two_scene_engine_matches_jax_render_frame(app, log2_T):
    """Two scenes in one bucket, served through the port's engine; each
    frame equals the JAX Pallas route's render_frame of its scene (12x12
    in tiles of 64: the last tile is masked)."""
    cj, ct = _cfgs(app, log2_T=log2_T)
    params = [_np_params(ct, 10 + s) for s in range(2)]
    settings = tpipeline.RenderSettings(tile_pixels=64)
    engine = RenderEngine(settings, device="cpu")
    keys = {engine.add_scene(f"s{s}", ct,
                             tfields.from_jax_params(p, ct, "cpu"))
            for s, p in enumerate(params)}
    assert len(keys) == 1
    engine.warmup()
    jsettings = jpipeline.RenderSettings(tile_pixels=64, use_pallas=True)
    cam = tscenes.orbit_camera(12, 12, 0.3)
    frames = []
    for s in range(2):
        got = engine.render_frame(f"s{s}", cam)
        ref = jpipeline.render_frame(_jax_tree(params[s]), cj,
                                     _jax_cam(cam), jsettings)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)
        frames.append(got)
    assert np.abs(frames[0] - frames[1]).max() > 0
    # random pixels of both scenes through submit equal the frames' pixels
    ids = np.random.default_rng(1).integers(0, 144, 50)
    tickets = [engine.submit(RenderRequest(f"s{s}", cam, ids))
               for s in range(2)]
    engine.flush()
    for s, t in enumerate(tickets):
        np.testing.assert_allclose(t.result(), frames[s].reshape(-1, 3)[ids],
                                   atol=TOL)
