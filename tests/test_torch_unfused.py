"""repro_torch's unfused route (``apply_field(fused=False)``: the encode's
features through memory, then the MLP, one call per head) against the JAX
package's ``apply_field(fused=False)``, on the CPU.

Inputs are made with numpy from a seed (tables U(-1, 1), weights
normal / sqrt(fan_in)) and handed to both packages through
``from_jax_params``. Tolerance 1e-5 of the output's size (f32): the same
operations, rounded differently only where XLA contracts or reorders. On
the CPU the port's wrappers run their plain versions, so its fused and
unfused routes run the same operations and must agree bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fields as jfields
from repro.core import pipeline as jpipeline
from repro.core import render as jrender
from repro.core import train as jtrain
from repro.quant import QuantSpec as JQuantSpec
from repro.quant import api as japi
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import train as ttrain
from repro_torch.data import scenes as tscenes
from repro_torch.quant import QuantSpec
from repro_torch.serve import RenderEngine, RenderRequest
from tests.test_torch_grad import _t_batch, jax_start

TOL = 1e-5
LOG2_T = 14       # level 0 of the hash grids is dense, the finer hashed


def _cfgs(app, encoding):
    """Table I's config for ``app`` and ``encoding`` at 2^14 rows, in both
    packages."""
    cj = jfields.make_field_config(app, encoding)
    cj = cj.with_grid(dataclasses.replace(cj.grid, log2_table_size=LOG2_T))
    ct = tfields.make_field_config(app, encoding)
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=LOG2_T))
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


def _inputs(ct, seed, n=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, ct.grid.dim)).astype(np.float32)
    pts[0], pts[1] = 0.0, 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pts, d


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL * max(1.0, np.abs(
        ref).max()), rtol=0)


@pytest.mark.parametrize("encoding", ["hash", "dense", "tiled"])
@pytest.mark.parametrize("app", ["nerf", "nvr", "gia", "nsdf"])
def test_unfused_field_matches_jax(app, encoding):
    cj, ct = _cfgs(app, encoding)
    np_params = _np_params(ct, 1)
    pts, dirs = _inputs(ct, 2)
    dirs_j = dirs if app == "nerf" else None
    ref = jfields.apply_field(np_params, cj, jnp.asarray(pts),
                              None if dirs_j is None else jnp.asarray(dirs_j),
                              fused=False)
    tp = tfields.from_jax_params(np_params, ct, "cpu")
    dirs_t = None if dirs_j is None else torch.from_numpy(dirs)
    got = tfields.apply_field(tp, ct, torch.from_numpy(pts), dirs_t,
                              fused=False)
    _close(got, ref)
    fused = tfields.apply_field(tp, ct, torch.from_numpy(pts), dirs_t)
    assert torch.equal(got, fused)


@pytest.mark.parametrize("mlp_qtype", [None, "int8"])
@pytest.mark.parametrize("app", ["nerf", "nvr", "gia", "nsdf"])
def test_unfused_quantized_field_matches_jax(app, mlp_qtype):
    """int8 tables (and int8 MLP weights): the scales go into the encode,
    the weights are dequantized on entry to each head."""
    cj, ct = _cfgs(app, "hash")
    jspec = JQuantSpec("int8", mlp_qtype=mlp_qtype)
    qnp = {k: (np.asarray(v) if not isinstance(v, dict) else
               {kk: np.asarray(vv) for kk, vv in v.items()})
           for k, v in japi.quantize_field(_np_params(ct, 3), jspec).items()}
    cj, ct = cj.with_quant(jspec), ct.with_quant(
        QuantSpec("int8", mlp_qtype=mlp_qtype))
    pts, dirs = _inputs(ct, 4)
    nerf = app == "nerf"
    ref = jfields.apply_field(qnp, cj, jnp.asarray(pts),
                              jnp.asarray(dirs) if nerf else None,
                              fused=False)
    tp = tfields.from_jax_params(qnp, ct, "cpu")
    assert tp["grid"].dtype == torch.int8
    got = tfields.apply_field(tp, ct, torch.from_numpy(pts),
                              torch.from_numpy(dirs) if nerf else None,
                              fused=False)
    _close(got, ref)


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_unfused_loss_curves_match_jax_reference(app):
    """Six steps of ``train_field_reference(fused=False)`` on the JAX
    package's initial params and batches against the JAX reference loop
    on its unfused route: every logged loss within 1e-5 of its size."""
    batch_size = {"nerf": 48, "gia": 128, "nsdf": 128, "nvr": 48}[app]
    cj, ct, p0, batch = jax_start(app, batch_size)
    _, jh = jtrain.train_field_reference(cj, steps=6, batch_size=batch_size,
                                         seed=0, fused=False, log_every=1)
    _, th = ttrain.train_field_reference(
        ct, steps=6, log_every=1, fused=False, device="cpu",
        params=tfields.from_jax_params(p0, ct, "cpu"),
        batch_fn=lambda i: _t_batch(batch(i)))
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(6))
    for (_, a), (_, b) in zip(jh, th):
        assert abs(b - float(a)) <= TOL * abs(float(a))


@pytest.mark.parametrize("app", ["nerf", "gia"])
def test_unfused_engine_frame_matches_jax(app):
    """An engine with ``RenderSettings(fused=False)`` serves the frame the
    JAX package renders on its unfused route, and the fused engine's."""
    cj, ct = _cfgs(app, "tiled")
    np_params = _np_params(ct, 5)
    cam = tscenes.orbit_camera(8, 8, 0.7)
    jcam = jrender.Camera(height=8, width=8, focal=cam.focal,
                          c2w=jnp.asarray(cam.c2w))
    ref = jpipeline.render_frame(np_params, cj, jcam,
                                 jpipeline.RenderSettings(
                                     tile_pixels=32, n_samples=8,
                                     fused=False))
    frames = {}
    for fused in (True, False):
        engine = RenderEngine(tpipeline.RenderSettings(
            tile_pixels=32, n_samples=8, fused=fused), device="cpu")
        engine.add_scene("s", ct, tfields.from_jax_params(np_params, ct,
                                                          "cpu"))
        frames[fused] = engine.render_frame("s", cam)
        assert isinstance(engine.submit(RenderRequest(
            "s", cam, np.arange(5))).result(), np.ndarray)
    _close(frames[False], ref)
    assert np.array_equal(frames[False], frames[True])
