"""repro_torch fields and rendering against the JAX package.

Parameters are made with numpy from a seed (tables U(-1, 1), weights
normal/sqrt(fan_in)) and handed to both packages; ``from_jax_params``
carries them into the port. The JAX side runs its Pallas route in
interpret mode (``use_pallas=True``) or its XLA route; the port runs its
kernel wrappers, which run their plain versions on CPU tensors.

Tolerance 1e-5 (f32): the two packages run the same operations, rounded
differently only where XLA contracts a multiply-add or orders a sum
otherwise. The grid levels here reach resolution 55, so a last-bit
difference in a sample point moves a feature by far less than that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.param import unbox
from repro.core import fields as jfields
from repro.core import render as jrender
from repro.data import scenes as jscenes
from repro_torch.core import fields as tfields
from repro_torch.core import render as trender
from repro_torch.data import scenes as tscenes
from tests.conftest import small_field_config

TOL = 1e-5


def _cfgs(app, encoding="hash", log2_T=12, n_levels=4):
    cj = small_field_config(app, encoding, log2_T=log2_T, n_levels=n_levels)
    ct = tfields.make_field_config(app, encoding)
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


def _jax_tree(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _jax_cam(tcam):
    return jrender.Camera(height=tcam.height, width=tcam.width,
                          focal=tcam.focal, c2w=jnp.asarray(tcam.c2w))


# ----------------------------------------------------------------- fields
@pytest.mark.parametrize("app,encoding", [("nerf", "hash"), ("nvr", "hash"),
                                          ("nerf", "dense"),
                                          ("nvr", "tiled")])
def test_apply_field_matches_jax_pallas_route(app, encoding):
    cj, ct = _cfgs(app, encoding)
    p = _np_params(ct, 1)
    rng = np.random.default_rng(2)
    pts = rng.uniform(size=(200, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jfields.apply_field(_jax_tree(p), cj, jnp.asarray(pts),
                              jnp.asarray(dirs), use_pallas=True)
    got = tfields.apply_field(tfields.from_jax_params(p, ct, "cpu"), ct,
                              torch.from_numpy(pts), torch.from_numpy(dirs))
    assert got.shape == (200, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("app", ["nerf", "nvr", "gia", "nsdf"])
def test_apply_field_matches_jax_xla_route(app):
    cj, ct = _cfgs(app)
    p = _np_params(ct, 3)
    rng = np.random.default_rng(4)
    pts = rng.uniform(size=(150, ct.grid.dim)).astype(np.float32)
    dirs = rng.normal(size=(150, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = jfields.apply_field(_jax_tree(p), cj, jnp.asarray(pts),
                              jnp.asarray(dirs))
    got = tfields.apply_field(tfields.from_jax_params(p, ct, "cpu"), ct,
                              torch.from_numpy(pts), torch.from_numpy(dirs))
    assert got.shape == (150, ct.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_from_jax_params_takes_jax_init_field():
    cj, ct = _cfgs("nerf")
    jp, _ = unbox(jfields.init_field(jax.random.PRNGKey(0), cj))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = tfields.from_jax_params(np_tree, ct, "cpu")
    np.testing.assert_array_equal(tp["grid"].numpy(), np_tree["grid"])
    np.testing.assert_array_equal(tp["density_mlp"]["w_hidden"].numpy(),
                                  np_tree["density_mlp"]["w_hidden"])
    bad = dict(np_tree, grid=np_tree["grid"][:2])
    with pytest.raises(ValueError, match="grid"):
        tfields.from_jax_params(bad, ct, "cpu")


@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_from_jax_params_keeps_bf16_leaves(app):
    """A JAX tree with a bf16 grid and bf16 weights comes across as bf16,
    bit for bit (torch.from_numpy refuses ml_dtypes' bfloat16), and its
    field equals the JAX XLA route's within 1e-5."""
    cj, ct = _cfgs(app)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.bfloat16),
                         _np_params(ct, 5))
    np_tree = jax.tree.map(np.asarray, jtree)
    tp = tfields.from_jax_params(np_tree, ct, "cpu")

    def check(t_tree, n_tree, path):
        for k, v in n_tree.items():
            if isinstance(v, dict):
                check(t_tree[k], v, f"{path}/{k}")
                continue
            assert t_tree[k].dtype == torch.bfloat16, f"{path}/{k}"
            np.testing.assert_array_equal(
                t_tree[k].view(torch.int16).numpy(), v.view(np.int16),
                err_msg=f"{path}/{k}")
    check(tp, np_tree, "params")
    rng = np.random.default_rng(6)
    pts = rng.uniform(size=(120, 3)).astype(np.float32)
    dirs = rng.normal(size=(120, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jfields.apply_field(jtree, cj, jnp.asarray(pts), jnp.asarray(dirs))
    got = tfields.apply_field(tp, ct, torch.from_numpy(pts),
                              torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_init_field_distributions():
    _, ct = _cfgs("nerf", log2_T=12)
    p = tfields.init_field(ct, torch.Generator().manual_seed(0),
                           device="cpu")
    shapes = tfields.param_shapes(ct)
    assert tuple(p["grid"].shape) == shapes["grid"]
    assert float(p["grid"].abs().max()) <= 1e-4
    assert float(p["grid"].std()) == pytest.approx(1e-4 / np.sqrt(3),
                                                   rel=0.05)
    w = p["density_mlp"]["w_hidden"]
    assert tuple(w.shape) == shapes["density_mlp"]["w_hidden"]
    assert float(w.std()) == pytest.approx(1 / 8, rel=0.05)   # 1/sqrt(64)
    again = tfields.init_field(ct, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["mlp"]["w_in"], p["mlp"]["w_in"])


# ------------------------------------------------------------------ rays
def test_look_at_and_cameras_match_jax():
    for tcam, jcam in ((tscenes.default_camera(8, 12),
                        jscenes.default_camera(8, 12)),
                       (tscenes.orbit_camera(16, 16, 2.1),
                        jscenes.orbit_camera(16, 16, 2.1))):
        np.testing.assert_allclose(tcam.c2w, np.asarray(jcam.c2w), atol=1e-6)
        assert tcam.resolution == jcam.resolution
        assert np.float32(tcam.focal) == float(jcam.focal)


def test_make_rays_matches_jax():
    tcam = tscenes.orbit_camera(12, 20, 0.4)
    ids = np.arange(12 * 20, dtype=np.int32)
    o_j, d_j = jrender.make_rays(_jax_cam(tcam), jnp.asarray(ids))
    o_t, d_t = trender.make_rays(tcam, torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


def test_sample_along_rays_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(30, 3)).astype(np.float32)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    p_j, dt_j = jrender.sample_along_rays(jnp.asarray(o), jnp.asarray(d),
                                          0.5, 4.5, 32)
    p_t, dt_t = trender.sample_along_rays(torch.from_numpy(o),
                                          torch.from_numpy(d), 0.5, 4.5, 32)
    # the same linspace formula: the sample depths agree bit for bit
    np.testing.assert_array_equal(dt_t.numpy(), np.asarray(dt_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    assert dt_t.shape == (1, 32)              # one row, broadcast later
    u = rng.uniform(size=(30, 32)).astype(np.float32)
    p_u, _ = trender.sample_along_rays(torch.from_numpy(o),
                                       torch.from_numpy(d), 0.5, 4.5, 32,
                                       u=torch.from_numpy(u))
    t = np.linspace(0.5, 4.5, 33, dtype=np.float32)
    ts = t[:-1] + (t[1:] - t[:-1]) * u
    np.testing.assert_allclose(p_u.numpy(), o[:, None] + ts[..., None]
                               * d[:, None], atol=1e-5)


def test_composite_matches_jax():
    rng = np.random.default_rng(6)
    rgb = rng.uniform(size=(50, 16, 3)).astype(np.float32)
    sigma = rng.exponential(2.0, size=(50, 16)).astype(np.float32)
    dts = np.full((50, 16), 0.125, np.float32)
    pj, oj = jrender.composite(jnp.asarray(rgb), jnp.asarray(sigma),
                               jnp.asarray(dts))
    pt, ot = trender.composite(torch.from_numpy(rgb),
                               torch.from_numpy(sigma), torch.from_numpy(dts))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL)


@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_render_rays_dense_matches_jax(app):
    cj, ct = _cfgs(app)
    p = _np_params(ct, 7)
    jp, tp = _jax_tree(p), tfields.from_jax_params(p, ct, "cpu")
    tcam = tscenes.orbit_camera(16, 16, 1.3)
    ids = np.random.default_rng(8).integers(0, 256, 40).astype(np.int32)
    o_j, d_j = jrender.make_rays(_jax_cam(tcam), jnp.asarray(ids))
    ref = jrender.render_rays(
        lambda q, d: jfields.apply_field(jp, cj, q, d, use_pallas=True),
        o_j, d_j, n_samples=8, use_pallas_composite=True)
    o_t, d_t = trender.make_rays(tcam, torch.from_numpy(ids.astype(np.int64)))
    got = trender.render_rays(
        lambda q, d: tfields.apply_field(tp, ct, q, d),
        o_t, d_t, n_samples=8)
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
