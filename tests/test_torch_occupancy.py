"""repro_torch's occupancy-culled sampling (``core/occupancy.py``, the
culled branch of ``render.render_rays``, the tile functions, the engine,
``train_field(occupancy_res=)``) against the JAX package's, on the CPU:
mirrors of every test in ``tests/test_occupancy.py`` but the mesh check
(``check_sample_budget``: ``tests/test_torch_sharding.py``), plus the two
packages side by side.

Bars: grids bit for bit on the same sigma (the port's int32 words are the
JAX package's uint32 bits); the EMA bit for bit on the same old and fresh
densities; with an all-occupied grid and the full budget the culled route
bit-identical to the dense one; the culled render within 1e-5 of JAX's
culled render on the same params and grid (the field's f32 rounding), the
same live and dropped counts; exact drop counts on overflow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fields as jfields
from repro.core import occupancy as jocc
from repro.core import pipeline as jpipeline
from repro.core import render as jrender
from repro.data import scenes as jscenes
from repro_torch.core import fields as tfields
from repro_torch.core import occupancy as occ
from repro_torch.core import pipeline, render
from repro_torch.core import train as ttrain
from repro_torch.data import scenes
from repro_torch.serve import RenderEngine
from tests.test_torch_grad import jax_start

TOL = 1e-5


def _oracle_sigma(p_unit):
    return scenes.volume_field(p_unit * 4.0 - 2.0)[:, 3]


def _analytic_apply(p_unit, d):
    return scenes.volume_field(p_unit * 4.0 - 2.0, d)


def _rays(h, w, n=None):
    cam = scenes.default_camera(h, w)
    return render.make_rays(cam, torch.arange(n or h * w))


def _jax_grid_as_port(g):
    return tfields._occupancy_from_numpy(
        {k: np.asarray(v) for k, v in g.items()}, torch.device("cpu"))


def _u32(bits):
    return bits.numpy().view(np.uint32)


def _field(app="nerf", seed=1):
    """(JAX config, port config, JAX params with U(-1, 1) tables (numpy),
    the port's same params)."""
    cj, ct, p0, _ = jax_start(app, 4)
    rng = np.random.default_rng(seed)
    p0 = {**p0, "grid": rng.uniform(-1, 1, p0["grid"].shape).astype(
        np.float32)}
    return cj, ct, p0, tfields.from_jax_params(p0, ct, "cpu")


# ------------------------------------------------------------- bit packing
def test_pack_bits_round_trip_and_jax_words():
    bools = np.random.default_rng(0).random(4 ** 3 * 8) > 0.5
    packed = occ.pack_bits(torch.from_numpy(bools))
    assert packed.dtype == torch.int32 and packed.shape == (16,)
    assert np.array_equal(occ.unpack_bits(packed).numpy(), bools)
    assert np.array_equal(_u32(packed),
                          np.asarray(jocc.pack_bits(jnp.asarray(bools))))
    ones = occ.pack_bits(torch.ones(64, dtype=torch.bool))
    assert _u32(ones).tolist() == [0xFFFFFFFF] * 2


def test_pack_bits_rejects_ragged():
    with pytest.raises(ValueError):
        occ.pack_bits(torch.zeros(33, dtype=torch.bool))
    with pytest.raises(ValueError):
        occ.all_occupied(res=6, device="cpu")


@pytest.mark.parametrize("res", [4, 8, 12])
def test_cell_index_and_centers_match_jax(res):
    pts = np.random.default_rng(res).random((500, 3)).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.999], [1e-7, 0.9999, 1]]
    assert np.array_equal(
        occ.cell_index(torch.from_numpy(pts), res).numpy(),
        np.asarray(jocc.cell_index(jnp.asarray(pts), res)))
    assert np.array_equal(occ.cell_centers(res).numpy(),
                          np.asarray(jocc.cell_centers(res)))


def test_query_matches_cell_lookup():
    res = 8
    rng = np.random.default_rng(1)
    occ_bool = rng.random(res ** 3) > 0.5
    g = {"bits": occ.pack_bits(torch.from_numpy(occ_bool)),
         "sigma": torch.arange(res ** 3, dtype=torch.float32)}
    pts = torch.from_numpy(rng.random((256, 3)).astype(np.float32))
    idx = occ.cell_index(pts, res).numpy()
    assert np.array_equal(occ.query(g, pts).numpy(), occ_bool[idx])
    assert np.array_equal(occ.query_sigma(g, pts).numpy(),
                          np.arange(res ** 3, dtype=np.float32)[idx])
    jg = {"bits": jnp.asarray(_u32(g["bits"])),
          "sigma": jnp.asarray(g["sigma"].numpy())}
    assert np.array_equal(occ.query(g, pts).numpy(),
                          np.asarray(jocc.query(jg, jnp.asarray(pts.numpy()))))


# ------------------------------------------------------------ build/update
def test_build_from_fn_thresholds_analytic_scene():
    g = occ.build_occupancy_from_fn(_oracle_sigma, res=32, threshold=0.01,
                                    device="cpu")
    frac = occ.occupied_fraction(g)
    assert 0.001 < frac < 0.25, frac
    assert np.array_equal(occ.unpack_bits(g["bits"]).numpy(),
                          g["sigma"].numpy() > 0.01)
    assert bool(occ.query(g, torch.tensor([[0.5, 0.5, 0.5]]))[0])
    # the JAX package's grid of the analytic scene: densities within 1e-5,
    # the same bits
    jg = jocc.build_occupancy_from_fn(
        lambda p: jscenes.volume_field(p * 4.0 - 2.0)[:, 3], res=32,
        threshold=0.01)
    np.testing.assert_allclose(g["sigma"].numpy(), np.asarray(jg["sigma"]),
                               rtol=TOL, atol=TOL)
    assert np.array_equal(_u32(g["bits"]), np.asarray(jg["bits"]))


@pytest.mark.parametrize("threshold", [0.01, 0.5, 3.0])
def test_grid_bits_match_jax_on_the_same_sigma(threshold):
    """The same density array in both packages: the same words, bit for
    bit."""
    sigma = np.random.default_rng(2).exponential(1.0, 16 ** 3).astype(
        np.float32)
    sigma[::7] = threshold                     # at the threshold: not >
    g = occ.build_occupancy_from_fn(
        lambda p: torch.from_numpy(sigma), res=16, threshold=threshold,
        device="cpu")
    jg = jocc.build_occupancy_from_fn(lambda p: jnp.asarray(sigma), res=16,
                                      threshold=threshold)
    assert np.array_equal(_u32(g["bits"]), np.asarray(jg["bits"]))
    assert np.array_equal(g["sigma"].numpy(), np.asarray(jg["sigma"]))


@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_build_occupancy_from_field_params(app):
    """The port's grid of a field (U(-1, 1) tables, so densities spread
    over the threshold) against the JAX package's: densities within 1e-5
    of their size, the same bits wherever the density is not within that
    of the threshold; and an untrained field (tables near 0) is all
    occupied, sigma ~ exp(0) = 1 >> 0.01."""
    cj, ct, p0, tp = _field(app)
    thr = 1.0
    g = occ.build_occupancy(tp, ct, res=8, threshold=thr)
    assert g["bits"].shape == (8 ** 3 // 32,) and g["sigma"].shape == (512,)
    jg = jocc.build_occupancy(jax.tree.map(jnp.asarray, p0), cj, res=8,
                              threshold=thr)
    js = np.asarray(jg["sigma"])
    np.testing.assert_allclose(g["sigma"].numpy(), js, rtol=TOL)
    far = np.abs(js - thr) > TOL * np.abs(js)
    assert 0.05 < float(np.mean(js > thr)) < 0.95
    bits, jbits = occ.unpack_bits(g["bits"]).numpy(), np.asarray(
        jocc.unpack_bits(jg["bits"]))
    assert np.array_equal(bits[far], jbits[far])
    _, ct0, q0, _ = jax_start(app, 4)
    g0 = occ.build_occupancy(tfields.from_jax_params(q0, ct0, "cpu"), ct0,
                             res=8, threshold=0.01)
    assert occ.occupied_fraction(g0) == 1.0


def test_update_occupancy_decays_stale_cells_off():
    """The EMA's max keeps recently dense cells, then decay fades them
    below the threshold once the field stops backing them."""
    _, ct, q0, _ = jax_start("nvr", 4)
    params = tfields.from_jax_params(q0, ct, "cpu")
    g = occ.build_occupancy(params, ct, res=8, threshold=10.0)
    assert occ.occupied_fraction(g) == 0.0
    g = {"bits": occ.pack_bits(torch.ones(512, dtype=torch.bool)),
         "sigma": torch.full_like(g["sigma"], 64.0)}
    fracs = []
    for _ in range(4):
        g = occ.update_occupancy(g, params, ct, decay=0.5, threshold=10.0)
        fracs.append(occ.occupied_fraction(g))
    assert fracs == [1.0, 1.0, 0.0, 0.0]


def test_update_occupancy_matches_jax_on_the_same_densities(monkeypatch):
    """The EMA of both packages on the same old grid and the same fresh
    densities (each package's field_sigma replaced by that array): the
    same sigma and words, bit for bit."""
    rng = np.random.default_rng(4)
    old_sigma = rng.exponential(1.0, 8 ** 3).astype(np.float32)
    fresh = rng.exponential(1.0, 8 ** 3).astype(np.float32)
    _, ct, _, tp = _field("nvr")
    cj = jax_start("nvr", 4)[0]
    monkeypatch.setattr(occ, "field_sigma",
                        lambda p, c, pts: torch.from_numpy(fresh))
    monkeypatch.setattr(jocc, "field_sigma",
                        lambda p, c, pts, **kw: jnp.asarray(fresh))
    g = occ.update_occupancy({"bits": occ.pack_bits(torch.from_numpy(
        old_sigma > 1.0)), "sigma": torch.from_numpy(old_sigma)}, tp, ct,
        decay=0.9, threshold=1.0)
    jg = jocc.update_occupancy.__wrapped__(
        {"bits": jocc.pack_bits(jnp.asarray(old_sigma > 1.0)),
         "sigma": jnp.asarray(old_sigma)}, None, cj, decay=0.9,
        threshold=1.0)
    assert np.array_equal(g["sigma"].numpy(), np.asarray(jg["sigma"]))
    assert np.array_equal(_u32(g["bits"]), np.asarray(jg["bits"]))


def test_update_occupancy_against_field():
    """update_occupancy == max(decay * old, build) at the same params."""
    _, ct, _, tp = _field("nvr")
    built = occ.build_occupancy(tp, ct, res=8, threshold=0.01)
    old = {"bits": built["bits"], "sigma": torch.full_like(built["sigma"],
                                                           7.0)}
    upd = occ.update_occupancy(old, tp, ct, decay=0.5, threshold=0.01)
    assert torch.equal(upd["sigma"], torch.maximum(
        torch.full_like(built["sigma"], 3.5), built["sigma"]))
    assert torch.equal(occ.unpack_bits(upd["bits"]), upd["sigma"] > 0.01)


# -------------------------------------------------------- culling-off parity
@pytest.mark.parametrize("app", ["nerf", "nvr"])
@pytest.mark.parametrize("tile", [64, 48])
def test_culling_off_is_bit_identical(app, tile):
    """All-occupied grid + full budget: the culled tile equals the dense
    tile bit for bit (a permutation of per-point math), and the aux row
    says all live."""
    _, ct, _, tp = _field(app)
    cam = scenes.default_camera(8, 8)
    ids = torch.arange(tile)
    s = 8
    dense = pipeline.RenderSettings(tile_pixels=tile, n_samples=s)
    rgb_dense = pipeline.make_tile_fn(ct, dense)(tp, cam, ids)
    culled = dataclasses.replace(dense, occupancy=True)
    rgb, row = pipeline.make_tile_fn(ct, culled, with_aux=True)(
        occ.attach(tp, occ.all_occupied(8, "cpu")), cam, ids)
    assert torch.equal(rgb, rgb_dense)
    assert row.tolist() == [[tile * s, tile * s, 0.0]]
    rgb_d, row_d = pipeline.make_tile_fn(ct, dense, with_aux=True)(
        tp, cam, ids, n_valid=10)
    assert torch.equal(rgb_d, rgb_dense)
    assert row_d.tolist() == [[10 * s, 10 * s, 0.0]]


def test_render_rays_dense_path_untouched_without_occupancy():
    calls = []

    def fapply(p, d):
        calls.append(tuple(p.shape))
        return _analytic_apply(p, d)
    o, d = _rays(4, 4)
    _, aux = render.render_rays(fapply, o, d, n_samples=4, return_aux=True)
    assert calls == [(64, 3)]
    assert int(aux["n_live"]) == 64 and int(aux["n_dropped"]) == 0


# ------------------------------------------------------------- overflow path
def test_budget_overflow_degrades_gracefully():
    """Everything live, budget B: exactly the B nearest samples (per depth,
    all rays) are evaluated, n_dropped reports the rest, and the pixels
    equal a dense march whose far half is transparent (1e-6)."""
    o, d = _rays(4, 4)
    r, s = 16, 8
    g = occ.all_occupied(res=4, device="cpu")
    seen = []

    def fapply(p, dd):
        seen.append(tuple(p.shape))
        return _analytic_apply(p, dd)
    budget = r * s // 2
    pix, aux = render.render_rays(fapply, o, d, n_samples=s, occupancy=g,
                                  sample_budget=budget, return_aux=True)
    assert seen == [(budget, 3)]
    assert int(aux["n_live"]) == r * s
    assert int(aux["n_dropped"]) == r * s - budget
    assert aux["n_budget"] == budget
    assert aux["dropped_per_ray"].tolist() == [s // 2] * r
    assert bool(torch.isfinite(pix).all())
    pts, dts = render.sample_along_rays(o, d, 0.5, 4.5, s)
    flat = render.normalize_to_unit(pts.reshape(-1, 3))
    full = _analytic_apply(flat, torch.repeat_interleave(d, s, 0)).reshape(
        r, s, 4)
    sigma = full[..., 3].clone()
    sigma[:, s // 2:] = 0.0
    ref, _ = render.composite(full[..., :3], sigma, dts.expand(r, s))
    np.testing.assert_allclose(pix.numpy(), ref.numpy(), atol=1e-6)


def test_budget_clamps_to_total():
    o, d = _rays(4, 4)
    g = occ.all_occupied(res=4, device="cpu")
    a = render.render_rays(_analytic_apply, o, d, n_samples=4, occupancy=g,
                           sample_budget=10 ** 9)
    b = render.render_rays(_analytic_apply, o, d, n_samples=4)
    assert torch.equal(a, b)


# ------------------------------------------------------------ quality parity
def test_quarter_budget_oracle_occupancy_close_to_dense():
    """Analytic field, oracle grid, budget R*S/4: the culled frame within
    40 dB of the dense one, fewer than a quarter of the samples live."""
    g = occ.build_occupancy_from_fn(_oracle_sigma, res=32, threshold=0.01,
                                    device="cpu")
    o, d = _rays(32, 32)
    s = 16
    dense = render.render_rays(_analytic_apply, o, d, n_samples=s)
    culled, aux = render.render_rays(_analytic_apply, o, d, n_samples=s,
                                     occupancy=g,
                                     sample_budget=1024 * s // 4,
                                     return_aux=True)
    assert float(aux["n_live"]) / (1024 * s) < 0.25
    assert int(aux["n_dropped"]) == 0
    mse = float(torch.mean((dense - culled) ** 2))
    assert ttrain.psnr(mse) >= 40.0


@pytest.mark.parametrize("budget_div,eps", [(1, 1e-3), (4, 1e-3), (16, 1e-3),
                                            (4, 0.5)])
def test_culled_render_matches_jax(budget_div, eps):
    """The same nerf params, rays and JAX grid (oracle densities) through
    both packages' culled render_rays: pixels within 1e-5, the same live
    and dropped counts (a quarter and a sixteenth budget overflow)."""
    cj, ct, p0, tp = _field("nerf")
    jg = jocc.build_occupancy_from_fn(
        lambda p: jscenes.volume_field(p * 4.0 - 2.0)[:, 3], res=16,
        threshold=0.01)
    cam = jscenes.default_camera(16, 16)
    o, d = jrender.make_rays(cam, jnp.arange(256, dtype=jnp.int32))
    s, budget = 16, 256 * 16 // budget_div
    pj, auxj = jrender.render_rays(
        lambda p, dd: jfields.apply_field(p0, cj, p, dd), o, d, n_samples=s,
        occupancy=jg, sample_budget=budget, early_term_eps=eps,
        return_aux=True)
    pt, auxt = render.render_rays(
        lambda p, dd: tfields.apply_field(tp, ct, p, dd),
        torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
        n_samples=s, occupancy=_jax_grid_as_port(jg), sample_budget=budget,
        early_term_eps=eps, return_aux=True)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=TOL,
                               atol=TOL)
    assert int(auxt["n_live"]) == int(auxj["n_live"])
    assert int(auxt["n_dropped"]) == int(auxj["n_dropped"])
    assert auxt["n_budget"] == auxj["n_budget"]


# --------------------------------------------------------------- plumbing
def test_tile_fn_requires_occupancy_leaf():
    _, ct, _, tp = _field("nerf")
    settings = pipeline.RenderSettings(tile_pixels=16, n_samples=4,
                                       occupancy=True)
    with pytest.raises(ValueError, match="occupancy"):
        pipeline.make_tile_fn(ct, settings)(tp, scenes.default_camera(4, 4),
                                            torch.arange(16))


@pytest.mark.parametrize("kw,n", [
    (dict(tile_pixels=4096, n_samples=32, occupancy=True,
          sample_budget=32768), 4096),
    (dict(tile_pixels=4096, n_samples=32, occupancy=True,
          sample_budget=32768), 1024),
    (dict(tile_pixels=4096, n_samples=32, occupancy=True,
          sample_budget=32768), 1),
    (dict(tile_pixels=4096, n_samples=32), 4096),
    (dict(tile_pixels=64, n_samples=8, occupancy=True), 64)])
def test_tile_budget_matches_jax(kw, n):
    assert pipeline.RenderSettings(**kw).tile_budget(n) == \
        jpipeline.RenderSettings(**kw).tile_budget(n)


def test_engine_culled_serving_stats_and_parity():
    """Scenes must carry the grid; distinct budgets get distinct buckets;
    culling-off serving equals the dense engine bit for bit; stats() gives
    the live fraction and counts samples of valid pixels only."""
    _, ct, _, tp = _field("nvr")
    dense_set = pipeline.RenderSettings(tile_pixels=32, n_samples=4)
    cull_set = dataclasses.replace(dense_set, occupancy=True)
    eng_c = RenderEngine(cull_set, device="cpu")
    with pytest.raises(ValueError, match="occupancy"):
        eng_c.add_scene("bare", ct, tp)
    p_occ = occ.attach(tp, occ.all_occupied(8, "cpu"))
    k1 = eng_c.add_scene("s0", ct, p_occ)
    assert k1.occupancy and k1.sample_budget is None
    eng_c.warmup()
    cam = scenes.default_camera(8, 8)
    got = eng_c.render_frame("s0", cam)
    eng_d = RenderEngine(dense_set, device="cpu")
    eng_d.add_scene("s0", ct, tp)
    eng_d.warmup()
    assert np.array_equal(got, eng_d.render_frame("s0", cam))
    st = eng_c.stats()
    assert st["live_sample_frac"] == 1.0
    assert st["samples_dropped"] == 0.0
    assert st["samples_total"] == 8 * 8 * 4
    assert any("/occ-bgt" in k for k in st["buckets"])
    assert st["effective_mpix_per_s"] == st["mpix_per_s"]
    k2 = RenderEngine(dataclasses.replace(cull_set, sample_budget=64),
                      device="cpu").add_scene("s0", ct, p_occ)
    assert k1 != k2
    # a partial request: its pad lanes' samples do not count
    eng_c.render_frame("s0", scenes.default_camera(5, 7))
    assert eng_c.stats()["samples_total"] == (64 + 35) * 4


def test_engine_reports_live_and_dropped_samples():
    """An oracle grid at a small budget: the engine's live and dropped
    counts equal render_rays' on the same rays."""
    g = occ.build_occupancy_from_fn(_oracle_sigma, res=16, threshold=0.01,
                                    device="cpu")
    _, ct, _, tp = _field("nerf")
    settings = pipeline.RenderSettings(tile_pixels=64, n_samples=16,
                                       occupancy=True, sample_budget=8)
    eng = RenderEngine(settings, device="cpu")
    eng.add_scene("s", ct, occ.attach(tp, g))
    cam = scenes.default_camera(8, 8)
    eng.render_frame("s", cam)
    st = eng.stats()
    o, d = render.make_rays(cam, torch.arange(64))
    _, aux = render.render_rays(
        lambda p, dd: tfields.apply_field(tp, ct, p, dd), o, d,
        n_samples=16, occupancy=g, sample_budget=8, return_aux=True)
    assert st["samples_total"] == 64 * 16
    assert st["live_sample_frac"] == int(aux["n_live"]) / (64 * 16)
    assert st["samples_dropped"] == int(aux["n_dropped"]) > 0
    assert any(k.endswith("occ-bgt8#0") for k in st["buckets"])


def test_render_frame_tail_padding_masked_not_wrapped():
    """A culled frame whose pixel count is not a tile multiple equals the
    per-tile evaluation on the valid ids (pad lanes: pixel 0, zeroed)."""
    _, ct, _, tp = _field("nerf")
    p_occ = occ.attach(tp, occ.build_occupancy(tp, ct, res=8, threshold=1.0))
    cam = scenes.default_camera(5, 7)
    settings = pipeline.RenderSettings(tile_pixels=16, n_samples=8,
                                       occupancy=True, sample_budget=64)
    img = pipeline.render_frame(p_occ, ct, cam, settings, device="cpu")
    assert img.shape == (5, 7, 3)
    tile = pipeline.make_tile_fn(ct, settings)
    ref = []
    for start in range(0, 48, 16):
        ids = np.arange(start, start + 16)
        ids = np.where(ids < 35, ids, 0)
        ref.append(tile(p_occ, cam, torch.from_numpy(ids)).numpy())
    ref = np.concatenate(ref)[:35].reshape(5, 7, 3)
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-6)


def test_from_jax_params_of_an_attached_grid():
    """A JAX scene with an attached grid comes to the port with its words
    bit for bit, and both packages' culled tiles agree to 1e-5."""
    cj, ct, p0, _ = _field("nerf")
    jg = jocc.build_occupancy(jax.tree.map(jnp.asarray, p0), cj, res=8,
                              threshold=1.0)
    jp = jax.tree.map(np.asarray, jocc.attach(p0, jg))
    tp = tfields.from_jax_params(jp, ct, "cpu")
    assert tp["occupancy"]["bits"].dtype == torch.int32
    assert np.array_equal(_u32(tp["occupancy"]["bits"]), jp["occupancy"][
        "bits"])
    assert np.array_equal(tp["occupancy"]["sigma"].numpy(),
                          jp["occupancy"]["sigma"])
    settings = dict(tile_pixels=64, n_samples=8, occupancy=True,
                    sample_budget=128)
    cam = jscenes.default_camera(8, 8)
    jrgb = jpipeline.make_tile_fn(cj, jpipeline.RenderSettings(**settings))(
        jax.tree.map(jnp.asarray, jp), cam, jnp.arange(64, dtype=jnp.int32))
    trgb = pipeline.make_tile_fn(ct, pipeline.RenderSettings(**settings))(
        tp, scenes.default_camera(8, 8), torch.arange(64))
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=TOL,
                               atol=TOL)
    bad = {**jp, "occupancy": {"bits": jp["occupancy"]["bits"][:3],
                               "sigma": jp["occupancy"]["sigma"]}}
    with pytest.raises(ValueError, match="occupancy"):
        tfields.from_jax_params(bad, ct, "cpu")


# ---------------------------------------------------------------- training
def test_train_field_keeps_an_occupancy_grid():
    """train_field(occupancy_res=) builds the grid at the first chunk end
    and EMA-refreshes it at every chunk end after, from that chunk's
    params; the grid comes back attached and outside the optimizer."""
    _, ct, _, _ = jax_start("nerf", 4)
    snaps = {}

    def on_metrics(i, row, st):
        if i in (1, 3, 5):
            snaps[i] = {k: (v.clone() if torch.is_tensor(v) else
                            {kk: vv.clone() for kk, vv in v.items()})
                        for k, v in st["params"].items()}
    params, _ = ttrain.train_field(
        ct, steps=6, batch_size=16, chunk_steps=2, device="cpu",
        occupancy_res=8, occupancy_threshold=0.5, occupancy_decay=0.9,
        on_metrics=on_metrics)
    g = occ.build_occupancy(snaps[1], ct, res=8, threshold=0.5)
    for i in (3, 5):
        g = occ.update_occupancy(g, snaps[i], ct, decay=0.9, threshold=0.5)
    assert set(params) == {"grid", "mlp", "density_mlp", "occupancy"}
    assert torch.equal(params["occupancy"]["sigma"], g["sigma"])
    assert torch.equal(params["occupancy"]["bits"], g["bits"])


def test_train_field_refreshes_every_nth_chunk():
    _, ct, _, _ = jax_start("nvr", 4)
    snaps = {}
    params, _ = ttrain.train_field(
        ct, steps=8, batch_size=8, chunk_steps=2, device="cpu",
        occupancy_res=4, occupancy_every=2,
        on_metrics=lambda i, r, st: snaps.__setitem__(i, {
            k: (v.clone() if torch.is_tensor(v) else
                {kk: vv.clone() for kk, vv in v.items()})
            for k, v in st["params"].items()}))
    g = occ.build_occupancy(snaps[1], ct, res=4)
    for i in (3, 7):                  # chunk ends 2 and 4
        g = occ.update_occupancy(g, snaps[i], ct)
    assert torch.equal(params["occupancy"]["sigma"], g["sigma"])
