"""Each CUDA kernel of repro_torch against its plain PyTorch version, on
the card. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed; tables are U(-1, 1) so that a
wrong row, corner or level shows. Tolerance 1e-4 (f32): the MLP kernels
take their products on the tensor cores in 3xTF32 (near, not at, f32
rounding) and sum in another order than the plain version's matmul, and
the exp heads magnify the difference. Row counts straddle the kernels'
16-row warp tiles and 128-point field tiles, and reach past one round of
the persistent grid (132 blocks on an H100), so its loop wraps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as tkernels
from repro_torch.core import encoding as tenc
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import fields, occupancy, pipeline, render
from repro_torch.core import train as ttrain
from repro_torch.core.mlp import MLPConfig, apply_mlp
from repro_torch.data import scenes
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.kernels.fused_field.ref import field_ref
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.hashgrid import ops as hops
from repro_torch.kernels.hashgrid import vjp as hvjp
from repro_torch.kernels.hashgrid.ref import encode_ref
from repro_torch.kernels.ray_march import ops as rm_ops
from repro_torch.kernels.ray_march import ray_march as rm_ray_march
from repro_torch.quant import QuantSpec, quantize_field
from repro_torch.quant.calibrate import table_scales
from repro_torch.quant.qtypes import quantize
from repro_torch.serve import RenderEngine
from repro_torch.train import compression
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim

TOL = 1e-4
# The encode backward against its twin (index_add_) on the card: both sum
# each table row's terms in f32, the kernel with atomics in an order that
# changes from run to run, so they differ by f32 rounding of sums of up to
# a few hundred terms: max error at most this share of the leaf's max abs.
GRAD_TOL = 1e-5


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mlp_params(cfg, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    shapes = fields._mlp_shapes(cfg)
    return {k: torch.from_numpy((rng.normal(size=s) / np.sqrt(s[-2])
                                 ).astype(np.float32)).to(device, dtype)
            for k, s in shapes.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n,dim,n_features,log2_T", [
    (1, 3, 2, 14), (127, 3, 2, 14), (128, 3, 2, 14), (129, 3, 2, 14),
    (300, 3, 2, 14), (4099, 3, 2, 19), (500, 3, 2, 12), (257, 3, 8, 12),
    (20000, 3, 2, 14)])
def test_field_kernel_matches_plain(dev, n, dim, n_features, log2_T):
    g = dataclasses.replace(tenc.hashgrid_config(dim=dim),
                            log2_table_size=log2_T, n_levels=4,
                            n_features=n_features)
    m = MLPConfig(in_dim=g.out_dim, n_hidden=3, out_dim=16)
    rng = np.random.default_rng(n)
    tables = torch.from_numpy(rng.uniform(
        -1, 1, (g.n_levels, g.table_size, n_features)).astype(
            np.float32)).to(dev)
    pts = rng.uniform(size=(n, dim)).astype(np.float32)
    pts[:1] = 1.0                                        # edge coordinate
    pts = torch.from_numpy(pts).to(dev)
    w = _mlp_params(m, n + 1, dev)
    before = tkernels.launch_counts()["field_fwd"]
    got = ff_ops.field(pts, tables, w, g, m)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["field_fwd"] == before + 1
    torch.testing.assert_close(got, field_ref(pts, tables, w, g, m),
                               atol=TOL, rtol=TOL)


def _grid_inputs(dev, n, n_features, log2_T, qtype, seed):
    """A 4-level hash grid, U(-1, 1) tables (quantized in the port when
    ``qtype`` is given), and n points with an edge coordinate."""
    g = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=log2_T,
                            n_levels=4, n_features=n_features)
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.uniform(
        -1, 1, (g.n_levels, g.table_size, n_features)).astype(
            np.float32)).to(dev)
    scales = None
    if qtype is not None:
        scales = table_scales(tables, QuantSpec(qtype))
        tables = quantize(tables, scales, qtype)
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pts[:1] = 1.0                                        # edge coordinate
    return g, tables, scales, torch.from_numpy(pts).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", [None, "int8", "fp8_e4m3", "bf16"])
@pytest.mark.parametrize("n,n_features,log2_T", [(1, 2, 14), (4099, 2, 19),
                                                 (257, 8, 12)])
def test_encode_kernel_matches_plain(dev, qtype, n, n_features, log2_T):
    g, tables, scales, pts = _grid_inputs(
        dev, n, n_features, log2_T, None if qtype == "bf16" else qtype, n)
    if qtype == "bf16":
        tables = tables.to(torch.bfloat16)
    before = tkernels.launch_counts()["encode_fwd"]
    got = hops.encode(pts, tables, g, table_scales=scales)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["encode_fwd"] == before + 1
    torch.testing.assert_close(got, encode_ref(pts, tables, g, scales),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("n,n_features,log2_T", [(300, 2, 14), (4099, 2, 19),
                                                 (257, 8, 12)])
def test_quantized_field_kernel_matches_plain(dev, qtype, n, n_features,
                                              log2_T):
    g, tables, scales, pts = _grid_inputs(dev, n, n_features, log2_T, qtype,
                                          n + 7)
    m = MLPConfig(in_dim=g.out_dim, n_hidden=3, out_dim=16)
    w = _mlp_params(m, n + 1, dev)
    before = tkernels.launch_counts()
    got = ff_ops.field(pts, tables, w, g, m, table_scales=scales)
    torch.cuda.synchronize()
    after = tkernels.launch_counts()
    assert after["field_fwd_q"] == before["field_fwd_q"] + 1
    assert after["field_fwd"] == before["field_fwd"]
    torch.testing.assert_close(got, field_ref(pts, tables, w, g, m, scales),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 127, 129, 4099, 40000])
@pytest.mark.parametrize("in_dim,hidden,n_hidden,out_dim", [
    (32, 64, 4, 3), (16, 64, 1, 4), (8, 64, 2, 1), (32, 64, 3, 16),
    (32, 32, 2, 3), (16, 128, 1, 4), (13, 24, 2, 5)])
def test_mlp_kernel_matches_plain(dev, in_dim, hidden, n_hidden, out_dim, n):
    """Widths the kernel pads (in 13, hidden 24 and 32 to 64, out to 8) and
    its 128-wide instantiation, at row counts around its 16-row tiles."""
    m = MLPConfig(in_dim=in_dim, hidden_dim=hidden, n_hidden=n_hidden,
                  out_dim=out_dim)
    w = _mlp_params(m, 9, dev)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(n, in_dim)).astype(np.float32)).to(dev)
    before = tkernels.launch_counts()["mlp_fwd"]
    got = mlp_ops.mlp(w, x, m)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["mlp_fwd"] == before + 1
    torch.testing.assert_close(got, apply_mlp(w, x, m), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim", [32, 13])
def test_mlp_kernel_rows_off_an_8_byte_boundary(dev, in_dim):
    """x a contiguous view 4 bytes into its storage: refused before the
    launch at an even width, whose rows the kernel reads two floats at a
    time, and run at an odd one; the card goes on working after either."""
    m = MLPConfig(in_dim=in_dim, n_hidden=2, out_dim=3)
    w = _mlp_params(m, 6, dev)
    buf = torch.from_numpy(np.random.default_rng(7).normal(
        size=300 * in_dim + 1).astype(np.float32)).to(dev)
    x = buf[1:].view(300, in_dim)
    before = tkernels.launch_counts()["mlp_fwd"]
    if in_dim % 2 == 0:
        with pytest.raises(ValueError, match="aligned"):
            mlp_ops.mlp(w, x, m)
        assert tkernels.launch_counts()["mlp_fwd"] == before
        x = x.clone()
    got = mlp_ops.mlp(w, x, m)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["mlp_fwd"] == before + 1
    torch.testing.assert_close(got, apply_mlp(w, x, m), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dim,n_hidden,out_dim", [(32, 4, 3), (16, 3, 16)])
def test_mlp_kernel_bf16_weights_match_plain(dev, in_dim, n_hidden, out_dim):
    """bf16 weights are widened exactly as they are staged."""
    m = MLPConfig(in_dim=in_dim, n_hidden=n_hidden, out_dim=out_dim)
    w = _mlp_params(m, 4, dev, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4099, in_dim)).astype(np.float32)).to(dev)
    before = tkernels.launch_counts()["mlp_fwd"]
    got = mlp_ops.mlp(w, x, m)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["mlp_fwd"] == before + 1
    torch.testing.assert_close(got, apply_mlp(w, x, m), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_features,hidden,n_hidden,out_dim,w_dtype", [
    (1, 2, 64, 3, 16, torch.bfloat16), (129, 2, 64, 3, 16, torch.float32),
    (4099, 2, 64, 3, 16, torch.bfloat16), (20000, 2, 32, 1, 1, torch.float32),
    (257, 8, 64, 2, 4, torch.bfloat16)])
def test_bf16_field_kernel_matches_plain(dev, n, n_features, hidden, n_hidden,
                                         out_dim, w_dtype):
    """bf16 tables (field_fwd, no scales), with f32 or bf16 weights."""
    g, tables, _, pts = _grid_inputs(dev, n, n_features, 14, None, n + 3)
    tables = tables.to(torch.bfloat16)
    m = MLPConfig(in_dim=g.out_dim, hidden_dim=hidden, n_hidden=n_hidden,
                  out_dim=out_dim)
    w = _mlp_params(m, n + 1, dev, w_dtype)
    before = tkernels.launch_counts()
    got = ff_ops.field(pts, tables, w, g, m)
    torch.cuda.synchronize()
    after = tkernels.launch_counts()
    assert after["field_fwd"] == before["field_fwd"] + 1
    assert after["field_fwd_q"] == before["field_fwd_q"]
    torch.testing.assert_close(got, field_ref(pts, tables, w, g, m),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
def test_composite_kernel_matches_plain(dev, broadcast):
    r, s = 333, 32
    rng = np.random.default_rng(0)
    packed = torch.from_numpy(np.concatenate([
        rng.uniform(size=(r, s, 3)),
        rng.exponential(3.0, size=(r, s, 1))], -1).astype(np.float32)).to(dev)
    dts = torch.from_numpy(rng.uniform(0.01, 0.2, (1 if broadcast else r, s)
                                       ).astype(np.float32)).to(dev)
    pix, opac = rm_ops.composite(packed[..., :3], packed[..., 3], dts)
    torch.cuda.synchronize()
    rpix, ropac = render.composite(packed[..., :3], packed[..., 3],
                                   dts.expand(r, s))
    torch.testing.assert_close(pix, rpix, atol=TOL, rtol=TOL)
    torch.testing.assert_close(opac, ropac, atol=TOL, rtol=TOL)


def _composite_inputs(dev, r, s, layout, dts_rows, seed):
    """rgb and sigma as separate tensors or as the columns of one packed
    (R, S, 4) array, dts (R, S) or a broadcast (1, S) row; ray 0 is opaque
    from its first sample, ray 1 empty."""
    rng = np.random.default_rng(seed)
    packed = np.concatenate([rng.uniform(size=(r, s, 3)),
                             rng.exponential(3.0, size=(r, s, 1))], -1
                            ).astype(np.float32)
    packed[0, :, 3] = 1e4
    if r > 1:
        packed[1, :, 3] = 0.0
    if layout == "packed":
        packed = torch.from_numpy(packed).to(dev)
        rgb, sigma = packed[..., :3], packed[..., 3]
    else:
        rgb, sigma = (torch.from_numpy(a.copy()).to(dev)
                      for a in (packed[..., :3], packed[..., 3]))
    dts = torch.from_numpy(rng.uniform(0.01, 0.2, (dts_rows or r, s)).astype(
        np.float32)).to(dev)
    return rgb, sigma, dts


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 8, 16, 31, 32, 33, 64, 192])
@pytest.mark.parametrize("r", [1, 333, 4096])
@pytest.mark.parametrize("layout", ["packed", "separate"])
@pytest.mark.parametrize("dts_rows", [None, 1])
def test_composite_segments_match_plain(dev, s, r, layout, dts_rows):
    """The warp-per-ray kernel over sample counts below, at and above its
    32-lane segment (S < 32 puts several rays in a warp; S > 32 carries the
    scan across chunks), ray counts off the rays per block, both input
    layouts (the 16-byte packed path and the strided one) and both dts
    shapes; an opaque ray's opacity stays finite and at most 1 + 1e-4."""
    rgb, sigma, dts = _composite_inputs(dev, r, s, layout, dts_rows, r + s)
    assert rm_ray_march.is_packed(rgb, sigma) == (layout == "packed")
    before = tkernels.launch_counts()["composite_fwd"]
    pix, opac = rm_ops.composite(rgb, sigma, dts)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["composite_fwd"] == before + 1
    rpix, ropac = render.composite(rgb, sigma, dts.expand(r, s))
    assert bool(torch.isfinite(pix).all()) and bool(torch.isfinite(opac).all())
    torch.testing.assert_close(pix, rpix, atol=TOL, rtol=TOL)
    torch.testing.assert_close(opac, ropac, atol=TOL, rtol=TOL)
    assert float(opac.max()) <= 1.0 + 1e-4
    assert abs(float(opac[0]) - 1.0) < 1e-4
    if r > 1:
        assert float(opac[1]) == 0.0 and float(pix[1].abs().max()) == 0.0


def _encode_inputs(dev, n, dim, n_features, n_levels, table, seed):
    """A hash grid of ``n_levels`` levels of 2^14 rows (the first dense, the
    finer hashed where L reaches them), U(-1, 1) tables as ``table``, n
    points with edge coordinates."""
    g = dataclasses.replace(
        tenc.hashgrid_config(dim=dim, growth=1.25992 if dim == 2
                             else 1.51572),
        log2_table_size=14, n_levels=n_levels, n_features=n_features)
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.uniform(
        -1, 1, (n_levels, g.table_size, n_features)).astype(
            np.float32)).to(dev)
    scales = None
    if table == "bf16":
        tables = tables.to(torch.bfloat16)
    elif table != "f32":
        scales = table_scales(tables, QuantSpec(table))
        tables = quantize(tables, scales, table)
    pts = rng.uniform(size=(n, dim)).astype(np.float32)
    pts[:1] = 1.0
    pts[1:2] = 0.0
    return g, tables, scales, torch.from_numpy(pts).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("dim,n_features", [(3, 2), (3, 8), (2, 2), (2, 8)])
@pytest.mark.parametrize("n_levels", [1, 6, 13, 16])
@pytest.mark.parametrize("n", [1, 255, 257, 4099, 131072])
def test_encode_level_groups_match_plain(dev, table, dim, n_features,
                                         n_levels, n):
    """The level-group encode over level counts that leave a ragged last
    group (6 and 13; 13 levels of F = 2 are 8-byte, not 16-byte, aligned
    rows), point counts off the 128-point tiles, and the group sizes the
    plan picks for each table type at small and full tiles."""
    g, tables, scales, pts = _encode_inputs(dev, n, dim, n_features,
                                            n_levels, table,
                                            n + n_levels + dim)
    before = tkernels.launch_counts()["encode_fwd"]
    got = hops.encode(pts, tables, g, table_scales=scales)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["encode_fwd"] == before + 1
    assert got.shape == (n, n_levels * n_features)
    torch.testing.assert_close(got, encode_ref(pts, tables, g, scales),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_engine_on_card_matches_cpu_render_frame(dev, app):
    cfg = fields.make_field_config(app, "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14,
                                            n_levels=6))
    params = fields.init_field(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    params["grid"] = torch.rand(params["grid"].shape,
                                generator=torch.Generator().manual_seed(1)
                                ) * 2 - 1
    settings = pipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = RenderEngine(settings, device=dev)
    engine.add_scene("a", cfg, params)
    engine.warmup()
    cam = scenes.orbit_camera(12, 12, 0.7)
    tkernels.reset_launch_counts()
    got = engine.render_frame("a", cam)
    launched = {k for k, n in tkernels.launch_counts().items() if n > 0}
    # nvr has no colour MLP; nerf runs all three kernels
    assert launched == ({"field_fwd", "composite_fwd"}
                        | ({"mlp_fwd"} if app == "nerf" else set()))
    ref = pipeline.render_frame(params, cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app,spec", [
    ("nerf", QuantSpec("int8")), ("nerf", QuantSpec("fp8_e4m3", "int8")),
    ("nvr", QuantSpec("fp8_e4m3"))])
def test_quantized_engine_on_card_matches_cpu_render_frame(dev, app, spec):
    """Scenes quantized on the card, served through their own bucket, equal
    the CPU render of the same quantized params."""
    cfg = fields.make_field_config(app, "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14,
                                            n_levels=6))
    params = fields.init_field(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    params["grid"] = torch.rand(params["grid"].shape,
                                generator=torch.Generator().manual_seed(1)
                                ).to(dev) * 2 - 1
    qparams = quantize_field(params, spec)
    qcfg = cfg.with_quant(spec)
    settings = pipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = RenderEngine(settings, device=dev)
    engine.add_scene("q", qcfg, qparams)
    engine.warmup()
    cam = scenes.orbit_camera(12, 12, 0.7)
    tkernels.reset_launch_counts()
    got = engine.render_frame("q", cam)
    counts = tkernels.launch_counts()
    assert counts["field_fwd_q"] > 0 and counts["field_fwd"] == 0
    ref = pipeline.render_frame(fields.to_device(qparams, torch.device("cpu")),
                                qcfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "nvr"])
def test_bf16_engine_on_card_matches_cpu_render_frame(dev, app):
    """A scene with bf16 tables gets its own bucket, runs field_fwd on its
    bf16 tables, and equals the CPU render of the same params."""
    cfg = fields.make_field_config(app, "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14,
                                            n_levels=6))
    params = fields.init_field(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    params["grid"] = (torch.rand(params["grid"].shape,
                                 generator=torch.Generator().manual_seed(1))
                      * 2 - 1).to(torch.bfloat16)
    settings = pipeline.RenderSettings(tile_pixels=64, n_samples=8)
    engine = RenderEngine(settings, device=dev)
    key = engine.add_scene("b", cfg, params)
    assert key.dtype.startswith("torch.bfloat16")
    engine.warmup()
    cam = scenes.orbit_camera(12, 12, 0.7)
    tkernels.reset_launch_counts()
    got = engine.render_frame("b", cam)
    counts = tkernels.launch_counts()
    assert counts["field_fwd"] > 0 and counts["field_fwd_q"] == 0
    ref = pipeline.render_frame(params, cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)


def _grid2d_inputs(dev, n, n_features, table, seed):
    """gia's 2-D grid (growth 1.25992): with F = 2, 12 levels of 2^14 rows
    (levels 0-9 dense, 10-11 hashed); with F = 8, 4 levels of 2^12 rows.
    U(-1, 1) tables as ``table`` (f32, bf16, or int8 / fp8_e4m3 codes
    quantized in the port), n points with edge coordinates."""
    log2_T, n_levels = (14, 12) if n_features == 2 else (12, 4)
    g = dataclasses.replace(tenc.hashgrid_config(dim=2, growth=1.25992),
                            log2_table_size=log2_T, n_levels=n_levels,
                            n_features=n_features)
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.uniform(
        -1, 1, (g.n_levels, g.table_size, n_features)).astype(
            np.float32)).to(dev)
    scales = None
    if table == "bf16":
        tables = tables.to(torch.bfloat16)
    elif table != "f32":
        scales = table_scales(tables, QuantSpec(table))
        tables = quantize(tables, scales, table)
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    pts[:1] = 1.0
    pts[1:2] = 0.0
    return g, tables, scales, torch.from_numpy(pts).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("n_features", [2, 8])
@pytest.mark.parametrize("n", [1, 4099, 40000])
def test_2d_field_kernel_matches_plain(dev, table, n_features, n):
    """gia's (2, F) cases: field_fwd for f32 and bf16 tables, field_fwd_q
    for codes, with gia's MLP (4 hidden layers of 64, 3 outputs)."""
    g, tables, scales, pts = _grid2d_inputs(dev, n, n_features, table, n)
    m = MLPConfig(in_dim=g.out_dim, n_hidden=4, out_dim=3)
    w = _mlp_params(m, n + 2, dev)
    kernel = "field_fwd" if scales is None else "field_fwd_q"
    before = tkernels.launch_counts()
    got = ff_ops.field(pts, tables, w, g, m, table_scales=scales)
    torch.cuda.synchronize()
    after = tkernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kernel) for k in after}
    torch.testing.assert_close(got, field_ref(pts, tables, w, g, m, scales),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("n_features", [2, 8])
@pytest.mark.parametrize("n", [1, 4099, 40000])
def test_2d_encode_kernel_matches_plain(dev, table, n_features, n):
    g, tables, scales, pts = _grid2d_inputs(dev, n, n_features, table, n + 1)
    before = tkernels.launch_counts()["encode_fwd"]
    got = hops.encode(pts, tables, g, table_scales=scales)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["encode_fwd"] == before + 1
    torch.testing.assert_close(got, encode_ref(pts, tables, g, scales),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 4099, 40000])
def test_field_kernel_single_output_matches_plain(dev, monkeypatch, table, n):
    """nsdf's MLP (32 -> 64 x 4 -> 1): the kernel writes the one column of
    its (B, 1) output and nothing past it: the output is handed out as the
    head of a buffer whose 64-float tail holds a sentinel, which the
    kernel must leave as it was."""
    g, tables, _, pts = _grid_inputs(dev, n, 2, 14, None, n + 5)
    g = dataclasses.replace(g, growth=1.38191)
    if table == "bf16":
        tables = tables.to(torch.bfloat16)
    m = MLPConfig(in_dim=g.out_dim, n_hidden=4, out_dim=1)
    w = _mlp_params(m, n + 6, dev)
    ref = field_ref(pts, tables, w, g, m)
    bufs = []

    def guarded_empty(shape, dtype, device):
        bufs.append(torch.full((shape[0] * shape[1] + 64,), 7.0,
                               dtype=dtype, device=device))
        return bufs[-1][:shape[0] * shape[1]].view(shape)
    monkeypatch.setattr(torch, "empty", guarded_empty)
    got = ff_ops.field(pts, tables, w, g, m)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert len(bufs) == 1 and got.data_ptr() == bufs[0].data_ptr()
    torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)
    assert bool((bufs[0][n:] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("app,table", [("gia", "f32"), ("gia", "bf16"),
                                       ("gia", "int8"), ("nsdf", "f32")])
def test_app_engine_on_card_matches_cpu_render_frame(dev, app, table):
    """gia (dense and hashed 2-D levels; f32, bf16 or int8 tables, each in
    its own bucket) and nsdf (the baked sphere, sphere-traced) through the
    engine on the card, against the CPU render of the same params. nsdf
    launches field_fwd 55 times per tile: 48 trace steps, the hit points
    and six offsets for the normal."""
    cfg = fields.make_field_config(app, "hash")
    log2_T, n_levels = (14, 12) if app == "gia" else (14, 6)
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=log2_T,
                                            n_levels=n_levels))
    if app == "nsdf":
        np_params = scenes.baked_sdf_params(cfg, 3)
    else:
        rng = np.random.default_rng(3)
        np_params = {"grid": rng.uniform(-1, 1, fields.param_shapes(cfg)[
            "grid"]).astype(np.float32),
            "mlp": {k: v.cpu().numpy()
                    for k, v in _mlp_params(cfg.mlp, 4, "cpu").items()}}
    params = fields.from_jax_params(np_params, cfg, dev)
    if table == "bf16":
        params["grid"] = params["grid"].to(torch.bfloat16)
    elif table == "int8":
        cfg = cfg.with_quant(QuantSpec("int8"))
        params = quantize_field(params, cfg.quant)
    settings = pipeline.RenderSettings(tile_pixels=64)
    engine = RenderEngine(settings, device=dev)
    engine.add_scene("a", cfg, params)
    engine.warmup()
    cam = scenes.orbit_camera(12, 12, 0.7)
    tkernels.reset_launch_counts()
    got = engine.render_frame("a", cam)
    counts = {k: n for k, n in tkernels.launch_counts().items() if n}
    kernel = "field_fwd_q" if table == "int8" else "field_fwd"
    assert counts == {kernel: 3 * (55 if app == "nsdf" else 1)}
    ref = pipeline.render_frame(fields.to_device(params, torch.device("cpu")),
                                cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)
    if app == "nsdf":
        hit = got.sum(-1) > 0
        assert 0 < hit.sum() < hit.size


def _rel_err(got, ref):
    """Max abs error over the reference's max abs (0 for an all-zero
    reference that is matched exactly)."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err / scale if scale else err


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "bf16"])
@pytest.mark.parametrize("dim,n_features", [(3, 2), (3, 8), (2, 2), (2, 8)])
@pytest.mark.parametrize("n_levels", [1, 6, 16])
@pytest.mark.parametrize("n", [1, 4099, 131072])
def test_encode_bwd_matches_twin(dev, table, dim, n_features, n_levels, n):
    """The encode's scatter-add (encode_bwd) against its plain twin on the
    card: the table gradient (bf16 tables: accumulated in f32, cast once)
    and the points' gradient, over ragged level groups (6 levels), tiles
    of one point and Table-I nerf's 131,072, and points at 0 and 1."""
    g, tables, _, pts = _encode_inputs(dev, n, dim, n_features, n_levels,
                                       table, 7 * n + n_levels + dim)
    cot = torch.from_numpy(np.random.default_rng(n).uniform(
        -1, 1, (n, g.out_dim)).astype(np.float32)).to(dev)
    before = tkernels.launch_counts()["encode_bwd"]
    d_pts, d_tab = hops.encode_vjp(pts, tables, g, cot, True)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["encode_bwd"] == before + 1
    r_pts, r_tab = hvjp.encode_bwd(pts, tables, g, cot)
    assert d_tab.dtype == tables.dtype and d_tab.shape == tables.shape
    assert _rel_err(d_pts, r_pts) <= GRAD_TOL
    if table == "f32":
        assert _rel_err(d_tab, r_tab) <= GRAD_TOL
    else:   # one bf16 rounding of f32 sums that differ in the last bits
        assert _rel_err(d_tab, r_tab) <= 2 ** -7
    none_pts, again = hops.encode_vjp(pts, tables, g, cot, False)
    assert none_pts is None
    assert _rel_err(again, r_tab) <= (GRAD_TOL if table == "f32" else 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 2])
def test_encode_bwd_atomics_in_one_cell(dev, dim):
    """Worst contention: 131,072 points in one cell of every level, so each
    of the 2^d corner rows of a level takes 131,072 atomic adds. Against an
    f64 sum: f32 sums of that many positive terms stay within 1e-4 of the
    leaf's max (about sqrt(K) * 6e-8 for a random order), the twin too."""
    n = 131072
    g, tables, _, _ = _encode_inputs(dev, 1, dim, 2, 16, "f32", dim)
    rng = np.random.default_rng(dim)
    pts = torch.from_numpy((0.5 + 1e-4 * rng.uniform(size=(n, dim))).astype(
        np.float32)).to(dev)
    cot = torch.from_numpy(rng.uniform(0, 1, (n, g.out_dim)).astype(
        np.float32)).to(dev)
    _, d_tab = hops.encode_vjp(pts, tables, g, cot, False)
    ref64 = torch.zeros(tables.shape, dtype=torch.float64, device=dev)
    for level in range(g.n_levels):
        cell, frac = tenc.level_cell(pts, g.level_resolution(level))
        for bits in tenc._corner_offsets(dim):
            w = torch.ones_like(frac[:, 0], dtype=torch.float64)
            for i in range(dim):
                w = w * (frac[:, i] if bits[i] else 1.0 - frac[:, i])
            ref64[level].index_add_(
                0, tenc.level_corner_index(cell, bits, level, g),
                w[:, None] * cot[:, 2 * level:2 * level + 2].double())
    _, twin = hvjp.encode_bwd(pts, tables, g, cot, False)
    assert _rel_err(d_tab, ref64) <= 1e-4
    assert _rel_err(twin, ref64) <= 1e-4


def _small_field(app):
    cfg = fields.make_field_config(app, "hash")
    return cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14,
                                             n_levels=4))


@pytest.mark.cuda
@pytest.mark.parametrize("n_hidden", [1, 3])
@pytest.mark.parametrize("n", [300, 20000])
def test_autograd_functions_on_card_match_cpu(dev, n_hidden, n):
    """The field, MLP and encode Functions' gradients on the card (kernels
    forward and backward) against the same Functions on the CPU (plain
    versions), every input requiring a gradient, points included."""
    g = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=14,
                            n_levels=4)
    m = MLPConfig(in_dim=g.out_dim, n_hidden=n_hidden, out_dim=16)
    rng = np.random.default_rng(n + n_hidden)
    tables = rng.uniform(-1, 1, (4, g.table_size, 2)).astype(np.float32)
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pts[:2] = [[1, 1, 1], [0, 0, 0]]
    w = {k: v.numpy() for k, v in _mlp_params(m, n, "cpu").items()}
    cot = rng.uniform(-1, 1, (n, 16)).astype(np.float32)
    x = rng.uniform(-1, 1, (n, g.out_dim)).astype(np.float32)

    def grads(device):
        t = {k: torch.from_numpy(v).to(device).requires_grad_(True)
             for k, v in dict(w, tables=tables, pts=pts, x=x).items()}
        weights = {k: t[k] for k in w}
        out = {"field": ff_ops.field(t["pts"], t["tables"], weights, g, m),
               "mlp": mlp_ops.mlp(weights, t["x"], m),
               "encode": hops.encode(t["pts"], t["tables"], g)}
        res = {}
        for name, y in out.items():
            c = torch.from_numpy(cot[:, :y.shape[1]]).to(device)
            leaves = [k for k in t if k in
                      {"field": [*w, "tables", "pts"], "mlp": [*w, "x"],
                       "encode": ["tables", "pts"]}[name]]
            gs = torch.autograd.grad(y, [t[k] for k in leaves], c)
            res.update({(name, k): v.cpu() for k, v in zip(leaves, gs)})
        return res

    got, ref = grads(dev), grads("cpu")
    assert got.keys() == ref.keys()
    for key in ref:
        assert _rel_err(got[key], ref[key]) <= GRAD_TOL, key


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_train_steps_on_card_match_cpu(dev, app):
    """Three training steps on the card (kernels) and on the CPU (plain
    versions) from the same params on the same batches: the losses agree
    to 1e-4 of their size (the kernels' 3xTF32 forward, f32 sums in
    another order; Adam then turns a near-zero gradient's rounding into a
    step of lr, which the loss averages out), and the card's run launches
    each kernel of its path and never the compositing kernel."""
    cfg = _small_field(app)
    init = fields.init_field(cfg, torch.Generator().manual_seed(1), "cpu")
    batches = [ttrain.make_batch(cfg, ttrain.batch_generator(1, i, "cpu"),
                                 64) for i in range(3)]

    def run(device):
        return ttrain.train_field(
            cfg, steps=3, log_every=1, params=init, device=device,
            batch_fn=lambda i: {k: v.to(device) for k, v in
                                batches[i].items()})[1]

    tkernels.reset_launch_counts()
    got = run(dev)
    counts = tkernels.launch_counts()
    ref = run("cpu")
    for (_, a), (_, b) in zip(got, ref):
        assert abs(a - b) <= 1e-4 * abs(b)
    for k in ["field_fwd", "encode_fwd", "encode_bwd"] + (
            ["mlp_fwd"] if app == "nerf" else []):
        assert counts[k] == 3, (k, counts)
    assert counts["composite_fwd"] == 0


# ------------------------------------------- occupancy, compression, resume
def _occ_scene(app, seed=3):
    """A small field with U(-1, 1) tables on the CPU."""
    cfg = _small_field(app)
    params = fields.init_field(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    rng = np.random.default_rng(seed)
    params["grid"] = torch.from_numpy(rng.uniform(
        -1, 1, tuple(params["grid"].shape)).astype(np.float32))
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("res", [4, 12, 64])
def test_occupancy_grid_on_card_matches_cpu(dev, res):
    """pack_bits, unpack_bits, cell_centers, query and query_sigma on the
    card against the CPU, bit for bit, and a grid built on the card from
    the same densities has the CPU's words."""
    rng = np.random.default_rng(res)
    sigma = rng.exponential(1.0, res ** 3).astype(np.float32)
    pts = rng.random((5000, 3)).astype(np.float32)
    grids = {d: occupancy.build_occupancy_from_fn(
        lambda p, d=d: torch.from_numpy(sigma).to(d), res=res,
        threshold=1.0, device=d) for d in (dev, "cpu")}
    assert torch.equal(grids[dev]["bits"].cpu(), grids["cpu"]["bits"])
    assert torch.equal(occupancy.unpack_bits(grids[dev]["bits"]).cpu(),
                       torch.from_numpy(sigma > 1.0))
    assert torch.equal(occupancy.cell_centers(res, dev).cpu(),
                       occupancy.cell_centers(res))
    for fn in (occupancy.query, occupancy.query_sigma):
        assert torch.equal(
            fn(grids[dev], torch.from_numpy(pts).to(dev)).cpu(),
            fn(grids["cpu"], torch.from_numpy(pts)))


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "nvr"])
@pytest.mark.parametrize("tile", [4096, 333])
def test_culled_tile_on_card_equals_dense_bitwise(dev, app, tile):
    """All-occupied grid, full budget: the culled tile on the card equals
    the dense tile on the card bit for bit. The field kernels' output per
    point does not depend on where the point sits in the batch: the field
    of the points in the culled route's (sample-major) order equals the
    dense output permuted, bit for bit."""
    cfg, params = _occ_scene(app)
    params = fields.to_device(params, dev)
    cam = scenes.orbit_camera(64, 64, 0.7)
    ids = torch.arange(tile, device=dev) % (64 * 64)
    dense = pipeline.RenderSettings(tile_pixels=tile, n_samples=32)
    culled = dataclasses.replace(dense, occupancy=True)
    p_occ = occupancy.attach(params, occupancy.all_occupied(8, dev))
    tkernels.reset_launch_counts()
    rgb_c, row = pipeline.make_tile_fn(cfg, culled, with_aux=True)(
        p_occ, cam, ids)
    counts = tkernels.launch_counts()
    rgb_d = pipeline.make_tile_fn(cfg, dense)(params, cam, ids)
    assert torch.equal(rgb_c, rgb_d)
    assert row.cpu().tolist() == [[tile * 32.0, tile * 32.0, 0.0]]
    assert counts["field_fwd"] == 1 and counts["composite_fwd"] == 1
    assert counts["mlp_fwd"] == (1 if app == "nerf" else 0)
    origins, dirs = render.make_rays(cam, ids)
    pts, _ = render.sample_along_rays(origins, dirs, 0.5, 4.5, 32)
    flat = render.normalize_to_unit(pts.reshape(-1, 3))
    d = torch.repeat_interleave(dirs, 32, dim=0)
    perm = torch.from_numpy(np.random.default_rng(tile).permutation(
        flat.shape[0])).to(dev)
    out = fields.apply_field(params, cfg, flat, d)
    assert torch.equal(fields.apply_field(params, cfg, flat[perm], d[perm]),
                       out[perm])


@pytest.mark.cuda
@pytest.mark.parametrize("budget_div", [1, 4, 64])
def test_culled_engine_on_card_matches_cpu(dev, budget_div):
    """An oracle grid (the analytic volume's densities) at full, quarter
    and 1/64 budget: the engine's culled frame on the card against
    render_frame on the CPU within 1e-4, the same sample counts, and the
    culled path launches the field, MLP and compositing kernels."""
    cfg, params = _occ_scene("nerf")
    grid = occupancy.build_occupancy_from_fn(
        lambda p: scenes.volume_field(p * 4.0 - 2.0)[:, 3], res=32,
        device="cpu")
    p_occ = occupancy.attach(params, grid)
    settings = pipeline.RenderSettings(
        tile_pixels=1024, n_samples=32, occupancy=True,
        sample_budget=1024 * 32 // budget_div)
    cam = scenes.default_camera(32, 32)
    eng = RenderEngine(settings, device=dev)
    eng.add_scene("s", cfg, p_occ)
    eng.warmup()
    tkernels.reset_launch_counts()
    got = eng.render_frame("s", cam)
    counts = tkernels.launch_counts()
    ref = pipeline.render_frame(p_occ, cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), rtol=TOL, atol=TOL)
    for k in ("field_fwd", "mlp_fwd", "composite_fwd"):
        assert counts[k] == 1, counts
    o, d = render.make_rays(cam, torch.arange(1024))
    _, aux = render.render_rays(
        lambda p, dd: fields.apply_field(params, cfg, p, dd), o, d,
        n_samples=32, occupancy=grid, sample_budget=settings.sample_budget,
        return_aux=True)
    st = eng.stats()
    assert st["samples_total"] == 1024 * 32
    assert st["live_sample_frac"] == int(aux["n_live"]) / (1024 * 32)
    assert st["samples_dropped"] == int(aux["n_dropped"])


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["topk", "int8"])
@pytest.mark.parametrize("shape", [(300,), (16, 4096, 2), (4, 1 << 19, 2)])
def test_compression_on_card_matches_cpu(dev, scheme, shape):
    """compress_topk and compress_int8 on the card against the CPU, bit
    for bit (the scale divides by a tensor, so it rounds as on the CPU),
    and top-k's kept + efb_new == g + efb_old exactly on the card."""
    rng = np.random.default_rng(len(shape))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    e = torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32))
    fn = (lambda a, b: compression.compress_topk(a, b, 0.05)) \
        if scheme == "topk" else compression.compress_int8
    got = fn(g.to(dev), e.to(dev))
    ref = fn(g, e)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    if scheme == "topk":
        assert torch.equal(got[0] + got[1], g.to(dev) + e.to(dev))


@pytest.mark.cuda
def test_async_checkpointer_snapshots_card_state_before_update(dev, tmp_path):
    """The state is updated in place on the card right after save returns:
    the checkpoint holds the values at the call, bit for bit, and the
    restored tensors land on the card."""
    rng = np.random.default_rng(0)
    state = {"params": {"grid": torch.from_numpy(rng.normal(
        size=(16, 1 << 19, 2)).astype(np.float32)).to(dev)},
        "opt": toptim.AdamState(step=3, mu={"grid": torch.zeros(
            16, 1 << 19, 2, device=dev)}, nu={"grid": torch.ones(
                16, 1 << 19, 2, device=dev)})}
    before = state["params"]["grid"].clone()
    ck = ckpt_store.AsyncCheckpointer(tmp_path)
    for i in range(3):
        ck.save(state, i)
        state["params"]["grid"].mul_(2.0).add_(1.0)
        state["opt"].nu["grid"].add_(1.0)
        ck.wait()
        got = ckpt_store.restore(tmp_path, state, step=i)
        assert got["params"]["grid"].device == before.device
        assert torch.equal(got["params"]["grid"], before)
        assert bool((got["opt"].nu["grid"] == 1.0 + i).all())
        assert got["opt"].step == 3
        before = state["params"]["grid"].clone()


@pytest.mark.cuda
def test_grad_accum_on_card_matches_single_pass(dev):
    """grad_accum=2 against 1 on the card, before Adam: the loss within
    1e-6 of its size, every gradient leaf within 1e-5 of its max (f32 sums
    in another order, atomics in another order)."""
    cfg, _ = _occ_scene("nerf")
    params = fields.init_field(cfg, torch.Generator().manual_seed(0), dev)
    batch = ttrain.make_batch(cfg, ttrain.batch_generator(0, 0, dev), 256)

    def loss_fn(p, b):
        return ttrain.field_loss(p, cfg, b)
    l1, g1 = tloop.value_and_grad(loss_fn, params, batch)
    l2, g2 = tloop.accumulated_value_and_grad(loss_fn, params, batch, 2)
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))
    for a, b in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g2)):
        assert _rel_err(b, a) <= GRAD_TOL


@pytest.mark.cuda
def test_resumed_card_run_within_bound(dev, tmp_path):
    """nerf (small grid) on the card: stopped at step 6 and resumed to 12.
    The checkpoint restores the state at step 5 bit for bit. The resumed
    run's losses differ from an uninterrupted run's by at most 4x what two
    uninterrupted runs differ by (encode_bwd's atomics sum in a varying
    order, so runs are not bitwise equal), with a floor of 1e-5 of the
    loss: the largest of one draw of that difference against another's."""
    cfg, _ = _occ_scene("nerf")
    kw = dict(steps=12, batch_size=256, seed=0, chunk_steps=3,
              ckpt_every=3, device=dev, log_every=1)

    def losses(**extra):
        rows = []
        ttrain.train_field(cfg, on_metrics=lambda i, r, st: rows.append(
            (i, r["loss"])), **{**kw, **extra})
        return rows
    a, b = losses(), losses()
    saved = {}

    def grab(i, r, st):
        if i == 5:
            saved.update({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in ckpt_store._flatten(st)})
    ck = str(tmp_path / "ck")
    ttrain.train_field(cfg, on_metrics=grab, ckpt_dir=ck,
                       **{**kw, "steps": 6})
    target = tloop.init_train_state(fields.init_field(
        cfg, torch.Generator().manual_seed(0), dev))
    restored = dict(ckpt_store._flatten(ckpt_store.restore(ck, target,
                                                           step=5)))
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert (torch.equal(restored[k], v) if torch.is_tensor(v)
                else restored[k] == v), k
    r = losses(ckpt_dir=ck)
    assert [i for i, _ in r] == list(range(6, 12))
    noise = max(abs(x - y) for (_, x), (_, y) in zip(a, b))
    for (i, x), (j, y) in zip(r, a[6:]):
        assert i == j and abs(x - y) <= max(4 * noise, 1e-5 * abs(y)), (
            i, x, y, noise)
