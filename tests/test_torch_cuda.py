"""The port's checks on the card: each CUDA kernel of repro_torch against
its plain PyTorch version, and the serving and training paths through
them, on small configs and, where a path's behaviour depends on the size,
at Table I's published width (``_table1``). Every test needs an NVIDIA GPU
and skips without one. ``chip_smoke.py`` measures the kernels; the
benchmark (``ngbench/``) measures the workloads.

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
import collections
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as tkernels
from repro_torch.core import encoding as tenc
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import fields, occupancy, pipeline, render
from repro_torch.core import train as ttrain
from repro_torch.core.mlp import MLPConfig, apply_mlp, init_mlp
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
from repro_torch.quant.api import maybe_dequant_mlp
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
# Table I's width: 4096-pixel tiles of 32 samples; training steps of 4096
# rays or points in chunks of 8, the rays' targets composited from the
# analytic volume at 64 samples; 64^3 occupancy grids.
T1_TILE, T1_SAMPLES = 4096, 32
T1_BATCH, T1_CHUNK, T1_GT = 4096, 8, 64
T1_OCC_RES = 64
# one training step's gradients at Table-I width, kernels against plain
# versions on the card: the kernels' 3xTF32 forward products (the exp and
# sigmoid heads magnify them, as for TOL) feed the loss's cotangent, and
# every sum runs in another order: max error over the leaf's max abs value
TRAIN_PARITY_TOL = 1e-4
# a quantized or bf16 frame against the f32 frame of the same scene: they
# differ, by less than this (tests/test_quant.py's bound)
QUANT_DENSE_MAX = 0.2
# a sharded frame against the unsharded one: the same kernels on each ray,
# point and row, whatever the tile's size
SHARD_TOL = 1e-6
REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table1(app, seed, device, encoding="hash"):
    """Table I's ``app`` x ``encoding`` at its published width, and a
    scene's params on ``device``: U(-1, 1) tables drawn in place in f32
    (gia's hash grid is 2 GiB), so a wrong row or level shows, and the
    port's initial weights (normal / sqrt(fan_in))."""
    cfg = fields.make_field_config(app, encoding)
    gen = torch.Generator().manual_seed(seed)
    tables = np.random.default_rng(seed).random(
        fields.param_shapes(cfg)["grid"], dtype=np.float32)
    tables *= 2
    tables -= 1
    params = {"grid": torch.from_numpy(tables),
              "mlp": init_mlp(cfg.mlp, gen)}
    if cfg.density_mlp is not None:
        params["density_mlp"] = init_mlp(cfg.density_mlp, gen)
    return cfg, fields.to_device(params, torch.device(device))


def _engine_frame(dev, cfg, params, settings, cam, mesh=None):
    """One scene's frame from a warmed-up engine on the card, the kernels'
    launches while it renders, and the scene's bucket key."""
    engine = RenderEngine(settings, mesh=mesh, device=torch.device("cuda", 0))
    key = engine.add_scene("a", cfg, params)
    engine.warmup()
    tkernels.reset_launch_counts()
    frame = engine.render_frame("a", cam)
    return frame, tkernels.launch_counts(), key


def _tiles(cam, settings):
    return -(-cam.height * cam.width // settings.tile_pixels)


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


# nerf's colour head on the card against the op-by-op head that runs the
# same mlp_fwd kernel: the SH in the same f32 operations, the same products,
# IEEE expf in both sigmoids and in sigma, so they agree to f32 rounding
HEAD_TOL = 1e-6
_HEAD_DIFF = {}


def _head_inputs(n, seed, dev, weights):
    """dfeat (n, 16) with a row of large sigma, unit directions (n, 3) with
    the axes among them, and the colour weights: f32, bf16, or an int8
    scene's dequantized colour MLP."""
    rng = np.random.default_rng(seed)
    dfeat = rng.normal(size=(n, 16)).astype(np.float32)
    dfeat[:1, 0] = 8.0
    d = rng.normal(size=(n, 3))
    d[:3] = np.eye(3)[:n]
    dirs = d / np.linalg.norm(d, axis=1, keepdims=True)
    cfg = fields.make_field_config("nerf", "hash").mlp
    if weights == "int8":
        spec = QuantSpec(table_qtype=None, mlp_qtype="int8")
        w = {"mlp": _mlp_params(cfg, seed + 1, dev)}
        w = maybe_dequant_mlp(quantize_field(w, spec)["mlp"])
    else:
        w = _mlp_params(cfg, seed + 1, dev, {"f32": torch.float32,
                                             "bf16": torch.bfloat16}[weights])
    return (torch.from_numpy(dfeat).to(dev),
            torch.from_numpy(dirs.astype(np.float32)).to(dev), w, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099, 131073])
def test_nerf_head_kernel_matches_plain_head(dev, n, weights):
    """``mlp_fwd_head`` (one launch, counted once as ``mlp_fwd``) against
    the op-by-op head on the card to HEAD_TOL absolute, and against the
    CPU's plain head to TOL; rows around the 16-row warp tiles and past
    one round of the persistent grid."""
    dfeat, dirs, w, cfg = _head_inputs(n, n, dev, weights)
    before = tkernels.launch_counts()
    got = mlp_ops.nerf_head(dfeat, dirs, w, cfg)
    torch.cuda.synchronize()
    after = tkernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("mlp_fwd", "mlp_fwd_head")) for k in after}
    want = mlp_ops.plain_head(dfeat, dirs, w, cfg)
    diff = float((got - want).abs().max())
    _HEAD_DIFF[n, weights] = diff
    print(f"nerf_head rows {n} {weights} weights: largest difference from "
          f"the plain head on the card {diff:.3g} (largest so far "
          f"{max(_HEAD_DIFF.values()):.3g})")
    torch.testing.assert_close(got, want, atol=HEAD_TOL, rtol=0)
    cpu = mlp_ops.nerf_head(dfeat.cpu(), dirs.cpu(),
                            {k: t.cpu() for k, t in w.items()}, cfg)
    torch.testing.assert_close(got.cpu(), cpu, atol=TOL, rtol=TOL)


def _nerf_field_inputs(dev, n=5000):
    cfg = _small_field("nerf")
    params = fields.to_device(_u11_params(cfg, 8), dev)
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.random((n, 3), dtype=np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    return cfg, params, pts, (d / d.norm(dim=-1, keepdim=True)).to(dev)


@pytest.mark.cuda
def test_fused_nerf_field_without_grad_takes_the_head_kernel(dev):
    """A fused nerf ``apply_field`` under ``torch.no_grad()``: ``field_fwd``
    once, then the colour head as one ``mlp_fwd`` launch, which is the
    ``mlp_fwd_head`` entry; the frame's field equals the op-by-op head's."""
    cfg, params, pts, dirs = _nerf_field_inputs(dev)
    tkernels.reset_launch_counts()
    with torch.no_grad():
        got = fields.apply_field(params, cfg, pts, dirs)
    torch.cuda.synchronize()
    assert {k: n for k, n in tkernels.launch_counts().items() if n} == {
        "field_fwd": 1, "mlp_fwd": 1, "mlp_fwd_head": 1}
    dfeat = ff_ops.field(pts, params["grid"], params["density_mlp"],
                         cfg.grid, cfg.density_mlp)
    want = mlp_ops.plain_head(dfeat, dirs, params["mlp"], cfg.mlp)
    torch.testing.assert_close(got, want, atol=HEAD_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["mlp", "density_mlp"])
def test_nerf_field_with_grad_keeps_the_plain_head(dev, needs):
    """Weights that require a gradient keep the op-by-op head (its autograd
    graph and ``mlp_fwd``'s VJP): ``mlp_fwd_head`` does not move, and the
    gradients are those of the op-by-op head."""
    cfg, params, pts, dirs = _nerf_field_inputs(dev)
    for t in params[needs].values():
        t.requires_grad_(True)
    tkernels.reset_launch_counts()
    out = fields.apply_field(params, cfg, pts, dirs)
    torch.cuda.synchronize()
    counts = tkernels.launch_counts()
    assert counts["mlp_fwd_head"] == 0 and counts["mlp_fwd"] == 1
    leaves = list(params[needs].values())
    got = torch.autograd.grad(out.square().sum(), leaves)
    dfeat = ff_ops.field(pts, params["grid"], params["density_mlp"],
                         cfg.grid, cfg.density_mlp)
    want_out = mlp_ops.plain_head(dfeat, dirs, params["mlp"], cfg.mlp)
    want = torch.autograd.grad(want_out.square().sum(), leaves)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_mode", [False, True])
def test_unfused_nerf_field_never_takes_the_head_kernel(dev, grad_mode):
    """``fused=False`` stays the op-by-op baseline: ``encode_fwd`` and two
    ``mlp_fwd`` launches (density, colour), never ``mlp_fwd_head``."""
    cfg, params, pts, dirs = _nerf_field_inputs(dev)
    tkernels.reset_launch_counts()
    with torch.set_grad_enabled(grad_mode):
        fields.apply_field(params, cfg, pts, dirs, fused=False)
    torch.cuda.synchronize()
    assert {k: n for k, n in tkernels.launch_counts().items() if n} == {
        "encode_fwd": 1, "mlp_fwd": 2}


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


def _small_scene(app, device="cpu"):
    """``app``'s hash config at 2^14 rows and 6 levels, with U(-1, 1)
    tables drawn from torch's generator."""
    cfg = fields.make_field_config(app, "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14,
                                            n_levels=6))
    params = fields.init_field(cfg, torch.Generator().manual_seed(0),
                               device=device)
    params["grid"] = torch.rand(params["grid"].shape,
                                generator=torch.Generator().manual_seed(1)
                                ).to(device) * 2 - 1
    return cfg, params


def _frame_case(app, width, device="cpu"):
    """(config, params, settings, camera) of a frame test: small (2^14
    rows, 6 levels; 64-pixel tiles of 8 samples, a 12x12 frame) or at
    Table I's width (a 32x32 frame in one 4096-pixel tile of 32 samples)."""
    if width == "small":
        return (*_small_scene(app, device),
                pipeline.RenderSettings(tile_pixels=64, n_samples=8),
                scenes.orbit_camera(12, 12, 0.7))
    return (*_table1(app, 0, device),
            pipeline.RenderSettings(tile_pixels=T1_TILE,
                                    n_samples=T1_SAMPLES),
            scenes.orbit_camera(32, 32, 0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("app,width,fused", [
    ("nerf", "small", True), ("nvr", "small", True),
    ("nerf", "table1", False)])
def test_engine_on_card_matches_cpu_render_frame(dev, app, width, fused):
    """The engine's frame on the card against render_frame on the CPU on
    the same params. The unfused route (``fused=False``: encode_fwd once
    and mlp_fwd once for each head a tile, field_fwd never) also against
    the fused engine's frame on the card, which launches the fused path's
    kernels. The fused nerf frame at Table-I width against a plain render
    is the ``nerf_hash.frames_720p`` cell's ``correct``."""
    cfg, params, settings, cam = _frame_case(app, width)
    settings = dataclasses.replace(settings, fused=fused)
    got, counts, _ = _engine_frame(dev, cfg, params, settings, cam)

    def fused_kernels(counts):
        # nvr has no colour MLP; nerf runs all three kernels, its colour
        # head as the mlp_fwd_head entry of mlp_fwd
        assert {k for k, n in counts.items() if n > 0} == (
            {"field_fwd", "composite_fwd"}
            | ({"mlp_fwd", "mlp_fwd_head"} if app == "nerf" else set()))
    if fused:
        fused_kernels(counts)
    else:
        t = _tiles(cam, settings)
        want = {"encode_fwd": t, "mlp_fwd": 2 * t, "field_fwd": 0,
                "field_fwd_q": 0, "composite_fwd": t}
        assert {k: counts[k] for k in want} == want
        fused_frame, fcounts, _ = _engine_frame(
            dev, cfg, params, dataclasses.replace(settings, fused=True), cam)
        fused_kernels(fcounts)
        np.testing.assert_allclose(got, fused_frame, atol=TOL, rtol=TOL)
    ref = pipeline.render_frame(params, cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app,spec,width", [
    ("nerf", QuantSpec("int8"), "small"),
    ("nerf", QuantSpec("fp8_e4m3", "int8"), "small"),
    ("nvr", QuantSpec("fp8_e4m3"), "small"),
    ("nerf", QuantSpec("int8"), "table1"),
    ("nerf", QuantSpec("fp8_e4m3", "int8"), "table1")])
def test_quantized_engine_on_card_matches_cpu_render_frame(dev, app, spec,
                                                           width):
    """Scenes quantized on the card, served through their own bucket, equal
    the CPU render of the same quantized params; at Table-I width the
    frame differs from the f32 scene's, by less than QUANT_DENSE_MAX."""
    cfg, params, settings, cam = _frame_case(app, width, dev)
    qparams = quantize_field(params, spec)
    qcfg = cfg.with_quant(spec)
    got, counts, _ = _engine_frame(dev, qcfg, qparams, settings, cam)
    assert counts["field_fwd_q"] > 0 and counts["field_fwd"] == 0
    ref = pipeline.render_frame(fields.to_device(qparams, torch.device("cpu")),
                                qcfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)
    if width == "table1":
        dense = _engine_frame(dev, cfg, params, settings, cam)[0]
        assert 0.0 < float(np.abs(got - dense).max()) < QUANT_DENSE_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("app,width", [("nerf", "small"), ("nvr", "small"),
                                       ("nerf", "table1")])
def test_bf16_engine_on_card_matches_cpu_render_frame(dev, app, width):
    """A scene with bf16 tables gets its own bucket, runs field_fwd on its
    bf16 tables, and equals the CPU render of the same params; at Table-I
    width its frame differs from the f32 scene's, by less than
    QUANT_DENSE_MAX."""
    cfg, params, settings, cam = _frame_case(app, width)
    bparams = {**params, "grid": params["grid"].to(torch.bfloat16)}
    got, counts, key = _engine_frame(dev, cfg, bparams, settings, cam)
    assert key.dtype.startswith("torch.bfloat16")
    assert counts["field_fwd"] > 0 and counts["field_fwd_q"] == 0
    ref = pipeline.render_frame(bparams, cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)
    if width == "table1":
        dense = _engine_frame(dev, cfg, params, settings, cam)[0]
        assert 0.0 < float(np.abs(got - dense).max()) < QUANT_DENSE_MAX


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
@pytest.mark.parametrize("app,table,width", [
    ("gia", "f32", "small"), ("gia", "bf16", "small"),
    ("gia", "int8", "small"), ("nsdf", "f32", "small"),
    ("gia", "f32", "table1"), ("gia", "bf16", "table1"),
    ("gia", "int8", "table1")])
def test_app_engine_on_card_matches_cpu_render_frame(dev, app, table, width):
    """gia (dense and hashed 2-D levels; f32, bf16 or int8 tables, each in
    its own bucket) and nsdf (the baked sphere, sphere-traced) through the
    engine on the card, against the CPU render of the same params: small
    (2^14 rows; 64-pixel tiles, a 12x12 frame) and at Table-I width (gia's
    2 GiB of f32 tables; a 32x32 frame in one 4096-pixel tile). nsdf
    launches field_fwd 55 times per tile: 48 trace steps, the hit points
    and six offsets for the normal. At Table-I width the bf16 and int8
    frames differ from the f32 one, by less than QUANT_DENSE_MAX. nsdf's
    frame at Table-I width against a plain render is the
    ``nsdf_hash.frames_720p`` cell's ``correct``."""
    cfg = fields.make_field_config(app, "hash")
    if width == "small":
        log2_T, n_levels = (14, 12) if app == "gia" else (14, 6)
        cfg = cfg.with_grid(dataclasses.replace(
            cfg.grid, log2_table_size=log2_T, n_levels=n_levels))
        settings = pipeline.RenderSettings(tile_pixels=64)
        cam = scenes.orbit_camera(12, 12, 0.7)
    else:
        settings = pipeline.RenderSettings(tile_pixels=T1_TILE,
                                           n_samples=T1_SAMPLES)
        cam = scenes.orbit_camera(32, 32, 0.9)
    if app == "nsdf":
        params = fields.from_jax_params(scenes.baked_sdf_params(cfg, 3), cfg,
                                        dev)
    elif width == "small":
        rng = np.random.default_rng(3)
        params = fields.from_jax_params({
            "grid": rng.uniform(-1, 1, fields.param_shapes(cfg)[
                "grid"]).astype(np.float32),
            "mlp": {k: v.cpu().numpy()
                    for k, v in _mlp_params(cfg.mlp, 4, "cpu").items()}},
            cfg, dev)
    else:
        cfg, params = _table1(app, 3, dev)
    f32_params = params
    if table == "bf16":
        params = {**params, "grid": params["grid"].to(torch.bfloat16)}
    elif table == "int8":
        cfg = cfg.with_quant(QuantSpec("int8"))
        params = quantize_field(params, cfg.quant)
    got, counts, _ = _engine_frame(dev, cfg, params, settings, cam)
    counts = {k: n for k, n in counts.items() if n}
    kernel = "field_fwd_q" if table == "int8" else "field_fwd"
    assert counts == {kernel: _tiles(cam, settings)
                      * (55 if app == "nsdf" else 1)}
    ref = pipeline.render_frame(fields.to_device(params, torch.device("cpu")),
                                cfg, cam, settings, device="cpu")
    np.testing.assert_allclose(got, ref.numpy(), atol=TOL)
    if app == "nsdf":
        hit = got.sum(-1) > 0
        assert 0 < hit.sum() < hit.size
    if width == "table1" and table != "f32":
        f32 = _engine_frame(dev, fields.make_field_config(app, "hash"),
                            f32_params, settings, cam)[0]
        assert 0.0 < float(np.abs(got - f32).max()) < QUANT_DENSE_MAX


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
@pytest.mark.parametrize("app,tile,width", [
    ("nerf", 4096, "small"), ("nerf", 333, "small"), ("nvr", 4096, "small"),
    ("nvr", 333, "small"), ("nerf", 4096, "table1")])
def test_culled_tile_on_card_equals_dense_bitwise(dev, app, tile, width):
    """All-occupied grid, full budget: the culled tile on the card equals
    the dense tile on the card bit for bit, small (2^14 rows, 4 levels) and
    at Table-I width. The field kernels' output per point does not depend
    on where the point sits in the batch: the field of the points in the
    culled route's (sample-major) order equals the dense output permuted,
    bit for bit."""
    if width == "small":
        cfg, params = _occ_scene(app)
        params, res = fields.to_device(params, dev), 8
    else:
        (cfg, params), res = _table1(app, 3, dev), T1_OCC_RES
    cam = scenes.orbit_camera(64, 64, 0.7)
    ids = torch.arange(tile, device=dev) % (64 * 64)
    dense = pipeline.RenderSettings(tile_pixels=tile, n_samples=32)
    culled = dataclasses.replace(dense, occupancy=True)
    p_occ = occupancy.attach(params, occupancy.all_occupied(res, dev))
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


def _volume_grid(res, device="cpu"):
    """The analytic volume's densities as an occupancy grid: an oracle."""
    return occupancy.build_occupancy_from_fn(
        lambda p: scenes.volume_field(p * 4.0 - 2.0)[:, 3], res=res,
        device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("budget_div,width", [(1, "small"), (4, "small"),
                                              (64, "small"), (4, "table1")])
def test_culled_engine_on_card_matches_cpu(dev, budget_div, width):
    """An oracle grid (the analytic volume's densities) at full, quarter
    and 1/64 budget: the engine's culled frame on the card against
    render_frame on the CPU within 1e-4, the same sample counts, and the
    culled path launches the field, MLP and compositing kernels; small
    (2^14 rows, 4 levels, a 32^3 grid) and at Table-I width (a 64^3
    grid)."""
    if width == "small":
        (cfg, params), grid = _occ_scene("nerf"), _volume_grid(32)
    else:
        (cfg, params), grid = _table1("nerf", 3, "cpu"), _volume_grid(
            T1_OCC_RES)
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


def _nerf_train_case(width):
    """(config, initial params' maker, batch of a step) of a nerf training
    test: small (2^14 rows, 4 levels; 256 rays) or at Table-I width (4096
    rays, targets from the analytic volume at 64 samples)."""
    if width == "small":
        cfg, _ = _occ_scene("nerf")

        def batch(step, device):
            return ttrain.make_batch(
                cfg, ttrain.batch_generator(0, step, device), 256)
    else:
        cfg = fields.make_field_config("nerf", "hash")

        def batch(step, device):
            return ttrain.make_batch(
                cfg, ttrain.batch_generator(0, step, device), T1_BATCH,
                scenes.default_camera(), gt_samples=T1_GT)

    def init(device):
        return fields.init_field(cfg, torch.Generator().manual_seed(0),
                                 device)
    return cfg, init, batch


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "table1"])
def test_grad_accum_on_card_matches_single_pass(dev, width):
    """grad_accum=2 against 1 on the card, before Adam, small and at
    Table-I width: the loss within 1e-6 of its size, every gradient leaf
    within 1e-5 of its max (f32 sums in another order, atomics in another
    order)."""
    cfg, init, make_batch = _nerf_train_case(width)
    params, batch = init(dev), make_batch(0, dev)

    def loss_fn(p, b):
        return ttrain.field_loss(p, cfg, b)
    l1, g1 = tloop.value_and_grad(loss_fn, params, batch)
    l2, g2 = tloop.accumulated_value_and_grad(loss_fn, params, batch, 2)
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))
    for a, b in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g2)):
        assert _rel_err(b, a) <= GRAD_TOL


# a resumed run's loss against an uninterrupted one's: at most this many
# times the largest difference between two uninterrupted runs (one draw of
# encode_bwd's atomics' rounding against another's), or this share of the
# loss, whichever is larger
RESUME_NOISE_FACTOR, RESUME_FLOOR = 4.0, 1e-5


def _resume_bound(noise, y):
    return max(RESUME_NOISE_FACTOR * noise, RESUME_FLOOR * abs(y))


def _train_kw(width, dev):
    """train_field's arguments of a nerf run: small (256 rays, chunks of
    3, 12 steps) or at Table-I width (4096 rays, chunks of 8, 48 steps)."""
    if width == "small":
        return dict(steps=12, batch_size=256, seed=0, chunk_steps=3,
                    device=dev, log_every=1)
    return dict(steps=48, batch_size=T1_BATCH, seed=0, chunk_steps=T1_CHUNK,
                gt_samples=T1_GT, device=dev, log_every=1)


def _losses(cfg, **kw):
    """(step, loss) of every step of one train_field run."""
    rows = []
    ttrain.train_field(cfg, on_metrics=lambda i, r, st: rows.append(
        (i, r["loss"])), **kw)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("width,stop", [("small", 6), ("table1", 16)])
def test_resumed_card_run_within_bound(dev, tmp_path, width, stop):
    """nerf on the card, small (2^14 rows; 12 steps) and at Table-I width
    (48 steps): stopped at ``stop`` and resumed to the end. The checkpoint
    restores the state at the last step bit for bit. The resumed run's
    losses differ from an uninterrupted run's by at most 4x what two
    uninterrupted runs differ by (encode_bwd's atomics sum in a varying
    order, so runs are not bitwise equal), with a floor of 1e-5 of the
    loss: the largest of one draw of that difference against another's."""
    cfg, init, _ = _nerf_train_case(width)
    kw = {**_train_kw(width, dev), "ckpt_every": _train_kw(width, dev)[
        "chunk_steps"]}
    a, b = _losses(cfg, **kw), _losses(cfg, **kw)
    saved = {}

    def grab(i, r, st):
        if i == stop - 1:
            saved.update({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in ckpt_store._flatten(st)})
    ck = str(tmp_path / "ck")
    ttrain.train_field(cfg, on_metrics=grab, ckpt_dir=ck,
                       **{**kw, "steps": stop})
    target = tloop.init_train_state(init(dev))
    restored = dict(ckpt_store._flatten(ckpt_store.restore(
        ck, target, step=stop - 1)))
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert (torch.equal(restored[k], v) if torch.is_tensor(v)
                else restored[k] == v), k
    r = _losses(cfg, ckpt_dir=ck, **kw)
    assert [i for i, _ in r] == list(range(stop, kw["steps"]))
    noise = max(abs(x - y) for (_, x), (_, y) in zip(a, b))
    for (i, x), (j, y) in zip(r, a[stop:]):
        assert i == j and abs(x - y) <= _resume_bound(noise, y), (
            i, x, y, noise)


# the kill-and-resume child: trains Table-I nerf with checkpoints until
# killed
KILL_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.core import fields, train
cfg = fields.make_field_config("nerf", "hash")
train.train_field(cfg, steps=100000, batch_size={batch}, seed=0,
                  chunk_steps={chunk}, ckpt_dir={ckpt!r}, ckpt_every={every},
                  gt_samples={gt}, device="cuda")
"""


@pytest.mark.cuda
def test_killed_card_run_resumes_within_bound(dev, tmp_path):
    """Table-I nerf in a child process, checkpointing every 16 steps,
    SIGKILLed right after its first commit: every step directory left is
    committed, latest_step is the last commit, and a temporary directory
    is left at most for a save the kill cut short (after the last
    commit). A run resumed from it to step 48 starts at the next step, its
    losses within the bound of an uninterrupted run's."""
    from repro_torch.checkpoint import store
    cfg = fields.make_field_config("nerf", "hash")
    kw = _train_kw("table1", dev)
    a, b = _losses(cfg, **kw), _losses(cfg, **kw)
    noise = max(abs(x - y) for (_, x), (_, y) in zip(a, b))
    ck, every = str(tmp_path / "kill"), 16
    child = subprocess.Popen([sys.executable, "-c", KILL_CHILD.format(
        src=str(SRC), batch=T1_BATCH, chunk=T1_CHUNK, ckpt=ck, every=every,
        gt=T1_GT)])
    t0 = time.perf_counter()
    try:
        while store.latest_step(ck) is None:
            assert child.poll() is None, "the child exited before a commit"
            assert time.perf_counter() - t0 < 300, "no commit in 300 s"
            time.sleep(0.005)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    step_dirs = [p for p in os.listdir(ck) if p.startswith("step_")]
    committed = sorted(int(p.split("_")[1]) for p in step_dirs
                       if os.path.exists(os.path.join(ck, p, store.MANIFEST)))
    # the store commits a save by renaming its temporary directory, which
    # latest_step never reads
    temps = [int(re.match(r"\.tmp_step_(\d+)_", p).group(1))
             for p in os.listdir(ck) if p.startswith(".tmp_step_")]
    last = store.latest_step(ck)
    assert len(committed) == len(step_dirs) and last == committed[-1]
    assert last < kw["steps"] - 1 and all(t > last for t in temps)
    r = _losses(cfg, ckpt_dir=ck, ckpt_every=every, **kw)
    assert [i for i, _ in r] == list(range(last + 1, kw["steps"]))
    for i, x in r:
        assert abs(x - a[i][1]) <= _resume_bound(noise, a[i][1]), (i, x)


@pytest.mark.cuda
def test_gia_train_state_checkpoints_on_card(dev, tmp_path):
    """gia's train state at Table-I width, 6 GiB on the card (2 GiB of
    tables and Adam's two moments, after one step so the moments are not
    zero), saved by the asynchronous checkpointer and restored bit for
    bit."""
    cfg = fields.make_field_config("gia", "hash")
    state = tloop.init_train_state(fields.init_field(
        cfg, torch.Generator().manual_seed(0), dev))
    state, _ = tloop.make_scanned_step(
        lambda p, b: ttrain.field_loss(p, cfg, b), toptim.AdamConfig())(
        state, 0, ttrain.make_batch(cfg, ttrain.batch_generator(0, 0, dev),
                                    T1_BATCH))
    ck = ckpt_store.AsyncCheckpointer(tmp_path / "gia", keep=1)
    ck.save(state, 0)
    ck.wait()
    got = ckpt_store.restore(tmp_path / "gia", state)
    for (kx, x), (ky, y) in zip(ckpt_store._flatten(got),
                                ckpt_store._flatten(state)):
        assert kx == ky and (torch.equal(x, y) if torch.is_tensor(x)
                             else x == y), kx


# ------------------------------------- the unfused route, obs, the launcher
def _enc_field(app, encoding):
    """Table I's ``app`` x ``encoding`` at 2^14 rows, every level kept."""
    cfg = fields.make_field_config(app, encoding)
    return cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14))


def _u11_params(cfg, seed):
    params = fields.init_field(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    rng = np.random.default_rng(seed)
    params["grid"] = torch.from_numpy(rng.uniform(
        -1, 1, tuple(params["grid"].shape)).astype(np.float32))
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("app,encoding,quant,n", [
    *((app, encoding, quant, 5000) for app in ("nerf", "nvr", "gia", "nsdf")
      for encoding in ("hash", "dense", "tiled") for quant in (None, "int8")),
    *(("nerf", "table1", quant, 131_072)
      for quant in (None, "int8", "fp8_e4m3")),
    *(("gia", "table1", quant, 4096) for quant in (None, "int8"))])
def test_unfused_field_on_card_matches_cpu(dev, app, encoding, quant, n):
    """``apply_field(fused=False)`` on the card (``encode_fwd``, then
    ``mlp_fwd`` per head, no ``field_fwd``) against the CPU's plain
    versions, and against the fused route on the card, at TOL: every
    Table-I encoding at 2^14 rows on 5000 points, and the hash grid at
    Table I's width (``table1``) on a tile's points (nerf's 4096 rays x 32
    samples, gia's 4096 pixels)."""
    if encoding == "table1":
        cfg, params = _table1(app, 5, "cpu")
    else:
        cfg = _enc_field(app, encoding)
        params = _u11_params(cfg, 5)
    if quant:
        spec = QuantSpec(quant)
        cfg, params = cfg.with_quant(spec), quantize_field(params, spec)
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.random((n, cfg.grid.dim), dtype=np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True) if app == "nerf" else None
    dp = fields.to_device(params, dev)

    def on_card(fused):
        return fields.apply_field(dp, cfg, pts.to(dev),
                                  None if d is None else d.to(dev),
                                  fused=fused)
    tkernels.reset_launch_counts()
    got = on_card(False)
    torch.cuda.synchronize()
    counts = tkernels.launch_counts()
    assert counts["encode_fwd"] == 1 and counts["field_fwd"] == 0 \
        and counts["field_fwd_q"] == 0
    assert counts["mlp_fwd"] == (2 if app == "nerf" else 1)
    ref = fields.apply_field(params, cfg, pts, d, fused=False)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.cpu().numpy(), on_card(True).cpu()
                               .numpy(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "gia"])
def test_unfused_train_steps_on_card_match_cpu(dev, app):
    """Three steps of ``train_field(fused=False)`` on the card and on the
    CPU: the losses agree to 1e-4 of their size; the card's run launches
    ``encode_fwd`` and ``encode_bwd`` once a step, ``mlp_fwd`` once a head
    and step, and never ``field_fwd``."""
    cfg = _enc_field(app, "tiled")
    init = fields.init_field(cfg, torch.Generator().manual_seed(2), "cpu")
    batches = [ttrain.make_batch(cfg, ttrain.batch_generator(2, i, "cpu"),
                                 64) for i in range(3)]

    def run(device):
        return ttrain.train_field(
            cfg, steps=3, log_every=1, params=init, device=device,
            fused=False, batch_fn=lambda i: {k: v.to(device) for k, v in
                                             batches[i].items()})[1]
    tkernels.reset_launch_counts()
    got = run(dev)
    counts = tkernels.launch_counts()
    for (_, a), (_, b) in zip(got, run("cpu")):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert counts["field_fwd"] == 0 and counts["encode_bwd"] == 3
    assert counts["encode_fwd"] == 3
    assert counts["mlp_fwd"] == 3 * (2 if app == "nerf" else 1)


def _leaves(tree, prefix=""):
    """{path: leaf} of a param tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def _plain_wrappers(monkeypatch):
    """``apply_field``'s field and MLP wrappers swapped for their plain
    versions: autograd through plain PyTorch ops on the card."""
    from repro_torch.kernels.fused_mlp.ref import mlp_ref

    def field(points, tables, w, grid_cfg, mlp_cfg, table_scales=None):
        return field_ref(points, tables, w, grid_cfg, mlp_cfg, table_scales)
    monkeypatch.setattr(fields.ff_ops, "field", field)
    monkeypatch.setattr(fields.mlp_ops, "mlp", mlp_ref)


def _falls(rows):
    losses = [loss for _, loss in rows]
    return bool(np.isfinite(losses).all()) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_unfused_route_trains_at_table1_width_on_card(dev):
    """Table-I nerf on the unfused route: the first step's gradients
    against the fused route's on the card (within TRAIN_PARITY_TOL of each
    leaf's max, none all zero), and 8 steps of ``train_field(fused=False)``
    whose loss falls, launching encode_fwd, mlp_fwd and encode_bwd and
    never field_fwd."""
    cfg, init, make_batch = _nerf_train_case("table1")
    params, batch = init(dev), make_batch(0, dev)
    grads = {f: _leaves(tloop.value_and_grad(
        lambda p, b, f=f: ttrain.field_loss(p, cfg, b, fused=f), params,
        batch)[1]) for f in (True, False)}
    for path, g in grads[False].items():
        assert float(grads[True][path].abs().max()) > 0, path
        assert _rel_err(g, grads[True][path]) <= TRAIN_PARITY_TOL, path
    tkernels.reset_launch_counts()
    rows = _losses(cfg, fused=False, params=params,
                   **{**_train_kw("table1", dev), "steps": 8})
    counts = tkernels.launch_counts()
    assert _falls(rows), rows
    assert counts["field_fwd"] == 0 and min(
        counts[k] for k in ("encode_fwd", "mlp_fwd", "encode_bwd")) > 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("app,steps", [("nerf", 32), ("gia", 16),
                                       ("nsdf", 16), ("nvr", 16)])
def test_apps_train_at_table1_width_on_card(dev, app, steps):
    """Each Table-I app at its published width (gia: 2 GiB of tables)
    through ``train_field`` (TrainEngine; chunks of 8; 4096 points or rays
    a step): the loss falls; field_fwd, encode_fwd (the backward's
    recomputed features), encode_bwd and, for nerf, mlp_fwd launch every
    step, composite_fwd never (the loss composites in plain ops)."""
    cfg = fields.make_field_config(app, "hash")
    init = fields.init_field(cfg, torch.Generator().manual_seed(0), dev)
    tkernels.reset_launch_counts()
    rows = _losses(cfg, params=init,
                   **{**_train_kw("table1", dev), "steps": steps})
    counts = tkernels.launch_counts()
    assert _falls(rows), rows
    for k in ["field_fwd", "encode_fwd", "encode_bwd"] + (
            ["mlp_fwd"] if app == "nerf" else []):
        assert counts[k] >= steps, (k, counts)
    assert counts["composite_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["gia"])
def test_first_step_grads_match_plain_at_table1_width_on_card(dev, app,
                                                               monkeypatch):
    """The first training step's gradient of every leaf at Table-I width,
    the kernels (encode_bwd once) against the plain versions on the card
    (no kernel launched): within TRAIN_PARITY_TOL of the leaf's max, which
    is not 0. From the initial params: at trained ones gradients can be
    exactly 0 (nerf's density collapses), so they would compare nothing.
    nerf's first step at Table-I width against a plain reference is the
    ``nerf_hash.train_32k_rays`` cell's ``correct``."""
    cfg = fields.make_field_config(app, "hash")
    params = fields.init_field(cfg, torch.Generator().manual_seed(0), dev)
    batch = ttrain.make_batch(cfg, ttrain.batch_generator(0, 0, dev),
                              T1_BATCH, scenes.default_camera(),
                              gt_samples=T1_GT)

    def loss_fn(p, b):
        return ttrain.field_loss(p, cfg, b)
    tkernels.reset_launch_counts()
    got = _leaves(tloop.value_and_grad(loss_fn, params, batch)[1])
    assert tkernels.launch_counts()["encode_bwd"] == 1
    _plain_wrappers(monkeypatch)
    tkernels.reset_launch_counts()
    ref = _leaves(tloop.value_and_grad(loss_fn, params, batch)[1])
    assert not any(tkernels.launch_counts().values())
    for path, g in got.items():
        assert float(ref[path].abs().max()) > 0, path
        assert _rel_err(g, ref[path]) <= TRAIN_PARITY_TOL, path


@pytest.mark.cuda
def test_trained_nerf_frame_beats_its_init_on_card(dev):
    """Table-I nerf trained 32 steps on the card and the params its
    training started from, in one engine: a 32x32 frame of each from the
    training camera against the analytic volume's pixels (64 samples). The
    trained frame's MSE is the lower, and the serving kernels launch."""
    cfg = fields.make_field_config("nerf", "hash")
    init = fields.init_field(cfg, torch.Generator().manual_seed(0), dev)
    trained, _ = ttrain.train_field(
        cfg, params=init, **{**_train_kw("table1", dev), "steps": 32})
    engine = RenderEngine(pipeline.RenderSettings(
        tile_pixels=T1_TILE, n_samples=T1_SAMPLES), device=dev)
    engine.add_scene("trained", cfg, trained)
    engine.add_scene("untrained", cfg, init)
    engine.warmup()
    cam = scenes.default_camera(32, 32)
    tkernels.reset_launch_counts()
    frames = {n: engine.render_frame(n, cam) for n in ("trained",
                                                       "untrained")}
    counts = tkernels.launch_counts()
    o, d = render.make_rays(cam, torch.arange(32 * 32, device=dev))
    gt = scenes.gt_render_rays(o, d, n_samples=T1_GT).reshape(
        32, 32, 3).cpu().numpy()
    mse = {n: float(((f - gt) ** 2).mean()) for n, f in frames.items()}
    assert np.isfinite(list(mse.values())).all() \
        and mse["trained"] < mse["untrained"], mse
    for k in ("field_fwd", "mlp_fwd", "composite_fwd"):
        assert counts[k] > 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compressed_training_keeps_what_it_does_not_send_on_card(dev,
                                                                 scheme):
    """Table-I nerf, 16 steps with its table gradient compressed (top-k 5%
    or int8) under error feedback: the loss falls, and on step 1's
    gradient with the feedback step 0 left (not 0), kept + efb_new equals
    g + efb_old: nothing is lost (exactly for top-k; int8 within 1e-6 of
    the max: one f32 rounding of acc - deq and one of the sum)."""
    cfg, _, make_batch = _nerf_train_case("table1")
    rows, first = [], {}

    def on_metrics(i, r, st):
        rows.append((i, r["loss"]))
        if i == 0:
            first.update(params=_clone(st["params"]),
                         efb=st["efb"]["grid"].clone())
    ttrain.train_field(cfg, compression=scheme, compression_topk=0.05,
                       on_metrics=on_metrics,
                       **{**_train_kw("table1", dev), "steps": 16})
    assert _falls(rows), rows
    _, g = tloop.value_and_grad(lambda p, b: ttrain.field_loss(p, cfg, b),
                                first["params"], make_batch(1, dev))
    kept, efb_new = (compression.compress_topk(g["grid"], first["efb"], 0.05)
                     if scheme == "topk"
                     else compression.compress_int8(g["grid"], first["efb"]))
    assert float(first["efb"].abs().max()) > 0
    assert _rel_err(kept + efb_new, g["grid"] + first["efb"]) <= (
        0.0 if scheme == "topk" else 1e-6)


# train_field's default occupancy threshold; the refresh's bits against
# the plain versions' agree but for cells within OCC_EPS of it (relative)
OCC_THRESHOLD, OCC_EPS = 0.01, 1e-3


@pytest.mark.cuda
def test_occupancy_refresh_in_training_matches_plain_on_card(dev,
                                                             monkeypatch):
    """Table-I nerf, 32 steps with a 64^3 occupancy grid built at the
    first chunk end and refreshed at the next three: the attached grid is
    the last refresh's; field_fwd's densities at the cell centres within
    TOL (relative) of the plain versions'; the last refresh recomputed by
    the plain versions (no kernel launched) on the same params and previous
    grid has its densities within TOL and its bits but for cells within
    OCC_EPS of the threshold."""
    cfg = fields.make_field_config("nerf", "hash")
    refreshes = []
    build, update = occupancy.build_occupancy, occupancy.update_occupancy

    def rec_build(params, c, **kw):
        grid = build(params, c, **kw)
        refreshes.append((None, _clone(params), grid))
        return grid

    def rec_update(prev, params, c, **kw):
        grid = update(prev, params, c, **kw)
        refreshes.append((prev, _clone(params), grid))
        return grid
    with monkeypatch.context() as m:
        m.setattr(occupancy, "build_occupancy", rec_build)
        m.setattr(occupancy, "update_occupancy", rec_update)
        trained, _ = ttrain.train_field(
            cfg, occupancy_res=T1_OCC_RES,
            **{**_train_kw("table1", dev), "steps": 32})
    assert len(refreshes) == 4
    prev, params, grid = refreshes[-1]
    assert torch.equal(trained["occupancy"]["bits"], grid["bits"])
    centers = occupancy.cell_centers(T1_OCC_RES, dev)
    fresh = occupancy.field_sigma(params, cfg, centers)
    with monkeypatch.context() as m:
        _plain_wrappers(m)
        tkernels.reset_launch_counts()
        plain = occupancy.update_occupancy(prev, params, cfg)
        fresh_ref = occupancy.field_sigma(params, cfg, centers)
        assert not any(tkernels.launch_counts().values())

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
    assert rel(fresh, fresh_ref) <= TOL
    assert rel(grid["sigma"], plain["sigma"]) <= TOL
    near = (plain["sigma"] - OCC_THRESHOLD).abs() <= OCC_EPS * OCC_THRESHOLD
    differ = occupancy.unpack_bits(grid["bits"]) \
        != occupancy.unpack_bits(plain["bits"])
    assert not bool((differ & ~near).any()), int(differ.sum())


@pytest.mark.cuda
def test_profiler_sees_the_phases_on_card(dev):
    """A served nerf tile under torch.profiler (CPU and CUDA activity):
    ``encode_mlp``, ``mlp``, ``raymarch`` and ``composite`` ranges, and the
    kernels' device events beneath them."""
    from repro_torch.obs.trace import annotate
    cfg = _enc_field("nerf", "hash")
    params = fields.to_device(_u11_params(cfg, 7), dev)
    tile = pipeline.make_tile_fn(cfg, pipeline.RenderSettings(
        tile_pixels=256, n_samples=8))
    cam = scenes.orbit_camera(16, 16, 0.0)
    ids = torch.arange(256, device=dev)
    tile(params, cam, ids)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tile(params, cam, ids)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert {"encode_mlp", "mlp", "raymarch", "composite"} <= names
    assert any("field_fwd" in n for n in names)
    assert annotate("x") is annotate("y")


def _traced_engine(dev, app, max_inflight):
    """A card engine serving one small ``app`` scene in 256-pixel tiles
    (nsdf: 4 sphere-tracing steps), warmed up."""
    cfg = _enc_field(app, "hash")
    settings = pipeline.RenderSettings(tile_pixels=256, n_samples=8,
                                       sphere_steps=4)
    engine = RenderEngine(settings, max_inflight=max_inflight, device=dev)
    engine.add_scene("a", cfg, _u11_params(cfg, 3))
    engine.warmup()
    return engine, scenes.orbit_camera(16, 16, 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "nsdf"])
def test_traced_tiles_nest_their_phases_and_submit_never_syncs(dev, app,
                                                               monkeypatch):
    """Four tiles submitted with nothing retired, untraced and then traced:
    ``submit`` calls no synchronize either way. Traced, every device
    interval of a request (its phases) lies inside that request's
    ``serve.tile`` interval, the tiles follow each other on the stream,
    and each phase interval has its host span."""
    from repro_torch.obs.trace import TRACER
    from repro_torch.serve import RenderRequest
    from repro_torch.serve import engine as eng_mod
    engine, cam = _traced_engine(dev, app, max_inflight=8)
    syncs = []

    def count_syncs():
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: syncs.append("device"))
        for cls in (torch.cuda.Event, torch.cuda.Stream):
            monkeypatch.setattr(cls, "synchronize",
                                lambda self: syncs.append(
                                    type(self).__name__))
        monkeypatch.setattr(eng_mod.Ticket, "is_ready", lambda self: False)
    try:
        for traced in (False, True):
            if traced:
                TRACER.clear()
                TRACER.enable()
            count_syncs()
            tickets = [engine.submit(RenderRequest("a", cam, np.arange(256)))
                       for _ in range(4)]
            monkeypatch.undo()
            assert syncs == [], (traced, syncs)
            engine.flush()
        spans = TRACER.spans_ns()
    finally:
        TRACER.disable()
        TRACER.clear()
    tiles = {sp.args["req"]: sp for sp in spans if sp.name == "serve.tile"}
    assert sorted(tiles) == [t.req for t in tickets]
    order = [tiles[t.req] for t in tickets]
    for a, b in zip(order, order[1:]):
        assert a.end <= b.start
    phases = [sp for sp in spans if sp.device is not None
              and sp.name != "serve.tile"]
    want = {"raymarch", "encode_mlp"} | (
        {"head", "mlp", "composite"} if app == "nerf" else set())
    assert want <= {sp.name for sp in phases}
    for sp in phases:
        tile = tiles[sp.args["req"]]
        assert tile.start <= sp.start <= sp.end <= tile.end, (sp, tile)
    host = {(sp.name, sp.args["req"]) for sp in spans if sp.device is None
            and sp.cat == "phase"}
    assert {(sp.name, sp.args["req"]) for sp in phases} == host


@pytest.mark.cuda
def test_device_intervals_line_up_with_the_profilers_kernels(dev):
    """Traced under ``torch.profiler`` (CUDA activity only, as the
    benchmark's device trace), each ``field_fwd`` kernel lies inside an
    ``encode_mlp`` device interval within 0.1 ms: the intervals are on the
    kineto events' clock. The timing events and the phases' ranges add no
    device event of their own."""
    from repro_torch.obs.trace import TRACER
    from repro_torch.serve import RenderRequest
    engine, cam = _traced_engine(dev, "nerf", max_inflight=2)
    torch.cuda.synchronize()
    TRACER.clear()
    TRACER.enable()
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for r in range(4):
                engine.submit(RenderRequest("a", cam, np.arange(256)))
            engine.flush()
            torch.cuda.synchronize()
        spans = TRACER.spans_ns()
        # each anchor's host bracket (ns), reported when a kernel lies off
        widths = {i: [a[2] for a in v] for i, v in TRACER._anchors.items()}
    finally:
        TRACER.disable()
        TRACER.clear()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == cuda and not ev.is_user_annotation()]
    names = {n for n, _, _ in events}
    assert not names & {"head", "encode_mlp", "raymarch", "composite",
                        "mlp", "serve.tile"}
    kernels = [e for e in events if "field_fwd" in e[0]]
    fields_iv = [sp for sp in spans if sp.name == "encode_mlp"
                 and sp.device is not None]
    assert len(kernels) == len(fields_iv) == 4
    for (_, s, e), iv in zip(sorted(kernels, key=lambda k: k[1]),
                             sorted(fields_iv, key=lambda i: i.start)):
        assert iv.start - 100_000 <= s <= e <= iv.end + 100_000, (
            s, e, iv, widths)


@pytest.mark.cuda
def test_traced_train_steps_order_their_phases_on_card(dev):
    """A traced chunk of a nerf training step on the card: each step's
    ``forward``, ``backward`` and ``adam`` device intervals follow each
    other on the stream."""
    from repro_torch.obs.trace import TRACER
    cfg = _enc_field("nerf", "hash")
    params = fields.to_device(_u11_params(cfg, 5), dev)
    step_fn = tloop.make_scanned_step(
        lambda p, b: torch.mean((fields.apply_field(
            p, cfg, b["x"], b["d"]) - 0.5) ** 2), toptim.AdamConfig(lr=1e-2))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(4096, 3, device=dev, generator=gen)
    d = torch.nn.functional.normalize(
        torch.rand(4096, 3, device=dev, generator=gen) - 0.5, dim=-1)
    engine = tloop.TrainEngine(tloop.EngineConfig(steps=3, chunk_steps=3),
                               step_fn, batch_fn=lambda s: {"x": x, "d": d})
    state = tloop.init_train_state(params)
    TRACER.clear()
    TRACER.enable()
    try:
        engine.run(state)
        spans = TRACER.spans_ns()
    finally:
        TRACER.disable()
        TRACER.clear()
    for step in range(3):
        iv = {sp.name: sp for sp in spans if sp.device is not None
              and sp.args.get("step") == step
              and sp.name in ("forward", "backward", "adam")}
        assert iv["forward"].end <= iv["backward"].start
        assert iv["backward"].end <= iv["adam"].start


def _annotate_calls(run):
    """Calls of ``obs.trace.annotate`` that ``run()`` makes, by phase name,
    counted through every module of the port that imported it."""
    from repro_torch.obs import trace
    real, n = trace.annotate, collections.Counter()

    def counting(name):
        n[name] += 1
        return real(name)
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.")
            and getattr(m, "annotate", None) is real]
    for m in mods:
        m.annotate = counting
    try:
        run()
    finally:
        for m in mods:
            m.annotate = real
    return n


@pytest.mark.cuda
def test_traced_serving_counts_every_event_at_table1_width_on_card(dev):
    """Two Table-I nerf scenes served in rounds of 20 requests of 4096
    random pixels, the process tracer off and on in turns (off, on, on,
    off, ...; 4 rounds each). Off, no event. On, each request's four
    serve.<phase> spans, its serve.tile device interval, and each phase it
    names (its annotate calls, counted with the tracer off) as a host span
    and a device interval, all carrying its req; serve.backpressure at
    most once a request past max_inflight. Under torch.profiler the
    encode_mlp, mlp, raymarch and composite ranges show."""
    from repro_torch.obs.trace import TRACER
    from repro_torch.serve import RenderRequest
    engine = RenderEngine(pipeline.RenderSettings(
        tile_pixels=T1_TILE, n_samples=T1_SAMPLES), device=dev)
    for s in range(2):
        engine.add_scene(f"scene{s}", *_table1("nerf", s, dev))
    engine.warmup()
    rng = np.random.default_rng(0)
    cams = [scenes.orbit_camera(256, 256, a) for a in (0.0, 2.1, 4.2)]
    window = [RenderRequest(f"scene{i % 2}", cams[i % 3],
                            rng.integers(0, 256 * 256, T1_TILE))
              for i in range(20)]

    def run_window():
        for r in window:
            engine.submit(r)
        engine.flush()
    want = {f"serve/serve.{ph}": len(window) for ph in SERVE_PHASES}
    want["device:serve/serve.tile"] = len(window)
    for ph, k in _annotate_calls(run_window).items():
        want[f"phase/{ph}"] = want[f"device:phase/{ph}"] = k
    try:
        for i in range(8):
            on = i % 4 in (1, 2)
            TRACER.clear()
            if on:
                TRACER.enable()
            run_window()
            TRACER.disable()
            evs = TRACER.events()
            if not on:
                assert evs == [], i
                continue
            counts = collections.Counter(f"{e['cat']}/{e['name']}"
                                         for e in evs)
            waits = [e["args"]["req"] for e in evs
                     if e["name"] == "serve.backpressure"]
            del counts["serve/serve.backpressure"]
            assert dict(counts) == want, i
            reqs = {e["args"].get("req") for e in evs}
            assert len(reqs) == len(window) and None not in reqs
            assert len(set(waits)) == len(waits) \
                <= len(window) - engine.max_inflight
    finally:
        TRACER.disable()
        TRACER.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_window()
    assert {"encode_mlp", "mlp", "raymarch", "composite"} <= {
        e.name for e in prof.events()}


@pytest.mark.cuda
def test_train_engine_snapshot_at_table1_width_on_card(dev):
    """Two chunks of 8 Table-I nerf steps with a metrics registry: its
    snapshot is valid against the schema and counts 16 train.steps, two
    train.step_s and two health.step_s.host0 observations (one a chunk),
    and no silent host."""
    from repro_torch.obs import export, metrics
    reg = metrics.Registry()
    ttrain.train_field(fields.make_field_config("nerf", "hash"),
                       steps=2 * T1_CHUNK, batch_size=T1_BATCH, seed=0,
                       chunk_steps=T1_CHUNK, gt_samples=T1_GT, device=dev,
                       metrics_registry=reg)
    snap = reg.snapshot()
    export.validate_snapshot(snap)
    assert snap["counters"].get("train.steps") == 2 * T1_CHUNK
    assert snap["histograms"]["train.step_s"]["count"] == 2
    assert snap["histograms"]["health.step_s.host0"]["count"] == 2
    assert snap["gauges"].get("health.silent_hosts") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("app,encoding,width", [
    *(("nvr", e, "small") for e in ("hash", "dense", "tiled")),
    *((a, e, "table1") for a in ("nerf", "nvr", "gia", "nsdf")
      for e in ("hash", "dense", "tiled"))])
def test_launcher_serves_on_card(dev, monkeypatch, app, encoding, width):
    """``serve_render`` on the card: small (nvr at 2^14 rows, 2 training
    steps, 3 requests of a 16x16 frame: one tile function), and every app
    and encoding at Table I's width (``log2_table_size=None``: gia's hash
    grid 2 GiB; 2 scenes of 16 training steps, 8 requests: scene 0's loss
    falls). Every request served, a finite p50 and Mpix/s, and the kernels
    of the app's path launched."""
    from repro_torch.launch.serve import serve_render
    histories = []
    real = ttrain.train_field

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        histories.append(out[1])
        return out
    monkeypatch.setattr(ttrain, "train_field", recording)
    tkernels.reset_launch_counts()
    if width == "small":
        st = serve_render(app, encoding, train_steps=2, n_requests=3,
                          tile_pixels=256, height=16, width=16,
                          device="cuda")
        assert st["n_requests"] == 3 and st["n_traces_total"] == 1
    else:
        st = serve_render(app, encoding, train_steps=16, n_requests=8,
                          seed=0, device=dev, log2_table_size=None)
        assert st["n_requests"] == 8 and _falls(histories[0]), histories
    counts = tkernels.launch_counts()
    assert np.isfinite(st["p50_ms"]) and np.isfinite(st["mpix_per_s"])
    for k in ["field_fwd", "encode_fwd", "encode_bwd"] + (
            ["mlp_fwd"] if app == "nerf" else []) + (
            ["composite_fwd"] if app in ("nerf", "nvr") else []):
        assert counts[k] > 0, (k, counts)


# the launcher's child: runs the module as ``python -m`` does, then writes
# its kernels' launch counts to a file
LAUNCH_CHILD = """
import json, runpy, sys
sys.path.insert(0, {src!r})
sys.argv = ["repro_torch.launch.serve"] + {argv!r}
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__",
                     alter_sys=True)
finally:
    from repro_torch import kernels
    with open({launches!r}, "w") as f:
        json.dump(kernels.launch_counts(), f)
"""
SERVE_PHASES = ("submit", "dispatch", "block", "slice")


@pytest.mark.cuda
@pytest.mark.parametrize("flags,kernels", [
    ([], ()), (["--app", "nerf", "--occupancy"], ("mlp_fwd", "composite_fwd")),
    (["--app", "nsdf", "--quant", "int8"], ("field_fwd_q",)),
    (["--shard"], ())], ids=["defaults", "nerf_occupancy", "nsdf_int8",
                             "shard"])
def test_launcher_module_serves_on_card(dev, tmp_path, flags, kernels):
    """``python -m repro_torch.launch.serve`` as a user starts it, in a
    child on the card: at its defaults (gia, hash, 2^14 tables, 150 steps,
    2 scenes, 8 requests), nerf culled, nsdf with int8 tables and
    ``--shard`` (its local mesh), each with ``--trace-out`` and
    ``--metrics-out``. Exit code 0; every stdout line one JSON object;
    ``served`` with 8 requests and a finite p50 and Mpix/s; one tile
    function per bucket and no leak; the snapshot valid against the
    schema; the trace a valid Chrome trace whose serve.submit, dispatch,
    block and slice events number what the histograms count (each > 0);
    and field_fwd, encode_fwd, encode_bwd and the run's own ``kernels``
    launched (counts written by the child at exit)."""
    from repro_torch.obs import export
    files = {k: str(tmp_path / f"{k}.json")
             for k in ("trace", "metrics", "launches")}
    argv = flags + ["--trace-out", files["trace"], "--metrics-out",
                    files["metrics"]]
    out = subprocess.run(
        [sys.executable, "-c", LAUNCH_CHILD.format(
            src=str(SRC), argv=argv, launches=files["launches"])],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()]
    assert all(isinstance(r, dict) for r in recs)
    events = {r["event"]: r for r in recs}
    served = events["served"]
    assert served["n_requests"] == 8 and np.isfinite(
        served["p50_ms"]) and np.isfinite(served["mpix_per_s"])
    with open(files["metrics"]) as f:
        snap = json.load(f)
    export.validate_snapshot(snap)
    with open(files["trace"]) as f:
        trace = json.load(f)
    export.validate_chrome_trace(trace)
    names = [e["name"] for e in trace["traceEvents"]]
    buckets = {k.rsplit(".bucket", 1)[1] for k in snap["histograms"]
               if ".bucket" in k}
    for ph in SERVE_PHASES:
        n_hist = sum(h["count"] for k, h in snap["histograms"].items()
                     if k.startswith(f"serve.{ph}_s.bucket"))
        assert names.count(f"serve.{ph}") == n_hist > 0, ph
    assert "bucket_leak" not in events and served["compiles"] == len(buckets)
    with open(files["launches"]) as f:
        counts = json.load(f)
    for k in ("field_fwd", "encode_fwd", "encode_bwd", *kernels):
        assert counts[k] > 0, (k, counts)


# each twin of examples/torch/ in a child at its defaults, which writes its
# kernels' launch counts to a file at exit
EXAMPLE_CHILD = """
import json, runpy, sys
sys.argv = [{script!r}]
try:
    runpy.run_path({script!r}, run_name="__main__")
finally:
    sys.path.insert(0, {src!r})
    from repro_torch import kernels
    with open({launches!r}, "w") as f:
        json.dump(kernels.launch_counts(), f)
"""
# The JAX examples' PSNRs at their defaults (seed 0) on the CPU
# (tools/jax_example_psnr.py): seed 1 gives 27.4 and 16.9 dB. The twins'
# random numbers are PyTorch's, so a twin lands within the JAX seeds'
# spread, bounded here at 1 dB. train_nerf's frame is all black in both
# packages (nerf's density collapses at lr 1e-2: a black frame's PSNR).
JAX_EXAMPLE_PSNR = {"quickstart": 27.7, "train_nerf": 16.9}
PSNR_LINE = re.compile(r"(?:reconstruction|novel-view) PSNR[^:]*: "
                       r"(-?[0-9.]+) dB")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernels", [
    ("quickstart", ("field_fwd", "encode_fwd", "encode_bwd")),
    ("train_nerf", ("field_fwd", "mlp_fwd", "encode_fwd", "encode_bwd",
                    "composite_fwd")),
    ("serve_render", ("field_fwd", "encode_fwd", "encode_bwd"))],
    ids=["quickstart", "train_nerf", "serve_render"])
def test_example_twin_on_card(dev, tmp_path, name, kernels):
    """Each twin of the JAX examples (``examples/torch/``) as a user runs
    it, in a child at its defaults on the card: quickstart's and
    train_nerf's PSNR within 1 dB of the JAX example's, serve_render's one
    ``served`` event with a finite p50 and Mpix/s; the kernels each runs
    launch."""
    script = str(REPO / "examples" / "torch" / f"{name}.py")
    launches = str(tmp_path / "launches.json")
    out = subprocess.run(
        [sys.executable, "-c", EXAMPLE_CHILD.format(
            script=script, src=str(SRC), launches=launches)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(launches) as f:
        counts = json.load(f)
    for k in kernels:
        assert counts[k] > 0, (k, counts)
    if name in JAX_EXAMPLE_PSNR:
        found = PSNR_LINE.findall(out.stdout)
        assert len(found) == 1, out.stdout[-2000:]
        assert abs(float(found[0]) - JAX_EXAMPLE_PSNR[name]) <= 1.0, found
    else:
        served = [json.loads(line) for line in out.stdout.splitlines()
                  if line.startswith("{") and '"served"' in line]
        assert len(served) == 1 and all(np.isfinite(served[0][k])
                                        for k in ("p50_ms", "mpix_per_s"))


def _card_mesh(dev, n=4):
    """n shards on the card: the one card repeated (the JAX tests' forced
    host devices), or n cards where there are that many."""
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    if torch.cuda.device_count() >= n:
        return make_local_mesh(n)
    return Mesh([torch.device("cuda", 0)] * n, ("data",))


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "table1"])
@pytest.mark.parametrize("occ", [False, True])
def test_sharded_engine_on_card_matches_unsharded(dev, occ, width):
    """A 32x32 nerf frame through the 4-shard engine on the card, small
    (2^14 rows, 4 levels; a 32^3 grid when culled) and at Table-I width (a
    64^3 grid), against the same sharded engine on the CPU (1e-4, with the
    same sample counts when culled at a quarter budget) and, where no
    shard drops a sample, the unsharded card engine (1e-6); each kernel of
    the path launches once per shard a tile. Culled with an all-occupied
    grid at the full budget, the sharded frame equals the dense sharded
    frame bit for bit."""
    from repro_torch.launch.mesh import Mesh
    if width == "small":
        (cfg, params), res = _occ_scene("nerf"), 32
    else:
        (cfg, params), res = _table1("nerf", 3, "cpu"), T1_OCC_RES
    dense = pipeline.RenderSettings(tile_pixels=1024, n_samples=32)
    settings = dense
    scene = params
    if occ:
        scene = occupancy.attach(params, _volume_grid(res))
        settings = dataclasses.replace(dense, occupancy=True,
                                       sample_budget=1024 * 32 // 4)
    cam = scenes.default_camera(32, 32)
    frames, stats = {}, {}
    cpu_mesh = Mesh([torch.device("cpu")] * 4, ("data",))
    for name, mesh, where in (("plain", None, torch.device("cuda", 0)),
                              ("sharded", _card_mesh(dev),
                               torch.device("cuda", 0)),
                              ("cpu", cpu_mesh, torch.device("cpu"))):
        eng = RenderEngine(settings, mesh=mesh, device=where)
        eng.add_scene("s", cfg, scene)
        eng.warmup()
        tkernels.reset_launch_counts()
        frames[name] = eng.render_frame("s", cam)
        counts = tkernels.launch_counts()
        shards = {"plain": 1, "sharded": 4, "cpu": 0}[name]
        for k in ("field_fwd", "mlp_fwd", "composite_fwd"):
            assert counts[k] == shards, (name, counts)
        stats[name] = eng.stats()
    np.testing.assert_allclose(frames["sharded"], frames["cpu"], rtol=TOL,
                               atol=TOL)
    if occ:
        for k in ("samples_total", "samples_dropped", "live_sample_frac"):
            assert stats["sharded"][k] == stats["cpu"][k], k
        assert stats["sharded"]["samples_total"] == 1024 * 32
        full = dataclasses.replace(settings, sample_budget=None)
        all_occ = occupancy.attach(params, occupancy.all_occupied(res,
                                                                  "cpu"))
        assert np.array_equal(
            _engine_frame(dev, cfg, all_occ, full, cam, _card_mesh(dev))[0],
            _engine_frame(dev, cfg, params, dense, cam, _card_mesh(dev))[0])
    if not occ or stats["sharded"]["samples_dropped"] == 0:
        np.testing.assert_allclose(frames["sharded"], frames["plain"],
                                   rtol=0, atol=SHARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["small", "table1"])
def test_sharded_replicas_share_the_cards_storage(dev, width):
    """On a mesh that repeats the card, every shard reads the stack's own
    tables: one data_ptr, no copy per shard, small and at Table-I width
    (gia's 2 GiB); the sharded frame within 1e-6 of the unsharded tile's."""
    from repro_torch.launch.mesh import Mesh
    cfg, params = _occ_scene("gia") if width == "small" \
        else _table1("gia", 10, dev)
    mesh = Mesh([torch.device("cuda", 0)] * 4, ("data",))
    settings = pipeline.RenderSettings(tile_pixels=256)
    eng = RenderEngine(settings, mesh=mesh, device=torch.device("cuda", 0))
    key = eng.add_scene("s", cfg, params)
    eng.warmup()
    fn = eng._buckets[key].fn
    stacked = eng._get_stacked(key)
    assert list(fn.replicas) == [torch.device("cuda", 0)]
    assert fn.replicas[torch.device("cuda", 0)]["grid"].data_ptr() \
        == stacked["grid"].data_ptr()
    cam = scenes.orbit_camera(32, 32, 0.9)
    want = pipeline.render_frame(fields.to_device(params, dev), cfg, cam,
                                 settings, device=dev).cpu().numpy()
    np.testing.assert_allclose(eng.render_frame("s", cam), want, rtol=0,
                               atol=SHARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("app,width", [("nerf", "small"), ("gia", "small"),
                                       ("nerf", "table1")])
def test_data_parallel_first_step_grads_on_card(dev, app, width):
    """The first step's loss and gradients on a 4-shard mesh on the card
    against one pass on the card, small (256 rays or points) and at Table-I
    width (4096 rays): the loss within 1e-6 of its size, every leaf within
    1e-5 of its max (f32 sums and atomics in another order); each shard
    launches the field kernel and encode_bwd once."""
    if width == "small":
        cfg, _ = _occ_scene(app)
        params = fields.init_field(cfg, torch.Generator().manual_seed(0),
                                   dev)
        batch = ttrain.make_batch(cfg, ttrain.batch_generator(0, 0, dev),
                                  256)
    else:
        cfg, init, make_batch = _nerf_train_case(width)
        params, batch = init(dev), make_batch(0, dev)

    def loss_fn(p, b):
        return ttrain.field_loss(p, cfg, b)
    l1, g1 = tloop.value_and_grad(loss_fn, params, batch)
    tkernels.reset_launch_counts()
    l4, g4 = tloop.data_parallel_grad_fn(loss_fn, _card_mesh(dev))(params,
                                                                   batch)
    counts = tkernels.launch_counts()
    assert counts["field_fwd"] == 4 and counts["encode_bwd"] == 4, counts
    assert abs(float(l4) - float(l1)) <= 1e-6 * abs(float(l1))
    for a, b in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g4)):
        assert b.device == a.device
        assert _rel_err(b, a) <= GRAD_TOL


@pytest.mark.cuda
def test_data_parallel_training_at_table1_width_on_card(dev):
    """16 steps of Table-I nerf data-parallel over 4 shards on the card
    (``train_field(mesh=)``, 4096 rays a step): the loss falls; field_fwd,
    mlp_fwd, encode_fwd and encode_bwd launch once a shard a step,
    composite_fwd never."""
    cfg, init, _ = _nerf_train_case("table1")
    tkernels.reset_launch_counts()
    rows = _losses(cfg, params=init(dev), mesh=_card_mesh(dev),
                   **{**_train_kw("table1", dev), "steps": 16})
    counts = tkernels.launch_counts()
    assert _falls(rows), rows
    for k in ("field_fwd", "mlp_fwd", "encode_fwd", "encode_bwd"):
        assert counts[k] == 4 * 16, (k, counts)
    assert counts["composite_fwd"] == 0


class _HostLost(Exception):
    """Raised by the elastic test's failure handler to stop the run."""


@pytest.mark.cuda
def test_elastic_recovery_at_table1_width_on_card(dev, tmp_path):
    """Table-I nerf on 4 shards (two hosts of two), a checkpoint every 8
    steps. Two uninterrupted 48-step runs give the run-to-run noise. In a
    third the second host beats at the first chunk end only, so at the
    step-15 chunk end the health stack's FailurePolicy emits a
    FailureEvent, which stops it; ``remesh_plan(2, 4, 1)`` is (2, 1, 2);
    ``recover`` restores the step-15 checkpoint onto 2 shards bit for bit,
    and the run goes on with grad_accum=2 (the same global batch) to step
    48, every loss within the resume bound of the uninterrupted run's."""
    from repro_torch.runtime import elastic
    from repro_torch.runtime.health import HeartbeatMonitor
    cfg, init, make_batch = _nerf_train_case("table1")
    mesh, steps, lost_at, every = _card_mesh(dev), 48, 15, 8
    kw = {**_train_kw("table1", dev), "mesh": mesh}
    a = [loss for _, loss in _losses(cfg, **kw)]
    noise = max(abs(x - y) for x, (_, y) in zip(a, _losses(cfg, **kw)))
    opt = toptim.AdamConfig(lr=1e-2)      # train_field's

    def loss_fn(p, b):
        return ttrain.field_loss(p, cfg, b)
    clock = [0.0]
    mon = HeartbeatMonitor(timeout_s=5.0, clock=lambda: clock[0])

    def beat(end, state):        # host0 drives the engine; host1 goes quiet
        clock[0] += 10.0
        mon.beat("host0")
        if end < lost_at:
            mon.beat("host1")
    events, saved = [], {}

    def lost(ev):
        events.append(ev)
        raise _HostLost

    def grab(i, row, state):
        if i == lost_at:
            saved.update({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in ckpt_store._flatten(state)})
    ck = str(tmp_path / "ckpt")
    engine = tloop.TrainEngine(
        tloop.EngineConfig(steps=steps, chunk_steps=T1_CHUNK, ckpt_dir=ck,
                           ckpt_every=every, host="host0"),
        tloop.make_scanned_step(loss_fn, opt, mesh=mesh),
        batch_fn=lambda i: make_batch(i, dev), monitor=mon,
        on_chunk_end=beat, on_event=lost)
    with pytest.raises(_HostLost):
        engine.run(tloop.init_train_state(init(dev)), on_metrics=grab)
    assert events and (events[0].kind, tuple(events[0].hosts),
                       events[0].step) == ("dead", ("host1",), lost_at)
    assert ckpt_store.latest_step(ck) == lost_at
    plan = elastic.remesh_plan(2, 4, 1)
    assert (plan.data, plan.model, plan.microbatch_multiplier) == (2, 1, 2)
    _, step_fn, state, step = elastic.recover(
        ck, tloop.init_train_state(init(dev)), plan, devices=mesh.devices,
        make_step=lambda m, rules: tloop.make_scanned_step(
            loss_fn, opt, grad_accum=plan.microbatch_multiplier, mesh=m,
            rules=rules))
    restored = dict(ckpt_store._flatten(state))
    assert step == lost_at and restored.keys() == saved.keys()
    for k, v in saved.items():
        assert (torch.equal(restored[k], v) if torch.is_tensor(v)
                else restored[k] == v), k
    resumed = []
    tloop.TrainEngine(
        tloop.EngineConfig(steps=steps, chunk_steps=T1_CHUNK, ckpt_dir=ck,
                           ckpt_every=every),
        step_fn, batch_fn=lambda i: make_batch(i, dev)).run(
        state, on_metrics=lambda i, r, st: resumed.append((i, r["loss"])))
    assert [i for i, _ in resumed] == list(range(lost_at + 1, steps))
    for i, x in resumed:
        assert abs(x - a[i]) <= _resume_bound(noise, a[i]), (i, x, a[i])


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["nerf", "nvr", "gia", "nsdf"])
def test_budget_matches_cuda(dev, app):
    """analysis/budget.py against CUDA for every kernel the app's hash
    config launches with f32 and int8 tables (the encode plans at this
    card's SM count): threads and shared memory per block, no local
    memory, and blocks_per_sm of the loaded kernel's registers against
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from repro_torch.analysis import budget
    from repro_torch.kernels import info
    from repro_torch.kernels.hashgrid.hashgrid import sm_count
    index = torch.cuda.current_device()
    for dtype in (torch.float32, torch.int8):
        for est in budget.estimate_config(app, "hash", dtype,
                                          sm_count(index)):
            cuda = info.kernel_info(est.instance, index)
            assert cuda["threads"] == est.threads, est.where
            assert (cuda["dynamic_smem"] + cuda["static_smem"]
                    == est.smem_bytes), est.where
            assert cuda["local_bytes"] == 0, est.where
            assert budget.blocks_per_sm(
                cuda["registers"], est.threads, est.smem_bytes) == cuda[
                "blocks_per_sm"], est.where


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,v", [(1, 64, 256), (37, 3584, 4096),
                                   (512, 512, 51865)])
def test_lm_unembed_bf16_gemm_matches_cpu(dev, n, d, v):
    """The LM unembedding on the card (one bf16 GEMM with an f32 output,
    ``torch.mm(out_dtype=)``) against the CPU's widened bf16 operands:
    the same products, summed in another order."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(n)
    x = torch.randn((n, d), generator=gen)
    table = torch.randn((v, d), generator=gen) * 0.02
    want = layers.unembed({"table": table}, x)
    got = layers.unembed({"table": table.to(dev)}, x.to(dev))
    assert got.dtype == torch.float32 and got.shape == (n, v)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-base",
                                  "qwen2-vl-72b", "h2o-danube-1.8b"])
def test_lm_serving_on_the_card_matches_cpu(dev, arch):
    """A reduced arch in f32 on the same params: prefill and 8 greedy
    decode steps on the card against the CPU within 1e-4 (the unembed
    widened to f32 on both: its bf16 rounding would turn f32 noise into
    whole bf16 steps), and no kernel of the port launches."""
    import dataclasses
    from repro_torch.common.param import tree_map
    from repro_torch.configs import registry
    from repro_torch.models import encdec, lm
    from repro_torch.parallel import api
    from torch_lm_f32 import f32_unembed   # tests/ is on the path
    cfg = dataclasses.replace(registry.reduced_config(arch),
                              act_dtype="float32")
    mod = encdec if cfg.is_encdec else lm
    p_cpu = api.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 24)))
    emb = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                           .astype(np.float32))
    tkernels.reset_launch_counts()
    outs = []
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda a: a.to(d), p_cpu)
        batch = {"tokens": toks[:, :16].to(d)}
        if cfg.is_encdec:
            batch["enc_embeddings"] = emb.to(d)
        if cfg.frontend == "vision":
            batch = {"embeddings": emb.to(d)}
        cache = api.make_cache(cfg, 2, 24, enc_len=16 if cfg.is_encdec
                               else 0, device=d)
        with f32_unembed():
            logits, cache = mod.prefill(p, cfg, batch, cache)
            steps = [logits]
            for i in range(8):
                logits, cache = mod.decode_step(
                    p, cfg, toks[:, 16 + i:17 + i].to(d), 16 + i, cache)
                steps.append(logits)
        outs.append(torch.stack(steps).cpu())
    torch.testing.assert_close(outs[1], outs[0], atol=TOL, rtol=TOL)
    assert not any(tkernels.launch_counts().values())


@pytest.mark.cuda
def test_lm_full_width_serves_in_bf16_when_only_bf16_fits(dev, capsys):
    """qwen3-32b at its published config: 131 GB in f32, 65.5 GB in bf16.
    ``init_params`` refuses the f32 tree before drawing, and ``serve_lm``
    (params drawn in bf16, no f32 master) serves it; jamba-v0.1-52b
    (103 GB in bf16) is refused even in bf16."""
    import json
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.parallel import api
    torch.cuda.empty_cache()
    cfg = registry.get_config("qwen3-32b")
    with pytest.raises(MemoryError, match="qwen3-32b: its params take"):
        api.init_params(cfg, device=dev)
    with pytest.raises(MemoryError, match="in bfloat16"):
        api.init_params(registry.get_config("jamba-v0.1-52b"), device=dev,
                        compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    capsys.readouterr()
    serve.serve_lm("qwen3-32b", reduced=False, batch=1, prompt_len=16,
                   gen_len=2, device=dev)
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["event"] for r in recs] == ["lm_served", "lm_sample"]
    peak = torch.cuda.max_memory_allocated(dev)
    assert api.param_bytes(cfg, torch.bfloat16) <= peak < \
        api.param_bytes(cfg, torch.bfloat16) + 8 * 10 ** 9
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b",
                                  "mamba2-2.7b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_lm_train_step_on_the_card_matches_cpu(dev, arch):
    """A reduced arch in f32 on the same params (chunked attention in 4
    query blocks, danube's keys sliced): the loss and every gradient leaf
    on the card against the CPU, then 3 train steps' losses and grad
    norms, within 1e-4 (the unembed widened to f32 on both); no kernel of
    the port launches."""
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.configs import registry
    from repro_torch.models import encdec, lm
    from repro_torch.parallel import api
    from torch_lm_f32 import f32_unembed   # tests/ is on the path
    cfg = registry.reduced_config(arch)
    ch = {"act_dtype": "float32", "attn_q_chunk": 4}
    if cfg.swa_window is not None:
        ch["swa_window"] = 4
    cfg = dataclasses.replace(cfg, **ch)
    mod = encdec if cfg.is_encdec else lm
    p_cpu = api.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 256, (4, 2, 17)))
    emb = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model))
                           .astype(np.float32))
    tkernels.reset_launch_counts()
    outs = []
    for d in (torch.device("cpu"), dev):
        def batch(i):
            b = {"tokens": toks[i, :, :16].to(d),
                 "labels": toks[i, :, 1:].to(d)}
            if cfg.is_encdec:
                b = {"tokens": toks[i, :, :16].to(d),
                     "enc_embeddings": emb.to(d)}
            if cfg.frontend == "vision":
                b["embeddings"] = emb.to(d)
            return b
        p = tree_map(lambda a: a.to(d, copy=True), p_cpu)
        with f32_unembed():
            loss, grads = tloop.value_and_grad(
                lambda q, b: mod.loss_fn(q, cfg, b)[0], p, batch(0))
            step, _ = api.make_train_step(cfg)
            state = api.make_train_state(p)
            curve = []
            for i in range(1, 4):
                state, m = step(state, batch(i))
                curve.append(torch.stack([m["loss"], m["grad_norm"]]))
        outs.append([loss] + tree_leaves(grads) + [torch.stack(curve)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got.cpu(), want, atol=TOL, rtol=TOL)
    assert not any(tkernels.launch_counts().values())


@pytest.mark.cuda
def test_lm_unembed_backward_on_the_card(dev):
    """The card's unembedding backward (bf16 GEMMs of the cotangent
    rounded to bf16) against the CPU's f32 autograd of the widened
    operands: each gradient within 1% of its max (one bf16 rounding)."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((300, 512), generator=gen)
    table = torch.randn((4096, 512), generator=gen) * 0.02
    g = torch.randn((300, 4096), generator=gen)
    grads = []
    for d in (torch.device("cpu"), dev):
        xd = x.to(d).requires_grad_(True)
        td = table.to(d).requires_grad_(True)
        out = layers.unembed({"table": td}, xd)
        assert out.dtype == torch.float32
        grads.append(torch.autograd.grad(out, (xd, td), g.to(d)))
    for got, want in zip(grads[1], grads[0]):
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_lm_train_state_fit_check_on_the_card(dev):
    """olmoe-1b-7b's train state (6.92 B params x 16 bytes and its bf16
    copy, 124.6 GB) is refused before anything is drawn;
    h2o-danube-1.8b's (33 GB) passes the check."""
    from repro_torch.configs import registry
    from repro_torch.parallel import api
    torch.cuda.empty_cache()
    tc = api.TrainConfig()
    before = torch.cuda.memory_allocated(dev)
    with pytest.raises(MemoryError, match="olmoe-1b-7b: its train state"):
        api.init_params(registry.get_config("olmoe-1b-7b"), device=dev,
                        train_cfg=tc)
    assert torch.cuda.memory_allocated(dev) == before
    api.check_fits(registry.get_config("h2o-danube-1.8b"), dev,
                   train_cfg=tc)


def _lm_card_mesh(dev, shape):
    from repro_torch.launch.mesh import Mesh
    return Mesh(np.array([dev] * (shape[0] * shape[1]), dtype=object)
                .reshape(shape), ("data", "model"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_lm_sharded_step_and_decode_on_the_card(dev, arch):
    """The LM sharding on ``[cuda:0] * 4`` as (2, 2) (whisper: tinydp, the
    batch over both axes): a reduced arch in f32, 3 sharded train steps'
    losses and every param against the unsharded steps on the card, then
    the sharded prefill and 4 decode steps' logits, within 1e-5; no kernel
    of the port launches."""
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.parallel import api, sharded
    from torch_lm_f32 import f32_unembed   # tests/ is on the path
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.reduced_config(arch),
                              act_dtype="float32")
    mesh = _lm_card_mesh(dev, (2, 2))
    rules = rule_preset("tinydp" if cfg.is_encdec else "baseline")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 256, (4, 4, 21))).to(dev)
    emb = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model))
                           .astype(np.float32)).to(dev)

    def batch(i):
        if cfg.is_encdec:
            return {"tokens": toks[i, :, :16], "enc_embeddings": emb}
        return {"tokens": toks[i, :, :16], "labels": toks[i, :, 1:17]}
    tkernels.reset_launch_counts()
    enc = 16 if cfg.is_encdec else 0
    outs = []
    with f32_unembed():
        for m in (None, mesh):
            params = (api.init_params(cfg, 5, device=dev) if m is None
                      else api.init_params(cfg, 5, m, rules))
            step, _ = api.make_train_step(cfg, m, rules if m else None)
            state = api.make_train_state(params)
            losses = []
            for i in range(3):
                state, met = step(state, batch(i))
                losses.append(met["loss"])
            params = (api.init_params(cfg, 5, device=dev) if m is None
                      else api.init_params(cfg, 5, m, rules))
            pre, info = api.make_prefill_step(
                cfg, m, rules if m else None, capacity=20, batch_size=4,
                enc_len=enc)
            dec, _ = api.make_decode_step(cfg, m, rules if m else None,
                                          capacity=20, batch_size=4,
                                          enc_len=enc)
            cache = (api.make_cache(cfg, 4, 20, enc, device=dev)
                     if m is None else
                     api.make_cache(cfg, 4, 20, enc, shardings=info["cache"]))
            b = {"tokens": toks[3, :, :16]}
            if cfg.is_encdec:
                b["enc_embeddings"] = emb
            lg, cache = pre(params, b, cache)
            logits = [lg]
            for i in range(4):
                lg, cache = dec(params, cache, toks[3, :, 16 + i:17 + i],
                                16 + i)
                logits.append(lg)
            outs.append((torch.stack(losses), [
                sharded.gather(l, dev) for l in
                toptim.tree_leaves(state["params"])], logits))
    (l1, p1, g1), (l2, p2, g2) = outs
    torch.testing.assert_close(l2, l1, atol=1e-5, rtol=0)
    for a, b in zip(p2 + g2, p1 + g1):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert not any(tkernels.launch_counts().values())


@pytest.mark.cuda
def test_lm_sharded_recovery_on_the_card(dev, tmp_path):
    """A reduced danube train state saved on ``[cuda:0] * 4`` as (4, 1)
    recovers onto the (2, 1) plan of two survivors bit for bit, sharded on
    the new mesh, and takes one more step."""
    from repro_torch.common.partitioning import DEFAULT_RULES
    from repro_torch.configs import registry
    from repro_torch.parallel import api, sharded
    from repro_torch.runtime import elastic
    cfg = dataclasses.replace(registry.reduced_config("h2o-danube-1.8b"),
                              act_dtype="float32")
    mesh = _lm_card_mesh(dev, (4, 1))
    state = api.make_train_state(api.init_params(cfg, 0, mesh,
                                                 DEFAULT_RULES))
    step, _ = api.make_train_step(cfg, mesh, DEFAULT_RULES)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8, 17))).to(dev)
    state, _ = step(state, {"tokens": toks[0]})
    ckpt_store.save(state, 1, tmp_path)
    plan = elastic.remesh_plan(2, 4, 1)
    mesh2, step_fn, got, at = elastic.recover(
        tmp_path, cfg, plan, devices=[dev] * 2,
        make_step=lambda c, m, r: api.make_train_step(c, m, r)[0])
    assert at == 1 and mesh2.shape == {"data": 2, "model": 1}
    for a, b in zip(toptim.tree_leaves(got["params"]),
                    toptim.tree_leaves(state["params"])):
        assert a.sharding.mesh is mesh2
        assert torch.equal(sharded.gather(a, dev), sharded.gather(b, dev))
    got, m = step_fn(got, {"tokens": toks[1]})
    assert got["opt"].step == 2 and torch.isfinite(m["loss"])


# ------------------------------------------ Mamba-2's intra-chunk SSD
def _ssd_leaves(dev, b, nc, q, h, p, g, seed, dt_scale=1.0):
    """Leaves (CB, cums, dtc, xc) of the intra-chunk term on ``dev``, as
    ``ssd_chunked`` makes them: C.B of bf16 C and B (d_state 16) as a bf16
    einsum, dt = softplus(N(-1, 1)) * ``dt_scale``, A = -exp(U(0, log 16))
    as Mamba-2 draws it, cums the within-chunk cumsum of dt A; x N(0, 1)
    in bf16."""
    rng = np.random.default_rng(seed)

    def bf16(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev, torch.bfloat16)
    C, B = bf16((b, nc, q, g, 16), 0.5), bf16((b, nc, q, g, 16), 0.5)
    CB = torch.einsum("bcigm,bcjgm->bcijg", C, B)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(-1.0, 1.0, (b, nc, q, h)).astype(np.float32))) * dt_scale
    A = -torch.exp(torch.from_numpy(
        rng.uniform(0.0, np.log(16.0), h).astype(np.float32)))
    cums = torch.cumsum(dt * A, dim=2)
    return [t.to(dev).requires_grad_() for t in
            (CB, cums, dt, bf16((b, nc, q, h, p)))]


def _within_bf16_rounding(got, want):
    """Within one bf16 step of each other (2^-7 of the value), beside the
    f32 sums' other order (1e-4 of the largest value)."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7,
                               atol=1e-4 * float(want.abs().max()))


# (b, nc, q, heads, head dim, groups): q in {16, 64, 256}, rep = heads /
# groups in {1, 8}, head dim in {16, 32, 64} (every head dim the kernels
# take); then granite-4.0-h-small's layer
SSD_SHAPES = [(1, 2, q, 2 * rep, p, 2) for q in (16, 64, 256)
              for rep in (1, 8) for p in (16, 32, 64)] + [
                  (1, 2, 256, 128, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_fwd_matches_plain(dev, shape):
    """``ssd_intra_fwd`` (one launch) against the plain term on the card:
    y within one bf16 rounding (the same bf16 products m, summed in f32
    in another order than cuBLAS's)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref
    leaves = [t.detach() for t in _ssd_leaves(dev, *shape, seed=3)]
    tkernels.reset_launch_counts()
    got = ssd_ops.ssd_intra(*leaves)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["ssd_intra_fwd"] == 1
    _within_bf16_rounding(got, ssd_intra_ref(*leaves))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_bwd_matches_autograd(dev, shape):
    """Every input's gradient from ``ssd_intra_bwd`` against plain
    autograd of the plain term on the card, each within 1e-2 of its
    largest value (autograd rounds dM to bf16 before its products, the
    kernel keeps it in f32), and against the kernel's f32 twin
    (``ref.ssd_intra_bwd_ref``) to f32 order (dCB and dx to one bf16
    rounding); the same bits on a second run (no atomics)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_bwd_ref, ssd_intra_ref
    leaves = _ssd_leaves(dev, *shape, seed=4)
    dy = torch.randn(leaves[3].shape, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(torch.bfloat16)
    tkernels.reset_launch_counts()
    runs = [torch.autograd.grad(ssd_ops.ssd_intra(*leaves), leaves, dy)
            for _ in range(2)]
    torch.cuda.synchronize()
    counts = tkernels.launch_counts()
    assert (counts["ssd_intra_fwd"], counts["ssd_intra_bwd"]) == (2, 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    got = runs[0]
    want = torch.autograd.grad(ssd_intra_ref(*leaves), leaves, dy)
    twin = ssd_intra_bwd_ref(dy, *[t.detach() for t in leaves])
    for name, g_, w, t in zip(("CB", "cums", "dt", "x"), got, want, twin):
        scale = float(w.float().abs().max())
        err = float((g_.float() - w.float()).abs().max())
        assert torch.isfinite(g_).all() and err <= 1e-2 * scale, \
            (name, err, scale)
        if t.dtype == torch.float32:
            torch.testing.assert_close(
                g_, t, rtol=0, atol=1e-4 * float(t.abs().max()))
        else:
            _within_bf16_rounding(g_, t)


@pytest.mark.cuda
def test_ssd_overflowing_segments_give_no_nan_on_the_card(dev):
    """dt large enough that exp(cums_i - cums_j) above the diagonal
    overflows f32: the kernels never take it, so the forward and every
    gradient stay finite, and the forward still matches the plain term."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_ref
    leaves = _ssd_leaves(dev, 1, 2, 64, 16, 64, 2, seed=5, dt_scale=50.0)
    cums = leaves[1].detach()
    assert float((cums[:, :, :1] - cums[:, :, -1:]).max()) > 89.0
    y = ssd_ops.ssd_intra(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.ones_like(y))
    assert torch.isfinite(y).all()
    assert all(bool(torch.isfinite(g_).all()) for g_ in grads)
    _within_bf16_rounding(y, ssd_intra_ref(*[t.detach() for t in leaves]))


@pytest.mark.cuda
def test_ssd_kernels_launch_in_a_granite_train_step(dev):
    """A reduced granite-4.0-h-small train step in bf16 under full remat
    (head dim 16 and d_state 16, so the kernels take it): each of the nine
    Mamba-2 layers launches ``ssd_intra_fwd`` and ``ssd_inter_fwd`` twice
    (the forward and the recompute) and ``ssd_intra_bwd`` and
    ``ssd_inter_bwd`` once, and the step's loss is finite."""
    from repro_torch.configs import registry
    from repro_torch.parallel import api
    cfg = registry.reduced_config("granite-4.0-h-small")
    cfg = dataclasses.replace(cfg, act_dtype="bfloat16", remat="full",
                              ssm=dataclasses.replace(cfg.ssm, head_dim=16))
    mamba = sum(cfg.layer_kind(l) != "attn" for l in range(cfg.n_layers))
    step, _ = api.build_train_step(cfg)
    state = api.make_train_state(api.init_params(cfg, 0, device=dev))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 33))).to(dev)
    tkernels.reset_launch_counts()
    state, metrics = step(state, {"tokens": toks[:, :32],
                                  "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    counts = tkernels.launch_counts()
    assert mamba == 9
    assert cfg.ssm.d_state == 16
    assert (counts["ssd_intra_fwd"], counts["ssd_intra_bwd"]) == \
        (2 * mamba, mamba)
    assert (counts["ssd_inter_fwd"], counts["ssd_inter_bwd"]) == \
        (2 * mamba, mamba)
    assert torch.isfinite(metrics["loss"])


# ------------------------------------------ Mamba-2's inter-chunk SSD
def _inter_leaves(dev, b, nc, q, h, p, g, n, seed):
    """Leaves (cums, dtc, xc, Bc, Cc) of the inter-chunk term on ``dev`` as
    ``ssd_chunked`` makes them: dt = softplus(N(-1, 1)), A = -exp(U(0, log
    16)) as Mamba-2 draws it, cums the within-chunk cumsum of dt A; x, B
    and C bf16 views of one (b, nc q, h p + 2 g n) tensor, x N(0, 1), B
    and C N(0, 1/4), as the in-projection's split gives them."""
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, nc * q, h * p + 2 * g * n))
    conv[..., h * p:] *= 0.5
    conv = torch.from_numpy(conv.astype(np.float32)).to(dev, torch.bfloat16)
    conv.requires_grad_()
    x, B, C = torch.split(conv, [h * p, g * n, g * n], dim=-1)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(-1.0, 1.0, (b, nc, q, h)).astype(np.float32))).to(dev)
    A = -torch.exp(torch.from_numpy(
        rng.uniform(0.0, np.log(16.0), h).astype(np.float32))).to(dev)
    cums = torch.cumsum(dt * A, dim=2).detach().requires_grad_()
    dt.requires_grad_()
    return [cums, dt, x.reshape(b, nc, q, h, p),
            B.reshape(b, nc, q, g, n), C.reshape(b, nc, q, g, n)], conv


def _within_a_bf16_step_of_max(got, want, name=""):
    """The largest difference at most one bf16 step at want's largest
    magnitude (2^(floor(log2 max) - 7))."""
    want = want.float()
    top = float(want.abs().max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    err = float((got.float() - want).abs().max())
    assert torch.isfinite(got).all() and err <= step, (name, err, step, top)


# (b, nc, q, heads, head dim, groups, d_state): granite-4.0-h-small's
# layer, mamba2-2.7b's chunk of 128 (80 heads), jamba's d_state 16 at its
# chunk of 64, two groups at head dims 32 and 16 (a chunk of 16 under the
# 64 positions an inter_dm block takes), a chunk of 48 (a partial block)
INTER_SHAPES = [(2, 32, 256, 128, 64, 1, 128), (1, 4, 128, 80, 64, 1, 128),
                (1, 4, 64, 16, 64, 1, 16), (1, 3, 64, 16, 32, 2, 128),
                (1, 2, 16, 8, 16, 2, 16), (2, 2, 48, 4, 32, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INTER_SHAPES)
def test_ssd_inter_fwd_matches_plain(dev, shape):
    """``ssd_inter_fwd`` (one call) against the plain term on the card:
    y_inter and the final state within one bf16 step of their largest
    value (the chunk states' and y_inter's f32 sums run in another order
    than cuBLAS's), and the states before each chunk and the final state
    bit for bit the plain loop's on the kernels' own chunk states."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd as ssd_launch
    from repro_torch.kernels.ssd.ref import ssd_inter_ref
    leaves = [t.detach() for t in _inter_leaves(dev, *shape, seed=3)[0]]
    tkernels.reset_launch_counts()
    y, state = ssd_ops.ssd_inter(*leaves)
    torch.cuda.synchronize()
    assert tkernels.launch_counts()["ssd_inter_fwd"] == 1
    want_y, want_state = ssd_inter_ref(*leaves)
    _within_a_bf16_step_of_max(y, want_y, "y")
    _within_a_bf16_step_of_max(state, want_state, "state")
    _, final, prev, states = ssd_launch.ssd_inter_fwd_cuda(*leaves)
    decay = torch.exp(leaves[0][:, :, -1]).to(torch.bfloat16)
    s = torch.zeros_like(final)
    for c in range(shape[1]):
        assert torch.equal(prev[:, c], s), c
        s = s * decay[:, c, :, None, None] + states[:, c]
    assert torch.equal(final, s)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INTER_SHAPES)
def test_ssd_inter_bwd_matches_autograd(dev, shape):
    """Every input's gradient from ``ssd_inter_bwd`` (with a gradient of
    the final state too) against autograd through the plain term on the
    card and against the kernels' twin (``ref.ssd_inter_bwd_ref``), each
    within one bf16 step of its largest value; the same bits on a second
    run (no atomics)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_inter_bwd_ref, ssd_inter_ref
    leaves, conv = _inter_leaves(dev, *shape, seed=4)
    b, nc, q, h, p, g, n = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    dy = torch.randn((b, nc, q, h, p), generator=gen,
                     device=dev).to(torch.bfloat16)
    ds = torch.randn((b, h, p, n), generator=gen,
                     device=dev).to(torch.bfloat16)
    ins = [leaves[0], leaves[1], conv]
    tkernels.reset_launch_counts()
    runs = [torch.autograd.grad(ssd_ops.ssd_inter(*leaves), ins, (dy, ds))
            for _ in range(2)]
    torch.cuda.synchronize()
    counts = tkernels.launch_counts()
    assert (counts["ssd_inter_fwd"], counts["ssd_inter_bwd"]) == (2, 2)
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    want = torch.autograd.grad(ssd_inter_ref(*leaves), ins, (dy, ds))
    got = list(runs[0][:2]) + list(torch.split(
        runs[0][2], [h * p, g * n, g * n], dim=-1))
    want = list(want[:2]) + list(torch.split(
        want[2], [h * p, g * n, g * n], dim=-1))
    dcums, ddt, dx, dB, dC = ssd_inter_bwd_ref(
        dy, ds, *[t.detach() for t in leaves])
    twin = [dcums, ddt, dx.reshape(b, nc * q, h * p),
            dB.reshape(b, nc * q, g * n), dC.reshape(b, nc * q, g * n)]
    for name, g_, w, t in zip(("cums", "dt", "x", "B", "C"), got, want,
                              twin):
        _within_a_bf16_step_of_max(g_, w, name)
        _within_a_bf16_step_of_max(g_, t, name + " twin")
