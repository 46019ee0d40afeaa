"""repro_torch kernel wrappers and plain versions against the JAX kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version; here
those are held against the JAX package's Pallas kernels, run in interpret
mode as tests/test_kernels.py runs them. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py.

Tolerance: f32 throughout, 1e-5: both sides run the same operations in
another association order (XLA's dot against PyTorch's matmul, FMA
contraction).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core.mlp import MLPConfig as JMLPConfig
from repro.core.mlp import apply_mlp as japply_mlp
from repro.kernels.fused_field import ops as jff_ops
from repro.kernels.fused_field.ref import field_ref as jfield_ref
from repro.kernels.hashgrid.ref import encode_ref as jencode_ref
from repro.kernels.fused_mlp import ops as jmlp_ops
from repro.kernels.ray_march import ops as jrm_ops
from repro_torch import kernels as tkernels
from repro_torch.core import encoding as tenc
from repro_torch.core import fields as tfields
from repro_torch.core import render as trender
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels import build
from repro_torch.kernels.common import TABLE_DTYPE_CODE, check_kernel_input
from repro_torch.kernels.hashgrid import hashgrid
from repro_torch.kernels.hashgrid.hashgrid import check_tables
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.kernels.fused_field import fused_field as tff
from repro_torch.kernels.fused_field.fused_field import (field_plan,
                                                         fused_field_cuda)
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_mlp.fused_mlp import (MAX_SMEM_BYTES,
                                                     fused_mlp_cuda, mlp_plan)
from repro_torch.kernels.hashgrid import ops as hops
from repro_torch.kernels.ray_march import ops as rm_ops
from repro_torch.kernels.ray_march import ray_march as rm_ray_march

TOL = 1e-5


def _grid_pair(log2_T=14, n_levels=4, growth=1.51572):
    gj = dataclasses.replace(jenc.hashgrid_config(growth=growth),
                             log2_table_size=log2_T, n_levels=n_levels)
    gt = dataclasses.replace(tenc.hashgrid_config(growth=growth),
                             log2_table_size=log2_T, n_levels=n_levels)
    return gj, gt


def _mlp_params(cfg, seed):
    rng = np.random.default_rng(seed)
    p = {"w_in": rng.normal(size=(cfg.in_dim, cfg.hidden_dim))
         / np.sqrt(cfg.in_dim),
         "w_out": rng.normal(size=(cfg.hidden_dim, cfg.out_dim))
         / np.sqrt(cfg.hidden_dim)}
    if cfg.n_hidden > 1:
        p["w_hidden"] = rng.normal(size=(cfg.n_hidden - 1, cfg.hidden_dim,
                                         cfg.hidden_dim)) / np.sqrt(
                                             cfg.hidden_dim)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _t(tree, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _field_inputs(n, seed=0, log2_T=14, n_levels=4, out_dim=16, n_hidden=3):
    gj, gt = _grid_pair(log2_T, n_levels)
    rng = np.random.default_rng(seed)
    tables = rng.uniform(-1, 1, (n_levels, gt.table_size, 2)).astype(
        np.float32)
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5]]         # edges
    m = MLPConfig(in_dim=gt.out_dim, n_hidden=n_hidden, out_dim=out_dim)
    jm = JMLPConfig(in_dim=gt.out_dim, n_hidden=n_hidden, out_dim=out_dim)
    return gj, gt, m, jm, tables, pts, _mlp_params(m, seed + 1)


def _composite_inputs(r, s, seed=0, broadcast_dts=False):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(r, s, 3)).astype(np.float32)
    sigma = rng.exponential(3.0, size=(r, s)).astype(np.float32)
    sigma[0] = 0.0                                        # empty ray
    sigma[1, 2:] = 1e4                                    # opaque ray
    dts = rng.uniform(0.01, 0.2, size=(1 if broadcast_dts else r, s)
                      ).astype(np.float32)
    return rgb, sigma, dts


# --------------------------------------------- plain versions vs JAX kernels
@pytest.mark.parametrize("n,out_dim,n_hidden", [(300, 16, 3), (77, 4, 4),
                                                (64, 16, 1)])
def test_field_plain_matches_jax_kernel(n, out_dim, n_hidden):
    gj, gt, m, jm, tables, pts, w = _field_inputs(n, out_dim=out_dim,
                                                  n_hidden=n_hidden)
    assert {gt.level_is_hashed(l) for l in range(4)} == {False, True}
    before = tkernels.launch_counts()
    got = ff_ops.field(torch.from_numpy(pts), torch.from_numpy(tables),
                       _t(w), gt, m)
    assert tkernels.launch_counts() == before      # CPU: no kernel launch
    ref = jff_ops.field(jnp.asarray(pts), jnp.asarray(tables), _j(w), gj, jm,
                        block_b=64)
    assert got.shape == (n, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("app,log2_T", [("gia", 9), ("nsdf", 14)])
def test_field_plain_matches_jax_kernel_at_app_shapes(app, log2_T):
    """gia's 2-D grid with its MLP (4 hidden layers, 3 outputs) and nsdf's
    3-D one with its single signed-distance output; dense and hashed
    levels both."""
    gj = dataclasses.replace(jenc.hashgrid_config(
        dim=2 if app == "gia" else 3,
        growth=1.25992 if app == "gia" else 1.38191),
        log2_table_size=log2_T, n_levels=4)
    gt = dataclasses.replace(tenc.hashgrid_config(
        dim=gj.dim, growth=gj.growth), log2_table_size=log2_T, n_levels=4)
    assert {gt.level_is_hashed(l) for l in range(4)} == {False, True}
    out_dim = 3 if app == "gia" else 1
    m = MLPConfig(in_dim=8, n_hidden=4, out_dim=out_dim)
    jm = JMLPConfig(in_dim=8, n_hidden=4, out_dim=out_dim)
    rng = np.random.default_rng(log2_T)
    tables = rng.uniform(-1, 1, (4, gt.table_size, 2)).astype(np.float32)
    pts = rng.uniform(size=(200, gt.dim)).astype(np.float32)
    pts[0] = 1.0                                          # edge
    w = _mlp_params(m, 5)
    got = ff_ops.field(torch.from_numpy(pts), torch.from_numpy(tables),
                       _t(w), gt, m)
    ref = jff_ops.field(jnp.asarray(pts), jnp.asarray(tables), _j(w), gj, jm,
                        block_b=64)
    assert got.shape == (200, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("in_dim,n_hidden,out_dim,n", [(32, 4, 3, 300),
                                                       (16, 1, 4, 50)])
def test_mlp_plain_matches_jax_kernel(in_dim, n_hidden, out_dim, n):
    m = MLPConfig(in_dim=in_dim, n_hidden=n_hidden, out_dim=out_dim)
    jm = JMLPConfig(in_dim=in_dim, n_hidden=n_hidden, out_dim=out_dim)
    w = _mlp_params(m, 5)
    x = np.random.default_rng(6).normal(size=(n, in_dim)).astype(np.float32)
    got = mlp_ops.mlp(_t(w), torch.from_numpy(x), m)
    ref = jmlp_ops.mlp(_j(w), jnp.asarray(x), jm, block_b=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("r,s,broadcast", [(64, 16, False), (500, 32, False),
                                           (100, 8, True)])
def test_composite_plain_matches_jax_kernel(r, s, broadcast):
    rgb, sigma, dts = _composite_inputs(r, s, broadcast_dts=broadcast)
    pix, opac = rm_ops.composite(torch.from_numpy(rgb),
                                 torch.from_numpy(sigma),
                                 torch.from_numpy(dts))
    rpix, ropac = jrm_ops.composite(jnp.asarray(rgb), jnp.asarray(sigma),
                                    jnp.asarray(dts))
    assert np.isfinite(pix.numpy()).all()
    np.testing.assert_allclose(pix.numpy(), np.asarray(rpix), atol=TOL)
    np.testing.assert_allclose(opac.numpy(), np.asarray(ropac), atol=TOL)
    # an opaque ray's weights sum to 1 up to f32 rounding of exp(csum - x)
    assert abs(float(opac[1]) - 1.0) < 1e-4 and float(opac[0]) == 0.0


def test_composite_reads_packed_field_output():
    """The render path hands the wrapper the rgb and sigma columns of the
    field's packed (R, S, 4) output and a broadcast (1, S) dts."""
    rgb, sigma, dts = _composite_inputs(40, 8, broadcast_dts=True)
    packed = torch.cat([torch.from_numpy(rgb),
                        torch.from_numpy(sigma)[..., None]], dim=-1)
    got = rm_ops.composite(packed[..., :3], packed[..., 3],
                           torch.from_numpy(dts))
    ref = trender.composite(torch.from_numpy(rgb), torch.from_numpy(sigma),
                            torch.from_numpy(np.repeat(dts, 40, axis=0)))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 8, 31, 33, 64, 192])
@pytest.mark.parametrize("layout", ["separate", "packed"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_composite_plain_matches_jax_kernel_over_sample_counts(s, layout,
                                                               broadcast):
    """S below, at the edges of and above the kernel's 32-lane segments,
    R = 333 (no multiple of the rays per block), an empty and an opaque
    ray, and the two input layouts the wrapper tells apart: separate rgb
    and sigma, or the columns of the field's packed (R, S, 4) output."""
    r = 333
    rgb, sigma, dts = _composite_inputs(r, s, seed=s, broadcast_dts=broadcast)
    sigma[1, :] = 1e4                               # opaque from the start
    trgb, tsigma = torch.from_numpy(rgb), torch.from_numpy(sigma)
    if layout == "packed":
        packed = torch.cat([trgb, tsigma[..., None]], dim=-1)
        trgb, tsigma = packed[..., :3], packed[..., 3]
        assert rm_ray_march.is_packed(trgb, tsigma)
    pix, opac = rm_ops.composite(trgb, tsigma, torch.from_numpy(dts))
    rpix, ropac = jrm_ops.composite(jnp.asarray(rgb), jnp.asarray(sigma),
                                    jnp.asarray(dts))
    assert pix.shape == (r, 3) and opac.shape == (r,)
    assert np.isfinite(pix.numpy()).all() and np.isfinite(opac.numpy()).all()
    np.testing.assert_allclose(pix.numpy(), np.asarray(rpix), atol=TOL)
    np.testing.assert_allclose(opac.numpy(), np.asarray(ropac), atol=TOL)
    assert float(opac[0]) == 0.0                          # empty ray
    assert abs(float(opac[1]) - 1.0) < 1e-4               # opaque ray
    assert float(opac.max()) <= 1.0 + 1e-4


@pytest.mark.parametrize("s,lanes,rays", [(0, 1, 256), (1, 1, 256),
                                          (2, 2, 128), (8, 8, 32),
                                          (16, 16, 16), (17, 32, 8),
                                          (31, 32, 8), (32, 32, 8),
                                          (33, 32, 8), (192, 32, 8)])
def test_composite_plan_gives_a_segment_per_ray(s, lanes, rays):
    """A ray takes the next power of two of S lanes, at most a warp; the
    rays of a warp and of a block follow."""
    plan = rm_ray_march.composite_plan(s)
    assert plan == {"lanes_per_ray": lanes, "rays_per_block": rays}
    assert plan["rays_per_block"] * plan["lanes_per_ray"] == \
        32 * rm_ray_march.WARPS_PER_BLOCK


def test_composite_packed_layout_is_told_apart():
    """The 16-byte-load path is taken only for the columns of one (R, S, 4)
    f32 array on a 16-byte boundary."""
    packed = torch.zeros((5, 7, 4))
    assert rm_ray_march.is_packed(packed[..., :3], packed[..., 3])
    assert not rm_ray_march.is_packed(torch.zeros((5, 7, 3)),
                                      torch.zeros((5, 7)))
    assert not rm_ray_march.is_packed(packed[..., :3], packed[..., 2])
    wide = torch.zeros((5, 7, 5))                         # sample stride 5
    assert not rm_ray_march.is_packed(wide[..., :3], wide[..., 3])
    off = torch.zeros(5 * 7 * 4 + 1)[1:].view(5, 7, 4)    # 4 bytes off
    assert not rm_ray_march.is_packed(off[..., :3], off[..., 3])


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper runs the plain version only for CPU tensors; on any other
    device it does not fall back."""
    gt = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=8,
                             n_levels=2)
    m = MLPConfig(in_dim=4, n_hidden=2, out_dim=4)
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in _t(_mlp_params(m, 0)).items()}
    pts = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError):
        ff_ops.field(pts, torch.empty((2, 256, 2), device="meta"), meta,
                     gt, m)
    with pytest.raises(ValueError):
        mlp_ops.mlp(meta, torch.empty((8, 4), device="meta"), m)
    with pytest.raises(ValueError):
        rm_ops.composite(torch.empty((8, 4, 3), device="meta"),
                         torch.empty((8, 4), device="meta"),
                         torch.empty((1, 4)))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_kernel_registry_lists_the_slice():
    assert set(tkernels.kernels()) == {"field_fwd", "field_fwd_q",
                                       "encode_fwd", "mlp_fwd",
                                       "composite_fwd"}
    tkernels.reset_launch_counts()
    assert set(tkernels.launch_counts().values()) == {0}


def test_check_kernel_input_takes_codec_tables_only_where_asked():
    """Codec tables pass exactly the grid kernels' table check; every other
    kernel input stays f32."""
    codes = torch.zeros((2, 256, 2), dtype=torch.int8)
    with pytest.raises(TypeError):
        check_kernel_input("w_in", codes)
    check_kernel_input("tables", codes, (2, 256, 2),
                       dtypes=tuple(TABLE_DTYPE_CODE))
    gt = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=8,
                             n_levels=2)
    for dtype in (torch.int8, torch.float8_e4m3fn):
        check_tables(codes.to(dtype), torch.ones((2, 1, 1)), gt)
    with pytest.raises(TypeError):
        check_tables(codes.to(torch.float16), None, gt)
    with pytest.raises(ValueError, match="aligned"):
        check_tables(torch.zeros(2 * 256 * 2 + 1, dtype=torch.int8)[1:]
                     .view(2, 256, 2), torch.ones((2, 1, 1)), gt)


# ----------------------------------------------------------- bf16 leaves
def _bf16(tree):
    """numpy f32 arrays -> JAX bf16 arrays -> numpy (ml_dtypes bfloat16)."""
    return {k: np.asarray(jnp.asarray(v, dtype=jnp.bfloat16))
            for k, v in tree.items()}


@pytest.mark.parametrize("n,n_hidden,out_dim", [(300, 3, 16), (77, 1, 4)])
def test_bf16_plain_versions_match_jax_xla_route(n, n_hidden, out_dim):
    """bf16 tables and weights, widened after the gather and before each
    product, give the JAX XLA route's field, encode and MLP within 1e-5."""
    gj, gt, m, jm, tables, pts, w = _field_inputs(n, seed=2,
                                                  out_dim=out_dim,
                                                  n_hidden=n_hidden)
    tab = np.asarray(jnp.asarray(tables, dtype=jnp.bfloat16))
    wb = _bf16(w)
    tt = tfields.leaf_from_numpy(tab)
    tw = {k: tfields.leaf_from_numpy(v) for k, v in wb.items()}
    assert tt.dtype == torch.bfloat16 and tw["w_in"].dtype == torch.bfloat16
    tp = torch.from_numpy(pts)
    before = tkernels.launch_counts()
    got = {"field": ff_ops.field(tp, tt, tw, gt, m),
           "encode": hops.encode(tp, tt, gt),
           "mlp": mlp_ops.mlp(tw, hops.encode(tp, tt, gt), m)}
    assert tkernels.launch_counts() == before      # CPU: no kernel launch
    jtab, jw = jnp.asarray(tab), {k: jnp.asarray(v) for k, v in wb.items()}
    feats = jencode_ref(jnp.asarray(pts), jtab, gj)
    want = {"field": jfield_ref(jnp.asarray(pts), jtab, jw, gj, jm),
            "encode": feats, "mlp": japply_mlp(jw, feats, jm)}
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=TOL,
                                   rtol=TOL, err_msg=k)


@pytest.mark.parametrize("hidden,n_hidden,why", [
    (60, 2, "multiple of 8"), (136, 1, "from 8 to 128"),
    (0, 1, "multiple of 8"), (128, 4, "shared-memory plan")])
def test_mlp_wrapper_raises_on_widths_the_kernel_does_not_take(
        hidden, n_hidden, why):
    m = MLPConfig(in_dim=32, hidden_dim=hidden, n_hidden=n_hidden,
                  out_dim=3)
    with pytest.raises(ValueError, match=why):
        mlp_plan(m)
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in _t(_mlp_params(m, 0)).items()}
    with pytest.raises(ValueError, match=why):
        fused_mlp_cuda(torch.empty((8, 32), device="meta"), meta["w_in"],
                       meta.get("w_hidden"), meta["w_out"], m)


def test_field_wrapper_raises_on_widths_the_kernel_does_not_take():
    """The field kernel's MLP is built 64 wide: 72 to 128 is the
    standalone MLP kernel's only."""
    gt = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=8,
                             n_levels=2)
    for hidden, why in ((128, "from 8 to 64"), (20, "multiple of 8")):
        m = MLPConfig(in_dim=gt.out_dim, hidden_dim=hidden, n_hidden=1,
                      out_dim=4)
        with pytest.raises(ValueError, match=why):
            field_plan(m)
        meta = {k: torch.empty(v.shape, device="meta")
                for k, v in _t(_mlp_params(m, 0)).items()}
        with pytest.raises(ValueError, match=why):
            fused_field_cuda(torch.empty((8, 3), device="meta"),
                             torch.empty((2, 256, 2), device="meta"),
                             meta["w_in"], None, meta["w_out"], gt, m)


@pytest.mark.parametrize("app", ["nerf", "nsdf", "gia", "nvr"])
@pytest.mark.parametrize("encoding", ["hash", "dense", "tiled"])
def test_kernel_plans_fit_every_table1_config(app, encoding):
    """The shared-memory plans of the field kernel (the grid-facing MLP)
    and of the MLP kernel (NeRF's colour MLP) fit in the 227 KB a block
    may use, for all 12 Table-I configurations."""
    cfg = tfields.make_field_config(app, encoding)
    grid_mlp = cfg.density_mlp if app == "nerf" else cfg.mlp
    plans = [field_plan(grid_mlp)]
    if app == "nerf":
        plans.append(mlp_plan(cfg.mlp))
    for plan in plans:
        assert plan["hidden_padded"] == 64
        assert 0 < plan["smem_bytes"] <= MAX_SMEM_BYTES == 232_448
    # the colour MLP's weights, split hi/lo: 116 KB
    assert mlp_plan(tfields.make_field_config("nerf", "hash").mlp)[
        "smem_bytes"] == 118_784


def test_mlp_wrapper_raises_on_misaligned_rows():
    """The MLP kernel reads rows of an even width two floats at a time: a
    contiguous view that starts 4 bytes into its storage is refused before
    the launch, not left to fault on the card."""
    m = MLPConfig(in_dim=32, n_hidden=2, out_dim=3)
    w = _t(_mlp_params(m, 0))
    x = torch.zeros(8 * 32 + 1)[1:].view(8, 32)
    assert x.is_contiguous() and x.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp_cuda(x, w["w_in"], w.get("w_hidden"), w["w_out"], m)


_HIDDEN_128 = MLPConfig(in_dim=32, hidden_dim=128, n_hidden=1, out_dim=3)


@pytest.mark.parametrize("source,constant,mirror", [
    ("mlp.cuh", r"kMaxSmemBytes = (\d+);", MAX_SMEM_BYTES),
    ("mlp.cu", r"kHidden <= 64 \? (\d+) :", mlp_plan(MLPConfig(in_dim=32))["warps"]),
    ("mlp.cu", r"kHidden <= 64 \? \d+ : (\d+);",
     mlp_plan(_HIDDEN_128)["warps"]),
    ("field.cu", r"kEncodeWarps = (\d+);", tff.ENCODE_WARPS),
    ("field.cu", r"kMlpWarps = (\d+);", tff.MLP_WARPS),
    ("field.cu", r"kFieldRows = (\d+) \* kMlpWarps;",
     tff.TILE_ROWS // tff.MLP_WARPS),
    ("field.cu", r"kFieldHidden = (\d+);",
     field_plan(MLPConfig(in_dim=32))["hidden_padded"]),
    ("composite.cu", r"kCompositeWarps = (\d+);",
     rm_ray_march.WARPS_PER_BLOCK),
    ("encode.cu", r"kEncodeRows = (\d+);", hashgrid.ENCODE_ROWS),
    ("encode.cu", r"kMaxGroup = (\d+);", hashgrid.MAX_GROUP),
    ("encode.cu", r"kGroupRowBytes = (\d+);", hashgrid.GROUP_ROW_BYTES),
    ("encode.cuh", r"kMaxLevels = (\d+);", hashgrid.MAX_LEVELS)])
def test_kernel_plans_mirror_the_cuda_sources(source, constant, mirror):
    """The wrappers' plans (shared memory, rays per block, level groups)
    repeat constants of the CUDA sources; each copy equals its source."""
    m = re.search(constant, (build.CSRC / source).read_text())
    assert m is not None, constant
    assert int(m.group(1)) == mirror


@pytest.mark.parametrize("source,case", [("field.cu", "REPRO_FIELD_CASE"),
                                         ("encode.cu", "REPRO_ENCODE_CASE")])
def test_grid_kernel_cases_mirror_supported(source, case):
    """The wrappers' ``hashgrid.SUPPORTED`` (dim, n_features) pairs are
    exactly those the CUDA sources instantiate, and each pair for every
    table type of ``TABLE_DTYPE_CODE``."""
    cases = re.findall(case + r"\((\d+), (\d+), (\w+), [\w:]+\)",
                       (build.CSRC / source).read_text())
    pairs = {(int(d), int(f)) for d, f, _ in cases}
    assert pairs == hashgrid.SUPPORTED
    assert {(2, 2), (2, 8), (3, 2), (3, 8)} <= pairs
    assert len(cases) == len(pairs) * len(TABLE_DTYPE_CODE)
    assert len(set(cases)) == len(cases)


def test_encode_group_sizes_mirror_the_cuda_dispatch():
    """Every level-group size the plan can pick is one the CUDA source
    dispatches to, for every table type and (dim, F) pair."""
    cases = {int(g) for g in re.findall(
        r"REPRO_ENCODE_GROUP\((\d+)\)", (build.CSRC / "encode.cu").read_text())}
    picked = set()
    for dim, f in hashgrid.SUPPORTED:
        for log2_T in (8, 14, 19):
            gt = dataclasses.replace(tenc.hashgrid_config(dim=dim),
                                     n_features=f, log2_table_size=log2_T)
            for dtype in TABLE_DTYPE_CODE:
                for n in (1, 4096, 131072):
                    picked.add(hashgrid.encode_plan(gt, dtype, n, 132)[
                        "group_levels"])
    assert picked <= cases
    assert max(cases) == hashgrid.MAX_GROUP
