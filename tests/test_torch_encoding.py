"""repro_torch encodings and configs against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. Grid
tables are drawn U(-1, 1), not the U(-1e-4, 1e-4) of a fresh field, so a
wrong row, corner or level changes the output visibly.

Tolerance: both packages run the same f32 operations in the same order;
only XLA's fusion (FMA contraction) can round differently, which stays
far below 1e-5 at these magnitudes (|feature| <= 1).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import fields as jfields
from repro.kernels.hashgrid.hashgrid import level_meta as jlevel_meta
from repro_torch.core import encoding as tenc
from repro_torch.core import fields as tfields
from repro_torch.kernels.common import pad_batch, round_up
from repro_torch.kernels.hashgrid.hashgrid import level_meta

APPS = ("nerf", "nsdf", "gia", "nvr")
ENCODINGS = ("hash", "dense", "tiled")
TOL = 1e-5


def _grid_pair(kind, dim, log2_T, n_levels, growth=None):
    mk_j = {"hash": jenc.hashgrid_config, "dense": jenc.densegrid_config,
            "tiled": jenc.tiledgrid_config}[kind]
    mk_t = {"hash": tenc.hashgrid_config, "dense": tenc.densegrid_config,
            "tiled": tenc.tiledgrid_config}[kind]
    kw = {"growth": growth} if growth is not None else {}
    gj = dataclasses.replace(mk_j(dim=dim, **kw), log2_table_size=log2_T)
    gt = dataclasses.replace(mk_t(dim=dim, **kw), log2_table_size=log2_T)
    gj = dataclasses.replace(gj, n_levels=min(n_levels, gj.n_levels))
    gt = dataclasses.replace(gt, n_levels=min(n_levels, gt.n_levels))
    return gj, gt


def _tables(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (cfg.n_levels, cfg.table_size,
                                   cfg.n_features)).astype(np.float32)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_table1_config_matches_jax(app, encoding):
    cj = jfields.make_field_config(app, encoding)
    ct = tfields.make_field_config(app, encoding)
    assert dataclasses.asdict(ct.grid) == dataclasses.asdict(cj.grid)
    assert dataclasses.asdict(ct.mlp) == dataclasses.asdict(cj.mlp)
    if cj.density_mlp is None:
        assert ct.density_mlp is None
    else:
        assert (dataclasses.asdict(ct.density_mlp)
                == dataclasses.asdict(cj.density_mlp))
    assert (ct.app, ct.name, ct.in_dim, ct.out_dim) == (
        cj.app, cj.name, cj.in_dim, cj.out_dim)
    assert tfields.field_param_count(ct) == jfields.field_param_count(cj)
    g = ct.grid
    assert [g.level_resolution(l) for l in range(g.n_levels)] == [
        cj.grid.level_resolution(l) for l in range(g.n_levels)]
    np.testing.assert_array_equal(level_meta(g),
                                  np.asarray(jlevel_meta(cj.grid)))


def test_nerf_hash_levels_mix_dense_and_hashed():
    """Table-I nerf_hash: levels 0-3 (res 16, 24, 36, 55) are dense with
    stride res+1, levels 4-15 hashed, because (res+1)^3 > 2^19 there."""
    g = tfields.make_field_config("nerf", "hash").grid
    meta = level_meta(g)
    assert meta[:4, 0].tolist() == [16, 24, 36, 55]
    assert meta[:, 1].tolist() == [0] * 4 + [1] * 12
    assert meta[-1, 0] == g.level_resolution(15)


def test_with_grid_recomputes_mlp_in_dim():
    ct = tfields.make_field_config("nerf", "hash")
    g = dataclasses.replace(ct.grid, n_levels=4)
    assert ct.with_grid(g).density_mlp.in_dim == 8
    assert ct.with_grid(g).mlp.in_dim == 32
    cn = tfields.make_field_config("nvr", "dense")
    assert cn.with_grid(dataclasses.replace(cn.grid, n_levels=3)
                        ).mlp.in_dim == 6


# ---------------------------------------------------------------- encode
@pytest.mark.parametrize("kind,dim,log2_T,n", [
    ("hash", 3, 14, 300), ("hash", 2, 12, 200), ("dense", 3, 12, 300),
    ("tiled", 2, 12, 200), ("tiled", 3, 12, 128)])
def test_grid_encode_matches_jax(kind, dim, log2_T, n):
    gj, gt = _grid_pair(kind, dim, log2_T, 4,
                        growth=1.51572 if kind == "hash" else None)
    if (kind, dim) == ("hash", 3):   # nerf growth at log2_T=14 mixes
        assert [gt.level_is_hashed(l) for l in range(4)] == [
            False, False, True, True]
    tables = _tables(gt)
    pts = np.random.default_rng(1).uniform(size=(n, dim)).astype(np.float32)
    ref = jenc.grid_encode(jnp.asarray(pts), jnp.asarray(tables), gj)
    got = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(tables),
                           gt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_grid_encode_edge_coordinates():
    """frac is taken before the cell is clipped to res-1: a coordinate of
    exactly 1.0 weights the corner at res-1 with frac 0, and 0 and 1 never
    index out of bounds."""
    gj, gt = _grid_pair("hash", 3, 14, 4, growth=1.51572)
    tables = _tables(gt, seed=3)
    pts = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1],
                    [0.999999, 1e-7, 0.5]], np.float32)
    ref = jenc.grid_encode(jnp.asarray(pts), jnp.asarray(tables), gj)
    got = tenc.grid_encode(torch.from_numpy(pts), torch.from_numpy(tables),
                           gt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    # at 1.0 the clipped cell is res-1 with frac 0: the level-0 feature is
    # exactly the row of corner (res-1, res-1, res-1)
    res = gt.level_resolution(0)
    row = tenc.dense_index(torch.tensor([[res - 1] * 3]), res,
                           gt.table_size)
    np.testing.assert_allclose(got[1, :2].numpy(), tables[0, row[0]],
                               atol=1e-6)


def test_hash_index_wraps_uint32():
    coords = np.array([[8192, 8192, 8192], [2 ** 20, 12345, 99999],
                       [2 ** 30, 2 ** 30 + 7, 3], [0, 1, 2]], np.int32)
    T = 1 << 19
    expect = []
    for x, y, z in coords.tolist():
        h = ((x * jenc.HASH_PRIMES[0]) ^ (y * jenc.HASH_PRIMES[1])
             ^ (z * jenc.HASH_PRIMES[2])) & 0xFFFFFFFF
        expect.append(h & (T - 1))
    got = tenc.hash_index(torch.from_numpy(coords), T)
    ref = jenc.hash_index(jnp.asarray(coords), T)
    assert got.tolist() == expect == np.asarray(ref).tolist()
    # 4-D coordinates use the fourth prime (>2^31)
    c4 = np.array([[3, 5, 7, 2 ** 29]], np.int32)
    assert (tenc.hash_index(torch.from_numpy(c4), T).tolist()
            == np.asarray(jenc.hash_index(jnp.asarray(c4), T)).tolist())


def test_dense_index_matches_jax():
    coords = np.random.default_rng(2).integers(0, 1025, (64, 3)).astype(
        np.int32)
    for res, T in ((16, 1 << 19), (1024, 1 << 14)):
        got = tenc.dense_index(torch.from_numpy(coords), res, T)
        ref = jenc.dense_index(jnp.asarray(coords), res, T)
        assert got.tolist() == np.asarray(ref).tolist()


def test_sh_encode_matches_jax():
    d = np.random.default_rng(4).normal(size=(257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tenc.sh_encode(torch.from_numpy(d))
    ref = jenc.sh_encode(jnp.asarray(d))
    assert got.shape == (257, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_pad_batch_and_round_up():
    x = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    p, n = pad_batch(x, 4)
    assert n == 5 and p.shape == (8, 2)
    assert torch.equal(p[:5], x) and not p[5:].any()
    same, n2 = pad_batch(x, 5)
    assert same is x and n2 == 5
    assert [round_up(v, 8) for v in (0, 1, 8, 9)] == [0, 8, 8, 16]
