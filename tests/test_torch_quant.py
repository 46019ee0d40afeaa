"""repro_torch.quant and the quantized field against the JAX package.

Inputs are made with numpy from a seed (tables U(-1, 1)) and handed to
both packages. Codes and scales must be EQUAL to the JAX package's: the
same f32 divisions, rounding and clipping, and a percentile rounded as XLA
compiles ``jnp.percentile``. Field outputs are held to 1e-5 (f32): the
same operations, rounded differently only where XLA contracts or reorders.
The JAX field runs its Pallas kernels in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fields as jfields
from repro.core.mlp import MLPConfig as JMLPConfig
from repro.kernels.fused_field import ops as jff_ops
from repro.quant import QuantSpec as JQuantSpec
from repro.quant import api as japi
from repro_torch import kernels as tkernels
from repro_torch.core import fields as tfields
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.quant import QuantSpec, api as tapi
from repro_torch.quant import qtypes
from tests.conftest import small_field_config

TOL = 1e-5
SPECS = [("int8", None, 100.0), ("fp8_e4m3", None, 100.0),
         ("int8", "int8_affine", 100.0), ("fp8_e4m3", "int8", 99.0),
         ("int8", "fp8_e4m3", 99.0), (None, "int8", 90.0)]


def _cfgs(app, log2_T=10, n_levels=4):
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


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _assert_trees_equal(tree_t, tree_np, path="params"):
    assert set(tree_t) == set(tree_np), path
    for k, v in tree_np.items():
        if isinstance(v, dict):
            _assert_trees_equal(tree_t[k], v, f"{path}/{k}")
        else:
            want = tfields.leaf_from_numpy(np.asarray(v))
            assert tree_t[k].dtype == want.dtype, f"{path}/{k}"
            assert torch.equal(_bits(tree_t[k]), _bits(want)), f"{path}/{k}"


def _pts_dirs(n, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


# ------------------------------------------------------------------ codecs
def test_quant_spec_validation_and_tag():
    for args in [("int8", "int8"), ("fp8_e4m3", None), (None, "int8_affine")]:
        assert QuantSpec(*args).tag == JQuantSpec(*args).tag
    for bad in [dict(table_qtype="nope"), dict(table_qtype="int8_affine"),
                dict(mlp_qtype="int4"), dict(percentile=0.0),
                dict(percentile=101.0)]:
        with pytest.raises(ValueError):
            QuantSpec(**bad)
        with pytest.raises(ValueError):
            JQuantSpec(**bad)


@pytest.mark.parametrize("table_qtype,mlp_qtype,percentile", SPECS)
@pytest.mark.parametrize("log2_T", [8, 10])
def test_quantize_field_equals_jax(table_qtype, mlp_qtype, percentile,
                                   log2_T):
    """Codes and scale (zero) leaves of every table and MLP weight equal
    the JAX package's bit for bit."""
    _, ct = _cfgs("nerf", log2_T=log2_T)
    p = _np_params(ct, log2_T)
    jq = japi.quantize_field(jax.tree.map(jnp.asarray, p),
                             JQuantSpec(table_qtype, mlp_qtype, percentile))
    tq = tapi.quantize_field(tfields.from_jax_params(p, ct, "cpu"),
                             QuantSpec(table_qtype, mlp_qtype, percentile))
    _assert_trees_equal(tq, jax.tree.map(np.asarray, jq))


def test_percentile_clips_outlier_rows():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 64, 2)).astype(np.float32))
    x[0, 0, 0] = 100.0                                  # one outlier row
    full = tapi.calibrate.table_scales(x, QuantSpec("int8"))
    clipped = tapi.calibrate.table_scales(x, QuantSpec("int8",
                                                       percentile=90.0))
    assert float(clipped[0, 0, 0]) < float(full[0, 0, 0])
    assert bool((clipped <= full).all())


def test_fp8_saturates_instead_of_nan():
    x = torch.tensor([1e6, -1e6, 0.0])
    q = qtypes.quantize(x, torch.tensor(1.0), "fp8_e4m3")
    assert q.float().tolist() == [qtypes.FP8_E4M3_MAX, -qtypes.FP8_E4M3_MAX,
                                  0.0]


def test_quantize_field_structure_and_dense_twin():
    _, ct = _cfgs("nerf", log2_T=8)
    params = tfields.from_jax_params(_np_params(ct, 0), ct, "cpu")
    spec = QuantSpec("int8", mlp_qtype="int8")
    qp = tapi.quantize_field(params, spec)
    assert qp["grid"].dtype == torch.int8
    assert qp["grid_scale"].shape == (4, 1, 1)
    assert qp["mlp"]["w_in_scale"].shape == (1, 1)
    assert qp["mlp"]["w_hidden_scale"].shape == (3, 1, 1)
    assert tapi.is_quantized_field(qp) and not tapi.is_quantized_field(params)
    with pytest.raises(ValueError, match="already quantized"):
        tapi.quantize_field(qp, spec)
    dense = tapi.dequantize_field(qp)
    assert dense["grid"].dtype == torch.float32 and "grid_scale" not in dense
    assert set(dense["mlp"]) == set(params["mlp"])
    torch.testing.assert_close(dense["grid"], params["grid"],
                               atol=float(qp["grid_scale"].max()) / 2,
                               rtol=0)


# ------------------------------------------- carrying a JAX tree across
@pytest.mark.parametrize("app", ["nerf", "nvr"])
@pytest.mark.parametrize("table_qtype,mlp_qtype", [("int8", None),
                                                   ("fp8_e4m3", "int8"),
                                                   ("int8", "int8_affine")])
def test_from_jax_params_carries_quantized_tree(app, table_qtype, mlp_qtype):
    """A JAX quantize_field tree (int8 / fp8 codes, f32 scale and zero
    leaves) comes across bit for bit and evaluates to the JAX Pallas route
    within 1e-5. Carried as f32 values without scales, as the port once
    did, the same tree renders another scene."""
    cj, ct = _cfgs(app)
    jspec = JQuantSpec(table_qtype, mlp_qtype)
    jq = japi.quantize_field(jax.tree.map(jnp.asarray, _np_params(ct, 7)),
                             jspec)
    npq = jax.tree.map(np.asarray, jq)
    qcfg = ct.with_quant(QuantSpec(table_qtype, mlp_qtype))
    tq = tfields.from_jax_params(npq, qcfg, "cpu")
    _assert_trees_equal(tq, npq)
    pts, dirs = _pts_dirs(200)
    want = np.asarray(jfields.apply_field(
        jq, cj.with_quant(jspec), jnp.asarray(pts), jnp.asarray(dirs),
        use_pallas=True))
    got = tfields.apply_field(tq, qcfg, torch.from_numpy(pts),
                              torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the fault this guards: codes read as f32 values, scale dropped
    as_f32 = {k: (v.float() if isinstance(v, torch.Tensor)
                  else {kk: vv.float() for kk, vv in v.items()
                        if not kk.endswith(("_scale", "_zero"))})
              for k, v in tq.items() if k != "grid_scale"}
    wrong = tfields.apply_field(as_f32, ct, torch.from_numpy(pts),
                                torch.from_numpy(dirs)).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_from_jax_params_raises_on_leaves_the_config_does_not_give():
    _, ct = _cfgs("nerf", log2_T=8)
    jq = jax.tree.map(np.asarray, japi.quantize_field(
        jax.tree.map(jnp.asarray, _np_params(ct, 0)), JQuantSpec("int8")))
    qcfg = ct.with_quant(QuantSpec("int8"))
    with pytest.raises(ValueError, match="params/grid_scale"):
        tfields.from_jax_params(jq, ct, "cpu")        # dense cfg
    with pytest.raises(ValueError, match="params/occupancy"):
        tfields.from_jax_params({**jq, "occupancy": np.ones((8, 8, 8))},
                                qcfg, "cpu")
    with pytest.raises(ValueError, match="params/mlp/w_in_scale"):
        tfields.from_jax_params(
            {**jq, "mlp": {**jq["mlp"], "w_in_scale": np.ones((1, 1))}},
            qcfg, "cpu")
    with pytest.raises(ValueError, match="params/grid_scale: missing"):
        tfields.from_jax_params({k: v for k, v in jq.items()
                                 if k != "grid_scale"}, qcfg, "cpu")
    with pytest.raises(ValueError, match="params/grid_scale: shape"):
        tfields.from_jax_params({**jq, "grid_scale": np.ones((4, 1))},
                                qcfg, "cpu")


# ----------------------------------------------------- quantized kernels
@pytest.mark.parametrize("qtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("mlp_qtype", [None, "int8"])
def test_quantized_field_plain_matches_jax_kernel(qtype, mlp_qtype):
    """The field wrapper with ``table_scales`` (and a quantized MLP dict,
    dequantized on entry) against the JAX ``field(table_scales=)``."""
    cj, ct = _cfgs("nerf", log2_T=14)
    jspec = JQuantSpec(qtype, mlp_qtype)
    jq = japi.quantize_field(jax.tree.map(jnp.asarray, _np_params(ct, 5)),
                             jspec)
    tq = tfields.from_jax_params(jax.tree.map(np.asarray, jq),
                                 ct.with_quant(QuantSpec(qtype, mlp_qtype)),
                                 "cpu")
    m = ct.density_mlp
    jm = JMLPConfig(in_dim=m.in_dim, hidden_dim=m.hidden_dim,
                    n_hidden=m.n_hidden, out_dim=m.out_dim)
    assert isinstance(m, MLPConfig)
    pts, _ = _pts_dirs(300)
    pts[:2] = [[0, 0, 0], [1, 1, 1]]                   # edges
    before = tkernels.launch_counts()
    got = ff_ops.field(torch.from_numpy(pts), tq["grid"], tq["density_mlp"],
                       ct.grid, m, table_scales=tq["grid_scale"])
    assert tkernels.launch_counts() == before          # CPU: no launch
    want = jff_ops.field(jnp.asarray(pts), jq["grid"], jq["density_mlp"],
                         cj.grid, jm, table_scales=jq["grid_scale"],
                         block_b=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    with pytest.raises(ValueError, match="requires"):
        ff_ops.field(torch.from_numpy(pts), tq["grid"], tq["density_mlp"],
                     ct.grid, m)
