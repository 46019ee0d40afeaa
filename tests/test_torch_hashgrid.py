"""repro_torch's standalone grid encode (``kernels/hashgrid/ops.encode``)
against the JAX package's ``kernels/hashgrid/ops.encode``, dense and with
int8 / fp8-e4m3 tables and per-level scales.

On the CPU the wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as tests/test_quant.py runs it. Inputs
are made with numpy from a seed, tables U(-1, 1), and quantized by the JAX
package; the port gets the same codes through ``from_jax_params``'s leaf
conversion. Tolerance 1e-5 (f32): the same operations in the same order,
rounded differently only where XLA contracts a multiply-add.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.kernels.hashgrid import ops as jhops
from repro.quant import qtypes as jq
from repro_torch import kernels as tkernels
from repro_torch.core import encoding as tenc
from repro_torch.core import fields as tfields
from repro_torch.core.fields import leaf_from_numpy
from repro_torch.kernels.hashgrid import hashgrid
from repro_torch.kernels.hashgrid import ops as hops

TOL = 1e-5


def _inputs(qtype, n=300, log2_T=14, n_levels=4, n_features=2, seed=0):
    gj = dataclasses.replace(jenc.hashgrid_config(), log2_table_size=log2_T,
                             n_levels=n_levels, n_features=n_features)
    gt = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=log2_T,
                             n_levels=n_levels, n_features=n_features)
    rng = np.random.default_rng(seed)
    tables = jnp.asarray(rng.uniform(-1, 1, (n_levels, gt.table_size,
                                             n_features)).astype(np.float32))
    scales = None
    if qtype is not None:
        scales = jq.absmax_scale(tables, qtype, axis=(1, 2))
        tables = jq.quantize(tables, scales, qtype)
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5]]         # edges
    return gj, gt, tables, scales, pts


def _t(x):
    return None if x is None else leaf_from_numpy(np.asarray(x))


@pytest.mark.parametrize("qtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("n,n_features", [(300, 2), (77, 8)])
def test_encode_plain_matches_jax_kernel(qtype, n, n_features):
    gj, gt, tables, scales, pts = _inputs(qtype, n=n, n_features=n_features)
    assert {gt.level_is_hashed(l) for l in range(4)} == {False, True}
    tt = _t(tables)
    assert tt.dtype == {None: torch.float32, "int8": torch.int8,
                        "fp8_e4m3": torch.float8_e4m3fn}[qtype]
    before = tkernels.launch_counts()
    got = hops.encode(torch.from_numpy(pts), tt, gt, table_scales=_t(scales))
    assert tkernels.launch_counts() == before      # CPU: no kernel launch
    ref = jhops.encode(jnp.asarray(pts), tables, gj, table_scales=scales,
                       block_b=64)
    assert got.shape == (n, gt.out_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("qtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("n_features", [2, 8])
def test_encode_plain_matches_jax_kernel_2d(qtype, n_features):
    """gia's 2-D grid (growth 1.25992): at T = 2^9 levels 0-1 are dense and
    2-3 hashed."""
    gj = dataclasses.replace(jenc.hashgrid_config(dim=2, growth=1.25992),
                             log2_table_size=9, n_levels=4,
                             n_features=n_features)
    gt = dataclasses.replace(tenc.hashgrid_config(dim=2, growth=1.25992),
                             log2_table_size=9, n_levels=4,
                             n_features=n_features)
    assert [gt.level_is_hashed(l) for l in range(4)] == [False, False, True,
                                                         True]
    rng = np.random.default_rng(n_features)
    tables = jnp.asarray(rng.uniform(-1, 1, (4, gt.table_size, n_features)
                                     ).astype(np.float32))
    scales = None
    if qtype is not None:
        scales = jq.absmax_scale(tables, qtype, axis=(1, 2))
        tables = jq.quantize(tables, scales, qtype)
    pts = rng.uniform(size=(150, 2)).astype(np.float32)
    pts[:3] = [[0, 0], [1, 1], [0, 1]]                    # edges
    got = hops.encode(torch.from_numpy(pts), _t(tables), gt,
                      table_scales=_t(scales))
    ref = jhops.encode(jnp.asarray(pts), tables, gj, table_scales=scales,
                       block_b=64)
    assert got.shape == (150, 4 * n_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_quantized_encode_dequantizes_per_gather():
    """The plain version dequantizes each gathered row with the same
    formula as the whole table: the two agree bit for bit (int8 codes and
    the scale multiply are exact in f32 either way)."""
    _, gt, tables, scales, pts = _inputs("int8")
    tt, ts = _t(tables), _t(scales)
    got = hops.encode(torch.from_numpy(pts), tt, gt, table_scales=ts)
    whole = hops.encode(torch.from_numpy(pts), tt.float() * ts, gt)
    torch.testing.assert_close(got, whole, atol=0, rtol=0)


def test_encode_rejects_scale_drift():
    _, gt, tables, scales, pts = _inputs("int8")
    tt, ts, p = _t(tables), _t(scales), torch.from_numpy(pts)
    with pytest.raises(ValueError, match="requires"):
        hops.encode(p, tt, gt)                         # int8, no scales
    with pytest.raises(ValueError, match="forbids"):
        hops.encode(p, tt.float() * ts, gt, table_scales=ts)  # f32 + scales


@pytest.mark.parametrize("which", ["points", "tables"])
def test_encode_refuses_gradients(which):
    """Quantized tables are inference only, as in the JAX package, whose
    quantized route has no VJP: a call that would need a gradient, of the
    points or of the table side (its f32 scales: int8 codes take none),
    raises instead of returning a wrong one; dense tables differentiate
    (tests/test_torch_grad.py)."""
    _, gt, tables, scales, pts = _inputs("int8")
    p, t, s = torch.from_numpy(pts), _t(tables), _t(scales)
    (p if which == "points" else s).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="inference only"):
        hops.encode(p, t, gt, table_scales=s)
    with torch.no_grad():
        assert hops.encode(p, t, gt, table_scales=s).shape == (
            pts.shape[0], gt.out_dim)


def test_encode_raises_off_cpu_and_cuda():
    _, gt, _, _, _ = _inputs(None, log2_T=8)
    with pytest.raises(ValueError):
        hops.encode(torch.empty((8, 3), device="meta"),
                    torch.empty((4, 256, 2), device="meta"), gt)


_TABLE_DTYPES = [torch.float32, torch.bfloat16, torch.int8,
                 torch.float8_e4m3fn]
# an H100 SXM's streaming multiprocessors
_H100_SMS = 132


@pytest.mark.parametrize("app", ["nerf", "nsdf", "gia", "nvr"])
@pytest.mark.parametrize("dtype", _TABLE_DTYPES)
@pytest.mark.parametrize("n", [1, 4096, 131072])
def test_encode_plan_fits_every_table1_grid(app, dtype, n):
    """Each Table-I hash grid's level groups: every level in exactly one
    group, in order; each group's reachable tables within the L2 share;
    whole 16-byte stores; the corner rows within the register budget; and
    enough blocks to fill the card at a full tile."""
    cfg = tfields.make_field_config(app, "hash").grid
    plan = hashgrid.encode_plan(cfg, dtype, n, _H100_SMS)
    g, groups = plan["group_levels"], plan["groups"]
    assert [l for a, b in groups for l in range(a, b)] == list(
        range(cfg.n_levels))
    assert all(b - a == g for a, b in groups[:-1])
    assert 0 < groups[-1][1] - groups[-1][0] <= g
    level_bytes = hashgrid.level_table_bytes(cfg, dtype)
    assert plan["group_table_bytes"] == max(sum(level_bytes[a:b])
                                            for a, b in groups)
    assert plan["group_table_bytes"] <= hashgrid.L2_SHARE_BYTES
    assert plan["store_bytes"] == g * cfg.n_features * 4
    assert plan["store_bytes"] % 16 == 0
    assert g * cfg.n_features * dtype.itemsize <= hashgrid.GROUP_ROW_BYTES
    assert g <= hashgrid.MAX_GROUP
    assert plan["blocks"] == -(-n // hashgrid.ENCODE_ROWS) * len(groups)
    if n == 131072:
        assert plan["blocks"] >= hashgrid.BLOCKS_PER_SM * _H100_SMS
        # nerf's f32 levels are 4 MiB each: four to a 16 MiB group
        assert g == (4 if dtype == torch.float32 else 8)


def test_encode_plan_ragged_last_group():
    """13 levels in groups of 4 (or of 2, at a small batch) leave one level
    for the last group."""
    gt = dataclasses.replace(tenc.hashgrid_config(), log2_table_size=14,
                             n_levels=13)
    plan = hashgrid.encode_plan(gt, torch.float32, 131072, _H100_SMS)
    assert plan["group_levels"] == 4 and plan["n_groups"] == 4
    assert plan["groups"][-1] == (12, 13)
    small = hashgrid.encode_plan(gt, torch.float32, 4096, _H100_SMS)
    assert small["group_levels"] == 2 and small["groups"][-1] == (12, 13)


@pytest.mark.parametrize("change,error", [
    ({"dim": 4}, ValueError), ({"n_features": 4}, ValueError),
    ({"n_levels": 33}, ValueError), ({"n_levels": 0}, ValueError),
    ({"log2_table_size": 32}, ValueError)])
def test_encode_plan_raises_on_what_the_kernel_does_not_take(change, error):
    gt = dataclasses.replace(tenc.hashgrid_config(), **change)
    with pytest.raises(error):
        hashgrid.encode_plan(gt, torch.float32, 100, _H100_SMS)


def test_encode_plan_raises_on_other_table_types():
    with pytest.raises(TypeError):
        hashgrid.encode_plan(tenc.hashgrid_config(), torch.float16, 100,
                             _H100_SMS)


@pytest.mark.parametrize("app,n,group", [
    ("nerf", 131072, 2), ("nvr", 131072, 2), ("nsdf", 4096, 1),
    ("gia", 4096, 1), ("nerf", 1, 1)])
def test_encode_bwd_plan_sizes_the_accumulator_against_l2(app, n, group):
    """The backward's level groups at Table-I width: the largest G whose
    groups' f32 accumulator rows fit BWD_L2_SHARE_BYTES (nerf: two hashed
    levels of 2^19 x 2, 8 MiB), made smaller while the grid leaves SMs of
    an H100 idle (4096 points: 32 tiles)."""
    g = tfields.make_field_config(app, "hash").grid
    plan = hashgrid.encode_bwd_plan(g, n, _H100_SMS)
    assert plan["group_levels"] == group
    assert plan["n_groups"] == -(-g.n_levels // group)
    assert plan["group_accumulator_bytes"] <= hashgrid.BWD_L2_SHARE_BYTES \
        or group == 1
    if n == 131072:
        bigger = hashgrid._group_bytes(hashgrid.level_table_bytes(
            g, torch.float32), 2 * group)
        assert bigger > hashgrid.BWD_L2_SHARE_BYTES
    with pytest.raises(ValueError):
        hashgrid.encode_bwd_plan(dataclasses.replace(g, n_features=4), n,
                                 _H100_SMS)
