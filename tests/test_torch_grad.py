"""repro_torch's backward passes against the JAX package's, on the CPU.

The port's differentiable wrappers (``hashgrid/ops.encode``,
``fused_field/ops.field``, ``fused_mlp/ops.mlp``) are
``torch.autograd.Function``s; on CPU tensors their forward and backward
run the plain versions (the encode's backward is the ``index_add_`` twin
``kernels/hashgrid/vjp.py``). They are held against the JAX package's
custom VJPs (``jax.vjp`` of its ``ops`` wrappers, Pallas in interpret
mode), against ``jax.grad`` of its pure encode, and, for whole losses,
against ``jax.grad`` of ``repro.core.train.field_loss`` on the same
JAX-made batch and params. The compositing wrapper and quantized tables
refuse gradients (the guards of fault C1).

Tolerance: f32 gradients within 1e-5 of the leaf's max abs value (the
same operations, summed in another order: XLA's dots and segment sums
against PyTorch's matmuls and ``index_add_``). bf16 tables: the table
gradient is summed in f32 and rounded once to bf16 on both sides, so the
same bar holds on the f32 sums before the cast and one bf16 ulp after.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common.param import unbox
from repro.core import encoding as jenc
from repro.core import fields as jfields
from repro.core import train as jtrain
from repro.core.mlp import MLPConfig as JMLPConfig
from repro.data import scenes as jscenes
from repro.kernels.fused_field import ops as jff_ops
from repro.kernels.fused_mlp import ops as jmlp_ops
from repro.kernels.hashgrid import vjp as jvjp
from repro_torch.core import encoding as tenc
from repro_torch.core import fields as tfields
from repro_torch.core import render as trender
from repro_torch.core import train as ttrain
from repro_torch.core.fields import leaf_from_numpy
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.hashgrid import ops as hops
from repro_torch.kernels.hashgrid import vjp as tvjp
from repro_torch.kernels.ray_march import ops as rm_ops
from repro_torch.quant import QuantSpec, quantize_field
from repro_torch.train import loop as tloop
from tests.conftest import small_field_config

TOL = 1e-5


def _rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    return err / scale if scale else err


def _grids(dim, log2_T, n_levels=4):
    growth = 1.25992 if dim == 2 else 1.51572
    kw = dict(log2_table_size=log2_T, n_levels=n_levels)
    return (dataclasses.replace(jenc.hashgrid_config(dim=dim, growth=growth),
                                **kw),
            dataclasses.replace(tenc.hashgrid_config(dim=dim, growth=growth),
                                **kw))


def _points(rng, n, dim):
    """Random points, with the cube's corners 0 and 1 and points on cell
    faces of every level (coordinates k / 16, k / 20: level 0's and, in
    2-D, level 1's vertices), where a weight factor is exactly 0 or 1."""
    pts = rng.uniform(size=(n, dim)).astype(np.float32)
    pts[0], pts[1] = 0.0, 1.0
    pts[2] = 0.25
    pts[3] = [0.5] + [0.3] * (dim - 1)
    pts[4] = [0.55] * dim                  # 11 / 20
    pts[5, 0] = 0.0
    return pts


# (dim, log2_T): 3-D with dense and hashed levels, 2-D all hashed past
# level 0, 2-D all dense
_GRID_CASES = [(3, 14), (2, 8), (2, 14)]


def _is_hashed(gt):
    return [gt.level_is_hashed(l) for l in range(gt.n_levels)]


@pytest.mark.parametrize("dim,log2_T", _GRID_CASES)
@pytest.mark.parametrize("table", ["f32", "bf16"])
def test_encode_vjp_twin_matches_jax_vjp(dim, log2_T, table):
    gj, gt = _grids(dim, log2_T)
    rng = np.random.default_rng(dim * 100 + log2_T)
    tables = rng.uniform(-1, 1, (4, gt.table_size, 2)).astype(np.float32)
    if table == "bf16":
        tables = tables.astype(ml_dtypes.bfloat16)
    pts = _points(rng, 150, dim)
    g = rng.uniform(-1, 1, (150, gt.out_dim)).astype(np.float32)
    jp, jt = jvjp.encode_bwd(jnp.asarray(pts), jnp.asarray(tables), gj,
                             jnp.asarray(g))
    tp, tt = tvjp.encode_bwd(torch.from_numpy(pts), leaf_from_numpy(tables),
                             gt, torch.from_numpy(g))
    assert tt.dtype == (torch.bfloat16 if table == "bf16" else torch.float32)
    assert _rel_err(tp.numpy(), jp) <= TOL
    tt32 = tt.float().numpy()
    jt32 = np.asarray(jt, np.float32)
    if table == "f32":
        assert _rel_err(tt32, jt32) <= TOL
    else:      # f32 sums within TOL, then one rounding to bf16 each
        assert np.all(np.abs(tt32 - jt32) <= 2 ** -8 * np.abs(jt32) + 1e-30)
    none, tt2 = tvjp.encode_bwd(torch.from_numpy(pts),
                                leaf_from_numpy(tables), gt,
                                torch.from_numpy(g), need_points=False)
    assert none is None and torch.equal(tt2, tt)


@pytest.mark.parametrize("dim,log2_T", _GRID_CASES)
def test_encode_function_matches_jax_grad_of_grid_encode(dim, log2_T):
    """The encode's autograd Function against jax.grad of the pure encode
    (the oracle the JAX package's VJP is tested against), for the points
    and the tables."""
    gj, gt = _grids(dim, log2_T)
    hashed = _is_hashed(gt)
    assert (True in hashed) == (log2_T == 8 or dim == 3)
    rng = np.random.default_rng(dim + log2_T)
    tables = rng.uniform(-1, 1, (4, gt.table_size, 2)).astype(np.float32)
    pts = _points(rng, 150, dim)
    g = rng.uniform(-1, 1, (150, gt.out_dim)).astype(np.float32)
    jp, jt = jax.grad(lambda p, t: jnp.sum(jenc.grid_encode(p, t, gj) * g),
                      argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(tables))
    p = torch.from_numpy(pts).requires_grad_(True)
    t = torch.from_numpy(tables).requires_grad_(True)
    (hops.encode(p, t, gt) * torch.from_numpy(g)).sum().backward()
    assert _rel_err(p.grad.numpy(), jp) <= TOL
    assert _rel_err(t.grad.numpy(), jt) <= TOL


def _mlp_np(m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"w_in": (m.in_dim, m.hidden_dim),
              "w_out": (m.hidden_dim, m.out_dim)}
    if m.n_hidden > 1:
        shapes["w_hidden"] = (m.n_hidden - 1, m.hidden_dim, m.hidden_dim)
    return {k: (rng.normal(size=s) / np.sqrt(s[-2])).astype(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("n_hidden", [1, 3])
@pytest.mark.parametrize("dim,log2_T", [(3, 10), (2, 8)])
def test_field_backward_matches_jax_vjp(n_hidden, dim, log2_T):
    """The field Function's gradients (points, tables, every weight)
    against jax.vjp of the JAX package's fused field (its Pallas forward in
    interpret mode, its rematerialising custom VJP), ``w_hidden``-less
    MLPs included."""
    gj, gt = _grids(dim, log2_T)
    mj = JMLPConfig(in_dim=gj.out_dim, n_hidden=n_hidden, out_dim=16)
    mt = MLPConfig(in_dim=gt.out_dim, n_hidden=n_hidden, out_dim=16)
    rng = np.random.default_rng(n_hidden + dim)
    tables = rng.uniform(-1, 1, (4, gt.table_size, 2)).astype(np.float32)
    pts = _points(rng, 96, dim)
    w = _mlp_np(mt, n_hidden)
    g = rng.uniform(-1, 1, (96, 16)).astype(np.float32)

    def jfield(p, t, wts):
        return jff_ops.field(p, t, wts, gj, mj, interpret=True)
    _, vjp_fn = jax.vjp(jfield, jnp.asarray(pts), jnp.asarray(tables),
                        jax.tree.map(jnp.asarray, w))
    jp, jt, jw = vjp_fn(jnp.asarray(g))
    tt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in dict(w, tables=tables, pts=pts).items()}
    out = ff_ops.field(tt["pts"], tt["tables"], {k: tt[k] for k in w}, gt, mt)
    out.backward(torch.from_numpy(g))
    assert _rel_err(tt["pts"].grad.numpy(), jp) <= TOL
    assert _rel_err(tt["tables"].grad.numpy(), jt) <= TOL
    assert set(jw) == set(w)
    for k in w:
        assert _rel_err(tt[k].grad.numpy(), jw[k]) <= TOL, k


@pytest.mark.parametrize("in_dim,n_hidden,out_dim", [(32, 4, 3), (16, 1, 16),
                                                     (13, 2, 5)])
def test_mlp_backward_matches_jax_vjp(in_dim, n_hidden, out_dim):
    mj = JMLPConfig(in_dim=in_dim, n_hidden=n_hidden, out_dim=out_dim)
    mt = MLPConfig(in_dim=in_dim, n_hidden=n_hidden, out_dim=out_dim)
    rng = np.random.default_rng(in_dim)
    x = rng.uniform(-1, 1, (77, in_dim)).astype(np.float32)
    w = _mlp_np(mt, in_dim + n_hidden)
    g = rng.uniform(-1, 1, (77, out_dim)).astype(np.float32)
    _, vjp_fn = jax.vjp(lambda xx, wts: jmlp_ops.mlp(wts, xx, mj,
                                                     interpret=True),
                        jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    jx, jw = vjp_fn(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    mlp_ops.mlp(tw, tx, mt).backward(torch.from_numpy(g))
    assert _rel_err(tx.grad.numpy(), jx) <= TOL
    for k in w:
        assert _rel_err(tw[k].grad.numpy(), jw[k]) <= TOL, k


def _cfgs(app, log2_T=10, n_levels=4):
    cj = small_field_config(app, "hash", log2_T=log2_T, n_levels=n_levels)
    ct = tfields.make_field_config(app, "hash")
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=log2_T,
                                          n_levels=n_levels))
    return cj, ct


def jax_start(app, batch_size, seed=0, log2_T=10, n_levels=4):
    """(JAX config, port config, the JAX engine's initial params and the
    batch function of its RNG contract, both as numpy)."""
    cj, ct = _cfgs(app, log2_T, n_levels)
    k_init, k_data = jtrain._data_keys(seed)
    params, _ = unbox(jfields.init_field(k_init, cj))
    cam = jscenes.default_camera() if app in ("nerf", "nvr") else None

    def batch(step):
        b = jtrain.make_batch(cj, jax.random.fold_in(k_data, step),
                              batch_size, cam)
        return {k: np.asarray(v) for k, v in b.items()}
    return cj, ct, jax.tree.map(np.asarray, params), batch


def _t_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_field_loss_grads_match_jax(app):
    """The whole loss: the JAX package's field_loss (its XLA route) and the
    port's (the kernel wrappers' Functions, plain on the CPU; ray apps
    composite with the plain composite) on JAX's initial params, trained
    for one step so that the tables are not near 0, and JAX's batch."""
    cj, ct, np_params, batch = jax_start(app, 48)
    step = jtrain.make_field_train_step(cj)
    opt = jtrain.optim.adam_init(np_params)
    np_params, _, _ = step(np_params, opt, batch(0))
    np_params = jax.tree.map(np.asarray, np_params)
    b = batch(1)
    jl, jg = jax.value_and_grad(jtrain.field_loss)(np_params, cj, b)
    tl, tg = tloop.value_and_grad(
        lambda p, bb: ttrain.field_loss(p, ct, bb),
        tfields.from_jax_params(np_params, ct, "cpu"), _t_batch(b))
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    flat_j = jax.tree_util.tree_leaves_with_path(jg)
    assert len(flat_j) == sum(1 for _ in _leaves(tg))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        got = tg
        for k in keys:
            got = got[k]
        assert _rel_err(got.numpy(), leaf) <= TOL, keys


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("which", ["rgb", "sigma", "dts"])
def test_composite_refuses_gradients(which):
    """The compositing kernel has no backward: its wrapper raises on every
    device when a gradient would be needed, and runs under no_grad."""
    rng = np.random.default_rng(0)
    t = {"rgb": torch.from_numpy(rng.uniform(size=(5, 7, 3)).astype(
        np.float32)),
         "sigma": torch.from_numpy(rng.uniform(size=(5, 7)).astype(
             np.float32)),
         "dts": torch.full((1, 7), 0.1)}
    t[which].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        rm_ops.composite(t["rgb"], t["sigma"], t["dts"])
    with torch.no_grad():
        pix, _ = rm_ops.composite(t["rgb"], t["sigma"], t["dts"])
    assert pix.shape == (5, 3)


def test_render_rays_trains_through_the_plain_composite():
    """render_rays composites with the plain, differentiable composite
    unless the caller asks for the kernel (the serving tiles do); the
    kernel route refuses a gradient."""
    origins = torch.zeros((4, 3))
    dirs = torch.nn.functional.normalize(torch.ones((4, 3)), dim=-1)
    w = torch.tensor([0.3, -0.2, 0.5, 0.1], requires_grad=True)

    def field(p, d):
        return torch.sigmoid(p[:, :1] * w + d[:, :1])

    pix = trender.render_rays(field, origins, dirs, n_samples=8)
    pix.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    with pytest.raises(NotImplementedError, match="no backward"):
        trender.render_rays(field, origins, dirs, n_samples=8,
                            use_kernel_composite=True)
    with torch.no_grad():
        served = trender.render_rays(field, origins, dirs, n_samples=8,
                                     use_kernel_composite=True)
    torch.testing.assert_close(served, pix.detach(), atol=0, rtol=0)


@pytest.mark.parametrize("qtype", ["int8", "fp8_e4m3"])
def test_quantized_tables_refuse_gradients(qtype):
    """int8 and fp8 tables are inference only: the field (codes with f32
    weights that require a gradient), the encode and the backward's twin
    raise; without a gradient they run."""
    _, ct = _cfgs("gia")
    params = tfields.from_jax_params(
        {"grid": np.random.default_rng(1).uniform(
            -1, 1, tfields.param_shapes(ct)["grid"]).astype(np.float32),
         "mlp": _mlp_np(ct.mlp, 2)}, ct, "cpu")
    q = quantize_field(params, QuantSpec(qtype))
    pts = torch.rand((16, 2), generator=torch.Generator().manual_seed(0))
    w = {k: v.clone().requires_grad_(True) for k, v in q["mlp"].items()}
    with pytest.raises(NotImplementedError, match="inference only"):
        ff_ops.field(pts, q["grid"], w, ct.grid, ct.mlp,
                     table_scales=q["grid_scale"])
    with pytest.raises(NotImplementedError, match="inference only"):
        hops.encode(pts.clone().requires_grad_(True), q["grid"], ct.grid,
                    table_scales=q["grid_scale"])
    with pytest.raises(TypeError, match="inference only"):
        tvjp.encode_bwd(pts, q["grid"], ct.grid,
                        torch.zeros((16, ct.grid.out_dim)))
    with torch.no_grad():
        out = ff_ops.field(pts, q["grid"], w, ct.grid, ct.mlp,
                           table_scales=q["grid_scale"])
    assert out.shape == (16, 3)


def test_gradients_flow_only_where_asked():
    """The Functions return no gradient for inputs that need none, and the
    field's table gradient is the encode backward's of the MLP's input
    gradient."""
    _, gt = _grids(3, 10)
    m = MLPConfig(in_dim=gt.out_dim, n_hidden=2, out_dim=4)
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(rng.uniform(-1, 1, (4, gt.table_size, 2))
                              .astype(np.float32)).requires_grad_(True)
    w = {k: torch.from_numpy(v) for k, v in _mlp_np(m, 3).items()}
    pts = torch.from_numpy(_points(rng, 40, 3))
    out = ff_ops.field(pts, tables, w, gt, m)
    g = torch.from_numpy(rng.uniform(-1, 1, (40, 4)).astype(np.float32))
    (d_tables,) = torch.autograd.grad(out, [tables], g)
    feats = hops.encode(pts, tables.detach(), gt).requires_grad_(True)
    (d_feats,) = torch.autograd.grad(mlp_ops.mlp(w, feats, m), [feats], g)
    _, ref = tvjp.encode_bwd(pts, tables.detach(), gt, d_feats, False)
    torch.testing.assert_close(d_tables, ref, atol=1e-6, rtol=1e-6)
    assert pts.grad is None and all(v.grad is None for v in w.values())
