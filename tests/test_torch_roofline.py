"""The port's roofline terms and counting mode (``launch/roofline.py``),
the kernels' work (``kernels/cost.py``) and the wrappers' meta routes.

``rooflines`` and ``model_flops`` are held to the JAX package's functions
on the same inputs and ``H100_SXM``, exactly. ``kernels/cost.py`` is held
to the formulas ``chip_smoke.py``'s ``kernels`` phase wrote inline before
they moved there (copied below as they were). The counter's FLOPs, bytes
and peak are held to toy functions counted by hand.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import fields
from repro_torch.core.encoding import GridConfig
from repro_torch.kernels import cost
from repro_torch.kernels.fused_field import ops as ff_ops
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.hashgrid import ops as h_ops
from repro_torch.kernels.ray_march import ops as rm_ops
from repro_torch.launch import roofline
from tests.torch_lm_parity import one_torch_thread  # noqa: F401


def test_h100_peaks():
    hw = roofline.H100_SXM
    assert (hw["peak_flops_bf16"], hw["peak_flops_tf32"],
            hw["peak_flops_f32"], hw["hbm_bw"]) == (989e12, 495e12, 67e12,
                                                    3.35e12)
    assert hw["hbm_bytes"] == 80e9
    assert (hw["ici_link_bw"], hw["ib_bw"]) == (450e9, 50e9)


@pytest.mark.parametrize("cost_,coll,chips", [
    ({"flops": 3.9e15, "bytes accessed": 4.6e13}, 1.5e10, 256),
    ({"flops": 1.0, "bytes accessed": 7e15}, 0, 512),
    ({"flops": 5e16}, 8e12, 1),
    (None, 3, 2)])
def test_rooflines_match_jax(cost_, coll, chips):
    assert roofline.rooflines(cost_, coll, chips) == jroofline.rooflines(
        cost_, coll, chips, hw=roofline.H100_SXM)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b"])
def test_model_flops_match_jax(arch, shape):
    cfg = registry.get_config(arch)
    n = cfg.active_param_count()
    assert roofline.model_flops(cfg, SHAPES[shape], n) == \
        jroofline.model_flops(cfg, JSHAPES[shape], n)


# ------------------------------------------------------------- kernels/cost
def _old_grid(n, gg, itemsize, quantized, rows):
    """chip_smoke.py's inline ``grid_work`` before the move."""
    return {"bytes": n * gg.dim * 4 + rows * gg.n_features * itemsize
            + (gg.n_levels * 4 if quantized else 0),
            "flops": n * gg.n_levels * (1 << gg.dim)
            * (gg.dim + (3 if quantized else 2) * gg.n_features)}


def _old_mlp_flops(m):
    return 2 * (m.in_dim * m.hidden_dim
                + (m.n_hidden - 1) * m.hidden_dim ** 2
                + m.hidden_dim * m.out_dim)


@pytest.mark.parametrize("app,kind", [("nerf", "hash"), ("gia", "hash"),
                                      ("nsdf", "dense"), ("nvr", "tiled")])
@pytest.mark.parametrize("itemsize,quantized", [(4, False), (2, False),
                                                (1, True)])
def test_cost_matches_the_old_inline_formulas(app, kind, itemsize,
                                              quantized):
    cfg = fields.make_field_config(app, kind)
    gg = cfg.grid
    m = cfg.density_mlp or cfg.mlp
    n, rows, wbytes = 4096 * 32, 123_457, 37_000
    old = _old_grid(n, gg, itemsize, quantized, rows)
    assert cost.field_fwd(n, gg, m, itemsize, quantized, wbytes, rows) == {
        "bytes": old["bytes"] + wbytes + n * m.out_dim * 4,
        "flops": old["flops"], "mlp_flops": n * _old_mlp_flops(m),
        "launches": 1}
    assert cost.encode_fwd(n, gg, itemsize, quantized, rows) == {
        "bytes": old["bytes"] + n * gg.out_dim * 4, "flops": old["flops"],
        "mlp_flops": 0, "launches": 1}
    assert cost.mlp_fwd(n, m, wbytes) == {
        "bytes": n * (m.in_dim + m.out_dim) * 4 + wbytes, "flops": 0,
        "mlp_flops": n * _old_mlp_flops(m), "launches": 1}
    table_numel = gg.n_levels * gg.table_size * gg.n_features
    corners = n * gg.n_levels * (1 << gg.dim)
    assert cost.encode_bwd(n, gg, table_numel, itemsize) == {
        "bytes": (n * gg.dim + n * gg.out_dim) * 4 + table_numel * itemsize,
        "flops": corners * (gg.dim + 2 * gg.n_features), "mlp_flops": 0,
        "launches": 1}


@pytest.mark.parametrize("r,s,dts", [(4096, 32, 32), (4096, 32, 4096 * 32),
                                     (1, 1, 1)])
def test_composite_cost_matches_the_old_inline_formula(r, s, dts):
    b = r * s
    assert cost.composite_fwd(r, s, dts) == {
        "bytes": b * 4 * 4 + dts * 4 + r * 4 * 4, "flops": b * 16,
        "mlp_flops": 0, "launches": 1}


def test_distinct_rows_bound():
    """min(points x 2^d, the level's reachable rows), per level."""
    g = GridConfig(dim=3, n_levels=3, n_features=2, log2_table_size=12,
                   base_resolution=4, growth=4.0, kind="hash")
    # levels: res 4 (125 rows, dense), 16 (17^3 > 4096: hashed), 64
    assert [cost.level_rows(g, l) for l in range(3)] == [125, 4096, 4096]
    assert cost.distinct_rows(g, 10) == 80 + 80 + 80
    assert cost.distinct_rows(g, 1000) == 125 + 4096 + 4096


# ------------------------------------------------------- the counting mode
def test_counter_counts_a_toy_by_hand():
    """x (1000 f32) is the argument. a = x * 2 and b = a + 1 are both
    live (8000 bytes), then a is dropped and b.sum() leaves b and a
    scalar: peak 8000. Bytes: mul 4000 + 4000, add 4000 + 4000, sum
    4000 + 4; the mm of (8, 16) bf16 by (16, 4) counts 2*8*16*4 FLOPs."""
    x = torch.empty(1000, device="meta")
    with roofline.Counter([x]) as c:
        a = x * 2
        b = a + 1
        del a
        s = b.sum()
        del b
        mm = torch.empty(8, 16, dtype=torch.bfloat16, device="meta") @ \
            torch.empty(16, 4, dtype=torch.bfloat16, device="meta")
    c.outputs(s)
    r = c.result()
    assert r["argument_bytes"] == 4000 and r["output_bytes"] == 4
    assert r["temp_bytes"] == 8000
    assert r["peak_bytes"] == 12000
    assert r["flops_by_dtype"] == {"bfloat16": 2 * 8 * 16 * 4}
    # the two empties write nothing; the mm reads 256 + 128, writes 64
    assert r["op_bytes"] == 8000 + 8000 + 4004 + (256 + 128 + 64)
    assert mm.shape == (8, 4)


def test_counter_keeps_what_autograd_saves():
    """exp saves its result y for the backward, so dropping the name y
    frees nothing: after z (40 bytes) the live bytes are y, the scalar s
    and z, 4044. The backward then adds the seed (4) and exp's gradient
    (4000), after which exp releases y before mul's gradient is made:
    peak 4044 + 4 + 4000."""
    w = torch.empty(1000, device="meta", requires_grad=True)
    x = torch.empty(1000, device="meta")
    with roofline.Counter([w, x]) as c:
        h = w * x
        y = h.exp()
        del h
        s = y.sum()
        del y
        z = torch.zeros(10, device="meta")
        live = c.result()["temp_bytes"], c._live_bytes
        (g,) = torch.autograd.grad(s, [w])
    assert g.shape == w.shape and z.shape == (10,)
    assert live == (8000, 4044)
    assert c.result()["temp_bytes"] == 8048


def test_counter_reports_views_as_no_bytes():
    """Views and detach move nothing; a reshape of a transpose is a copy
    (8192 bytes read, 8192 written and held)."""
    x = torch.empty(64, 32, device="meta")
    with roofline.Counter([x]) as c:
        x.t()
        x.reshape(-1)[:10]
        x.detach()
    r = c.result()
    assert r["op_bytes"] == 0 and r["temp_bytes"] == 0
    with roofline.Counter([x]) as c:
        y = x.t().reshape(-1)
    r = c.result()
    assert (r["op_bytes"], r["temp_bytes"]) == (16384, 8192)
    assert y.shape == (2048,)


# -------------------------------------------------------- the meta routes
def _nerf():
    cfg = fields.make_field_config("nerf", "hash")
    return cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=10,
                                             n_levels=4))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _weights(m, dtype=torch.float32):
    w = {"w_in": _meta(m.in_dim, m.hidden_dim, dtype=dtype),
         "w_out": _meta(m.hidden_dim, m.out_dim, dtype=dtype)}
    if m.n_hidden > 1:
        w["w_hidden"] = _meta(m.n_hidden - 1, m.hidden_dim, m.hidden_dim,
                              dtype=dtype)
    return w


def _calls():
    """name -> (a call on meta tensors, its expected output shapes, the
    work kernels/cost.py gives it)."""
    cfg = _nerf()
    g, m = cfg.grid, cfg.density_mlp
    n = 300
    pts = _meta(n, 3)
    tab = _meta(g.n_levels, g.table_size, g.n_features)
    tab8 = _meta(g.n_levels, g.table_size, g.n_features, dtype=torch.int8)
    scales = _meta(g.n_levels, 1, 1)
    w = _weights(m)
    wb = cost.tensor_bytes(w.values())
    x = _meta(n, cfg.mlp.in_dim)
    cw = _weights(cfg.mlp)
    rgb, sigma, dts = _meta(n, 32, 3), _meta(n, 32), _meta(1, 32)
    cot = _meta(n, g.out_dim)
    return {
        "field_fwd": (lambda: ff_ops.field(pts, tab, w, g, m), [(n, 16)],
                      cost.field_fwd(n, g, m, 4, False, wb)),
        "field_fwd_q": (lambda: ff_ops.field(pts, tab8, w, g, m,
                                             table_scales=scales),
                        [(n, 16)], cost.field_fwd(n, g, m, 1, True, wb)),
        "encode_fwd": (lambda: h_ops.encode(pts, tab, g), [(n, 8)],
                       cost.encode_fwd(n, g, 4, False)),
        "encode_bwd": (lambda: h_ops.encode_vjp(pts, tab, g, cot, False),
                       [None, tuple(tab.shape)],
                       cost.encode_bwd(n, g, tab.numel(), 4)),
        "mlp_fwd": (lambda: mlp_ops.mlp(cw, x, cfg.mlp), [(n, 3)],
                    cost.mlp_fwd(n, cfg.mlp, cost.tensor_bytes(
                        cw.values()))),
        "composite_fwd": (lambda: rm_ops.composite(rgb, sigma, dts),
                          [(n, 3), (n,)], cost.composite_fwd(n, 32, 32))}


@pytest.mark.parametrize("name", ["field_fwd", "field_fwd_q", "encode_fwd",
                                  "encode_bwd", "mlp_fwd", "composite_fwd"])
def test_meta_route_records_the_kernels_work(name):
    from repro_torch import kernels as K
    call, shapes, work = _calls()[name]
    K.reset_launch_counts()
    with roofline.Counter() as c:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [None if o is None else tuple(o.shape) for o in out] == shapes
    assert all(o is None or o.device.type == "meta" for o in out)
    assert c.result()["kernels"] == {name: work}
    assert not any(K.launch_counts().values())     # nothing launched
    with pytest.raises(ValueError, match="outside a counting mode"):
        call()


def test_meta_route_refuses_a_mix_of_devices():
    cfg = _nerf()
    with roofline.Counter(), pytest.raises(ValueError, match="meta"):
        h_ops.encode(torch.zeros(4, 3), _meta(4, 1024, 2), cfg.grid)


def test_summarize_keys_and_terms():
    """The JAX record's keys (``fits_h100_80g`` for ``fits_v5e_16g``), and
    each unit's peak in the compute term."""
    class Mem:
        argument_size_in_bytes, output_size_in_bytes = 10, 2
        temp_size_in_bytes = 5
    ref = jroofline.summarize("x", {"flops": 1.0}, Mem(), "", 4, 1.0)
    w = cost.field_fwd(1000, _nerf().grid, _nerf().density_mlp, 4, False,
                       100)
    counted = {"flops": 2 * 10 ** 12, "flops_by_dtype": {
        "bfloat16": 10 ** 12, "float32": 10 ** 12}, "bytes": 10 ** 9,
        "kernels": {"field_fwd": w}, "argument_bytes": 10,
        "output_bytes": 2, "temp_bytes": 5, "n_ops": 3}
    rec = roofline.summarize("x", counted, 4, 1.0,
                             coll={"all-gather": 900e6, "all-reduce": 100e6,
                                   "links": {"all-gather": "nvlink",
                                             "all-reduce": "ib"}})
    assert set(ref) <= set(rec)
    want = set(ref["memory_analysis"]) - {"fits_v5e_16g"} | {"fits_h100_80g"}
    assert want == set(rec["memory_analysis"])
    hw = roofline.H100_SXM
    assert np.isclose(rec["compute_s"], 1e12 / hw["peak_flops_bf16"]
                      + 1e12 / hw["peak_flops_f32"]
                      + roofline.kernel_ops_s(w))
    assert np.isclose(rec["collective_s"], 900e6 / 450e9 + 100e6 / 50e9)
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"],
                                 rec["collective_s"])
    assert rec["collectives"]["link_all-reduce"] == "ib"
