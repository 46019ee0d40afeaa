"""NeRF's colour head on the CPU: ``fused_mlp/ops.nerf_head`` (the one-launch
head, ``mlp_fwd_head`` on the card) against ``plain_head`` (the op-by-op
head), the route ``core/fields.apply_field`` takes between them, and what
they record on meta tensors. The kernel itself is held against the plain
head on the card by tests/test_torch_cuda.py.

On the CPU ``nerf_head`` runs ``plain_head``, so the two agree bit for bit;
``plain_head`` is held against the head written out op by op.
"""
import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels as tkernels
from repro_torch.core import encoding as tenc
from repro_torch.core import fields as tfields
from repro_torch.core.mlp import apply_mlp
from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_mlp.fused_mlp import nerf_head_cuda
from repro_torch.launch import roofline
from repro_torch.quant import QuantSpec, quantize_field
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

COLOUR = tfields.make_field_config("nerf", "hash").mlp


def _head_inputs(n, seed, w_dtype=torch.float32):
    """dfeat (n, 16), unit directions (n, 3) and colour weights, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    dfeat = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    d = rng.normal(size=(n, 3))
    dirs = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                            .astype(np.float32))
    w = {k: torch.from_numpy((rng.normal(size=s) / np.sqrt(s[-2]))
                             .astype(np.float32)).to(w_dtype)
         for k, s in tfields._mlp_shapes(COLOUR).items()}
    return dfeat, dirs, w


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 17, 300])
def test_nerf_head_on_the_cpu_is_the_plain_head(n, w_dtype):
    dfeat, dirs, w = _head_inputs(n, n, w_dtype)
    got = mlp_ops.nerf_head(dfeat, dirs, w, COLOUR)
    assert got.shape == (n, 4) and got.dtype == torch.float32
    assert torch.equal(got, mlp_ops.plain_head(dfeat, dirs, w, COLOUR))
    # the head written out: sigmoid(MLP([SH, dfeat])), then exp(sigma)
    rgb = torch.sigmoid(apply_mlp(
        w, torch.cat([tenc.sh_encode(dirs), dfeat], dim=-1), COLOUR))
    assert torch.equal(got, torch.cat([rgb, torch.exp(dfeat[:, :1])], -1))


def test_nerf_head_refuses_gradients():
    """The kernel has no backward: a call that needs a gradient raises on
    every device, before anything runs; under no_grad it runs."""
    dfeat, dirs, w = _head_inputs(20, 0)
    for need in ("dfeat", "dirs", "w_out"):
        args = {"dfeat": dfeat.clone(), "dirs": dirs.clone(),
                "w_out": w["w_out"].clone()}
        args[need].requires_grad_(True)
        ws = {**w, "w_out": args["w_out"]}
        with pytest.raises(NotImplementedError, match="no backward"):
            mlp_ops.nerf_head(args["dfeat"], args["dirs"], ws, COLOUR)
        with torch.no_grad():
            mlp_ops.nerf_head(args["dfeat"], args["dirs"], ws, COLOUR)


def _small_nerf(seed=0):
    cfg = tfields.make_field_config("nerf", "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=12,
                                            n_levels=4))
    params = tfields.init_field(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    params["grid"] = torch.rand(params["grid"].shape,
                                generator=torch.Generator().manual_seed(1)
                                ) * 2 - 1
    return cfg, params


@pytest.mark.parametrize("fused,grad_mode,needs,route", [
    (True, False, None, "nerf_head"),
    (True, True, None, "nerf_head"),
    (True, False, "mlp", "nerf_head"),
    (True, True, "mlp", "plain_head"),
    (True, True, "density_mlp", "plain_head"),
    (True, True, "dirs", "plain_head"),
    (False, False, None, "plain_head"),
    (False, True, "mlp", "plain_head")])
def test_apply_field_routes_nerfs_head(monkeypatch, fused, grad_mode, needs,
                                       route):
    """The fused route takes the one-launch head wherever no gradient is
    needed (grad mode off, or nothing that reaches the head requires one);
    training and the unfused route keep the op-by-op head. The output is
    the same either way."""
    cfg, params = _small_nerf()
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(size=(40, 3)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    want = tfields.apply_field(params, cfg, pts, dirs, fused=fused)
    if needs == "dirs":
        dirs.requires_grad_(True)
    elif needs is not None:
        for t in params[needs].values():
            t.requires_grad_(True)
    calls = []
    for name in ("nerf_head", "plain_head"):
        def spy(*a, _name=name, _fn=getattr(mlp_ops, name)):
            calls.append(_name)
            return _fn(*a)
        monkeypatch.setattr(mlp_ops, name, spy)
    with torch.set_grad_enabled(grad_mode):
        got = tfields.apply_field(params, cfg, pts, dirs, fused=fused)
    # on the CPU the one-launch head runs as the plain head
    assert calls == [route] + (["plain_head"] if route == "nerf_head" else [])
    torch.testing.assert_close(got.detach(), want, atol=0, rtol=0)


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict)
            else torch.empty_like(v, device="meta") for k, v in tree.items()}


@pytest.mark.parametrize("quant", [None, QuantSpec("int8", "int8")])
def test_meta_head_records_the_plain_heads_count(monkeypatch, quant):
    """On meta tensors the one-launch head records what the op-by-op head
    records: the same ops' bytes and one mlp_fwd of the colour MLP (with a
    quantized scene's dequantized weights), so a dry run's counts do not
    depend on the route; nothing launches."""
    cfg, params = _small_nerf()
    if quant:
        cfg, params = cfg.with_quant(quant), quantize_field(params, quant)
    params = _meta(params)
    n = 4096
    pts, dirs = torch.empty((n, 3), device="meta"), torch.empty(
        (n, 3), device="meta")
    tkernels.reset_launch_counts()
    counts = []
    for head in ("nerf_head", "plain_head"):
        monkeypatch.setattr(mlp_ops, "nerf_head", getattr(mlp_ops, head))
        with torch.no_grad(), roofline.Counter() as c:
            out = tfields.apply_field(params, cfg, pts, dirs)
        assert out.shape == (n, 4) and out.device.type == "meta"
        counts.append(c.result())
    assert counts[0] == counts[1]
    assert counts[0]["kernels"]["mlp_fwd"]["launches"] == 1
    assert not any(tkernels.launch_counts().values())


def test_nerf_head_cuda_refuses_what_the_kernel_does_not_take():
    """Checked before any launch: the colour MLP's widths (32 -> 3),
    dfeat's shape and its 8-byte alignment (rows read two floats at a
    time)."""
    dfeat, dirs, w = _head_inputs(8, 1)
    other = dataclasses.replace(COLOUR, out_dim=4)
    with pytest.raises(ValueError, match="32 -> 3"):
        nerf_head_cuda(dfeat, dirs, w["w_in"], w["w_hidden"], w["w_out"],
                       other)
    with pytest.raises(ValueError, match="shape"):
        nerf_head_cuda(dfeat[:, :8].contiguous(), dirs, w["w_in"],
                       w["w_hidden"], w["w_out"], COLOUR)
    off = torch.zeros(8 * 16 + 1)[1:].view(8, 16)
    assert off.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="aligned"):
        nerf_head_cuda(off, dirs, w["w_in"], w["w_hidden"], w["w_out"],
                       COLOUR)


def test_head_launches_count_as_mlp_fwd_launches(monkeypatch):
    """A launch of ``mlp_fwd_head`` counts once under its own name and once
    under ``mlp_fwd``, whose kernel it instantiates."""
    from repro_torch.kernels.fused_mlp.fused_mlp import (MLP_FWD,
                                                         MLP_FWD_HEAD)
    assert MLP_FWD_HEAD.counts_as is MLP_FWD
    monkeypatch.setattr(MLP_FWD_HEAD, "_fn", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    tkernels.reset_launch_counts()
    MLP_FWD_HEAD(torch.device("cuda", 0))
    assert {k: n for k, n in tkernels.launch_counts().items() if n} == {
        "mlp_fwd": 1, "mlp_fwd_head": 1}
    tkernels.reset_launch_counts()


def test_head_kernel_constants_mirror_sh_encode():
    """The head's SH constants in csrc/mlp.cu are sh_encode's, digit for
    digit (each rounded to f32 from the same double)."""
    src = inspect.getsource(tenc.sh_encode)
    want = sorted({abs(float(x)) for x in re.findall(r"\d\.\d{6,}", src)})
    got = sorted(float(x) for x in re.findall(
        r"kSh\w+ = \(float\)(\d\.\d+);", (build.CSRC / "mlp.cu").read_text()))
    assert got == want
