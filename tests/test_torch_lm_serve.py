"""The LM port's serving layer on the CPU: ``from_jax_params``, the
``parallel/api`` steps and caches against the JAX package's, the
launcher's ``serve_lm`` and ``--mode lm``, and the example twin
``examples/torch/serve_lm.py`` in a child process."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common.param import unbox as junbox
from repro.configs import registry as jregistry
from repro.models import encdec as jencdec, lm as jlm
from repro.parallel import api as japi
from repro_torch.common.param import KeyGen, tree_leaves
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import encdec as tencdec, lm as tlm
from repro_torch.obs import trace as ttrace
from repro_torch.parallel import api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_params(cfg):
    return jax.tree.map(np.asarray, junbox(jlm.init_lm(
        jax.random.PRNGKey(0), cfg))[0])


def test_from_jax_params_keeps_shapes_and_dtypes():
    cfg = jregistry.reduced_config("qwen2-7b")
    pj = _jax_params(cfg)
    pt = tlm.from_jax_params(pj, tregistry.reduced_config("qwen2-7b"),
                             device="cpu")
    assert jax.tree.structure(pt) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(pt), jax.tree.leaves(pj)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    pj["final_norm"]["scale"] = pj["final_norm"]["scale"].astype(
        jax.numpy.bfloat16)
    pt = tlm.from_jax_params(pj, tregistry.reduced_config("qwen2-7b"),
                             device="cpu")
    assert pt["final_norm"]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("fault,match", [
    ("missing", r"params/blocks/sub0/attn: missing keys \['bq'\]"),
    ("extra", r"params/blocks/sub0/mlp: missing keys \[\], extra keys "
              r"\['w_extra'\]"),
    ("shape", r"params/embedding/table: shape \(255, 64\), expected "
              r"\(256, 64\)"),
    ("leaf", r"params/final_norm: expected a dict")])
def test_from_jax_params_raises_on_a_tree_that_differs(fault, match):
    cfg = jregistry.reduced_config("qwen2-7b")
    pj = _jax_params(cfg)
    if fault == "missing":
        del pj["blocks"]["sub0"]["attn"]["bq"]
    elif fault == "extra":
        pj["blocks"]["sub0"]["mlp"]["w_extra"] = np.zeros(3, np.float32)
    elif fault == "shape":
        pj["embedding"]["table"] = pj["embedding"]["table"][1:]
    else:
        pj["final_norm"] = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match=match):
        tlm.from_jax_params(pj, tregistry.reduced_config("qwen2-7b"),
                             device="cpu")


def test_from_jax_params_encdec_rejects_an_lm_tree():
    with pytest.raises(ValueError, match="missing keys"):
        tencdec.from_jax_params(
            _jax_params(jregistry.reduced_config("qwen2-7b")),
            tregistry.reduced_config("whisper-base"), device="cpu")


@pytest.mark.parametrize("arch", jregistry.list_archs())
def test_make_cache_matches_jax(arch):
    """Same leaves, shapes, dtypes and values as the JAX ``make_cache``
    (ring slots -1, not 0); ``cache_shapes`` of the steps says the same."""
    cj = jregistry.reduced_config(arch)
    ct = tregistry.reduced_config(arch)
    enc = 12 if cj.is_encdec else 0
    want = jax.tree.map(np.asarray, japi.make_cache(cj, 2, 40, enc_len=enc))
    got = api.make_cache(ct, 2, 40, enc_len=enc, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(), b.astype(
            np.float32))
    shapes = api.make_decode_step(ct, capacity=40, batch_size=2,
                                  enc_len=enc)[1]["cache_shapes"]
    assert jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)) \
        == [(tuple(a.shape), a.dtype) for a in jax.tree.leaves(got)]
    if cj.swa_window is not None:
        assert (got["sub0"]["slot_pos"] == -1).all()
        assert got["sub0"]["k"].shape[2] == cj.swa_window   # the ring


def test_cast_params_for_compute_matches_jax_and_drops_the_master():
    """The cast leaves the JAX cast's dtypes; ``init_params(compute_dtype=)``
    gives the same tree bit for bit with no f32 leaf of two or more
    dimensions (no master), and a cast leaf passes the steps' cast."""
    cfg = jregistry.reduced_config("jamba-v0.1-52b")
    pj = _jax_params(cfg)
    want = jax.tree.map(lambda a: str(a.dtype),
                        japi.cast_params_for_compute(pj, cfg.adtype))
    pt = tlm.from_jax_params(pj, tregistry.reduced_config("jamba-v0.1-52b"),
                             device="cpu")
    got = api.cast_params_for_compute(pt, torch.bfloat16)
    assert jax.tree.map(lambda a: str(a.dtype).replace("torch.", ""),
                        got) == want
    assert all(a.dtype == torch.float32 for a in tree_leaves(pt))
    ct = tregistry.reduced_config("jamba-v0.1-52b")
    master = api.init_params(ct, seed=4, device="cpu")
    served = api.init_params(ct, seed=4, device="cpu",
                             compute_dtype=torch.bfloat16)
    assert jax.tree.map(lambda a: str(a.dtype).replace("torch.", ""),
                        served) == want
    for a, b in zip(tree_leaves(served), tree_leaves(
            api.cast_params_for_compute(master, torch.bfloat16))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert api.param_bytes(ct, torch.bfloat16) == sum(
        a.numel() * a.element_size() for a in tree_leaves(served))
    again = api.cast_params_for_compute(served, torch.bfloat16)
    assert again["blocks"]["sub0"]["ssm"]["w_in"] is \
        served["blocks"]["sub0"]["ssm"]["w_in"]


def test_a_model_that_does_not_fit_on_the_card_is_refused(monkeypatch):
    """``init_params`` on a CUDA device measures the tree on the meta
    device against the free memory and raises before drawing."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (80 * 10 ** 9, 80 * 10 ** 9))
    cuda = torch.device("cuda", 0)
    for arch, fits in (("qwen3-32b", True), ("jamba-v0.1-52b", False),
                       ("qwen2-vl-72b", False)):
        cfg = tregistry.get_config(arch)
        bf16 = api.param_bytes(cfg, torch.bfloat16)
        assert abs(bf16 - 2 * cfg.param_count()) < 0.01 * bf16
        with pytest.raises(MemoryError, match=f"{arch}: its params take"):
            api.check_fits(cfg, cuda)                        # f32
        if fits:
            api.check_fits(cfg, cuda, torch.bfloat16)
        else:
            with pytest.raises(MemoryError, match="in bfloat16"):
                api.check_fits(cfg, cuda, torch.bfloat16)
    api.check_fits(tregistry.get_config("jamba-v0.1-52b"), CPU)


def test_serve_lm_raises_on_a_logit_that_is_not_finite(monkeypatch):
    init = api.init_params

    def nan_params(*a, **kw):
        p = init(*a, **kw)
        p["final_norm"]["scale"][0] = float("nan")
        return p
    monkeypatch.setattr(api, "init_params", nan_params)
    with pytest.raises(FloatingPointError, match="yi-6b: a logit"):
        tserve.serve_lm("yi-6b", batch=1, prompt_len=8, gen_len=2,
                        device="cpu")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_api_steps_equal_the_model_functions_on_cast_params(arch):
    """bf16 acts (the configs' own): the steps on the f32 master equal the
    model functions on params cast once, bit for bit."""
    cfg = tregistry.reduced_config(arch)
    params = api.init_params(cfg, seed=3, device="cpu")
    cast = api.cast_params_for_compute(params, cfg.adtype)
    b, s, cap = 2, 12, 20
    enc = s if cfg.is_encdec else 0
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (b, s)))}
    if cfg.is_encdec:
        batch["enc_embeddings"] = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model))).to(cfg.adtype)
    if cfg.frontend == "vision":
        batch = {"embeddings": torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model))).to(cfg.adtype)}
    prefill, _ = api.make_prefill_step(cfg, capacity=cap, batch_size=b,
                                       enc_len=enc)
    decode, _ = api.make_decode_step(cfg, capacity=cap, batch_size=b,
                                     enc_len=enc)
    mod = tencdec if cfg.is_encdec else tlm
    c1 = api.make_cache(cfg, b, cap, enc_len=enc, device="cpu")
    c2 = api.make_cache(cfg, b, cap, enc_len=enc, device="cpu")
    l1, c1 = prefill(params, batch, c1)
    l2, c2 = mod.prefill(cast, cfg, batch, c2)
    assert l1.dtype == torch.float32 and torch.equal(l1, l2)
    tok = torch.argmax(l1, -1)[:, None]
    for i in range(3):
        l1, c1 = decode(params, c1, tok, s + i)
        l2, c2 = mod.decode_step(cast, cfg, tok, s + i, c2)
        assert torch.equal(l1, l2) and torch.isfinite(l1).all()
        tok = torch.argmax(l1, -1)[:, None]


def test_steps_take_one_device_and_refuse_a_larger_mesh():
    """A one-device mesh gives plain tensors; a larger one, refused until
    the LM sharding (ROADMAP A14.5), gives sharded params (a (1, 2) mesh:
    'model' splits storage, one row computes) whose prefill and decode
    equal the one-device steps' on the same params."""
    from repro_torch.parallel import sharded
    cfg = tregistry.reduced_config("yi-6b")
    one = Mesh([CPU], ("data",))
    params = api.init_params(cfg, seed=0, mesh=one)
    assert tree_leaves(params)[0].device == CPU
    api.make_prefill_step(cfg, one, capacity=8)
    two = Mesh([[CPU, CPU]], ("data", "model"))
    sp = api.init_params(cfg, mesh=two)
    assert all(isinstance(l, sharded.Sharded) for l in tree_leaves(sp))
    assert any(l.shards[0].shape != l.shape for l in tree_leaves(sp))
    batch = {"tokens": torch.arange(8).reshape(2, 4) % cfg.vocab_size}
    outs = []
    for mesh, p in ((two, sp), (None, sharded.gather_tree(sp, CPU))):
        pre, info = api.make_prefill_step(cfg, mesh, capacity=8,
                                          batch_size=2)
        dec, _ = api.make_decode_step(cfg, mesh, capacity=8, batch_size=2)
        cache = (api.make_cache(cfg, 2, 8, shardings=info["cache"])
                 if mesh is not None else
                 api.make_cache(cfg, 2, 8, device="cpu"))
        logits, cache = pre(p, batch, cache)
        tok = torch.argmax(logits, -1)[:, None]
        outs.append((logits, dec(p, cache, tok, 4)[0]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_init_params_is_a_function_of_the_seed():
    cfg = tregistry.reduced_config("olmoe-1b-7b")
    a = api.init_params(cfg, seed=5, device="cpu")
    b = api.init_params(cfg, seed=5, device="cpu")
    c = api.init_params(cfg, seed=6, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))
    assert not torch.equal(a["embedding"]["table"], c["embedding"]["table"])
    assert a["blocks"]["sub0"]["moe"]["w_up"].shape == (2, 8, 64, 32)


def test_entry_points_without_a_gpu_raise(monkeypatch):
    """No device named: CUDA or an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tregistry.reduced_config("yi-6b")
    pj = _jax_params(jregistry.reduced_config("yi-6b"))
    pw = jax.tree.map(np.asarray, junbox(jencdec.init_encdec(
        jax.random.PRNGKey(0), jregistry.reduced_config("whisper-base")))[0])
    whisper = tregistry.reduced_config("whisper-base")
    for call in (lambda: api.init_params(cfg),
                 lambda: api.make_cache(cfg, 1, 8),
                 lambda: KeyGen(0),
                 lambda: tlm.from_jax_params(pj, cfg),
                 lambda: tencdec.from_jax_params(pw, whisper),
                 lambda: tlm.init_cache(cfg, 1, 8),
                 lambda: tencdec.init_dec_cache(whisper, 1, 8, 4),
                 lambda: tserve.serve_lm("yi-6b"),
                 lambda: tserve.main(["--mode", "lm"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _records(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_serve_lm_logs_the_jax_records(arch, capsys):
    """The JAX ``serve_lm``'s two records with its keys, 16 tokens."""
    capsys.readouterr()
    t_pre, t_dec = tserve.serve_lm(arch, batch=2, prompt_len=16,
                                   gen_len=4, device="cpu")
    recs = _records(capsys)
    assert [r["event"] for r in recs] == ["lm_served", "lm_sample"]
    assert sorted(recs[0]) == sorted(
        ["ts", "level", "logger", "event", "arch", "prompt_len",
         "prefill_ms", "decode_steps", "decode_ms", "tok_per_s"])
    assert recs[0]["arch"] == arch and recs[0]["decode_steps"] == 4
    assert len(recs[1]["tokens"]) == 4 and t_pre > 0 and t_dec > 0
    assert all(0 <= t < 256 for t in recs[1]["tokens"])


def test_mode_lm_serves_and_traces(tmp_path, capsys):
    capsys.readouterr()
    try:
        tserve.main(["--mode", "lm", "--arch", "h2o-danube-1.8b",
                     "--device", "cpu", "--trace-out",
                     str(tmp_path / "t.json")])
    finally:
        ttrace.TRACER.disable()
        ttrace.TRACER.clear()
    recs = _records(capsys)
    assert [r["event"] for r in recs] == ["lm_served", "lm_sample",
                                          "trace_written"]
    names = [e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]]
    assert names.count("lm.prefill") == 1 and names.count("lm.decode") == 1


def test_full_flag_serves_the_published_config(monkeypatch):
    seen = []
    monkeypatch.setattr(tserve, "serve_lm",
                        lambda arch, reduced, device: seen.append(
                            (arch, reduced, device)))
    tserve.main(["--mode", "lm", "--arch", "qwen2-7b", "--device", "cpu"])
    tserve.main(["--mode", "lm", "--arch", "qwen2-7b", "--device", "cpu",
                 "--full"])
    assert seen == [("qwen2-7b", True, "cpu"), ("qwen2-7b", False, "cpu")]


def test_example_twin_serves_in_a_child():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      "serve_lm.py"),
         "--device", "cpu", "--arch", "jamba-v0.1-52b", "--gen", "3"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()]
    assert recs[0]["event"] == "lm_served" and recs[0]["decode_steps"] == 3
    assert recs[1]["event"] == "lm_sample" and len(recs[1]["tokens"]) == 3


def test_decode_matches_forward_in_the_port():
    """Self-consistency without JAX, as the JAX package's own test: with
    drops switched off (capacity 16x) and the unembed widened to f32, the
    prefill's and each greedy step's logits equal the forward's at that
    position, for a MoE, an SSM and a ring-cache arch."""
    from tests.torch_lm_parity import f32_unembed
    for arch in ("olmoe-1b-7b", "mamba2-2.7b", "h2o-danube-1.8b"):
        cfg = dataclasses.replace(tregistry.reduced_config(arch),
                                  act_dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
        params = api.init_params(cfg, seed=1, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (2, 24)))
        with f32_unembed():
            full, _ = tlm.forward(params, cfg, {"tokens": toks})
            cache = api.make_cache(cfg, 2, 24, device="cpu")
            got, cache = tlm.prefill(params, cfg, {"tokens": toks[:, :16]},
                                     cache)
            torch.testing.assert_close(got, full[:, 15], atol=1e-4,
                                       rtol=1e-4)
            for i in range(16, 24):
                got, cache = tlm.decode_step(params, cfg, toks[:, i:i + 1],
                                             i, cache)
                torch.testing.assert_close(got, full[:, i], atol=1e-4,
                                           rtol=1e-4)
