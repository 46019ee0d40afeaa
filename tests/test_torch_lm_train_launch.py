"""The port's LM training runtime on the CPU: the token stream and its
prefetcher against the JAX package's ``data/tokens.py``, compressed and
micro-batched train steps, the engine's host batches, a checkpointed run
interrupted and resumed, ``launch/train.py`` and the ``train_lm`` twin
against their JAX counterparts, and the train state's fit check.
"""
import argparse
import dataclasses
import json
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.parallel import api as japi
from repro.train import optim as joptim
from repro_torch.common.param import tree_map
from repro_torch.configs import registry
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as ttrain
from repro_torch.obs.trace import TRACER
from repro_torch.parallel import api as tapi
from repro_torch.train import loop, optim as toptim
from tests import torch_lm_parity as P
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# reduced olmoe in bf16, 24 steps: the (2, 2) tensor-parallel curve against
# one device's differs by up to 1.6e-3 (the whole-copy step by 1.4e-3)
MESH_BF16_TOL = 5e-3


# ---------------------------------------------------------------- tokens
@pytest.mark.parametrize("seed,n_hosts,vocab", [(0, 1, 256), (3, 4, 512),
                                                 (7, 2, 50280)])
def test_synthetic_tokens_equal_jax_bit_for_bit(seed, n_hosts, vocab):
    kw = dict(vocab_size=vocab, seq_len=64, global_batch=8, seed=seed)
    for host in range(n_hosts):
        j = jtokens.SyntheticTokens(jtokens.DataConfig(**kw), host, n_hosts)
        t = ttokens.SyntheticTokens(ttokens.DataConfig(**kw), host, n_hosts)
        np.testing.assert_array_equal(t.motifs, j.motifs)
        np.testing.assert_array_equal(t.unigram, j.unigram)
        for step in (0, 1, 5, 1000):
            a, b = t.batch(step)["tokens"], j.batch(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_data_config_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(ttokens.DataConfig)] == \
        [f.name for f in dataclasses.fields(jtokens.DataConfig)]
    assert ttokens.DataConfig(1, 2, 3).__dict__ == \
        jtokens.DataConfig(1, 2, 3).__dict__


def test_prefetcher_yields_in_order_and_moves_items():
    cfg = ttokens.DataConfig(vocab_size=512, seq_len=64, global_batch=8,
                             seed=3)
    ref = jtokens.SyntheticTokens(jtokens.DataConfig(**cfg.__dict__))
    pf = ttokens.Prefetcher(iter(ttokens.SyntheticTokens(cfg)), depth=2,
                            to_device=lambda b: torch.from_numpy(
                                b["tokens"]))
    for step in range(4):
        np.testing.assert_array_equal(next(pf).numpy(),
                                      ref.batch(step)["tokens"])
    pf.close()


def test_prefetcher_raises_the_iterators_error():
    def bad():
        yield 1
        raise KeyError("boom")
    pf = ttokens.Prefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(KeyError):
        next(pf)


# ------------------------------------------------------------ the config
def test_train_config_and_optimizer_spec_equal_jax():
    t, j = tapi.TrainConfig(), japi.TrainConfig()
    assert dataclasses.asdict(t.optimizer) == dataclasses.asdict(j.optimizer)
    assert (t.num_microbatches, t.compression, t.compression_topk,
            t.cast_params_once) == (j.num_microbatches, j.compression,
                                    j.compression_topk, j.cast_params_once)
    specs = {"w": ("embed", "mlp")}
    assert tuple(toptim.optimizer_spec(specs)) == \
        tuple(joptim.optimizer_spec(specs))


@pytest.mark.parametrize("compression", ["topk", "int8"])
def test_compressed_train_steps_match_jax(compression):
    got, state = P.port_train_curve("h2o-danube-1.8b", compression)
    P.assert_curves_close(got, P.jax_train_curve("h2o-danube-1.8b",
                                                 compression))
    assert set(state["efb"]) == set(state["params"])


def test_microbatches_match_one_pass():
    """qwen2-vl's stub batch (embeddings, labels and (3, B, S) M-RoPE
    positions, split on axis 1) in 2 micro-batches against one pass: the
    loss, the grad norm and the params after one step."""
    cfg, _, params = P.port_train_params("qwen2-vl-72b")
    batch = P.torch_batch(cfg, P.inputs(cfg), labels=True)
    assert batch["positions"].shape[0] == 3
    out = {}
    for nmb in (1, 2):
        step, _ = tapi.make_train_step(
            cfg, train_cfg=tapi.TrainConfig(num_microbatches=nmb))
        state = tapi.make_train_state(tree_map(torch.clone, params))
        with P.f32_unembed():
            state, m = step(state, batch)
        out[nmb] = (m, state["params"])
    for k in ("loss", "grad_norm"):
        P.assert_close(out[2][0][k], float(out[1][0][k]), k)
    P.assert_tree_close(out[2][1], tree_map(lambda a: a.numpy(), out[1][1]),
                        path="params")


def test_engine_takes_exactly_one_batch_source():
    cfg = loop.EngineConfig(steps=1)
    with pytest.raises(ValueError):
        loop.TrainEngine(cfg, lambda s, i, b: (s, {}))
    with pytest.raises(ValueError):
        loop.TrainEngine(cfg, lambda s, i, b: (s, {}),
                         batch_fn=lambda i: {}, host_batch_fn=lambda i: {})


# ------------------------------------------------ the launcher and resume
def _run(cfg, ckpt, steps=16, stop_after=None):
    losses = []

    def on_step(step, loss, st):
        losses.append((step, loss))
        if stop_after is not None and step == stop_after:
            raise KeyboardInterrupt

    try:
        ttrain.train_loop(cfg, steps=steps, seq_len=32, global_batch=4,
                          ckpt_dir=ckpt, ckpt_every=4, chunk_steps=4,
                          on_step=on_step, device="cpu")
    except KeyboardInterrupt:
        pass
    return losses


def test_train_loop_interrupted_and_resumed_replays_bit_for_bit(tmp_path):
    """olmoe (MoE) reduced: a run stopped in its third chunk resumes from
    its step-7 checkpoint at step 8, and its losses from there equal an
    uninterrupted run's exactly."""
    cfg = registry.reduced_config("olmoe-1b-7b")
    full = _run(cfg, str(tmp_path / "a"))
    assert [s for s, _ in full] == list(range(16))
    assert np.mean([l for _, l in full[-4:]]) < np.mean(
        [l for _, l in full[:4]])
    part = _run(cfg, str(tmp_path / "b"), stop_after=10)
    assert part[-1][0] == 10
    resumed = _run(cfg, str(tmp_path / "b"))
    assert resumed[0][0] == 8
    assert resumed == full[8:]


def test_launcher_flags_are_jax_plus_device(monkeypatch):
    def parser_of(main):
        seen = []

        class Stop(Exception):
            pass

        def catch(self, args=None, namespace=None):
            seen.append(self)
            raise Stop
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Stop):
            main()
        monkeypatch.undo()
        return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                         a.type, type(a).__name__, a.required)
                for a in seen[0]._actions}

    for jmain, tmain in (
            (jtrain.main, ttrain.main),
            (runpy.run_path(str(ROOT / "examples/train_lm.py"))["main"],
             runpy.run_path(str(ROOT / "examples/torch/train_lm.py"))
             ["main"])):
        jflags, tflags = parser_of(jmain), parser_of(tmain)
        assert set(tflags) - set(jflags) == {"device"}
        assert set(jflags) <= set(tflags)
        for dest in jflags:
            assert tflags[dest] == jflags[dest], dest
        assert tflags["device"][:2] == (("--device",), "cuda")


def test_launcher_refuses_a_mesh_and_an_encdec(monkeypatch, capsys):
    """``--data 2 --model 2`` (refused until the LM sharding, ROADMAP
    A14.5) trains reduced olmoe on a (2, 2) mesh of the four CPUs the
    local device list is patched to: its losses equal ``train_loop``'s on
    that mesh, and follow ``train_loop``'s on one device step by step
    within ``MESH_BF16_TOL`` (the tensor-parallel step sums in another
    order, in bf16; the curve on random tokens is flat, so whether its
    last steps' mean falls below its first steps' is noise on either
    device). An encoder-decoder is still refused."""
    from repro_torch.launch import mesh as lmesh
    monkeypatch.setattr(lmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--data", "2", "--model",
            "2", "--steps", "24", "--batch", "4", "--seq", "16",
            "--chunk-steps", "8", "--device", "cpu"]
    capsys.readouterr()
    ttrain.main(argv)
    trained = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()
               if json.loads(line)["event"] == "trained"][0]
    mesh = lmesh.make_local_mesh(2, 2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    _, losses = ttrain.train_loop(registry.reduced_config("olmoe-1b-7b"),
                                  mesh, steps=24, seq_len=16,
                                  global_batch=4, chunk_steps=8,
                                  device="cpu")
    assert trained["loss_first"] == round(losses[0], 4)
    assert trained["loss_last"] == round(losses[-1], 4)
    _, one = ttrain.train_loop(registry.reduced_config("olmoe-1b-7b"),
                               steps=24, seq_len=16, global_batch=4,
                               chunk_steps=8, device="cpu")
    assert np.max(np.abs(np.subtract(losses, one))) <= MESH_BF16_TOL
    with pytest.raises(ValueError, match="build_train_step"):
        ttrain.train_loop(registry.reduced_config("whisper-base"), steps=1,
                          seq_len=8, global_batch=2, device="cpu")


def test_launcher_runs_and_logs_the_jax_events(tmp_path, capsys):
    TRACER.clear()
    try:
        ttrain.main(["--arch", "mamba2-2.7b", "--reduced", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--chunk-steps", "2",
                     "--device", "cpu", "--trace-out",
                     str(tmp_path / "t.json"), "--metrics-out",
                     str(tmp_path / "m.json")])
    finally:
        TRACER.disable()
        TRACER.clear()
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    events = [r["event"] for r in recs]
    assert events[0] == "step" and "trained" in events
    assert {"metrics_written", "trace_written"} <= set(events)
    trace = json.loads((tmp_path / "t.json").read_text())
    assert sum(e.get("name") == "train.chunk"
               for e in trace["traceEvents"]) == 2
    snap = json.loads((tmp_path / "m.json").read_text())
    assert "train.step_s" in json.dumps(snap)


def test_train_lm_twin_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/torch/train_lm.py"),
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if not l.startswith("{")]
    assert lines[0].startswith("arch=olmoe-1b-7b (reduced: 2L d=64)")
    assert lines[-1].startswith("loss: ")


# ---------------------------------------------------------- the fit check
def test_check_fits_refuses_a_train_state_larger_than_the_card(monkeypatch):
    """On a stubbed 80 GB card: olmoe-1b-7b's train state (6.92 B params x
    16 bytes, and its bf16 copy) is refused; h2o-danube-1.8b's fits;
    nothing is drawn (the check runs on a meta-device init)."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10**9, 80 * 10**9))
    dev = torch.device("cuda", 0)
    tc = tapi.TrainConfig()
    olmoe = registry.get_config("olmoe-1b-7b")
    with pytest.raises(MemoryError, match="its train state takes 1"):
        tapi.check_fits(olmoe, dev, train_cfg=tc)
    tapi.check_fits(olmoe, dev, compute_dtype=olmoe.adtype)   # serving fits
    danube = registry.get_config("h2o-danube-1.8b")
    tapi.check_fits(danube, dev, train_cfg=tc)
    n = tapi.param_bytes(danube) // 4
    assert tapi.train_state_bytes(danube, tc) == pytest.approx(
        16 * n + 2 * n, rel=1e-3)
    assert tapi.train_state_bytes(danube, dataclasses.replace(
        tc, compression="topk")) - tapi.train_state_bytes(danube, tc) == \
        4 * n
