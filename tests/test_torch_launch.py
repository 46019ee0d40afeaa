"""repro_torch's render launcher (``python -m repro_torch.launch.serve``)
against the JAX package's ``repro.launch.serve``, on the CPU.

The launchers build the same field configs, take the same flags (but
``--use-pallas`` and ``--trace-sync``, which the port drops, and
``--device``, which it adds),
and a tiny run of each logs the same events with the same keys. What the
port has not ported raises.
"""
import argparse
import dataclasses
import json

import pytest
import torch

import repro.core.train as jtrain_mod
import repro_torch.core.train as ttrain_mod
from repro.launch import serve as jserve
from repro.obs import trace as jtrace
from repro_torch.launch import serve as tserve
from repro_torch.obs import export as texport
from repro_torch.obs import trace as ttrace


class _Stop(Exception):
    pass


def _built_config(mod, train_mod, monkeypatch, **kw):
    """The field config a launcher's ``serve_render`` trains: its
    ``train_field`` replaced by one that records the config and stops."""
    seen = []

    def fake(cfg, **_):
        seen.append(cfg)
        raise _Stop
    monkeypatch.setattr(train_mod, "train_field", fake)
    with pytest.raises(_Stop):
        mod.serve_render(**kw)
    return seen[0]


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("encoding", ["hash", "dense", "tiled"])
@pytest.mark.parametrize("app", ["nerf", "nvr", "gia", "nsdf"])
def test_serve_render_builds_the_jax_config(app, encoding, quant,
                                            monkeypatch):
    """Field by field (grid, MLPs, name, quant spec): the laptop table by
    default, and with ``log2_table_size=None`` Table I's config."""
    kw = dict(app=app, encoding=encoding, quant=quant)
    cj = _built_config(jserve, jtrain_mod, monkeypatch, **kw)
    ct = _built_config(tserve, ttrain_mod, monkeypatch, device="cpu", **kw)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.grid.log2_table_size == 14
    full = _built_config(tserve, ttrain_mod, monkeypatch, device="cpu",
                         log2_table_size=None, **kw)
    table1 = jtrain_mod.fields.make_field_config(app, encoding)
    assert dataclasses.asdict(full.with_quant(None)) == dataclasses.asdict(
        table1)


def _parser_of(main, monkeypatch):
    """The parser a launcher's ``main`` builds, caught at parse time."""
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise _Stop
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Stop):
        main([])
    monkeypatch.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     type(a).__name__)
            for a in seen[0]._actions}


def test_parser_flags_are_jax_minus_use_pallas_plus_device(monkeypatch):
    jflags = _parser_of(jserve.main, monkeypatch)
    tflags = _parser_of(tserve.main, monkeypatch)
    # --trace-sync: the port's spans never wait on the device; its
    # device intervals give device completion without a wait
    assert set(jflags) - set(tflags) == {"use_pallas", "trace_sync"}
    # --full: the JAX --reduced is on by default and cannot be turned off
    assert set(tflags) - set(jflags) == {"device", "full"}
    for dest in set(jflags) & set(tflags):
        assert tflags[dest] == jflags[dest], dest
    assert tflags["device"][:2] == (("--device",), "cuda")


def _run_main(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in lines]      # one object a line


def test_tiny_runs_log_the_same_events_with_the_same_keys(tmp_path, capsys):
    """nvr, culled and int8-quantized, 2 training steps per scene, 2
    requests of 64 pixels at 16x16, traced and with a snapshot: both
    launchers log the same event names in the same order, each with the
    same keys; the port's trace and snapshot validate."""
    argv = ["--app", "nvr", "--occupancy", "--quant", "int8",
            "--train-steps", "2", "--requests", "2", "--tile-pixels", "64",
            "--height", "16", "--width", "16"]
    runs = {}
    try:
        for name, main, extra in (("jax", jserve.main, []),
                                  ("torch", tserve.main,
                                   ["--device", "cpu"])):
            runs[name] = _run_main(main, argv + extra + [
                "--trace-out", str(tmp_path / f"{name}_trace.json"),
                "--metrics-out", str(tmp_path / f"{name}_metrics.json")],
                capsys)
    finally:
        for tr in (jtrace.TRACER, ttrace.TRACER):
            tr.disable()
            tr.clear()

    def shape(recs):
        return [(r["event"], r["logger"], r["level"], sorted(r))
                for r in recs]
    assert shape(runs["torch"]) == shape(runs["jax"])
    events = [r["event"] for r in runs["torch"]]
    assert events == ["train_scene", "scene_trained", "scene_quantized"] * 2 \
        + ["warmup", "served", "occupancy_culling", "frame_budget_4k",
           "metrics_written", "trace_written"]
    served = runs["torch"][events.index("served")]
    assert served["n_requests"] == 2 and served["compiles"] == 1
    trace = json.loads((tmp_path / "torch_trace.json").read_text())
    texport.validate_chrome_trace(trace)
    names = [e["name"] for e in trace["traceEvents"]]
    for phase in ("submit", "dispatch", "block", "slice"):
        assert names.count(f"serve.{phase}") == 2
    assert names.count("train.chunk") == 2
    texport.validate_snapshot(json.loads(
        (tmp_path / "torch_metrics.json").read_text()))


@pytest.mark.parametrize("argv", [["--shard", "--mode", "lm"],
                                  ["--mode", "lm"]])
def test_what_is_not_ported_raises(argv, capsys):
    """The LM mode serves, with ``--shard`` too (its 1 x 1 local mesh is
    one device), and what raised here until the LM sharding (ROADMAP
    A14.5) serves: ``serve_lm`` on a mesh of two devices gives the
    one-device tokens (its sample), the batch split over 'data'."""
    capsys.readouterr()
    tserve.main(argv + ["--device", "cpu"])
    records = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["event"] for r in records] == ["lm_served", "lm_sample"]
    from repro_torch.launch.mesh import Mesh
    two = Mesh([torch.device("cpu")] * 2, ("data",))
    tserve.serve_lm("olmoe-1b-7b", batch=2, prompt_len=8, gen_len=4,
                    device="cpu", mesh=two)
    tserve.serve_lm("olmoe-1b-7b", batch=2, prompt_len=8, gen_len=4,
                    device="cpu")
    sampled = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert [r["event"] for r in sampled] == ["lm_served", "lm_sample"] * 2
    assert sampled[1]["tokens"] == sampled[3]["tokens"]


def test_launcher_without_a_gpu_raises(monkeypatch):
    """No ``--device``: CUDA or an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--train-steps", "1"])
    with pytest.raises(ValueError, match="occupancy"):
        tserve.serve_render(app="gia", occupancy=True, device="cpu")
