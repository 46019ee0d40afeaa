"""repro_torch's observability (``obs/log``, ``obs/export``, ``obs/trace``)
and health stack (``runtime/health``) against the JAX package's, on the
CPU, and their wiring into the port's serve and train engines.

The JSON-lines records, the Chrome traces made from the same
``perf_counter`` stamps, the schema verdicts and the health decisions under
one simulated clock must be the same in both packages; the engines'
metrics snapshots must validate and carry the JAX engines' keys for the
same scenes, stream and steps.
"""
import copy
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common.param import unbox
from repro.core import fields as jfields
from repro.core import pipeline as jpipeline
from repro.obs import export as jexport
from repro.obs import log as jlog
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.runtime import health as jhealth
from repro.serve import RenderEngine as JRenderEngine
from repro.serve import RenderRequest as JRenderRequest
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpipeline
from repro_torch.data import scenes as tscenes
from repro_torch.obs import export as texport
from repro_torch.obs import log as tlog
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import health as thealth
from repro_torch.serve import RenderEngine, RenderRequest
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from tests.conftest import small_field_config

SRC = Path(__file__).resolve().parents[1] / "src"


def _records(text):
    """The JSON records of a stream's lines, ``ts`` dropped."""
    out = []
    for line in text.strip().splitlines():
        rec = json.loads(line)
        assert isinstance(rec.pop("ts"), float)
        out.append(rec)
    return out


@pytest.fixture
def tracers():
    """Both packages' process tracers, disabled and emptied after."""
    yield jtrace.TRACER, ttrace.TRACER
    for tr in (jtrace.TRACER, ttrace.TRACER):
        tr.disable()
        tr.clear()


# ------------------------------------------------------------------- log
@pytest.mark.parametrize("level", ["debug", "info", "warning", "error"])
def test_logger_records_match_jax(level):
    """The same calls at each threshold give the same records but ``ts``."""
    out = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        lg = mod.Logger("serve", level=level, stream=buf)
        lg.debug("chunk", start=0, n_steps=4, step_ms=1.25)
        lg.info("served", n_requests=8, p50_ms=1.5, nested={"k": [1, 2]},
                obj=object.__name__)
        lg.warning("bucket_leak", traces=2, buckets=1)
        lg.error("boom")
        lg.log("info", "any", x=None)
        out.append(_records(buf.getvalue()))
    assert out[0] == out[1]
    assert len(out[1]) == {"debug": 5, "info": 4, "warning": 2,
                           "error": 1}[level]
    for rec in out[1]:
        assert list(rec)[:3] == ["level", "logger", "event"]


def test_logger_reads_repro_log_level_as_jax():
    """``REPRO_LOG_LEVEL`` sets the default threshold at import, in both."""
    code = ("import sys\n"
            "from repro.obs import log as a\n"
            "from repro_torch.obs import log as b\n"
            "for m in (a, b):\n"
            "    lg = m.get_logger('t')\n"
            "    lg.info('no'); lg.warning('yes', m=m.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu",
                              "REPRO_LOG_LEVEL": "warning"})
    assert out.returncode == 0, out.stderr
    recs = _records(out.stdout)
    assert [r["event"] for r in recs] == ["yes", "yes"]
    assert [r["m"] for r in recs] == ["repro.obs.log", "repro_torch.obs.log"]
    with pytest.raises(ValueError):
        tlog.set_level("loud")
    assert tlog.get_logger("same") is tlog.get_logger("same")


# ----------------------------------------------------------------- trace
def _stamped_events(tr, epoch):
    tr._epoch = epoch
    tr.enable()
    tr.add_event("serve.submit", epoch + 0.5, epoch + 0.75, cat="serve",
                 bucket=0, scene="s0")
    tr.add_event("serve.block", epoch + 1.0, epoch + 0.9, cat="serve",
                 bucket=1)
    tr.add_event("train.chunk", epoch + 2.0, epoch + 3.5, cat="train",
                 start=0, n_steps=4, host="host0")
    tr.add_event("encode", epoch + 4.0, epoch + 4.25, cat="phase")
    tr.add_event("dropped", epoch + 5.0, epoch + 6.0)


def test_chrome_trace_matches_jax(tmp_path):
    """The same perf_counter stamps give the same Chrome trace (drops and
    all), the same phase totals, and a trace each validator accepts."""
    objs = []
    for name, mod in (("j", jtrace), ("t", ttrace)):
        tr = mod.Tracer(max_events=4)
        _stamped_events(tr, 100.0)
        assert tr.dropped == 1
        obj = tr.export(tmp_path / f"{name}.json")
        assert json.loads((tmp_path / f"{name}.json").read_text()) == obj
        objs.append((obj, tr.phase_totals(), tr.phase_totals(cat="serve")))
    assert objs[0] == objs[1]
    obj = objs[1][0]
    assert obj["metadata"] == {"dropped_events": 1}
    assert obj["traceEvents"][1]["dur"] == 0.0        # t1 < t0 clamps
    jexport.validate_chrome_trace(obj)
    texport.validate_chrome_trace(obj)


def test_disabled_tracer_hands_out_shared_null_span():
    tr = ttrace.Tracer()
    assert tr.span("a") is tr.span("b") is ttrace._NULL_SPAN
    with tr.span("a") as sp:
        assert sp.bind(42) == 42
    tr.add_event("x", 0.0, 1.0)
    assert tr.events() == [] and not ttrace.TRACER.enabled


def test_add_event_makes_no_system_call(monkeypatch):
    """The hot path keeps raw stamps: no ``os.getpid()`` per event, yet
    each record carries this process's id and the recording thread's."""
    tr = ttrace.Tracer()
    tr._epoch = 100.0
    tr.enable()
    pid = ttrace.os.getpid()

    def boom():
        raise AssertionError("os.getpid() called on the hot path")
    monkeypatch.setattr(ttrace.os, "getpid", boom)
    tr.add_event("serve.submit", 101.0, 101.5, cat="serve", bucket=0)
    monkeypatch.undo()
    (ev,) = tr.events()
    assert ev["pid"] == pid
    assert ev["tid"] == ttrace.threading.get_ident() % (1 << 31)
    assert (ev["ts"], ev["dur"]) == (1e6, 0.5e6)


def test_span_nesting_matches_jax():
    """Nested spans carry the JAX tracer's depth, parent and args."""
    shapes = []
    for mod in (jtrace, ttrace):
        tr = mod.Tracer()
        tr.enable()
        with tr.span("outer", cat="host"):
            with tr.span("inner", cat="phase", bucket=0):
                pass
        evs = tr.events()
        inner, outer = evs
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
        shapes.append([(e["name"], e["cat"], e["ph"], e["args"])
                       for e in evs])
    assert shapes[0] == shapes[1]


def test_synced_span_waits_only_when_synced(monkeypatch):
    """A synced span waits at close on its bound value; an async one never
    calls the wait; a CPU tensor creates no CUDA event."""
    waits = []
    real = ttrace._wait_for
    monkeypatch.setattr(ttrace, "_wait_for",
                        lambda v: (waits.append(v), real(v)))
    monkeypatch.setattr(torch.cuda, "Event", None)   # any use would raise
    x = torch.ones(3)
    for sync in (False, True):
        tr = ttrace.Tracer()
        tr.enable(sync=sync)
        with tr.span("s") as sp:
            sp.bind({"a": [x, (x,)]})
        with tr.span("unbound"):
            pass
    assert len(waits) == 1 and waits[0]["a"][0] is x
    assert list(ttrace._cuda_tensors({"a": [x, (x,)], "b": 3})) == []


def test_time_fn_is_a_median_of_timed_calls():
    calls = []
    t = ttrace.time_fn(lambda a: calls.append(a) or torch.ones(2) * a, 3,
                       warmup=2, iters=5)
    assert t >= 0.0 and calls == [3] * 7


def test_annotate_is_a_null_context_without_a_profiler():
    a, b = ttrace.annotate("encode"), ttrace.annotate("mlp")
    assert a is b
    with a:
        pass


@pytest.mark.parametrize("fused", [True, False])
def test_annotate_names_the_phases_under_the_profiler(fused):
    """Under torch.profiler the field's phases appear as ranges: the fused
    route's ``encode_mlp``, the unfused route's ``encode`` and ``mlp``; the
    serve tile's ``raymarch`` and ``composite``."""
    cfg = tfields.make_field_config("nerf", "hash")
    ct = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=10,
                                           n_levels=2))
    params = tfields.init_field(ct, torch.Generator().manual_seed(0), "cpu")
    settings = tpipeline.RenderSettings(tile_pixels=16, n_samples=4,
                                        fused=fused)
    tile = tpipeline.make_tile_fn(ct, settings)
    cam = tscenes.orbit_camera(4, 4, 0.0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with ttrace.annotate("host"):
            tile(params, cam, torch.arange(16))
    names = {e.name for e in prof.events()}
    want = {"host", "raymarch", "mlp", "composite"}
    want |= {"encode_mlp"} if fused else {"encode"}
    assert want <= names
    assert ("encode_mlp" in names) == fused


# ---------------------------------------------------------------- export
_GOOD = {"counters": {"serve.requests": 3}, "gauges": {"g": -1.5},
         "histograms": {"h": {"count": 1, "sum": 0.1, "min": 0.1,
                              "max": 0.1, "p50": 0.1, "p90": 0.1,
                              "p99": 0.1}}}


def _broken(edit):
    snap = copy.deepcopy(_GOOD)
    edit(snap)
    return snap


_SNAPSHOTS = {
    "good": _GOOD,
    "empty": {"counters": {}, "gauges": {}, "histograms": {}},
    "missing_gauges": _broken(lambda s: s.pop("gauges")),
    "extra_top_key": _broken(lambda s: s.update(extra={})),
    "negative_counter": _broken(lambda s: s["counters"].update(c=-1)),
    "bool_counter": _broken(lambda s: s["counters"].update(c=True)),
    "string_gauge": _broken(lambda s: s["gauges"].update(g="x")),
    "hist_missing_p99": _broken(lambda s: s["histograms"]["h"].pop("p99")),
    "hist_extra_key": _broken(lambda s: s["histograms"]["h"].update(p95=1)),
    "hist_not_object": _broken(lambda s: s["histograms"].update(h=[1])),
    "not_an_object": [1, 2],
}


def _verdict(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return "ok"


@pytest.mark.parametrize("name", sorted(_SNAPSHOTS))
def test_snapshot_validation_verdicts_match_jax(name):
    snap = _SNAPSHOTS[name]
    got = _verdict(texport.validate_snapshot, snap)
    assert got == _verdict(jexport.validate_snapshot, snap)
    assert (got == "ok") == (name in ("good", "empty"))


_TRACES = {
    "good": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0,
                              "dur": 1.0, "pid": 1, "tid": 1}]},
    "no_events": {"other": []},
    "events_not_list": {"traceEvents": {}},
    "missing_pid": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0,
                                     "dur": 1.0, "tid": 1}]},
    "negative_dur": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0,
                                      "dur": -1.0, "pid": 1, "tid": 1}]},
    "negative_ts": {"traceEvents": [{"name": "a", "ph": "i", "ts": -1.0,
                                     "pid": 1, "tid": 1}]},
    "name_not_str": {"traceEvents": [{"name": 3, "ph": "i", "ts": 0.0,
                                      "pid": 1, "tid": 1}]},
}


@pytest.mark.parametrize("name", sorted(_TRACES))
def test_chrome_trace_verdicts_match_jax(name):
    got = _verdict(texport.validate_chrome_trace, _TRACES[name])
    assert got == _verdict(jexport.validate_chrome_trace, _TRACES[name])
    assert (got == "ok") == (name == "good")


def test_default_schema_is_the_checked_in_file(tmp_path):
    """``validate_snapshot`` with and without the explicit path agree."""
    path = SRC.parent / "benchmarks" / "schemas" / \
        "metrics_snapshot.schema.json"
    bad = _SNAPSHOTS["hist_extra_key"]
    assert _verdict(texport.validate_snapshot, bad) == _verdict(
        texport.validate_snapshot, bad, path) != "ok"
    assert texport.load_schema(path) == jexport.load_schema(path)


# ---------------------------------------------------------------- health
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _health_run(mod, scenario):
    """Drive one package's monitor, detector and policy through one
    scenario under a simulated clock; returns every decision made."""
    clk = _Clock()
    reg = tmetrics.Registry() if mod is thealth else jmetrics.Registry()
    mon = mod.HeartbeatMonitor(timeout_s=10.0, clock=clk)
    det = mod.StragglerDetector(window=8, threshold=1.5, registry=reg)
    pol = mod.FailurePolicy(mon, det, persistence_steps=5)
    rng = np.random.default_rng(0)
    hosts = ["h0", "h1", "h2", "h3"]
    out = []
    for step in range(30):
        clk.t = float(step)
        for h in hosts:
            if scenario == "dead" and h == "h2" and step > 5:
                continue
            mon.beat(h)
            if scenario == "silent" and h == "h3":
                continue
            slow = scenario == "straggler" and h == "h1" and step >= 4
            det.record(h, float(rng.uniform(0.9, 1.1)) * (3.0 if slow
                                                          else 1.0))
        ev = pol.poll(step)
        out.append((step, mon.dead_hosts(), mon.alive_hosts(),
                    det.stragglers(), pol.silent_hosts(),
                    None if ev is None else (ev.kind, ev.hosts, ev.step),
                    reg.snapshot()["gauges"]))
    out.append(reg.snapshot())
    return out


@pytest.mark.parametrize("scenario", ["healthy", "dead", "straggler",
                                      "silent"])
def test_health_decisions_match_jax(scenario):
    t, j = _health_run(thealth, scenario), _health_run(jhealth, scenario)
    assert t == j
    events = {e[5][0] for e in t[:-1] if e[5] is not None}
    assert events == {"healthy": set(), "dead": {"dead"},
                      "straggler": {"straggler"}, "silent": set()}[scenario]
    texport.validate_snapshot(t[-1])
    assert t[-1]["histograms"]["health.step_s.h0"]["count"] == 30
    assert t[-1]["gauges"]["health.silent_hosts"] == (
        1 if scenario == "silent" else 0)


def test_policy_defaults_to_the_process_registry():
    pol = thealth.FailurePolicy(thealth.HeartbeatMonitor(),
                                thealth.StragglerDetector())
    assert pol.registry is tmetrics.REGISTRY is tmetrics.get_registry()


# --------------------------------------------------------- serve engine
def _serve_stream(pkg):
    """The JAX test_obs mixed stream (2 gia scenes, 12 requests) through
    one package's engine; the same numpy params for both."""
    cj = small_field_config("gia", "hash", log2_T=10, n_levels=4)
    ct = tfields.make_field_config("gia", "hash")
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=10,
                                          n_levels=4))
    params = [jax.tree.map(np.asarray, unbox(jfields.init_field(
        jax.random.PRNGKey(s), cj))[0]) for s in range(2)]
    if pkg == "jax":
        engine = JRenderEngine(jpipeline.RenderSettings(tile_pixels=64))
        request, cams = JRenderRequest, None
        from repro.data import scenes as jscenes
        cams = [jscenes.orbit_camera(8, 8, a) for a in (0.0, 2.1, 4.2)]
        for s, p in enumerate(params):
            engine.add_scene(f"s{s}", cj, p)
    else:
        reg = tmetrics.Registry()
        engine = RenderEngine(tpipeline.RenderSettings(tile_pixels=64),
                              device="cpu", metrics_registry=reg)
        assert engine.obs is reg
        request = RenderRequest
        cams = [tscenes.orbit_camera(8, 8, a) for a in (0.0, 2.1, 4.2)]
        for s, p in enumerate(params):
            engine.add_scene(f"s{s}", ct, tfields.from_jax_params(p, ct,
                                                                  "cpu"))
    engine.warmup()
    rng = np.random.default_rng(0)
    for r in range(12):
        ids = rng.integers(0, 64, 48).astype(np.int32)
        engine.submit(request(scene=f"s{r % 2}", camera=cams[r % 3],
                              pixel_ids=ids))
    engine.flush()
    return engine


def _shape(snap):
    """A snapshot's names, counter values and histogram counts."""
    return ({k: v for k, v in snap["counters"].items()}, sorted(
        snap["gauges"]), {k: h["count"] for k, h in
                          snap["histograms"].items()})


def test_engine_snapshot_has_the_jax_engines_keys(tracers):
    """The same scenes and stream: the port engine's snapshot validates and
    has the JAX engine's counters, gauges and histograms with the same
    counts; with the tracers enabled both emit the same serve events (4
    a request, warmup excluded) with the same args, in the order each
    retires its requests."""
    jtr, ttr = tracers
    jtr.enable()
    ttr.enable()
    js = _serve_stream("jax").stats()
    ts = _serve_stream("torch").stats()
    texport.validate_snapshot(ts["metrics"])
    assert _shape(ts["metrics"]) == _shape(js["metrics"])
    assert ts["n_traces_total"] == js["n_traces_total"] == 1
    assert ts["metrics"]["counters"]["serve.compiles"] == 1
    for key in js:
        assert key in ts, key

    def events(tr):     # retire order follows the device: compare as sets
        return sorted((e["name"], e["cat"], sorted(e["args"].items()))
                      for e in tr.events())
    assert events(ttr) == events(jtr)
    names = [e[0] for e in events(ttr)]
    for phase in ("submit", "dispatch", "block", "slice"):
        assert names.count(f"serve.{phase}") == 12


def test_disabled_tracer_adds_nothing_to_the_submit_path(monkeypatch):
    """With the process tracer disabled the engine never reaches
    ``add_event``, and records no event."""
    assert not ttrace.TRACER.enabled

    def boom(*a, **k):
        raise AssertionError("add_event called while disabled")
    monkeypatch.setattr(ttrace.TRACER, "add_event", boom)
    engine = _serve_stream("torch")
    assert engine.stats()["n_requests"] == 12
    assert ttrace.TRACER.events() == []


# --------------------------------------------------------- train engine
def _toy_train(pkg, steps, chunk, monitor=None, registry=None):
    """One package's TrainEngine on a toy quadratic: params w (8,),
    batches from the step, chunks of ``chunk``."""
    target = np.linspace(-1.0, 1.0, 8, dtype=np.float32)
    if pkg == "jax":
        import jax.numpy as jnp
        step_fn = jloop.make_scanned_step(
            lambda p, b: jnp.mean((p["w"] - b["x"]) ** 2),
            joptim.AdamConfig(lr=1e-2))
        eng = jloop.TrainEngine(
            jloop.EngineConfig(steps=steps, chunk_steps=chunk),
            step_fn, device_batch_fn=lambda s: {
                "x": jnp.asarray(target) + 0.0 * s},
            monitor=monitor, metrics_registry=registry)
        state = jloop.init_train_state({"w": jnp.zeros(8)})
    else:
        step_fn = tloop.make_scanned_step(
            lambda p, b: torch.mean((p["w"] - b["x"]) ** 2),
            toptim.AdamConfig(lr=1e-2))
        eng = tloop.TrainEngine(
            tloop.EngineConfig(steps=steps, chunk_steps=chunk), step_fn,
            batch_fn=lambda s: {"x": torch.from_numpy(target)},
            monitor=monitor, metrics_registry=registry)
        state = tloop.init_train_state({"w": torch.zeros(8)})
    eng.run(state)
    return eng


def test_train_engine_metrics_trace_and_logs_match_jax(tracers, capsys,
                                                      monkeypatch):
    """Ten steps in chunks of 4: both engines' snapshots have the same
    names and counts (train.step_s, train.steps, health.step_s.host0,
    health.silent_hosts), the same train.chunk events and the same debug
    ``chunk`` log records but their times."""
    jtr, ttr = tracers
    jtr.enable()
    ttr.enable()
    monkeypatch.setattr(jloop._LOG, "level", "debug")
    monkeypatch.setattr(tloop._LOG, "level", "debug")
    shapes, events, logs = [], [], []
    for pkg, tr in (("jax", jtr), ("torch", ttr)):
        capsys.readouterr()
        eng = _toy_train(pkg, steps=10, chunk=4)
        recs = _records(capsys.readouterr().out)
        for r in recs:
            assert r.pop("step_ms") >= 0
        logs.append(recs)
        shapes.append(_shape(eng.obs.snapshot()))
        events.append([(e["name"], e["cat"], e["args"])
                       for e in tr.events()])
        assert eng.events == [] and eng.host == "host0"
    assert shapes[0] == shapes[1] == (
        {"train.steps": 10}, ["health.silent_hosts"],
        {"train.step_s": 3, "health.step_s.host0": 3})
    assert events[0] == events[1] and len(events[1]) == 3
    assert logs[0] == logs[1] and [r["event"] for r in logs[1]] == [
        "chunk"] * 3


def test_train_engine_failure_event_matches_jax(capsys):
    """A host that heartbeat once and then went silent past the timeout is
    dead at the first poll: both engines append the same FailureEvent and
    log the same ``failure_event`` warning."""
    out = []
    for pkg, mod in (("jax", jhealth), ("torch", thealth)):
        clk = _Clock()
        mon = mod.HeartbeatMonitor(timeout_s=5.0, clock=clk)
        mon.beat("ghost")
        clk.t = 100.0
        capsys.readouterr()
        eng = _toy_train(pkg, steps=6, chunk=4, monitor=mon,
                         registry=(tmetrics.Registry() if pkg == "torch"
                                   else jmetrics.Registry()))
        recs = [r for r in _records(capsys.readouterr().out)
                if r["event"] == "failure_event"]
        assert all(r["hint"] == "see runtime/elastic.py" for r in recs)
        out.append(([(e.kind, e.hosts, e.step) for e in eng.events], recs))
    assert out[0][0] == out[1][0] == [("dead", ("ghost",), 3),
                                      ("dead", ("ghost",), 5)]
    assert out[0][1] == out[1][1] and len(out[1][1]) == 2
    assert out[1][1][0]["level"] == "warning"
