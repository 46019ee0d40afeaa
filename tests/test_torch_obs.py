"""repro_torch's observability (``obs/log``, ``obs/export``, ``obs/trace``)
and health stack (``runtime/health``) against the JAX package's, on the
CPU, and their wiring into the port's serve and train engines.

The JSON-lines records, the Chrome traces made from the same
``perf_counter`` stamps, the schema verdicts and the health decisions under
one simulated clock must be the same in both packages; the engines'
metrics snapshots must validate and carry the JAX engines' keys for the
same scenes, stream and steps.
"""
import contextlib
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
from repro_torch.serve import engine as tengine
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
    with tr.span("a"):
        pass
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


def test_spans_ns_puts_host_stamps_on_clock_realtime():
    """A span stamped on ``perf_counter`` comes out of ``spans_ns()`` at
    the ``time.time_ns()`` of its start and end, within 1 ms, its
    duration kept to the nanosecond; a host span has no device."""
    tr = ttrace.Tracer()
    tr.enable()
    t0, ns0 = ttrace.time.perf_counter(), ttrace.time.time_ns()
    tr.add_event("serve.submit", t0, t0 + 0.25, cat="serve", req=3)
    with tr.span("outer"):
        ns1 = ttrace.time.time_ns()
    (a, b) = tr.spans_ns()
    assert (a.name, a.cat, a.args, a.device) == ("serve.submit", "serve",
                                                 {"req": 3}, None)
    assert abs(a.start - ns0) < 1_000_000
    assert abs((a.end - a.start) - 250_000_000) <= 1
    assert b.name == "outer" and abs(b.start - ns1) < 1_000_000
    tr.clear()
    assert tr.spans_ns() == []


@pytest.mark.parametrize("profiled", [False, True])
def test_annotate_records_phase_spans_while_the_tracer_is_enabled(
        tracers, profiled):
    """With the tracer enabled ``annotate`` is a ``phase`` span carrying
    its scope's args and its parent, with or without a profiler (under one
    it is a profiler range too); on the CPU it makes no device interval.
    With the tracer and the profiler off it is the one shared null context
    again."""
    _, ttr = tracers
    ttr.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts) if profiled else None
    with prof or contextlib.nullcontext():
        with ttr.scope("cpu", req=7):
            with ttrace.annotate("head"):
                with ttrace.annotate("mlp"):
                    pass
        with ttrace.annotate("adam"):
            pass
    got = [(e["name"], e["cat"], e["args"]) for e in ttr.events()]
    assert got == [
        ("mlp", "phase", {"depth": 1, "parent": "head", "req": 7}),
        ("head", "phase", {"depth": 0, "parent": "", "req": 7}),
        ("adam", "phase", {"depth": 0, "parent": ""})]
    assert all(sp.device is None for sp in ttr.spans_ns())
    if profiled:
        assert {"head", "mlp", "adam"} <= {e.name for e in prof.events()}
    ttr.disable()
    assert ttrace.annotate("head") is ttrace.annotate("adam") \
        is ttrace._NULL_CONTEXT


def test_a_scope_gives_its_spans_args_and_restores_the_outer(tracers):
    """Spans opened in a scope carry its args (a span's own args added);
    an inner scope replaces the outer one until it closes; a disabled
    tracer's scope is the shared null context."""
    _, ttr = tracers
    assert ttr.scope("cpu", req=1) is ttrace._NULL_CONTEXT
    ttr.enable()
    with ttr.scope("cpu", req=1):
        with ttr.scope("cpu", step=5):
            with ttr.span("s", cat="train"):
                pass
        assert ttr._local.scope == (torch.device("cpu"), {"req": 1})
        with ttr.span("t", cat="serve", bucket=0):
            pass
    assert ttr._local.scope is None
    assert [e["args"] for e in ttr.events()] == [
        {"depth": 0, "parent": "", "step": 5},
        {"depth": 0, "parent": "", "req": 1, "bucket": 0}]


def test_device_phases_limit_the_device_intervals(tracers):
    """``enable(phases=...)`` records the named phases alone, each with a
    device interval in a CUDA scope (a CPU scope gives none); the others
    are what ``annotate`` is with the tracer off, the shared null context
    without a profiler and a profiler range under one. ``enable()``
    records every phase again. No CUDA is touched: the spans are made,
    not entered."""
    _, ttr = tracers
    ttr.enable(phases=("head",))
    with ttr.scope("cuda:0", req=1):
        assert ttrace.annotate("head")._device == torch.device("cuda", 0)
        assert ttrace.annotate("mlp") is ttrace._NULL_CONTEXT
    with ttr.scope("cpu", req=1):
        assert ttrace.annotate("head")._device is None
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with ttrace.annotate("mlp"):
            pass
    assert "mlp" in {e.name for e in prof.events()}
    assert ttr.events() == []
    ttr.enable()
    with ttr.scope("cuda:0", req=1):
        assert ttrace.annotate("mlp")._device == torch.device("cuda", 0)


def test_a_missing_device_event_counts_as_dropped():
    """A device interval whose event could not be made (a full buffer)
    is dropped and counted; nothing is recorded while disabled."""
    tr = ttrace.Tracer(max_events=1)
    tr.add_interval("x", "cuda", None, None)
    assert tr.dropped == 0
    tr.enable()
    tr.add_interval("x", "cuda", None, None)
    assert tr.dropped == 1 and tr.spans_ns() == []


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


def _arg_keys(events):
    """The arg keys of each event name in Chrome-trace records."""
    keys = {}
    for e in events:
        keys.setdefault(e["name"], set()).update(e["args"])
    return keys


def _shape(snap):
    """A snapshot's names, counter values and histogram counts."""
    return ({k: v for k, v in snap["counters"].items()}, sorted(
        snap["gauges"]), {k: h["count"] for k, h in
                          snap["histograms"].items()})


def test_engine_snapshot_has_the_jax_engines_keys(tracers):
    """The same scenes and stream: the port engine's snapshot validates and
    has the JAX engine's counters, gauges and histograms with the same
    counts; with the tracers enabled the port's events, restricted to the
    JAX engine's event names and to each name's arg keys, are the JAX
    engine's serve events (4 a request, warmup excluded), in the order
    each retires its requests. The port adds spans and args (its phases,
    ``serve.tile``, ``req``) that the JAX engine does not have."""
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

    keys = _arg_keys(jtr.events())

    def events(tr):     # retire order follows the device: compare as sets
        return sorted((e["name"], e["cat"], sorted(
            (k, v) for k, v in e["args"].items() if k in keys[e["name"]]))
            for e in tr.events() if e["name"] in keys)
    assert events(ttr) == events(jtr)
    names = [e[0] for e in events(ttr)]
    for phase in ("submit", "dispatch", "block", "slice"):
        assert names.count(f"serve.{phase}") == 12


def test_disabled_tracer_adds_nothing_to_the_submit_path(monkeypatch):
    """With the process tracer disabled the engine never reaches
    ``add_event``, a scope, a span, a phase or a device event, creates no
    CUDA event, and records no event: neither for the gia stream nor for
    nerf tiles, whose phases run ``annotate``."""
    assert not ttrace.TRACER.enabled

    def boom(*a, **k):
        raise AssertionError("the tracer was reached while disabled")
    for name in ("add_event", "add_interval", "device_event", "scope",
                 "span", "phase"):
        monkeypatch.setattr(ttrace.TRACER, name, boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    engine = _serve_stream("torch")
    assert engine.stats()["n_requests"] == 12
    engine, cam = _nerf_engine(max_inflight=1)
    for r in range(3):
        engine.submit(RenderRequest("n0", cam, np.arange(16)))
    engine.flush()
    assert ttrace.TRACER.events() == []


def _nerf_engine(max_inflight):
    """A CPU engine serving one tiny nerf scene in tiles of 16 pixels."""
    cfg = tfields.make_field_config("nerf", "hash")
    ct = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=10,
                                           n_levels=2))
    engine = RenderEngine(tpipeline.RenderSettings(tile_pixels=16,
                                                   n_samples=4),
                          max_inflight=max_inflight, device="cpu")
    engine.add_scene("n0", ct, tfields.init_field(
        ct, torch.Generator().manual_seed(0), "cpu"))
    engine.warmup()
    return engine, tscenes.orbit_camera(4, 4, 0.0)


def test_every_span_of_a_request_carries_its_req(tracers):
    """Traced on the CPU, each request's engine spans and tile phases carry
    its engine-assigned ``req``: the engine spans once a request, the
    phases (``raymarch``, ``encode_mlp``, ``head`` with the colour ``mlp``
    inside, ``composite``) under their parents. Tickets carry their
    ids."""
    _, ttr = tracers
    engine, cam = _nerf_engine(max_inflight=2)
    ttr.enable()
    tickets = [engine.submit(RenderRequest("n0", cam, np.arange(16)))
               for _ in range(3)]
    engine.flush()
    spans = ttr.spans_ns()
    reqs = [t.req for t in tickets]
    assert reqs == [1, 2, 3]               # the warmup's request was 0
    by_req = {}
    for sp in spans:
        by_req.setdefault(sp.args["req"], []).append(sp)
    assert sorted(by_req) == reqs
    for r in reqs:
        names = [sp.name for sp in by_req[r]]
        for phase in ("submit", "dispatch", "block", "slice"):
            assert names.count(f"serve.{phase}") == 1
        assert {"raymarch", "encode_mlp", "head", "mlp",
                "composite"} <= set(names)
        parents = {sp.name: sp.args.get("parent") for sp in by_req[r]
                   if sp.cat == "phase"}
        assert parents["mlp"] == "head"
        assert "serve.backpressure" not in names


@pytest.mark.parametrize("ready", [True, False])
def test_backpressure_span_appears_when_tiles_queue_up(tracers,
                                                       monkeypatch, ready):
    """``serve.backpressure`` is the wait in ``submit`` for the oldest
    ticket while more than ``max_inflight`` are queued, carrying the id of
    the request that waited: none while every tile is done at once (the
    CPU), one for each request past ``max_inflight`` while tiles stay
    pending."""
    _, ttr = tracers
    engine, cam = _nerf_engine(max_inflight=2)
    if not ready:
        monkeypatch.setattr(tengine.Ticket, "is_ready", lambda self: False)
    ttr.enable()
    tickets = [engine.submit(RenderRequest("n0", cam, np.arange(16)))
               for _ in range(5)]
    engine.flush()
    waits = [e["args"]["req"] for e in ttr.events()
             if e["name"] == "serve.backpressure"]
    ids = [t.req for t in tickets]
    assert waits == ([] if ready else ids[2:])


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
    health.silent_hosts), the same train.chunk events (the port's events
    restricted to the JAX engine's event names and arg keys: the port adds
    its step spans and phases) and the same debug ``chunk`` log records
    but their times."""
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
        keys = _arg_keys(jtr.events())
        events.append([(e["name"], e["cat"], {
            k: v for k, v in e["args"].items() if k in keys[e["name"]]})
            for e in tr.events() if e["name"] in keys])
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


def test_each_train_step_holds_forward_backward_and_adam(tracers):
    """Traced, each step of the port's engine is one ``train.step`` span
    with its index, whose children are the ``forward``, ``backward`` and
    ``adam`` phases carrying the same index, inside their chunk's
    ``train.chunk``."""
    _, ttr = tracers
    ttr.enable()
    _toy_train("torch", steps=6, chunk=4)
    spans = ttr.spans_ns()
    steps = [sp for sp in spans if sp.name == "train.step"]
    assert [sp.args["step"] for sp in steps] == list(range(6))
    for step in steps:
        kids = [sp for sp in spans if sp.cat == "phase"
                and sp.args.get("step") == step.args["step"]]
        assert sorted(sp.name for sp in kids) == ["adam", "backward",
                                                  "forward"]
        for sp in kids:
            assert sp.args["parent"] == "train.step"
            assert step.start <= sp.start <= sp.end <= step.end
    chunks = [sp for sp in spans if sp.name == "train.chunk"]
    assert [sp.args["start"] for sp in chunks] == [0, 4]
    for step in steps:
        chunk = chunks[step.args["step"] // 4]
        assert chunk.start <= step.start <= step.end <= chunk.end


def test_disabled_tracer_adds_nothing_to_the_train_step(monkeypatch):
    """With the process tracer disabled the training engine never reaches
    the tracer and creates no CUDA event."""
    assert not ttrace.TRACER.enabled

    def boom(*a, **k):
        raise AssertionError("the tracer was reached while disabled")
    for name in ("add_event", "add_interval", "device_event", "scope",
                 "span", "phase"):
        monkeypatch.setattr(ttrace.TRACER, name, boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    eng = _toy_train("torch", steps=6, chunk=4)
    assert eng.obs.snapshot()["counters"]["train.steps"] == 6
    assert ttrace.TRACER.events() == []
