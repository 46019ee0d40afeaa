"""The readers of the program's own spans (``ngbench/program_spans.py``),
each on synthetic spans and device events of one window on the clock they
share, and what they do where the program has no such spans."""
import time
from types import SimpleNamespace

import pytest

from ngbench import program_spans, spec

HEAD = "head"


def _read(name, run):
    mod = spec.load_module(spec.metric_file(name),
                           "test_" + name.replace(".", "_"))
    return mod.read(run)


def _trace(events=(), w0=0, w1=1_000_000_000):
    return SimpleNamespace(events=list(events), w0=w0, w1=w1)


def _host(name, s, e, **args):
    return (name, "serve", s, e, args, None)


def _dev(name, s, e, **args):
    return (name, "phase", s, e, args, 0)


MS = 1_000_000


def _serve_run(**kw):
    """Two tiles of one frame in a 100 ms window: tile 1 dispatched 0-2 ms,
    run on the device 2-40 ms; tile 2 dispatched 3-5 ms, queued behind
    tile 1 until 40 ms, run 40-70 ms; its submit waited 5-30 ms for
    tile 1. A span of the warm-up before the window is left out."""
    spans = [
        _host("serve.dispatch", 0, 2 * MS, req=1),
        _dev("serve.tile", 2 * MS, 40 * MS, req=1),
        _dev(HEAD, 10 * MS, 20 * MS, req=1),
        _host("serve.dispatch", 3 * MS, 5 * MS, req=2),
        _host("serve.backpressure", 5 * MS, 30 * MS, req=2),
        _dev("serve.tile", 40 * MS, 70 * MS, req=2),
        _dev(HEAD, 50 * MS, 56 * MS, req=2),
        _dev(HEAD, -50 * MS, -40 * MS, req=0),
    ]
    base = dict(trace=_trace([("k", 2 * MS, 70 * MS)], 0, 100 * MS),
                program_spans=spans, tiles=2, tiles_per_frame=2,
                submit_s=[0.004, 0.030])
    base.update(kw)
    return SimpleNamespace(**base)


def test_submit_enqueue_is_submit_less_backpressure():
    run = _serve_run()
    # (4 ms + 30 ms - 25 ms of backpressure) over 2 calls
    assert _read("submit_enqueue_ms", run) == pytest.approx(4.5)
    assert _read("submit_host_ms", run) == pytest.approx(17.0)


def test_tile_queue_runs_from_dispatch_end_to_device_start():
    # tile 1: 2 ms - 2 ms = 0; tile 2: 40 ms - 5 ms = 35
    assert _read("tile_queue_ms", _serve_run()) == pytest.approx(17.5)
    early = _serve_run(program_spans=[
        _host("serve.dispatch", 0, 5 * MS, req=1),
        _dev("serve.tile", 1 * MS, 9 * MS, req=1)])
    assert _read("tile_queue_ms", early) == 0.0


def test_head_is_device_ms_a_frame_inside_the_window():
    # (10 + 6) ms over 2 tiles, 2 tiles a frame; the warm-up's is left out
    assert _read("head_device_ms", _serve_run()) == pytest.approx(16.0)


@pytest.mark.parametrize("phase", ["forward", "backward", "adam"])
def test_train_phases_are_device_ms_a_step(phase):
    spans = []
    for step, t in enumerate((0, 20 * MS)):
        spans += [("train.step", "train", t, t + 2 * MS, {"step": step},
                   None),
                  _dev("forward", t + 1 * MS, t + 4 * MS, step=step),
                  _dev("backward", t + 4 * MS, t + 13 * MS, step=step),
                  _dev("adam", t + 13 * MS, t + 15 * MS, step=step),
                  ("forward", "phase", t, t + MS, {"step": step}, None)]
    run = SimpleNamespace(trace=_trace(w1=40 * MS), program_spans=spans,
                          units=2)
    want = {"forward": 3.0, "backward": 9.0, "adam": 2.0}[phase]
    assert _read(f"{phase}_device_ms", run) == pytest.approx(want)


def test_idle_counts_only_gaps_inside_the_enqueue_spans():
    """Device events 0-10 and 20-30 ms and 60-100 ms of a 100 ms window:
    the idle gap 10-20 ms overlaps a dispatch 15-25 ms for 5 ms and is
    counted; the gap 30-60 ms lies outside every dispatch and is not."""
    run = SimpleNamespace(
        trace=_trace([("k", 0, 10 * MS), ("k", 20 * MS, 30 * MS),
                      ("k", 60 * MS, 100 * MS)], 0, 100 * MS),
        program_spans=[_host("serve.dispatch", 15 * MS, 25 * MS, req=1),
                       _host("serve.dispatch", 26 * MS, 29 * MS, req=2),
                       _host("serve.block", 30 * MS, 60 * MS, req=1)])
    assert _read("idle_in_enqueue_pct.serve", run) == pytest.approx(5.0)
    train = SimpleNamespace(
        trace=run.trace,
        program_spans=[("train.step", "train", 8 * MS, 12 * MS, {}, None),
                       ("train.step", "train", 12 * MS, 16 * MS, {}, None),
                       ("backward", "phase", 40 * MS, 50 * MS, {}, 0)])
    assert _read("idle_in_enqueue_pct.train", train) == pytest.approx(6.0)
    assert program_spans.overlap_ns([(0, 10), (5, 20)], [(15, 30)]) == 5


def test_readers_find_nothing_without_program_spans():
    """A run of a program that recorded no span reads None everywhere:
    the metrics are left out of its line."""
    run = _serve_run(program_spans=[])
    for name in ("submit_enqueue_ms", "tile_queue_ms", "head_device_ms",
                 "idle_in_enqueue_pct.serve"):
        assert _read(name, run) is None, name
    assert program_spans.device_ms_per_unit(run, "adam", 3) is None


def test_start_does_nothing_outside_a_traced_run(monkeypatch):
    """Loading the readers (a listing, a test) leaves the program's tracer
    off; inside a traced run ``start`` empties it, makes room and turns it
    on for the phases the readers read alone, and ``spans`` reads the
    window's spans back from it."""
    from repro_torch.obs.trace import TRACER
    assert not program_spans._in_a_traced_run()
    spec.per_layer("nsdf_hash.frames_720p")
    assert not TRACER.enabled
    monkeypatch.setattr(program_spans, "_in_a_traced_run", lambda: True)
    try:
        program_spans.start()
        assert TRACER.enabled
        assert TRACER.phases == frozenset(program_spans.PHASES)
        assert TRACER.max_events >= program_spans.MAX_EVENTS
        t = time.perf_counter()
        TRACER.add_event("serve.dispatch", t, t + 1e-3, cat="serve", req=1)
        run = SimpleNamespace(trace=_trace(
            w0=TRACER.spans_ns()[0].start - 1, w1=2**62))
        (sp,) = program_spans.spans(run)
        assert sp[0] == "serve.dispatch" and sp[4]["req"] == 1
        assert sp[3] - sp[2] == 1_000_000
    finally:
        TRACER.disable()
        TRACER.clear()
        TRACER.max_events = 200_000
        program_spans._cache.clear()
