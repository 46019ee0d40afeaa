"""Reading a traced window: busy time, idle gaps named by the host span
they began in, port kernels by name, and the shares the readers make."""
from types import SimpleNamespace

import pytest

from ngbench import readers
from ngbench.trace import breakdown, idle_gaps, port_kernel, span_at, \
    union_s

FIELD = ("void repro::field_fwd_kernel<3, (repro::TableDtype)0>(float "
         "const*, float const*, float const*, repro::LevelMeta, int)")


def test_port_kernels_by_name():
    assert port_kernel(FIELD) == "field_fwd"
    assert port_kernel("void repro::encode_bwd_kernel<3, float>(x)") == \
        "encode_bwd"
    assert port_kernel("void at::native::vectorized_elementwise_kernel<4>"
                       "(int, at::native::mul)") is None
    assert port_kernel("field_fwd_kernels_other") is None


def test_union_and_gaps():
    spans = [(10, 20), (15, 30), (40, 50)]
    assert union_s(spans) == pytest.approx(30e-9)
    assert idle_gaps(spans, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert idle_gaps(spans, 12, 45) == [(30, 40)]
    host = [("submit", 0, 12), ("wait for frame", 25, 45)]
    assert span_at(host, 5) == "submit"
    assert span_at(host, 30) == "wait for frame"
    assert span_at(host, 20) == "harness"
    b = breakdown([(FIELD, 10, 20), ("memset", 15, 30), (FIELD, 40, 50)],
                  host, 0, 60)
    assert b["device_ops"][0] == ["repro::field_fwd_kernel<3, "
                                  "(repro::TableDtype)0>", 20e-9]
    assert b["idle_gaps"][0][0] in ("submit", "wait for frame", "harness")
    assert sorted(g[1] for g in b["idle_gaps"]) == [10e-9] * 3


def _run(events, units, works, window=100):
    tr = SimpleNamespace(events=events, window_s=window * 1e-9,
                         kernel_events=lambda k: [e for e in events
                                                  if port_kernel(e[0]) == k],
                         busy_s=lambda: union_s([(s, e) for _, s, e in
                                                 events]))
    return SimpleNamespace(trace=tr, units=units,
                           calls_per_unit={"field_fwd": 1},
                           call_work={"field_fwd": works}, compute_s=25e-9)


def test_roofline_reads_counted_calls_only():
    ev = [(FIELD, 0, 10), ("x", 10, 20), (FIELD, 30, 50)]
    # 1 s of least time at the memory peak for call 1 only
    run = _run(ev, 2, {1: {"bytes": 3.35e12 * 5e-9}})
    assert readers.roofline_pct(run, "field_fwd") == pytest.approx(25.0)
    assert readers.idle_pct(run) == pytest.approx(60.0)
    assert readers.mfu_pct(run) == pytest.approx(25.0)
    assert readers.plain_device_s(run) == pytest.approx(10e-9)
    # the calls are not the count the algorithm makes: nothing to read
    assert readers.roofline_pct(_run(ev, 3, {1: {"bytes": 1.0}}),
                                "field_fwd") is None
    assert readers.roofline_pct(_run(ev, 2, {}), "field_fwd") is None
