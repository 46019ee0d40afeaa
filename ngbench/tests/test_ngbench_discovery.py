"""A cell, a configuration, a traffic mix, a kind of cell, an app's part of
it and a per-layer metric are added as new files and entries only: the
harness finds each by its name, and no file it had changes. And
BENCHMARK.json agrees with those files."""
import hashlib
import json
import re
import shutil
import time
from types import SimpleNamespace

import pytest

from ngbench import bench, spec
from ngbench.tests.tiny import make_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _digest(here):
    return {p.relative_to(here): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(here.rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    here = make_copy(tmp_path)
    before = _digest(here)
    cfg = json.loads((here / "configs" / "nerf_hash.json").read_text())
    cfg["name"] = "dummy_cfg"
    (here / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "frames_720p.json").read_text())
    mix["viewers"] = 1
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    wl = json.loads((here / "workloads" / "nerf_hash.frames_720p.json")
                    .read_text())
    # a new kind of cell and nerf's part of it: here copies of the serving
    # ones, found by the workload's kind
    shutil.copy(here / "kinds" / "serve.py", here / "kinds" / "dummy_kind.py")
    shutil.copy(here / "apps" / "nerf.serve.py",
                here / "apps" / "nerf.dummy_kind.py")
    wl.update(config="dummy_cfg", traffic="dummy_mix", scenes=1,
              kind="dummy_kind")
    cell = "dummy_cfg.dummy_mix"
    (here / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    (here / "metrics" / "dummy_metric.py").write_text(
        'LAYER = "engine"\nUNIT = "ms"\nMOVES = "mpix_per_s"\n'
        'SOURCE = "host_clock"\n\n\ndef read(run):\n'
        '    return 1e3 * sum(run.submit_s)\n')
    b = json.loads((here.parent / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                         "file": "ngbench/configs/dummy_cfg.json",
                         "reduced": [], "why": "a test's"})
    b["workloads"].append({"name": cell, "config": "dummy_cfg",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test's"})
    for m in b["end_to_end"]:
        if m["name"] in ("mpix_per_s", "frame_p95_ms"):
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "dummy_metric", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "engine", "moves": "mpix_per_s",
                           "workloads": [cell]})
    # a variant that shares metrics/device_idle_pct.py
    b["per_layer"].append({"name": "device_idle_pct.dummy", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "mpix_per_s",
                           "workloads": [cell]})
    (here.parent / "BENCHMARK.json").write_text(json.dumps(b))

    found = spec.find_cell(cell, here)
    assert found.config["name"] == "dummy_cfg"
    assert found.traffic["viewers"] == 1
    assert spec.kind(found, here).__file__.endswith("dummy_kind.py")
    assert spec.app(found, here).__file__.endswith("nerf.dummy_kind.py")
    readers = spec.per_layer(cell, here)
    assert set(readers) == {"dummy_metric", "device_idle_pct.dummy"}
    assert readers["device_idle_pct.dummy"].__file__.endswith(
        "metrics/device_idle_pct.py")
    assert readers["dummy_metric"].read(SimpleNamespace(submit_s=[2e-3])) \
        == pytest.approx(2.0)
    assert "dummy_metric" not in spec.per_layer("nerf_hash.frames_720p", here)
    r = bench.run_cell(cell, 5, 2.0, False, time.perf_counter(),
                       device="cpu", here=here)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"mpix_per_s", "frame_p95_ms", "setup_s"}
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_agrees_with_its_files():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    here = spec.HERE
    for c in b["configs"]:
        cfg = json.loads((here.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    reported = {}
    for w in b["workloads"]:
        wl = json.loads((here / "workloads" / f"{w['name']}.json")
                        .read_text())
        for k in ("config", "traffic", "chips", "why"):
            assert wl[k] == w[k], (w["name"], k)
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        e2e = [m["name"] for m in spec.end_to_end(w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"]), w["name"]
        reported[w["name"]] = e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    for m in b["per_layer"]:
        mod = spec.load_module(spec.metric_file(m["name"], here),
                               "check_" + m["name"].replace(".", "_"))
        moves = mod.MOVES if isinstance(mod.MOVES, str) else \
            mod.MOVES[m["name"].split(".", 1)[1]]
        assert (mod.LAYER, mod.UNIT, moves, mod.SOURCE) == \
            (m["layer"], m["unit"], m["moves"], m["source"]), m["name"]
        for w in m["workloads"]:
            assert m["moves"] in reported[w], (m["name"], w)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    # the full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
