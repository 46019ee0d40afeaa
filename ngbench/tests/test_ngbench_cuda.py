"""On the card: a short run of each cell at its published size comes out
correct, and its traced run reads every per-layer metric it names. These
skip without a card; run them with ``python -m pytest ngbench/tests -m
cuda`` on a machine that has one."""
import json
import subprocess
import sys
import time

import pytest

from ngbench import bench, spec
from ngbench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    r = bench.run_cell(name, 2**31 + 101, 3.0, False, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["kind"].startswith("NVIDIA")
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(name)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_metrics(card, name):
    """Through ``run.py`` in a process of its own, as the benchmark runs:
    one traced window a process."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "ngbench" / "run.py"), "--workload",
         name, "--seed", str(2**31 + 102), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(spec.per_layer(name))
    for m in r["metrics"].values():
        assert m["value"] >= 0
        if m["unit"] == "%":
            assert m["value"] <= 105
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
