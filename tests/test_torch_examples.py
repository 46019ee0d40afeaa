"""The port's example twins (``examples/torch/``) against the JAX package's
examples (``examples/*.py``), on the CPU.

Each twin runs in a child interpreter at a tiny size with ``--device cpu``
(quickstart has no size flag: the child sets its ``STEPS`` constant), its
outputs under ``tmp_path``. It prints the JAX example's lines, in their
order and format (the patterns below are the JAX examples' print
statements), saves a frame of the JAX example's shape, and imports neither
``jax`` nor the JAX package.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TWINS = REPO / "examples" / "torch"
NUM = r"-?[0-9.]+"

# loads a twin as a module, sets its constants, runs main(argv), then
# names every module of JAX or the JAX package it imported
CHILD = """
import importlib.util, json, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("twin", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
for k, v in {consts!r}.items():
    setattr(mod, k, Path(v) if k == "OUT_DIR" else v)
mod.main({argv!r})
print("IMPORTED " + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def run_twin(name, argv, consts):
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(path=str(TWINS / name),
                                            consts=consts, argv=argv)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "OMP_NUM_THREADS": "4"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1].startswith("IMPORTED ")
    assert json.loads(lines[-1][len("IMPORTED "):]) == []
    return lines[:-1]


def match_lines(lines, patterns):
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_quickstart_twin(tmp_path):
    # examples/quickstart.py's prints
    lines = run_twin("quickstart.py", ["--device", "cpu"],
                     {"STEPS": 2, "OUT_DIR": str(tmp_path)})
    step = rf"  step +\d+ loss {NUM} psnr {NUM} dB lr {NUM}"
    match_lines(lines, [
        re.escape("training GIA on the procedural gigapixel image ..."),
        step.replace(r"\d+", "0"), step.replace(r"\d+", "1"),
        re.escape("rendering a 128x128 frame through the fused pipeline ..."),
        rf"frame: \(128, 128, 3\), mean={NUM}, finite=True",
        rf"reconstruction PSNR vs analytic image: {NUM} dB",
        "saved frame -> " + re.escape(str(tmp_path / "quickstart_gia.npy"))])
    img = np.load(tmp_path / "quickstart_gia.npy")
    assert img.shape == (128, 128, 3) and np.isfinite(img).all()


def test_train_nerf_twin(tmp_path):
    # examples/train_nerf.py's prints
    lines = run_twin("train_nerf.py",
                     ["--device", "cpu", "--steps", "2", "--rays", "32"],
                     {"OUT_DIR": str(tmp_path)})
    step = rf"  step +\d+ loss {NUM} psnr {NUM} dB"
    match_lines(lines, [
        re.escape("training NeRF for 2 steps (32 rays/step, "
                  "32 samples/ray) ..."),
        step.replace(r"\d+", "0"), step.replace(r"\d+", "1"),
        rf"novel-view PSNR: {NUM} dB"])
    img = np.load(tmp_path / "nerf_novel_view.npy")
    assert img.shape == (96, 96, 3) and np.isfinite(img).all()


def test_train_nerf_twin_resumes_from_its_checkpoints(tmp_path):
    argv = ["--device", "cpu", "--steps", "2", "--rays", "32", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    first = run_twin("train_nerf.py", argv, {"OUT_DIR": str(tmp_path)})
    again = run_twin("train_nerf.py", argv, {"OUT_DIR": str(tmp_path)})
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    # the second run resumes after the last step: it trains no step
    assert [l for l in again if "step" in l and "loss" in l] == []
    assert first[-1] == again[-1]         # the same params render


def test_serve_render_twin():
    lines = run_twin("serve_render.py",
                     ["--device", "cpu", "--train-steps", "2",
                      "--requests", "2"], {})
    recs = [json.loads(l) for l in lines]
    events = [r["event"] for r in recs]
    # the JAX launcher's events (src/repro/launch/serve.py), which the
    # JAX example logs through it
    want = ["train_scene", "scene_trained"] * 2 + ["warmup", "served",
                                                   "frame_budget_4k"]
    assert events == want
    jax_src = (REPO / "src" / "repro" / "launch" / "serve.py").read_text()
    assert all(f'"{e}"' in jax_src for e in want)
    served = recs[events.index("served")]
    assert served["n_requests"] == 2 and served["compiles"] == 1
    assert np.isfinite(served["p50_ms"]) and served["mpix_per_s"] > 0


@pytest.mark.parametrize("name", ["quickstart.py", "serve_render.py",
                                  "train_nerf.py"])
def test_twins_keep_the_jax_examples_flags(name):
    """Every flag of the JAX example but --pallas/--use-pallas, plus
    --device."""
    def flags(path):
        return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"',
                              path.read_text()))
    jax = flags(REPO / "examples" / name) - {"--pallas", "--use-pallas"}
    assert flags(TWINS / name) == jax | {"--device"}
