"""The system under test: the port's package ``repro_torch`` (under the
checkout's ``src``), and the only module of the benchmark that imports
it. The harness hands it inputs it made itself and reads back its outputs,
its counters (``RenderEngine.stats()``, the training rows) and, through
the profiler, its kernels."""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.core import fields, render                      # noqa: E402
from repro_torch.core import train as core_train                 # noqa: E402
from repro_torch.core.encoding import GridConfig                 # noqa: E402
from repro_torch.core.mlp import MLPConfig                       # noqa: E402
from repro_torch.core.pipeline import RenderSettings             # noqa: E402
from repro_torch.serve import RenderEngine, RenderRequest        # noqa: E402
from repro_torch.train import loop, optim                        # noqa: E402


def field_config(cfg: Dict) -> fields.FieldConfig:
    """The program's config of a configuration file's Table-I row."""
    density = cfg.get("density_mlp")
    return fields.FieldConfig(
        app=cfg["app"], grid=GridConfig(**cfg["grid"]),
        density_mlp=MLPConfig(**density) if density else None,
        mlp=MLPConfig(**cfg["mlp"]), name=cfg["name"])


def camera(cam) -> render.Camera:
    height, width, focal, c2w = cam
    return render.Camera(height=height, width=width, focal=focal, c2w=c2w)


def render_engine(engine: Dict, device) -> RenderEngine:
    """A RenderEngine with the workload's ``engine`` settings."""
    settings = RenderSettings(
        tile_pixels=engine["tile_pixels"], n_samples=engine["n_samples"],
        near=engine["near"], far=engine["far"],
        sphere_steps=engine["sphere_steps"], fused=True,
        occupancy=engine["occupancy"],
        sample_budget=engine.get("sample_budget"),
        early_term_eps=engine["early_term_eps"])
    return RenderEngine(settings, max_inflight=engine["max_inflight"],
                        device=device)


def request(scene: str, cam: render.Camera, pixel_ids) -> RenderRequest:
    return RenderRequest(scene=scene, camera=cam, pixel_ids=pixel_ids)


def train_step(cfg: Dict, train: Dict) -> Callable:
    """``train_field``'s step: the field loss (fused) under
    ``make_scanned_step`` with Adam."""
    fcfg = field_config(cfg)
    opt = optim.AdamConfig(lr=train["lr"], b1=train["b1"], b2=train["b2"],
                           eps=train["eps"])
    return loop.make_scanned_step(
        lambda p, b: core_train.field_loss(p, fcfg, b,
                                           n_samples=train["n_samples"],
                                           fused=True), opt)


def train_engine(step_fn: Callable, batch_fn: Callable, steps: int,
                 chunk_steps: int) -> loop.TrainEngine:
    return loop.TrainEngine(loop.EngineConfig(steps=steps,
                                              chunk_steps=chunk_steps),
                            step_fn, batch_fn=batch_fn)


def train_state(params: Dict) -> Dict:
    return loop.init_train_state(params)


def adam_moment(state: Dict) -> Dict:
    """Adam's first moment of every leaf, as the optimizer holds it."""
    return state["opt"].mu


def params_of(state: Dict) -> Dict:
    return state["params"]


def samples(engine: RenderEngine) -> Tuple[float, float, float]:
    """The engine's ``[live, total, dropped]`` sample counts so far."""
    st = engine.stats()
    return (st["live_sample_frac"] * st["samples_total"],
            st["samples_total"], st["samples_dropped"])
