"""Serving launcher of the port, the JAX package's ``launch/serve.py``:

  * ``--mode render``: train a few scenes, then serve a mixed stream of
    pixel requests (scenes x viewpoints) through the ``RenderEngine``.
  * ``--mode lm``: the LM decode loop, not ported yet (it raises).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode render --app gia
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --app nvr

It follows the JAX launcher step for step and logs the same events with
the same keys (JSON lines, ``obs/log.py``). It differs in four places:

  * ``--device`` (default ``cuda``) picks the device through
    ``device.resolve_device``: on the card the kernels run, with
    ``--device cpu`` their plain versions; without a GPU the default
    raises, it does not fall back.
  * ``serve_render(log2_table_size=)``, a keyword of the function only:
    14 (default) is the JAX launcher's laptop table, ``None`` keeps the
    Table-I size.
  * No ``--use-pallas``: there is no XLA route to choose against.
  * ``--mode lm`` raises ``NotImplementedError`` (the LM stack is not
    ported yet); ``--arch`` and ``--reduced`` stay, so that the flag sets
    match.

``--shard`` serves through a mesh of the visible devices
(``launch.mesh.make_local_mesh()``, 1 x 1 as in the JAX launcher: the
pixel-parallel split of ``serve/sharding.py`` with one shard), which
starts at the ``--device`` card, so that it holds the engine's device.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.obs import log as obs_log
from repro_torch.obs.trace import TRACER

_LOG = obs_log.get_logger("serve")


def serve_render(app: str = "gia", encoding: str = "hash",
                 train_steps: int = 150, n_requests: int = 8,
                 tile_pixels: int = 4096, height: int = 128,
                 width: int = 128, seed: int = 0,
                 n_scenes: int = 2, n_cameras: int = 3, shard: bool = False,
                 occupancy: bool = False,
                 sample_budget: Optional[int] = None,
                 quant: Optional[str] = None,
                 metrics_out: Optional[str] = None, *,
                 device: DeviceLike = None,
                 log2_table_size: Optional[int] = 14):
    """Train ``n_scenes`` fields, then serve a mixed request stream
    (scenes x viewpoints) through the RenderEngine, warmup excluded from
    the latency statistics; returns ``engine.stats()``.

    ``occupancy`` serves the ray apps occupancy-culled: training keeps the
    grid (res 32) at chunk ends, the engine compacts to ``sample_budget``
    samples per tile (default: the dense count). ``quant`` ('int8' |
    'fp8_e4m3') serves the scenes post-training-quantized: tables are
    calibrated and encoded after training and the kernels dequantize on
    the fly. ``log2_table_size`` sets the tables' rows (``None``: Table
    I's); ``device`` is where everything runs (CUDA unless named)."""
    from repro_torch.core import fields, pipeline
    from repro_torch.core.train import train_field
    from repro_torch.data import scenes
    from repro_torch.quant import QuantSpec, quantize_field
    from repro_torch.serve import RenderEngine, RenderRequest

    if n_scenes < 1 or n_cameras < 1:
        raise ValueError(f"need >=1 scene and >=1 camera "
                         f"(got {n_scenes}, {n_cameras})")
    if occupancy and app not in ("nerf", "nvr"):
        raise ValueError(f"--occupancy needs a ray-marched app (nerf/nvr),"
                         f" got {app!r}")
    dev = resolve_device(device)
    cfg = fields.make_field_config(app, encoding)
    if log2_table_size is not None:
        # with_grid recomputes the dependent MLP dims (nerf's density MLP)
        cfg = cfg.with_grid(dataclasses.replace(
            cfg.grid, log2_table_size=log2_table_size))
    qspec = QuantSpec(table_qtype=quant) if quant else None
    if qspec is not None:
        cfg = cfg.with_quant(qspec)

    settings = pipeline.RenderSettings(tile_pixels=tile_pixels,
                                       occupancy=occupancy,
                                       sample_budget=sample_budget)
    mesh = make_local_mesh(device=dev) if shard else None
    engine = RenderEngine(settings, mesh=mesh, device=dev)
    for s in range(n_scenes):
        _LOG.info("train_scene", scene=s, config=cfg.name,
                  steps=train_steps)
        params, hist = train_field(
            cfg, steps=train_steps, batch_size=4096, seed=seed + s,
            occupancy_res=32 if occupancy else None, device=dev)
        _LOG.info("scene_trained", scene=s,
                  loss_first=round(float(hist[0][1]), 4),
                  loss_last=round(float(hist[-1][1]), 4))
        if qspec is not None:
            params = quantize_field(params, qspec)
            _LOG.info("scene_quantized", scene=s, quant=qspec.tag)
        engine.add_scene(f"scene{s}", cfg, params)

    # viewpoints orbiting the scene, all served by one tile function
    cams = [scenes.orbit_camera(height, width, 2.0 * np.pi * c / n_cameras)
            for c in range(n_cameras)]

    t_warm = engine.warmup()
    _LOG.info("warmup", compile_s=round(t_warm, 2),
              note="excluded from stats")

    # mixed request stream: random (scene, camera, pixels) tuples
    rng = np.random.default_rng(seed)
    for r in range(n_requests):
        ids = rng.integers(0, height * width, tile_pixels).astype(np.int32)
        req = RenderRequest(scene=f"scene{r % n_scenes}",
                            camera=cams[r % n_cameras], pixel_ids=ids)
        engine.submit(req)
    engine.flush()

    stats = engine.stats()
    _LOG.info("served", n_requests=stats["n_requests"],
              n_scenes=n_scenes, n_cameras=n_cameras,
              p50_ms=round(stats["p50_ms"], 1),
              p99_ms=round(stats["p99_ms"], 1),
              mpix_per_s=round(stats["mpix_per_s"], 2),
              compiles=stats["n_traces_total"])
    if occupancy:
        _LOG.info("occupancy_culling",
                  live_sample_frac=round(stats["live_sample_frac"], 3),
                  samples_dropped=stats["samples_dropped"],
                  effective_mpix_per_s=round(
                      stats["effective_mpix_per_s"], 2))
    med_s = stats["p50_ms"] / 1e3
    _LOG.info("frame_budget_4k",
              ms_per_frame=round(3840 * 2160 / tile_pixels * med_s * 1e3))
    if stats["n_traces_total"] != len(stats["buckets"]):
        _LOG.warning("bucket_leak", traces=stats["n_traces_total"],
                     buckets=len(stats["buckets"]),
                     hint="a bucket built its tile function more than once")
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(engine.obs.to_json())
        _LOG.info("metrics_written", path=metrics_out)
    return stats


def serve_lm(arch: str, reduced: bool = True, batch: int = 2,
             prompt_len: int = 32, gen_len: int = 16, seed: int = 0):
    """The LM decode loop: not ported yet."""
    raise NotImplementedError(
        "--mode lm (the LM stack: models, parallel/api, the decode loop) is "
        "not ported to repro_torch yet (ROADMAP A14)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="render", choices=["render", "lm"])
    ap.add_argument("--app", default="gia")
    ap.add_argument("--encoding", default="hash")
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tile-pixels", type=int, default=4096)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--cameras", type=int, default=3)
    ap.add_argument("--shard", action="store_true",
                    help="pixel-parallel split over the local devices' mesh")
    ap.add_argument("--occupancy", action="store_true",
                    help="occupancy-culled sampling (ray apps)")
    ap.add_argument("--sample-budget", type=int, default=None,
                    help="static field-eval budget per tile (default: "
                         "tile_pixels * n_samples, the dense count)")
    ap.add_argument("--quant", default=None,
                    choices=["int8", "fp8_e4m3"],
                    help="post-training table quantization "
                         "(repro_torch.quant): serve scenes with int8/fp8 "
                         "tables, dequantized in the kernels")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of the run here "
                         "(enables the span tracer)")
    ap.add_argument("--trace-sync", action="store_true",
                    help="device-sync at span close for device-complete "
                         "phase times (slower; implies --trace-out use)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine metrics snapshot JSON here")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_out or args.trace_sync:
        TRACER.enable(sync=args.trace_sync)
    if args.mode == "render":
        serve_render(args.app, args.encoding,
                     train_steps=args.train_steps, n_requests=args.requests,
                     tile_pixels=args.tile_pixels, height=args.height,
                     width=args.width, n_scenes=args.scenes,
                     n_cameras=args.cameras, shard=args.shard,
                     occupancy=args.occupancy,
                     sample_budget=args.sample_budget,
                     quant=args.quant,
                     metrics_out=args.metrics_out, device=args.device)
    else:
        serve_lm(args.arch, args.reduced)
    if args.trace_out:
        TRACER.export(args.trace_out)
        _LOG.info("trace_written", path=args.trace_out,
                  n_events=len(TRACER.events()))


if __name__ == "__main__":
    main()
