"""Serving launcher of the port, the JAX package's ``launch/serve.py``:

  * ``--mode render``: train a few scenes, then serve a mixed stream of
    pixel requests (scenes x viewpoints) through the ``RenderEngine``.
  * ``--mode lm``: the LM decode loop (prefill, then greedy decode) for
    the ten assigned architectures.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode render --app gia
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --app nvr
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch mamba2-2.7b

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
  * ``--mode lm``: ``--full`` serves the arch's published config (the
    JAX launcher's ``--reduced`` is on by default and cannot be turned
    off). The LM loop runs on one device (``parallel/api``), its params
    drawn in the act dtype with no f32 master; an arch whose params do
    not fit on the card is refused (``MemoryError``) before any is drawn,
    and a logit that is not finite raises (the JAX loop checks neither).

``--shard`` serves through a mesh of the visible devices
(``launch.mesh.make_local_mesh()``, 1 x 1 as in the JAX launcher: the
pixel-parallel split of ``serve/sharding.py`` with one shard), which
starts at the ``--device`` card, so that it holds the engine's device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

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


def _wait(dev) -> None:
    # repro: sync-boundary the LM loop's timing points wait for the card
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_tokens(tok) -> np.ndarray:
    # repro: sync-boundary greedy decode reads each step's argmax on the host
    return tok[:, 0].cpu().numpy()


def _check_finite(finite, arch: str) -> None:
    # repro: sync-boundary read once, after the timed decode
    if not bool(finite):
        raise FloatingPointError(f"{arch}: a logit of the prefill or of a "
                                 "decode step is not finite")


def serve_lm(arch: str, reduced: bool = True, batch: int = 2,
             prompt_len: int = 32, gen_len: int = 16, seed: int = 0, *,
             device: DeviceLike = None, mesh=None):
    """Prefill a random prompt, then greedy-decode ``gen_len`` tokens for
    ``arch`` (its ``reduced_config`` unless ``reduced=False``) through the
    ``parallel/api`` steps built from the local mesh (its default
    ``(1, 1)`` shape: one device, as the JAX function's ``make_local_mesh()``
    is; a ``mesh`` of more devices shards the params, splits the batch and
    runs each row on its tensor-parallel group: ``parallel/tp.py``);
    logs ``lm_served`` and ``lm_sample``, adds ``lm.prefill``/``lm.decode``
    tracer events, and returns (prefill seconds, decode seconds). The
    params are drawn on the device in the act dtype, with no f32 master
    (``api.init_params(compute_dtype=)``); an arch they do not fit raises
    ``MemoryError`` first. A logit that is not finite raises
    ``FloatingPointError``."""
    from repro_torch.common.partitioning import DEFAULT_RULES
    from repro_torch.configs import registry
    from repro_torch.parallel import api

    dev = resolve_device(device)
    cfg = (registry.reduced_config(arch) if reduced
           else registry.get_config(arch))
    mesh = mesh or make_local_mesh(device=dev)
    dev = mesh.devices[0]
    rules = DEFAULT_RULES.copy_with()
    capacity = prompt_len + gen_len
    enc_len = prompt_len if cfg.is_encdec else 0

    prefill_fn, _ = api.make_prefill_step(
        cfg, mesh, rules, capacity=capacity, batch_size=batch,
        enc_len=enc_len)
    decode_fn, dsh = api.make_decode_step(
        cfg, mesh, rules, capacity=capacity, batch_size=batch,
        enc_len=enc_len)

    params = api.init_params(cfg, seed, mesh, rules,
                             compute_dtype=cfg.adtype)
    cache = api.make_cache(cfg, batch, capacity, enc_len=enc_len,
                           shardings=dsh.get("cache"), device=dev,
                           rules=rules)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    batch_in = {"tokens": toks}
    if cfg.is_encdec:
        batch_in["enc_embeddings"] = torch.from_numpy(
            rng.standard_normal((batch, prompt_len, cfg.d_model))).to(
            dev, cfg.adtype)
    if cfg.frontend == "vision":
        batch_in = {"embeddings": torch.from_numpy(
            rng.standard_normal((batch, prompt_len, cfg.d_model))).to(
            dev, cfg.adtype)}

    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch_in, cache)
    _wait(dev)
    t_prefill = time.perf_counter() - t0
    out_tokens = []
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen_len):
        out_tokens.append(_host_tokens(tok))
        logits, cache = decode_fn(params, cache, tok, prompt_len + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, -1)[:, None]
    _wait(dev)
    t_decode = time.perf_counter() - t0
    _check_finite(finite, arch)
    if TRACER.enabled:
        now = time.perf_counter()
        TRACER.add_event("lm.prefill", now - t_decode - t_prefill,
                         now - t_decode, cat="serve", arch=arch)
        TRACER.add_event("lm.decode", now - t_decode, now, cat="serve",
                         arch=arch, n_steps=gen_len)
    _LOG.info("lm_served", arch=arch, prompt_len=prompt_len,
              prefill_ms=round(t_prefill * 1e3),
              decode_steps=gen_len, decode_ms=round(t_decode * 1e3),
              tok_per_s=round(gen_len * batch / t_decode, 1))
    _LOG.info("lm_sample",
              tokens=[int(t) for t in np.stack(out_tokens, 1)[0][:12]])
    return t_prefill, t_decode


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="render", choices=["render", "lm"])
    ap.add_argument("--app", default="gia")
    ap.add_argument("--encoding", default="hash")
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", action="store_true",
                    help="--mode lm: the arch's published config in place "
                         "of its reduced one")
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
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine metrics snapshot JSON here")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_out:
        TRACER.enable()
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
        serve_lm(args.arch, args.reduced and not args.full,
                 device=args.device)
    if args.trace_out:
        TRACER.export(args.trace_out)
        _LOG.info("trace_written", path=args.trace_out,
                  n_events=len(TRACER.events()))


if __name__ == "__main__":
    main()
