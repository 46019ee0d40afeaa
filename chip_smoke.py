#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path, serving Table-I ``nerf_hash`` at full width
(L=16 levels of 2^19 x 2 f32 tables, density MLP 32->64x3->16, colour MLP
32->64x4->3; random weights and U(-1, 1) tables from a numpy seed) through
``RenderEngine``, and holds every CUDA kernel on that path against its
plain PyTorch version. Phases, each printing one JSON line:

  build    compile the kernel library from ``src/repro_torch/csrc`` (nvcc,
           sm_90a); ptxas' registers and spills per kernel
  kernels  each kernel against its plain version on the inputs of one real
           engine tile (4096 pixels x 32 samples): max error against the
           stated tolerance, device time per call (CUDA events), the plain
           version's time, the bound, and a PyTorch yardstick where one exists
  serve    2 scenes, warmup, 120 random-pixel requests over 2 scenes x 3
           orbit cameras at 256x256, at most 2 in flight (a closed loop);
           latency (p50, and p90: the highest percentile with 10 samples
           beyond it), throughput, and the launch count of every kernel
           during the stream (each must be > 0)
  profile  device busy time, idle share (1 - busy / wall) and time by
           kernel, each from one torch.profiler trace of one steady window
           of 20 served requests; one window with CPU + CUDA activity, one
           with CUDA activity alone
  parity   a 32x32 frame from the engine on the card against the port's
           render_frame on the CPU (plain versions), same params

then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}`` last. Any
failure exits non-zero before that line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
GPU and the CUDA toolkit (nvcc); imports nothing of JAX.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): HBM3 rate
# and f32 outside the tensor cores, which is what these kernels use.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = 1e-4          # kernel vs plain, f32: sequential FMA vs blocked sums
PARITY_TOL = 1e-4   # engine on the card vs render_frame on the CPU
TILE_PIXELS, N_SAMPLES, FRAME = 4096, 32, 256
N_REQUESTS = 120
PROFILE_REQUESTS = 20
SEED = 0


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps, rounds=5, warm=2):
    """Device milliseconds per call: the median over ``rounds`` of the mean
    of ``reps`` calls queued back to back behind a spin kernel, so that the
    host's launch cost does not show in the CUDA-event interval (a call
    whose host work outlasts the spin is timed at its host-bound rate)."""
    import torch
    for _ in range(warm):
        fn()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)          # ~10 ms of spinning
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def union_ms(spans):
    """Length of the union of (start, end) intervals: device busy time,
    counting overlapping kernels and copies once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def ptxas_summary(log):
    """[(kernel, registers, spill bytes)] from nvcc -Xptxas -v output."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5repro\d+(\w+?_kernel)"
                      r"(?:I(\w+?)E)?E", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), spill])
            name = None
    return rows


def np_params(cfg, seed):
    """U(-1, 1) tables (a wrong row or level shows) and normal/sqrt(fan_in)
    weights, from a numpy seed, as numpy f32 arrays."""
    import numpy as np
    from repro_torch.core import fields
    rng = np.random.default_rng(seed)

    def draw(shapes, grid):
        if isinstance(shapes, dict):
            return {k: draw(s, k == "grid") for k, s in shapes.items()}
        if grid:
            return rng.random(shapes, dtype=np.float32) * 2 - 1
        return (rng.standard_normal(shapes, dtype=np.float32)
                / np.float32(np.sqrt(shapes[-2])))
    return draw(fields.param_shapes(cfg), False)


def touched_rows(points, cfg):
    """Distinct table rows the encode of ``points`` gathers, over all
    levels: the table bytes this data needs."""
    import torch
    from repro_torch.core import encoding as enc
    n = 0
    for level in range(cfg.n_levels):
        cell, _ = enc.level_cell(points, cfg.level_resolution(level))
        idx = torch.cat([enc.level_corner_index(cell, bits, level, cfg)
                         for bits in enc._corner_offsets(cfg.dim)])
        n += int(torch.unique(idx).numel())
    return n


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch import kernels as K
    from repro_torch.core import fields, pipeline, render
    from repro_torch.core.encoding import sh_encode
    from repro_torch.core.mlp import apply_mlp
    from repro_torch.data import scenes
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_field import ops as ff_ops
    from repro_torch.kernels.fused_field.ref import field_ref
    from repro_torch.kernels.fused_mlp import ops as mlp_ops
    from repro_torch.kernels.ray_march import ops as rm_ops
    from repro_torch.serve import RenderEngine, RenderRequest
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "ptxas_kernel_registers_spill_bytes": ptxas_summary(log), **gpu})

    # ---------------------------------------------------------- kernels
    cfg = fields.make_field_config("nerf", "hash")
    params = [fields.from_jax_params(np_params(cfg, SEED + s), cfg, dev)
              for s in range(2)]
    p0 = params[0]
    rng = np.random.default_rng(SEED)
    cam = scenes.orbit_camera(FRAME, FRAME, 0.0)
    ids = torch.from_numpy(rng.integers(0, FRAME * FRAME, TILE_PIXELS)).to(dev)
    origins, dirs = render.make_rays(cam, ids)
    pts, dts = render.sample_along_rays(origins, dirs, 0.5, 4.5, N_SAMPLES)
    flat_pts = render.normalize_to_unit(pts.reshape(-1, 3)).contiguous()
    flat_dirs = torch.repeat_interleave(dirs, N_SAMPLES, dim=0)
    b = flat_pts.shape[0]
    dcfg, ccfg, g = cfg.density_mlp, cfg.mlp, cfg.grid

    dfeat_ref = field_ref(flat_pts, p0["grid"], p0["density_mlp"], g, dcfg)
    color_in = torch.cat([sh_encode(flat_dirs), dfeat_ref], -1).contiguous()
    rgb_ref = torch.sigmoid(apply_mlp(p0["mlp"], color_in, ccfg))
    packed = torch.cat([rgb_ref, torch.exp(dfeat_ref[:, :1])], -1).reshape(
        TILE_PIXELS, N_SAMPLES, 4)
    rgb, sigma = packed[..., :3], packed[..., 3]

    def mlp_flops(m):
        return 2 * (m.in_dim * m.hidden_dim
                    + (m.n_hidden - 1) * m.hidden_dim ** 2
                    + m.hidden_dim * m.out_dim)

    def wbytes(tree):
        return sum(t.numel() * 4 for t in tree.values())

    rows = touched_rows(flat_pts, g)
    corners = 1 << g.dim
    work = {
        "field_fwd": {
            "bytes": b * g.dim * 4 + rows * g.n_features * 4
            + wbytes(p0["density_mlp"]) + b * dcfg.out_dim * 4,
            # MLP, plus per level and corner the d-linear weight (d muls)
            # and F multiply-adds
            "flops": b * (mlp_flops(dcfg) + g.n_levels * corners
                          * (g.dim + 2 * g.n_features))},
        "mlp_fwd": {
            "bytes": b * (ccfg.in_dim + ccfg.out_dim) * 4 + wbytes(p0["mlp"]),
            "flops": b * mlp_flops(ccfg)},
        "composite_fwd": {
            # rgb + sigma per sample, one (1, S) dts row, pixel + opacity
            "bytes": b * 4 * 4 + N_SAMPLES * 4 + TILE_PIXELS * 4 * 4,
            # per sample: -sigma*dt, 2 exp, 1-alpha, csum, sub, mul, 4 fma
            "flops": b * 16},
    }
    runs = {
        "field_fwd": (
            lambda: ff_ops.field(flat_pts, p0["grid"], p0["density_mlp"], g,
                                 dcfg),
            lambda: field_ref(flat_pts, p0["grid"], p0["density_mlp"], g,
                              dcfg),
            None),
        "mlp_fwd": (
            lambda: mlp_ops.mlp(p0["mlp"], color_in, ccfg),
            lambda: apply_mlp(p0["mlp"], color_in, ccfg),
            # yardstick: the cuBLAS matmul + relu chain at the same shapes
            lambda: torch.relu(torch.relu(torch.relu(torch.relu(
                color_in @ p0["mlp"]["w_in"]) @ p0["mlp"]["w_hidden"][0])
                @ p0["mlp"]["w_hidden"][1]) @ p0["mlp"]["w_hidden"][2])
            @ p0["mlp"]["w_out"]),
        "composite_fwd": (
            lambda: rm_ops.composite(rgb, sigma, dts),
            lambda: render.composite(rgb, sigma, dts),
            None),
    }
    results = {}
    for name, (kern, plain, lib) in runs.items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        bad = max(float(((a - r).abs() - TOL * r.abs()).max())
                  for a, r in zip(got, ref))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            fail(f"{name}: non-finite output")
        if bad > TOL:
            fail(f"{name}: max abs error {err} exceeds atol {TOL} + rtol "
                 f"{TOL}")
        w = work[name]
        t_bytes = w["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = w["flops"] / PEAK_F32_FLOPS * 1e3
        results[name] = {
            "max_abs_err": err, "tol": TOL,
            "ms": device_ms(kern, reps=20),
            "plain_ms": device_ms(plain, reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": device_ms(lib, reps=20) if lib else None,
            "bytes": w["bytes"], "flops": w["flops"]}
    emit({"phase": "kernels", "points": b, "rays": TILE_PIXELS,
          "table_rows_touched": rows, "results": results, **gpu})

    # ------------------------------------------------------------ serve
    settings = pipeline.RenderSettings(tile_pixels=TILE_PIXELS,
                                       n_samples=N_SAMPLES)
    engine = RenderEngine(settings, device=dev)
    for s, p in enumerate(params):
        engine.add_scene(f"scene{s}", cfg, p)
    del params, p0
    warm_s = engine.warmup()
    cams = [scenes.orbit_camera(FRAME, FRAME, a) for a in (0.0, 2.1, 4.2)]
    reqs = [RenderRequest(f"scene{i % 2}", cams[i % 3],
                          rng.integers(0, FRAME * FRAME, TILE_PIXELS))
            for i in range(N_REQUESTS)]
    K.reset_launch_counts()
    tickets = [engine.submit(r) for r in reqs]
    engine.flush()
    launches = K.launch_counts()
    outs = [t.result() for t in tickets]
    for o in outs:
        if o.shape != (TILE_PIXELS, 3) or not np.isfinite(o).all() \
                or o.min() < 0 or o.max() > 1:
            fail("serve: a request returned a bad result")
    if min(launches.values()) <= 0:
        fail(f"serve: a kernel of the path never launched: {launches}")
    st = engine.stats()
    p50, p90, p99 = (1e3 * v for v in engine.exact_percentiles(50, 90, 99))
    emit({"phase": "serve", "scenes": 2, "requests": st["n_requests"],
          "tile_pixels": TILE_PIXELS, "n_samples": N_SAMPLES,
          "p50_ms": p50, "p90_ms": p90, "p99_ms": p99,
          "hist_p50_ms": st["p50_ms"], "hist_p99_ms": st["p99_ms"],
          "mpix_per_s": st["mpix_per_s"], "wall_s": st["wall_s"],
          "warmup_s": warm_s, "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), **gpu})

    # ---------------------------------------------------------- profile
    # Device busy time, idle share and time by kernel, each from one trace
    # of one steady window of PROFILE_REQUESTS served requests. Two windows:
    # CPU + CUDA activity (the breakdown), and CUDA activity alone, whose
    # host overhead is smaller, so its idle share is nearer the unprofiled
    # stream's.
    for window, acts in (("cpu+cuda", [ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]),
                         ("cuda", [ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for r in reqs[:PROFILE_REQUESTS]:
                engine.submit(r)
            engine.flush()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel, spans = {}, []
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                key = re.sub(r"\(.*", "", ev.name)[-70:]
                dur = (ev.time_range.end - ev.time_range.start) / 1e3
                by_kernel[key] = by_kernel.get(key, 0.0) + dur
                spans.append((ev.time_range.start / 1e3,
                              ev.time_range.end / 1e3))
        busy_ms = union_ms(spans)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        emit({"phase": "profile", "window": window,
              "requests": PROFILE_REQUESTS, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms if spans else "not measured",
              "device_idle_share": (1 - busy_ms / wall_ms) if spans
              else "not measured",
              "device_events": len(spans), "top_device_ms": top, **gpu})

    # ----------------------------------------------------------- parity
    pcam = scenes.orbit_camera(32, 32, 0.9)
    got = engine.render_frame("scene0", pcam)
    cpu_params = fields.from_jax_params(np_params(cfg, SEED), cfg, "cpu")
    ref = pipeline.render_frame(cpu_params, cfg, pcam, settings,
                                device="cpu").numpy()
    perr = float(np.abs(got - ref).max())
    if not np.isfinite(got).all() or perr > PARITY_TOL:
        fail(f"parity: engine vs CPU render_frame max abs error {perr}")
    emit({"phase": "parity", "frame": [32, 32], "max_abs_err": perr,
          "tol": PARITY_TOL, "mean_rgb": float(got.mean()), **gpu})

    # ----------------------------------------------------------- report
    source = {"field_fwd": ("src/repro_torch/csrc/field.cu",
                            "src/repro/kernels/fused_field/fused_field.py:111"),
              "mlp_fwd": ("src/repro_torch/csrc/mlp.cu",
                          "src/repro/kernels/fused_mlp/fused_mlp.py:74"),
              "composite_fwd": ("src/repro_torch/csrc/composite.cu",
                                "src/repro/kernels/ray_march/ray_march.py:53")}
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": source[n][0],
         "replaces": source[n][1], "launches": launches[n],
         **{k: results[n][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")}}
        for n in runs]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
