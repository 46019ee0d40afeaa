#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's serving paths through ``RenderEngine`` at Table-I width
and depth, and holds every CUDA kernel on them against its plain PyTorch
version: ``nerf_hash`` (L=16 levels of 2^19 x 2 f32 tables, density MLP
32->64x3->16, colour MLP 32->64x4->3), ``gia_hash`` (2-D points, L=16
levels of 2^24 x 2 tables, 2 GiB per scene in f32; MLP 32->64x4->3) and
``nsdf_hash`` (L=16 levels of 2^19 x 2; MLP 32->64x4->1, sphere-traced).
Weights and U(-1, 1) tables come from a numpy seed; the served nsdf scenes
are ``scenes.baked_sdf_params`` (a sphere in level 0, random perturbation
elsewhere), on which sphere tracing converges. Phases, each printing one
JSON line:

  build    compile the kernel library from ``src/repro_torch/csrc`` (nvcc,
           sm_90a); ptxas' registers and spills per kernel, the tensor-core
           instructions (HMMA) in each kernel's SASS (cuobjdump), and the
           shared memory per block of the MLP and field kernels' plans
  kernels  each kernel against its plain version on the inputs of one real
           engine tile (nerf: 4096 pixels x 32 samples; gia: 4096 pixels):
           max error against the stated tolerance, device time per call
           (CUDA events), ``floor_ms`` (the same kernel's queued time on
           the smallest input: 1 ray, 1 point, 1 row), host time to
           enqueue one call (the wrapper's checks, plan and launch), the
           plain version's time, the bound, and a PyTorch yardstick where
           one exists; the quantized field kernel and the standalone
           encode run on the same tile with tables quantized in the port
           (int8, fp8-e4m3) and cast to bf16 (nerf's field_fwd with bf16
           weights too); field_fwd at nsdf's MLP on 131,072 random points
           with U(-1, 1) params; composite_fwd on the field's packed
           (R, S, 4) output with a broadcast (1, S) dts (the served
           layout) and on separate rgb, sigma and (R, S) dts (its strided
           path); each encode row adds its gather count (B x L x 2^d),
           gathers per second and the level-group plan (G, points per
           block, groups, blocks)
  unfused  the unfused route, encode_fwd then mlp_fwd, for nerf's f32, int8
           and fp8 tables and gia's f32 and int8 ones, against the fused
           kernel (the paper's fused-vs-unfused comparison), with both
           device times
  serve    2 nerf scenes, warmup, 120 random-pixel requests over 2 scenes x
           3 orbit cameras at 256x256, at most 2 in flight (a closed loop);
           latency (p50, and p90: the highest percentile with 10 samples
           beyond it), throughput, and the launch count of every kernel
           during the stream (each must be > 0)
  profile  device busy time, idle share (1 - busy / wall) and time by
           kernel, each from one torch.profiler trace of one steady window
           of 20 served requests; one window with CPU + CUDA activity, one
           with CUDA activity alone
  parity   a 32x32 frame from the engine on the card against the port's
           render_frame on the CPU (plain versions), same params
  serve_quant  scene 0 quantized on the card twice, QuantSpec("int8") and
           QuantSpec("fp8_e4m3", mlp_qtype="int8"), and with its tables cast
           to bf16, one bucket each; 120 requests alternating between them
           as in serve; field_fwd_q must launch for the quantized buckets and
           field_fwd exactly once per bf16 request
  parity_quant  each of those scenes' 32x32 frame on the card against
           render_frame on the CPU on the same params, and its distance to
           the dense frame (finite, non-zero, under 0.2)
  serve_gia  2 gia scenes in three buckets (f32, bf16 tables, int8 tables
           quantized on the card), 120 requests of 4096 random pixels of a
           4096x4096 image; as serve, plus the seconds to make the tables
           and the device memory quantize_field takes on top of a 2 GiB
           stack; field_fwd and field_fwd_q must launch
  serve_nsdf  2 baked nsdf scenes, 3 orbit cameras at 256x256, 120
           requests of 4096 pixels; field_fwd must launch exactly 55 times
           per request (48 trace steps, the hit points, 6 for the normal)
  profile_gia, profile_nsdf  one CUDA-only window of 20 requests each
  parity_gia  each gia bucket's 32x32 frame against render_frame on the
           CPU, and the bf16 and int8 frames' distance to the f32 frame
           (finite, non-zero, under 0.2)
  parity_nsdf  the nsdf frame against render_frame on the CPU, and its hit
           fraction, which must be neither 0 nor 1

then the ``{"kernels": [...]}`` line (every kernel, launches from the path
that runs it and per path, ``floor_ms``, the rows of other table types,
apps and layouts under ``variants``), the card's name and power limit as
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

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): HBM3 rate,
# TF32 on the tensor cores (the MLP products, three passes in 3xTF32) and
# f32 outside them (the encode's arithmetic).
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
TF32_PASSES = 3
TOL = 1e-4          # kernel vs plain, f32: 3xTF32 products, another sum order
PARITY_TOL = 1e-4   # engine on the card vs render_frame on the CPU
QUANT_DENSE_MAX = 0.2   # quantized frame vs dense frame (tests/test_quant.py)
TILE_PIXELS, N_SAMPLES, FRAME = 4096, 32, 256
GIA_FRAME = 4096             # gia's image side: 16.7 Mpix
NSDF_POINTS = 131_072        # nsdf's kernel row: one nerf tile's points
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


def host_ms(fn, reps=20):
    """Host milliseconds per call to enqueue ``fn`` (its checks, its plan
    and its launch), without waiting for the device: the launch queue holds
    far more than ``reps`` launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def union_ms(spans):
    """Length of the union of (start, end) intervals: device busy time,
    counting overlapping kernels and copies once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# a kernel's mangled name: repro::<name>_kernel<template args>
KERNEL_NAME = re.compile(r"_ZN5repro\d+(\w+?_kernel)(?:I(\w+?)E)?E")


def kernel_name(line):
    """``name<template args>`` of the repro kernel a tool's line names, or
    None."""
    m = KERNEL_NAME.search(line)
    if not m:
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_summary(log):
    """[(kernel, registers, spill bytes)] from nvcc -Xptxas -v output."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), spill])
            name = None
    return rows


def sass_mma_counts(lib_path):
    """{kernel: tensor-core (HMMA) instructions in its SASS}, from the
    cuobjdump that ships beside nvcc."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        fail(f"build: {tool} not found, so the MLP kernels' tensor-core "
             "instructions cannot be counted")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = kernel_name(line)
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


def np_params(cfg, seed):
    """U(-1, 1) tables (a wrong row or level shows) and normal/sqrt(fan_in)
    weights, from a numpy seed, as numpy f32 arrays."""
    import numpy as np
    from repro_torch.core import fields
    rng = np.random.default_rng(seed)

    def draw(shapes, grid):
        if isinstance(shapes, dict):
            return {k: draw(s, k == "grid") for k, s in shapes.items()}
        if grid:                  # in place: gia's stack is 2 GiB
            tables = rng.random(shapes, dtype=np.float32)
            tables *= 2
            tables -= 1
            return tables
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
    from repro_torch.kernels.fused_field.fused_field import field_plan
    from repro_torch.kernels.fused_field.ref import field_ref
    from repro_torch.kernels.fused_mlp.fused_mlp import mlp_plan
    from repro_torch.kernels.fused_mlp import ops as mlp_ops
    from repro_torch.kernels.hashgrid import ops as hops
    from repro_torch.kernels.hashgrid.hashgrid import encode_plan, sm_count
    from repro_torch.kernels.hashgrid.ref import encode_ref
    from repro_torch.kernels.ray_march import ops as rm_ops
    from repro_torch.quant import QuantSpec, quantize_field
    from repro_torch.serve import RenderEngine, RenderRequest
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    gpu = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    # ------------------------------------------------------------ build
    t_start = t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    log = (lib_path.parent / "build.log").read_text()
    ptxas = ptxas_summary(log)
    mma = sass_mma_counts(lib_path)
    cfg = fields.make_field_config("nerf", "hash")
    gcfg = fields.make_field_config("gia", "hash")
    ncfg = fields.make_field_config("nsdf", "hash")
    smem = {"mlp_fwd (colour MLP)": mlp_plan(cfg.mlp)["smem_bytes"],
            "field_fwd (density MLP)": field_plan(cfg.density_mlp)[
                "smem_bytes"],
            "field_fwd (gia MLP)": field_plan(gcfg.mlp)["smem_bytes"],
            "field_fwd (nsdf MLP)": field_plan(ncfg.mlp)["smem_bytes"]}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, ROOT),
          "ptxas_kernel_registers_spill_bytes": ptxas,
          "sass_hmma_per_kernel": mma, "smem_bytes_per_block": smem, **gpu})
    spilled = [r for r in ptxas if r[2] > 0]
    if spilled:
        fail(f"build: ptxas spilled registers: {spilled}")
    # every MLP kernel, the colour MLP's 64-wide one and a field kernel
    # among them, must take its products on the tensor cores
    mlp_kernels = {k: n for k, n in mma.items()
                   if k.startswith(("mlp_fwd_kernel", "field_fwd_kernel"))}
    if (min(mlp_kernels.values(), default=0) == 0
            or not any(k.startswith("mlp_fwd_kernel<Li64") for k in mma)
            or not any(k.startswith("field_fwd_kernel<Li3E") for k in mma)
            or not any(k.startswith("field_fwd_kernel<Li2E") for k in mma)):
        fail(f"build: MLP kernels without tensor-core instructions, or no "
             f"3-D and 2-D field kernels: {mma}")
    if not any(k.startswith("encode_fwd_kernel<Li2E") for k in mma):
        fail(f"build: no 2-D encode kernel in the library: {sorted(mma)}")

    # ---------------------------------------------------------- kernels
    params = [fields.from_jax_params(np_params(cfg, SEED + s), cfg, dev)
              for s in range(2)]
    p0 = params[0]
    # the quantized tables of the kernel rows, made in the port on the card
    qtab = {v: quantize_field(p0, QuantSpec(qtype))
            for v, qtype in (("int8", "int8"), ("fp8", "fp8_e4m3"))}
    rng = np.random.default_rng(SEED)
    cam = scenes.orbit_camera(FRAME, FRAME, 0.0)
    ids = torch.from_numpy(rng.integers(0, FRAME * FRAME, TILE_PIXELS)).to(dev)
    origins, dirs = render.make_rays(cam, ids)
    pts, dts = render.sample_along_rays(origins, dirs, 0.5, 4.5, N_SAMPLES)
    flat_pts = render.normalize_to_unit(pts.reshape(-1, 3)).contiguous()
    flat_dirs = torch.repeat_interleave(dirs, N_SAMPLES, dim=0)
    b = flat_pts.shape[0]
    dcfg, ccfg, g = cfg.density_mlp, cfg.mlp, cfg.grid

    # gia: 2 scenes of 2 GiB f32 tables, made once (numpy, then the card);
    # the int8 and fp8 stacks of scene 0 quantized on the card, with the
    # device memory quantize_field takes on top of the stack
    t0 = time.perf_counter()
    gia_np0 = np_params(gcfg, SEED + 10)
    gia_params = [fields.from_jax_params(gia_np0, gcfg, dev),
                  fields.from_jax_params(np_params(gcfg, SEED + 11), gcfg,
                                         dev)]
    torch.cuda.synchronize()
    gia_make_s = time.perf_counter() - t0
    g0 = gia_params[0]
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    gqtab = {"gia_int8": quantize_field(g0, QuantSpec("int8"))}
    torch.cuda.synchronize()
    quant_peak_extra = torch.cuda.max_memory_allocated(dev) - base
    gqtab["gia_fp8"] = quantize_field(g0, QuantSpec("fp8_e4m3"))
    gia_bf16 = g0["grid"].to(torch.bfloat16)
    gia_cam = scenes.orbit_camera(GIA_FRAME, GIA_FRAME, 0.0)
    gia_pts = pipeline.pixel_coords(gia_cam, torch.from_numpy(
        rng.integers(0, GIA_FRAME * GIA_FRAME, TILE_PIXELS)).to(dev))
    # nsdf's kernel row: U(-1, 1) params, random points
    nsdf_rand = fields.from_jax_params(np_params(ncfg, SEED + 20), ncfg, dev)
    nsdf_pts = torch.from_numpy(rng.random((NSDF_POINTS, 3),
                                           dtype=np.float32)).to(dev)

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
        return sum(t.numel() * t.element_size() for t in tree.values())

    # each app's grid tile: (points, grid config, distinct rows it touches)
    tiles = {"nerf": (flat_pts, g, touched_rows(flat_pts, g)),
             "gia": (gia_pts, gcfg.grid, touched_rows(gia_pts, gcfg.grid)),
             "nsdf": (nsdf_pts, ncfg.grid, touched_rows(nsdf_pts,
                                                        ncfg.grid))}

    def grid_work(app, tables, scales):
        """Bytes and f32 flops of the encode of this tile: points in, the
        distinct table rows it gathers at the table's itemsize, the scales;
        per level and corner the d-linear weight (d muls), F multiply-adds
        and, for codes, F dequant multiplies."""
        x, gg, rows = tiles[app]
        quantized = scales is not None
        return {"bytes": x.numel() * 4
                + rows * gg.n_features * tables.element_size()
                + (scales.numel() * 4 if quantized else 0),
                "flops": x.shape[0] * gg.n_levels * (1 << gg.dim)
                * (gg.dim + (3 if quantized else 2) * gg.n_features),
                "mlp_flops": 0}

    grid_bf16 = p0["grid"].to(torch.bfloat16)
    dmlp_bf16 = {k: t.to(torch.bfloat16)
                 for k, t in p0["density_mlp"].items()}
    # variant -> (app, tables, scales, MLP weights, MLP config)
    field_inputs = {
        "f32": ("nerf", p0["grid"], None, p0["density_mlp"], dcfg),
        "bf16": ("nerf", grid_bf16, None, dmlp_bf16, dcfg),
        "int8": ("nerf", qtab["int8"]["grid"], qtab["int8"]["grid_scale"],
                 p0["density_mlp"], dcfg),
        "fp8": ("nerf", qtab["fp8"]["grid"], qtab["fp8"]["grid_scale"],
                p0["density_mlp"], dcfg),
        "gia_f32": ("gia", g0["grid"], None, g0["mlp"], gcfg.mlp),
        "gia_bf16": ("gia", gia_bf16, None, g0["mlp"], gcfg.mlp),
        "gia_int8": ("gia", gqtab["gia_int8"]["grid"],
                     gqtab["gia_int8"]["grid_scale"], g0["mlp"], gcfg.mlp),
        "gia_fp8": ("gia", gqtab["gia_fp8"]["grid"],
                    gqtab["gia_fp8"]["grid_scale"], g0["mlp"], gcfg.mlp),
        "nsdf_f32": ("nsdf", nsdf_rand["grid"], None, nsdf_rand["mlp"],
                     ncfg.mlp)}

    def field_call(v, kernel, n=None):
        app, tab, sc, w, m = field_inputs[v]
        x, gg, _ = tiles[app]
        x = x[:n]
        if kernel:
            return lambda: ff_ops.field(x, tab, w, gg, m, table_scales=sc)
        return lambda: field_ref(x, tab, w, gg, m, sc)

    def encode_call(v, kernel, n=None):
        app, tab, sc, _, _ = field_inputs[v]
        x, gg, _ = tiles[app]
        x = x[:n]
        if kernel:
            return lambda: hops.encode(x, tab, gg, table_scales=sc)
        return lambda: encode_ref(x, tab, gg, sc)

    # (kernel, variant) -> (kernel call, plain call, library call, work,
    # the kernel call on the smallest input); field_fwd[bf16] takes bf16
    # tables and bf16 density weights
    runs = {}
    for v, (app, tab, sc, w, m) in field_inputs.items():
        fw = grid_work(app, tab, sc)
        n = tiles[app][0].shape[0]
        runs["field_fwd" if sc is None else "field_fwd_q", v] = (
            field_call(v, True), field_call(v, False), None,
            {"bytes": fw["bytes"] + wbytes(w) + n * m.out_dim * 4,
             "flops": fw["flops"], "mlp_flops": n * mlp_flops(m)},
            field_call(v, True, 1))
    for v in ("f32", "bf16", "int8", "fp8", "gia_f32", "gia_bf16",
              "gia_int8", "gia_fp8"):
        app, tab, sc, _, _ = field_inputs[v]
        fw = grid_work(app, tab, sc)
        x, gg, _ = tiles[app]
        plan = encode_plan(gg, tab.dtype, x.shape[0],
                           sm_count(x.device.index))
        runs["encode_fwd", v] = (
            encode_call(v, True), encode_call(v, False), None,
            {**fw, "bytes": fw["bytes"] + x.shape[0] * gg.out_dim * 4,
             # every corner of every level: the gather requests it issues
             "gathers": x.shape[0] * gg.n_levels * (1 << gg.dim),
             "plan": {k: plan[k] for k in ("group_levels",
                                           "points_per_block", "n_groups",
                                           "blocks", "store_bytes")}},
            encode_call(v, True, 1))
    runs["mlp_fwd", None] = (
        lambda: mlp_ops.mlp(p0["mlp"], color_in, ccfg),
        lambda: apply_mlp(p0["mlp"], color_in, ccfg),
        # yardstick: the cuBLAS matmul + relu chain at the same shapes
        lambda: torch.relu(torch.relu(torch.relu(torch.relu(
            color_in @ p0["mlp"]["w_in"]) @ p0["mlp"]["w_hidden"][0])
            @ p0["mlp"]["w_hidden"][1]) @ p0["mlp"]["w_hidden"][2])
        @ p0["mlp"]["w_out"],
        {"bytes": b * (ccfg.in_dim + ccfg.out_dim) * 4 + wbytes(p0["mlp"]),
         "flops": 0, "mlp_flops": b * mlp_flops(ccfg)},
        lambda: mlp_ops.mlp(p0["mlp"], color_in[:1], ccfg))
    # composite_fwd on the served layout (the packed field output, a (1, S)
    # dts row) and on its strided path (separate rgb and sigma, (R, S) dts)
    rgb_s, sigma_s = rgb.contiguous(), sigma.contiguous()
    dts_s = dts.expand(TILE_PIXELS, N_SAMPLES).contiguous()
    for v, (c, sg, dt) in {"packed": (rgb, sigma, dts),
                           "strided": (rgb_s, sigma_s, dts_s)}.items():
        runs["composite_fwd", v] = (
            lambda c=c, sg=sg, dt=dt: rm_ops.composite(c, sg, dt),
            lambda c=c, sg=sg, dt=dt: render.composite(c, sg, dt),
            None,
            # rgb + sigma per sample, the dts, pixel + opacity; per
            # sample: -sigma*dt, 2 exp, 1-alpha, csum, sub, mul, 4 fma
            {"bytes": b * 4 * 4 + dt.numel() * 4 + TILE_PIXELS * 4 * 4,
             "flops": b * 16, "mlp_flops": 0},
            lambda c=c, sg=sg, dt=dt: rm_ops.composite(c[:1], sg[:1],
                                                       dt[:1]))

    results, outputs = {}, {}
    for (name, v), (kern, plain, lib, w, tiny) in runs.items():
        label = name if v is None else f"{name}[{v}]"
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a - r).abs().max()) for a, r in zip(got, ref))
        bad = max(float(((a - r).abs() - TOL * r.abs()).max())
                  for a, r in zip(got, ref))
        if not all(bool(torch.isfinite(a).all()) for a in got):
            fail(f"{label}: non-finite output")
        if bad > TOL:
            fail(f"{label}: max abs error {err} exceeds atol {TOL} + rtol "
                 f"{TOL}")
        outputs[name, v] = got[0]
        # the least time on the units the kernel uses: HBM bytes, the MLP
        # products on the tensor cores (3 TF32 passes), the rest in f32 on
        # the CUDA cores, which run beside the tensor cores; and, for the
        # record, with every flop in f32 on the CUDA cores
        t_bytes = w["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = max(TF32_PASSES * w["mlp_flops"] / PEAK_TF32_FLOPS,
                    w["flops"] / PEAK_F32_FLOPS) * 1e3
        t_f32 = (w["flops"] + w["mlp_flops"]) / PEAK_F32_FLOPS * 1e3
        ms = device_ms(kern, reps=20)
        results[name, v] = {
            "max_abs_err": err, "tol": TOL, "ms": ms,
            "floor_ms": device_ms(tiny, reps=20),
            "host_ms_per_call": host_ms(kern),
            "plain_ms": device_ms(plain, reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_cuda_cores_ms": max(t_bytes, t_f32),
            "library_ms": device_ms(lib, reps=20) if lib else None,
            "bytes": w["bytes"], "flops": w["flops"],
            "mlp_flops": w["mlp_flops"]}
        if "gathers" in w:
            results[name, v].update(gathers=w["gathers"],
                                    gathers_per_s=w["gathers"] / ms * 1e3,
                                    plan=w["plan"])
    emit({"phase": "kernels",
          "points": {app: t[0].shape[0] for app, t in tiles.items()},
          "rays": TILE_PIXELS,
          "table_rows_touched": {app: t[2] for app, t in tiles.items()},
          "results": {n if v is None else f"{n}[{v}]": r
                      for (n, v), r in results.items()}, **gpu})

    # ---------------------------------------------------------- unfused
    # The unfused route: encode_fwd writes the (B, L*F) features to device
    # memory and mlp_fwd reads them back, against the fused kernel.
    def unfused(v):
        app, tab, sc, w, m = field_inputs[v]
        x, gg, _ = tiles[app]
        return mlp_ops.mlp(w, hops.encode(x, tab, gg, table_scales=sc), m)

    fused = {v: ("field_fwd" if field_inputs[v][2] is None
                 else "field_fwd_q", v)
             for v in ("f32", "int8", "fp8", "gia_f32", "gia_int8")}
    K.reset_launch_counts()
    unfused_out = {v: unfused(v) for v in fused}
    torch.cuda.synchronize()
    unfused_launches = K.launch_counts()
    unfused_rows = {}
    for v, key in fused.items():
        ref = outputs[key]
        err = float((unfused_out[v] - ref).abs().max())
        if float(((unfused_out[v] - ref).abs() - TOL * ref.abs()).max()) \
                > TOL:
            fail(f"unfused[{v}]: differs from the fused kernel by {err}")
        unfused_rows[v] = {
            "max_abs_err_vs_fused": err,
            "unfused_ms": device_ms(lambda v=v: unfused(v), reps=20),
            "encode_fwd_ms": results["encode_fwd", v]["ms"],
            "fused_ms": results[key]["ms"]}
    if unfused_launches["encode_fwd"] != len(fused) \
            or unfused_launches["mlp_fwd"] != len(fused):
        fail(f"unfused: encode_fwd and mlp_fwd must launch {len(fused)} "
             f"times each: {unfused_launches}")
    emit({"phase": "unfused",
          "mlp": {"nerf": "32->64x3->16", "gia": "32->64x4->3"},
          "launches": unfused_launches, "results": unfused_rows, **gpu})
    gia_q0 = gqtab["gia_int8"]
    del runs, outputs, unfused_out, field_inputs, tiles, gqtab, nsdf_rand

    # ------------------------------------------------------------ serve
    settings = pipeline.RenderSettings(tile_pixels=TILE_PIXELS,
                                       n_samples=N_SAMPLES)
    cams = [scenes.orbit_camera(FRAME, FRAME, a) for a in (0.0, 2.1, 4.2)]

    def serve(engine, scene_names, phase, cams=cams):
        """120 random-pixel requests, scene_names and cameras in turn, with
        the launch counts of exactly this stream and the peak device memory
        allocated while it runs (every live tensor counts)."""
        torch.cuda.reset_peak_memory_stats(dev)
        warm_s = engine.warmup()
        reqs = []
        for i in range(N_REQUESTS):
            c = cams[i % len(cams)]
            reqs.append(RenderRequest(
                scene_names[i % len(scene_names)], c,
                rng.integers(0, c.height * c.width, TILE_PIXELS)))
        K.reset_launch_counts()
        tickets = [engine.submit(r) for r in reqs]
        engine.flush()
        launches = K.launch_counts()
        for t in tickets:
            o = t.result()
            if o.shape != (TILE_PIXELS, 3) or not np.isfinite(o).all() \
                    or o.min() < 0 or o.max() > 1:
                fail(f"{phase}: a request returned a bad result")
        st = engine.stats()
        p50, p90, p99 = (1e3 * v for v in engine.exact_percentiles(50, 90, 99))
        per_scene = {
            n: 1e3 * statistics.median(t.latency_s
                                       for r, t in zip(reqs, tickets)
                                       if r.scene == n)
            for n in scene_names}
        return reqs, launches, {
            "phase": phase, "scenes": len(scene_names),
            "requests": st["n_requests"], "tile_pixels": TILE_PIXELS,
            "n_samples": N_SAMPLES, "p50_ms": p50, "p90_ms": p90,
            "p99_ms": p99, "p50_ms_by_scene": per_scene,
            "hist_p50_ms": st["p50_ms"], "hist_p99_ms": st["p99_ms"],
            "mpix_per_s": st["mpix_per_s"], "wall_s": st["wall_s"],
            "warmup_s": warm_s, "launches": launches,
            "buckets": list(st["buckets"]),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), **gpu}

    engine = RenderEngine(settings, device=dev)
    for s, p in enumerate(params):
        engine.add_scene(f"scene{s}", cfg, p)
    del params
    reqs, launches, line = serve(engine, ["scene0", "scene1"], "serve")
    dense_path = ("field_fwd", "mlp_fwd", "composite_fwd")
    if min(launches[k] for k in dense_path) <= 0:
        fail(f"serve: a kernel of the path never launched: {launches}")
    emit(line)

    # ---------------------------------------------------------- profile
    # Device busy time, idle share and time by kernel, each from one trace
    # of one steady window of PROFILE_REQUESTS served requests. Two windows:
    # CPU + CUDA activity (the breakdown), and CUDA activity alone, whose
    # host overhead is smaller, so its idle share is nearer the unprofiled
    # stream's.
    def profile_window(engine, window_reqs, acts):
        """Device busy time, idle share, device events and time by kernel
        of one traced window of ``window_reqs``."""
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for r in window_reqs:
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
        return {"requests": len(window_reqs), "wall_ms": wall_ms,
                "device_busy_ms": busy_ms if spans else "not measured",
                "device_busy_ms_per_request": busy_ms / len(window_reqs)
                if spans else "not measured",
                "device_idle_share": (1 - busy_ms / wall_ms) if spans
                else "not measured",
                "device_events": len(spans), "top_device_ms": top}

    for window, acts in (("cpu+cuda", [ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]),
                         ("cuda", [ProfilerActivity.CUDA])):
        emit({"phase": "profile", "window": window,
              **profile_window(engine, reqs[:PROFILE_REQUESTS], acts), **gpu})

    # ----------------------------------------------------------- parity
    pcam = scenes.orbit_camera(32, 32, 0.9)
    dense_frame = engine.render_frame("scene0", pcam)
    cpu_params = fields.from_jax_params(np_params(cfg, SEED), cfg, "cpu")
    ref = pipeline.render_frame(cpu_params, cfg, pcam, settings,
                                device="cpu").numpy()
    perr = float(np.abs(dense_frame - ref).max())
    if not np.isfinite(dense_frame).all() or perr > PARITY_TOL:
        fail(f"parity: engine vs CPU render_frame max abs error {perr}")
    emit({"phase": "parity", "frame": [32, 32], "max_abs_err": perr,
          "tol": PARITY_TOL, "mean_rgb": float(dense_frame.mean()), **gpu})
    del engine

    # ------------------------------------------------------ serve_quant
    # Scene 0 quantized on the card two ways, and with its tables cast to
    # bf16, one bucket each; the stream alternates between them.
    qspecs = {"q_int8": QuantSpec("int8"),
              "q_fp8": QuantSpec("fp8_e4m3", mlp_qtype="int8")}
    qscenes = {n: (cfg.with_quant(spec), quantize_field(p0, spec))
               for n, spec in qspecs.items()}
    qscenes["bf16"] = (cfg, {**p0, "grid": grid_bf16})
    qengine = RenderEngine(settings, device=dev)
    for n, (qcfg, qp) in qscenes.items():
        qengine.add_scene(n, qcfg, qp)
    qreqs, qlaunches, line = serve(qengine, list(qscenes), "serve_quant")
    n_bf16 = sum(r.scene == "bf16" for r in qreqs)
    if qlaunches["field_fwd_q"] <= 0 or qlaunches["field_fwd"] != n_bf16 \
            or min(qlaunches["mlp_fwd"], qlaunches["composite_fwd"]) <= 0:
        fail(f"serve_quant: field_fwd_q, mlp_fwd and composite_fwd must "
             f"launch, and field_fwd once per bf16 request ({n_bf16}): "
             f"{qlaunches}")
    # every device launch of each bucket's requests, the plain PyTorch ops
    # around the kernels (the fp8 bucket's MLP dequant among them) included
    line["profile_cuda_by_scene"] = {
        n: profile_window(qengine, [r for r in qreqs if r.scene == n]
                          [:PROFILE_REQUESTS // 2], [ProfilerActivity.CUDA])
        for n in qscenes}
    emit(line)

    # ----------------------------------------------------- parity_quant
    qparity = {}
    for n, (qcfg, qp) in qscenes.items():
        frame = qengine.render_frame(n, pcam)
        ref = pipeline.render_frame(
            fields.to_device(qp, torch.device("cpu")), qcfg, pcam, settings,
            device="cpu").numpy()
        err = float(np.abs(frame - ref).max())
        to_dense = float(np.abs(frame - dense_frame).max())
        if not np.isfinite(frame).all() or err > PARITY_TOL:
            fail(f"parity_quant: {n} engine vs CPU render_frame max abs "
                 f"error {err}")
        if not 0.0 < to_dense < QUANT_DENSE_MAX:
            fail(f"parity_quant: {n} differs from the dense frame by "
                 f"{to_dense}, not in (0, {QUANT_DENSE_MAX})")
        qparity[n] = {"spec": qcfg.quant.tag if qcfg.quant else "bf16 grid",
                      "max_abs_err": err,
                      "max_abs_diff_to_dense": to_dense}
    emit({"phase": "parity_quant", "frame": [32, 32], "tol": PARITY_TOL,
          "dense_max": QUANT_DENSE_MAX, "scenes": qparity, **gpu})

    # -------------------------------------------------------- serve_gia
    # 2 gia scenes, each in three buckets: f32 tables, bf16 tables, and
    # int8 tables quantized on the card; requests of random pixels of a
    # 4096x4096 image.
    gia_scenes = {}
    for s_, gp in enumerate(gia_params):
        gia_scenes[f"gia{s_}"] = (gcfg, gp)
    for s_, gp in enumerate(gia_params):
        gia_scenes[f"gia{s_}_bf16"] = (gcfg, {
            **gp, "grid": gia_bf16 if s_ == 0 else gp["grid"].to(
                torch.bfloat16)})
    qspec = QuantSpec("int8")
    for s_, gp in enumerate(gia_params):
        gia_scenes[f"gia{s_}_int8"] = (gcfg.with_quant(qspec), gia_q0
                                       if s_ == 0 else quantize_field(
                                           gp, qspec))
    del gia_params, gia_bf16, gia_q0
    gengine = RenderEngine(settings, device=dev)
    for n, (c, gp) in gia_scenes.items():
        gengine.add_scene(n, c, gp)
    greqs, glaunches, line = serve(gengine, list(gia_scenes), "serve_gia",
                                   cams=[gia_cam])
    if min(glaunches["field_fwd"], glaunches["field_fwd_q"]) <= 0 \
            or glaunches["field_fwd"] + glaunches["field_fwd_q"] \
            != N_REQUESTS:
        fail(f"serve_gia: field_fwd and field_fwd_q must launch, once per "
             f"request in all: {glaunches}")
    line.update(image=[GIA_FRAME, GIA_FRAME], make_tables_s=gia_make_s,
                quantize_peak_extra_bytes=quant_peak_extra,
                table_bytes_per_scene=g0["grid"].numel() * 4)
    emit(line)
    emit({"phase": "profile_gia", "window": "cuda",
          **profile_window(gengine, greqs[:PROFILE_REQUESTS],
                           [ProfilerActivity.CUDA]), **gpu})

    # ------------------------------------------------------- parity_gia
    gparity, gia_frames = {}, {}
    gia_cpu = fields.from_jax_params(gia_np0, gcfg, "cpu")
    del gia_np0
    for n in ("gia0", "gia0_bf16", "gia0_int8"):
        c, gp = gia_scenes[n]
        frame = gengine.render_frame(n, pcam)
        cpu_p = (gia_cpu if n == "gia0" else
                 {**gia_cpu, "grid": gia_cpu["grid"].to(torch.bfloat16)}
                 if n == "gia0_bf16" else
                 fields.to_device(gp, torch.device("cpu")))
        ref = pipeline.render_frame(cpu_p, c, pcam, settings,
                                    device="cpu").numpy()
        err = float(np.abs(frame - ref).max())
        if not np.isfinite(frame).all() or err > PARITY_TOL:
            fail(f"parity_gia: {n} engine vs CPU render_frame max abs "
                 f"error {err}")
        gia_frames[n] = frame
        gparity[n] = {"max_abs_err": err, "mean_rgb": float(frame.mean())}
        del cpu_p
    for n in ("gia0_bf16", "gia0_int8"):
        to_dense = float(np.abs(gia_frames[n] - gia_frames["gia0"]).max())
        if not 0.0 < to_dense < QUANT_DENSE_MAX:
            fail(f"parity_gia: {n} differs from the f32 frame by "
                 f"{to_dense}, not in (0, {QUANT_DENSE_MAX})")
        gparity[n]["max_abs_diff_to_f32"] = to_dense
    emit({"phase": "parity_gia", "frame": [32, 32], "tol": PARITY_TOL,
          "dense_max": QUANT_DENSE_MAX, "scenes": gparity, **gpu})
    del gengine, gia_scenes, gia_cpu, g0

    # ------------------------------------------------------- serve_nsdf
    # 2 baked nsdf scenes: sphere tracing converges on them (a field with
    # random tables would amplify any rounding difference without bound)
    nsdf_np = [scenes.baked_sdf_params(ncfg, SEED + 30 + s_)
               for s_ in range(2)]
    nengine = RenderEngine(settings, device=dev)
    for s_, npp in enumerate(nsdf_np):
        nengine.add_scene(f"nsdf{s_}", ncfg,
                          fields.from_jax_params(npp, ncfg, dev))
    nreqs, nlaunches, line = serve(nengine, ["nsdf0", "nsdf1"], "serve_nsdf")
    evals = settings.sphere_steps + 7
    if nlaunches["field_fwd"] != evals * N_REQUESTS \
            or sum(nlaunches.values()) != nlaunches["field_fwd"]:
        fail(f"serve_nsdf: field_fwd must launch {evals} times per request "
             f"and no other kernel: {nlaunches}")
    line.update(field_evals_per_request=evals,
                sphere_steps=settings.sphere_steps)
    emit(line)
    emit({"phase": "profile_nsdf", "window": "cuda",
          **profile_window(nengine, nreqs[:PROFILE_REQUESTS],
                           [ProfilerActivity.CUDA]), **gpu})

    # ------------------------------------------------------ parity_nsdf
    frame = nengine.render_frame("nsdf0", pcam)
    ref = pipeline.render_frame(fields.from_jax_params(nsdf_np[0], ncfg,
                                                       "cpu"),
                                ncfg, pcam, settings, device="cpu").numpy()
    err = float(np.abs(frame - ref).max())
    hit = float((frame.sum(-1) > 0).mean())
    if not np.isfinite(frame).all() or err > PARITY_TOL:
        fail(f"parity_nsdf: engine vs CPU render_frame max abs error {err}")
    if not 0.0 < hit < 1.0:
        fail(f"parity_nsdf: hit fraction {hit}, not in (0, 1)")
    emit({"phase": "parity_nsdf", "frame": [32, 32], "max_abs_err": err,
          "tol": PARITY_TOL, "hit_fraction": hit,
          "hit_fraction_cpu": float((ref.sum(-1) > 0).mean()), **gpu})
    del nengine

    # ----------------------------------------------------------- report
    # kernel -> (source, TPU kernel it replaces, path its launches are
    # read from, launches on that path, variant of the row's own numbers)
    paths = {"serve": launches, "serve_quant": qlaunches,
             "serve_gia": glaunches, "serve_nsdf": nlaunches,
             "unfused": unfused_launches}
    report = {
        "field_fwd": ("src/repro_torch/csrc/field.cu",
                      "src/repro/kernels/fused_field/fused_field.py:111",
                      "serve", launches, "f32"),
        "field_fwd_q": ("src/repro_torch/csrc/field.cu",
                        "src/repro/kernels/fused_field/fused_field.py:111",
                        "serve_quant", qlaunches, "int8"),
        "encode_fwd": ("src/repro_torch/csrc/encode.cu",
                       "src/repro/kernels/hashgrid/hashgrid.py:183",
                       "unfused", unfused_launches, "f32"),
        "mlp_fwd": ("src/repro_torch/csrc/mlp.cu",
                    "src/repro/kernels/fused_mlp/fused_mlp.py:74",
                    "serve", launches, None),
        "composite_fwd": ("src/repro_torch/csrc/composite.cu",
                          "src/repro/kernels/ray_march/ray_march.py:53",
                          "serve", launches, "packed")}
    keys = ("max_abs_err", "ms", "floor_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows_out = []
    for n, (src, tpu, path, counts, main_v) in report.items():
        row = {"name": n, "route": "cuda", "source": src, "replaces": tpu,
               "launches": counts[n], "path": path,
               "launches_by_path": {p: c[n] for p, c in paths.items()},
               **{k: results[n, main_v][k] for k in keys}}
        if main_v is not None:
            row["variant"] = main_v
            row["variants"] = {v: {k: r[k] for k in keys}
                               for (kn, v), r in results.items() if kn == n}
        rows_out.append(row)
    emit({"kernels": rows_out, "script_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
