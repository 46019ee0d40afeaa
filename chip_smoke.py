#!/usr/bin/env python3
"""The port's measurement on one NVIDIA GPU: its kernel library's build,
the kernels' table and the LM stack's full-width phases.

The port's checks on the card are ``tests/test_torch_cuda.py`` (every
serving and training path, at small and at Table-I width); the benchmark
(``ngbench/``) measures the served and trained workloads end to end. This
script builds the library from ``src/repro_torch/csrc``, holds it to its
static budget, times each CUDA kernel on the inputs of one Table-I tile
(``nerf_hash``: L=16 levels of 2^19 x 2 f32 tables, density MLP
32->64x3->16, colour MLP 32->64x4->3; ``gia_hash``: 2-D points, L=16
levels of 2^24 x 2 tables, 2 GiB in f32, MLP 32->64x4->3; ``nsdf_hash``:
L=16 levels of 2^19 x 2, MLP 32->64x4->1) against its plain PyTorch
version and its counted bound, runs the LM phases, and drives the serving
and training paths once for the kernels' launch counts. Weights and
U(-1, 1) tables come from a numpy seed. Phases, each printing one JSON line:

  build    compile the kernel library from ``src/repro_torch/csrc`` (nvcc,
           sm_90a); ptxas' registers and spills per kernel, the tensor-core
           instructions (HMMA) in each kernel's SASS (cuobjdump), and the
           shared memory per block of the MLP and field kernels' plans
  analysis  the port's linter (``python -m repro_torch.analysis
           src/repro_torch --json``) in a child: 0 errors; then the Hopper
           budget (``repro_torch.analysis.budget``) of every kernel
           instantiation of the 12 Table-I configs x f32/bf16/int8/fp8
           tables (encode plans at this card's SM count), and every encode
           and encode_bwd instantiation in the library, against CUDA's own
           numbers (``repro_torch.kernels.info``): shared memory per block,
           threads, registers (ptxas' log against the kernel's attributes)
           and blocks per SM (``budget.blocks_per_sm`` of ptxas' registers
           against cudaOccupancyMaxActiveBlocksPerMultiprocessor); the
           encode kernels must reach the plans' 2 blocks per SM
 lm       the LM stack's serving path (``repro_torch.models``,
           ``parallel/api``), plain PyTorch but for Mamba-2's SSD kernels
           (bf16 chunks on the card): no other kernel of the port may
           launch on it (the counts are set to 0 before it and read
           after). The ten archs at ``reduced_config`` in f32, params
           from the port's init on the CPU copied to the card: forward,
           loss_fn, and through the ``parallel/api`` steps prefill and 8
           teacher-forced decode steps, on the card against the CPU within
           LM_TOL (the unembedding widened to f32 on both,
           ``tests/torch_lm_f32.py``; the shipped bf16 one held alone on
           the same inputs); qwen2-7b, olmoe-1b-7b (drops off: capacity
           factor E/k), mamba2-2.7b, h2o-danube-1.8b (a 6144-token prompt
           past its 4096 window: the ring wraps, prefill slices the keys)
           and whisper-base at their published width and depth in f32:
           prefill, 16 greedy decode steps, the last against one forward
           over the prompt and the generated tokens within LM_FULL_TOL;
           then each served by ``launch.serve.serve_lm(reduced=False)``,
           the user's path, params drawn in bf16 (no f32 master): prefill
           ms, decode ms per token and tokens/s at batch 4 and a 512-token
           prompt (danube: 1 x 6144), peak memory, the first greedy tokens
           (its ``lm_sample`` record; it raises on a logit that is not
           finite); last ``python -m repro_torch.launch.serve --mode lm``
           in children: a reduced arch and ``--full`` qwen2-7b must exit 0
           with one ``lm_served`` record, ``--full`` jamba-v0.1-52b (104 GB
           in bf16) must be refused with a ``MemoryError``
 lm_train  LM training (``parallel/api.build_train_step``, the backward
           with remat, ``launch/train.py``), plain PyTorch but for
           Mamba-2's SSD kernels: no other kernel of the port may launch
           on it, and full-width bf16 mamba2 must launch ssd_intra_bwd and
           ssd_inter_bwd once a layer and step and ssd_intra_fwd and
           ssd_inter_fwd once or twice (its launches are the SSD rows' of
           the final ``kernels`` line). The
           ten archs at ``reduced_config``
           in f32 (attention chunked in 4 query blocks, danube's window
           slicing the keys): one loss and every gradient leaf, then
           LM_TRAIN_PARITY_STEPS train steps' losses and grad norms, on the
           card against the CPU within LM_TOL (the unembedding widened to
           f32 on both); h2o-danube-1.8b (1 x 6144 tokens, past its
           window), mamba2-2.7b (4 x 1024) and whisper-base (4 x 512)
           trained at published width and depth in bf16 on an f32 master
           with ``TrainConfig``'s Adam for LM_TRAIN_STEPS steps: ms a step
           after a warm-up step, tokens/s, peak memory, the first loss
           against ln(vocab), the bound (8 N tokens at the bf16 peak) and
           one more step under a CUDA-only trace; the loss must fall (the
           last 4 steps' mean below the first 4's); danube in f32 at a
           small batch: the directional derivative along the normalised
           gradient against a central difference (LM_GRAD_CHECK_TOL);
           olmoe-1b-7b's 124.5 GB train state refused by ``check_fits``
           before anything is drawn; last, in children: ``python -m
           repro_torch.launch.train`` (reduced olmoe, 24 steps: the loss
           must fall), one killed after its first checkpoint and re-run
           (it resumes at the next step, losses within LM_RESUME_TOL of
           the uninterrupted run's) and ``examples/torch/train_lm.py`` at
           its defaults
 lm_shard  the LM sharding (``parallel/api`` on a mesh,
           ``parallel/sharded.py``), plain PyTorch but for Mamba-2's SSD
           kernels: no other kernel of the port may launch on it. The one card repeated as (2, 2) and (4, 1)
           ("data", "model") meshes: reduced danube, olmoe, mamba2,
           jamba and whisper (tinydp) in f32, every gradient leaf of
           the first batch, 3 sharded train steps' losses and every
           param, the sharded prefill and 4 decode
           steps' logits, against the unsharded ones on the card within
           LM_SHARD_TOL, the sharded init equal to the one-device init
           sliced, every shard in ``shard_shape``; h2o-danube-1.8b at full
           width in bf16 on an f32 master, 4 steps of 2 x 3072 tokens on
           (2, 2) and unsharded on the same batches: ms a step, tokens/s,
           peak memory, the gather and row-sum bytes a step (computed
           from the leaves' shapes), each loss
           within LM_SHARD_FULL_TOL of the unsharded one and falling;
           memory plans from meta inits (olmoe-1b-7b's train state,
           jamba-v0.1-52b's and qwen2-vl-72b's bf16 serving params) on
           80 GB devices; a reduced danube state saved on (4, 1) and
           recovered onto the (2, 1) plan bit for bit, one more step
 lm_tp    tensor, expert and sequence-parallel serving and training on
           the one card repeated as (1, 4) and (2, 2) ("data", "model")
           meshes, against the unsharded path (plain PyTorch: no kernel of
           the port may launch on it)
 dryrun   the dry run (``python -m repro_torch.launch.dryrun``), which
           counts steps on meta tensors on the CPU, held to this card:
           (a) ``--fields`` in a child: 12 records, each fitting with a
           bound > 0; (b) ``--mesh both`` children for whisper-base
           train_4k and jamba-v0.1-52b's and qwen2-vl-72b's decode_32k (a
           subset of ``--all``, which takes minutes): no failure, each
           record's state bytes equal ``train_state_bytes(mesh=)`` /
           ``param_bytes(mesh=)`` on the same stand-in mesh, every one
           fitting 80 GB; (c) nerf_hash, gia_hash and
           nsdf_hash render one position's 8,192 pixels of the 4k camera
           through ``pipeline.make_render_step`` here: each kernel's
           launches equal the record's, the device ms at least its
           ``bound_s`` (the ratio printed); (d) ``build_and_count`` on a
           one-position mesh at this card's shapes, h2o-danube-1.8b train
           at 1 x 6144 (bf16 on an f32 master) and qwen2-7b prefill at
           4 x 512 in bf16: the counted peak within 10% of
           ``torch.cuda.max_memory_allocated`` for the same step, the
           counted matrix FLOPs equal to ``FlopCounterMode`` on it, its ms
           at least ``bound_s``
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
           block, groups, blocks); encode_fwd, field_fwd and mlp_fwd (the
           unfused route's head on the encode's features) on Table I's
           dense (L=8, F=2) and tiled (L=2, F=8) grids, nerf's (2^19 rows,
           density MLP 16->64x3->16) on nerf's tile and gia's (2^24 rows,
           1 GiB each, MLP 16->64x4->3) on gia's; encode_bwd, the
           encode's table-gradient
           scatter-add, at nerf's tile with f32 and bf16 tables and at
           gia's, against its plain twin (index_add_ per level and corner)
           by max error over the gradient's max abs value, with its atomic
           adds (B x L x 2^d x F) and one index_add_ of the precomputed
           rows as the PyTorch yardstick
     head  nerf's colour head at a 720p tile's rows (460,800 rays x 32
           samples, the benchmark's nerf_hash.frames_720p): the one-launch
           head (mlp_fwd_head) against the op-by-op head on the card to
           1e-6, and the device time of each beside the head's counted
           bound, with mlp_fwd alone on the (B, 32) colour input
     ssd   Mamba-2's SSD at one granite-4.0-h-small layer's shape (2 x
           8,192 tokens in chunks of 256, 128 heads of 64, d_state 128):
           ssd_intra_fwd and ssd_intra_bwd (one launch each, the counts
           set to 0 first) against the plain term and autograd through it
           (y within one bf16 step, each gradient within SSD_GRAD_TOL of
           its largest value) and the backward against its f32 twin
           (within SSD_TWIN_TOL of each gradient's largest value, dCB and
           dx beside one bf16 step); ssd_inter_fwd and ssd_inter_bwd (one
           call each) against the plain inter-chunk term and autograd
           through it and against their twin, y_inter, the final state and
           every gradient within one bf16 step of its largest value, the
           states before each chunk bit for bit the plain loop's on the
           kernels' chunk states; each entry point's device time beside
           its counted bound, on one chunk and head and the plain route's,
           peak memory, and each kernel's registers, shared memory and
           blocks per SM; these numbers are the four rows of the final
           ``kernels`` line

    paths  one short drive of each field main path for the kernel rows'
           launch counts, untimed and held to no reference: 4 nerf
           requests at Table-I width through ``RenderEngine`` on an f32
           scene (``serve``) and 4 on its int8 twin (``serve_quant``), then
           one chunk of 8 nerf steps through ``train_field`` (``train``)

then the ``{"kernels": [...]}`` line (every kernel; its launches on the
path named in its row, ``serve``, ``serve_quant`` or ``train`` for the
field kernels and ``lm_train`` for the SSD kernels, each of which must have
launched it, and its launches on every path under ``launches_by_path``;
``floor_ms``; the rows of other table types, apps and layouts under
``variants``), the card's name and power limit as nvidia-smi gives them,
and ``{"ok": true, "device": {...}}`` last. Any failure exits non-zero before that line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
GPU and the CUDA toolkit (nvcc); imports nothing of JAX.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# The H100 SXM peaks (HBM3 rate, bf16, TF32 and f32 FLOP/s, 80 GB) are
# ``repro_torch.launch.roofline.H100_SXM``; the kernels' work, the bounds
# read, is ``repro_torch.kernels.cost``.
TOL = 1e-4          # kernel vs plain, f32: 3xTF32 products, another sum order
TILE_PIXELS, N_SAMPLES, FRAME = 4096, 32, 256
# the paths phase: requests a scene through RenderEngine, and one chunk of
# nerf steps through train_field (rays a step, ground-truth samples a ray)
PATH_REQUESTS = 4
TRAIN_CHUNK, TRAIN_BATCH, GT_SAMPLES = 8, 4096, 64
GIA_FRAME = 4096             # gia's image side: 16.7 Mpix
NSDF_POINTS = 131_072        # nsdf's kernel row: one nerf tile's points
SEED = 0
# encode_bwd against its twin: both sum each table row's terms in f32, the
# kernel with atomics in an order that changes from run to run, so f32
# gradients differ by the rounding of those sums: max error at most this
# share of the gradient's max abs value; bf16 tables add one rounding of
# sums that differ in their last bits, up to one bf16 ulp (2^-7 relative)
GRAD_TOL = 1e-5
GRAD_TOL_BF16 = 2.0 ** -7
# the grids of Table I besides the hash grid: dense (L=8, F=2) and tiled
# (L=2, F=8); their MLPs take L*F = 16 inputs
GRID_VARIANTS = ("dense", "tiled")
# the phases obs.trace.annotate names in torch.profiler traces
PHASES = ("encode", "mlp", "encode_mlp", "raymarch", "compact", "composite",
          "host")
# the lm phase: the ten archs at reduced_config, card against CPU (f32,
# the unembed widened to f32 on both: see lm_phase), B x S prompt tokens
# and LM_DECODE teacher-forced decode steps
LM_TOL = 1e-4
LM_REDUCED_BATCH, LM_REDUCED_PROMPT, LM_DECODE = 2, 16, 8
# full width and depth in f32: the last of LM_GEN greedy decode steps
# against one forward over the prompt and the generated tokens (another
# sum order: chunked against full attention, SSD chunks against the
# recurrence); atol + rtol
LM_FULL_TOL = 1e-3
LM_GEN = 16
# arch -> (batch, prompt) of the f32 check and of the bf16 timing;
# danube's prompt is longer than its 4096-token window, so its ring cache
# wraps and chunked prefill slices the keys to window + q_chunk
LM_FULL = {"qwen2-7b": ((2, 64), (4, 512)),
           "olmoe-1b-7b": ((2, 64), (4, 512)),
           "mamba2-2.7b": ((2, 64), (4, 512)),
           "h2o-danube-1.8b": ((1, 6144), (1, 6144)),
           "whisper-base": ((2, 64), (4, 512))}
# the launcher's --mode lm in children: a reduced arch; one published
# config that fits on the card in its act dtype (it must serve); and one
# that does not (it must be refused before anything is drawn)
LM_LAUNCH_ARCH = "olmoe-1b-7b"
LM_LAUNCH_FULL_ARCH = "qwen2-7b"
LM_LAUNCH_REFUSED_ARCH = "jamba-v0.1-52b"
LM_LAUNCH_TIMEOUT_S = 300
# the lm_train phase: the ten reduced archs in f32, one step's loss and
# gradients and LM_TRAIN_PARITY_STEPS steps' losses on the card against
# the CPU (LM_TOL), chunked attention at LM_TRAIN_Q_CHUNK (4 query blocks
# of the 16 tokens) and danube's window at LM_TRAIN_WINDOW (keys sliced)
LM_TRAIN_PARITY_STEPS = 4
LM_TRAIN_Q_CHUNK = 4
LM_TRAIN_WINDOW = 4
# full width and depth in bf16 compute with an f32 master, cut only in
# batch x tokens: arch -> (batch, tokens a row). danube's 6144 tokens pass
# its 4096 window, so the backward runs chunked attention's sliced keys
LM_TRAIN_FULL = {"h2o-danube-1.8b": (1, 6144), "mamba2-2.7b": (4, 1024),
                 "whisper-base": (4, 512)}
LM_TRAIN_STEPS = 8
# the full-width gradient check: danube in f32 at a small batch, the
# directional derivative along the normalised gradient against a central
# difference of the loss, relative; the step moves the loss by about
# LM_GRAD_CHECK_DELTA
LM_GRAD_CHECK = ("h2o-danube-1.8b", 2, 256)
LM_GRAD_CHECK_TOL = 1e-2
LM_GRAD_CHECK_DELTA = 1e-2
# refused at full width: its train state (16 bytes a parameter) does not
# fit on one card
LM_TRAIN_REFUSED_ARCH = "olmoe-1b-7b"
# the launcher's children: a reduced MoE arch, 24 steps in chunks of 8
# with a checkpoint every 8; a child killed after its first checkpoint
LM_TRAIN_LAUNCH_ARCH = "olmoe-1b-7b"
LM_TRAIN_LAUNCH_ARGV = ["--arch", LM_TRAIN_LAUNCH_ARCH, "--reduced",
                        "--chunk-steps", "8", "--ckpt-every", "8"]
LM_TRAIN_LAUNCH_STEPS = 24
LM_RESUME_TOL = 1e-4


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


def rel_err(got, ref):
    """(max abs error, that over the reference's max abs value)."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, (err / scale if scale else err)


def table_grad_scatter(points, cfg, g):
    """The encode backward's scatter, precomputed: the flat (L*T, F) table
    row of every point, level and corner, and its w * g values (the
    index_add_ yardstick's inputs)."""
    import torch
    from repro_torch.core import encoding as enc
    rows, vals, nf = [], [], cfg.n_features
    for level in range(cfg.n_levels):
        cell, frac = enc.level_cell(points, cfg.level_resolution(level))
        for bits in enc._corner_offsets(cfg.dim):
            w = torch.ones_like(frac[:, 0])
            for i in range(cfg.dim):
                w = w * (frac[:, i] if bits[i] else 1.0 - frac[:, i])
            rows.append(enc.level_corner_index(cell, bits, level, cfg)
                        + level * cfg.table_size)
            vals.append(w[:, None] * g[:, level * nf:(level + 1) * nf])
    return torch.cat(rows), torch.cat(vals)


def device_work(ev):
    """True for a profiler event that is device work (a kernel, a copy, a
    memset), not the device-side mirror of an ``obs.trace.annotate``
    range, which spans the work inside it and the gaps between."""
    import torch
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name not in PHASES)


def trace_device(run, acts, n, unit, top=10):
    """Device busy time, idle share, device events and time by kernel
    (the ``top`` longest) of one traced call of ``run``, which does
    ``n`` ``unit``s of work (requests, training steps) and waits for
    the device."""
    import torch
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, spans = {}, []
    for ev in prof.events():
        if device_work(ev):
            key = re.sub(r"\(.*", "", ev.name)[-70:]
            dur = (ev.time_range.end - ev.time_range.start) / 1e3
            by_kernel[key] = by_kernel.get(key, 0.0) + dur
            spans.append((ev.time_range.start / 1e3,
                          ev.time_range.end / 1e3))
    busy_ms = union_ms(spans)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {f"{unit}s": n, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if spans else "not measured",
            f"device_busy_ms_per_{unit}": busy_ms / n
            if spans else "not measured",
            "device_idle_share": (1 - busy_ms / wall_ms) if spans
            else "not measured",
            "device_events": len(spans), "top_device_ms": top}


# the analysis phase: the linter's child, and the template arguments of
# each kernel instantiation as ptxas names them (``kernel_name``)
ANALYSIS_TIMEOUT_S = 300
PTXAS_TYPE = {0: "f", 1: "a", 2: "13__nv_fp8_e4m3", 3: "13__nv_bfloat16"}
ENCODE_PTXAS = re.compile(r"(encode_fwd|encode_bwd)_kernel<Li(\d+)ELi(\d+)E"
                          r"(f|a|13__nv_fp8_e4m3|13__nv_bfloat16)Li(\d+)>")


def ptxas_name(instance):
    """The ptxas report's name (``kernel_name``) of a kernel instantiation
    as ``analysis.budget`` names it (``KernelEstimate.instance``)."""
    kind, args = instance[0], instance[1:]
    if kind in ("encode_fwd", "encode_bwd"):
        dim, f, code, g = args
        return f"{kind}_kernel<Li{dim}ELi{f}E{PTXAS_TYPE[code]}Li{g}>"
    if kind == "field_fwd":
        dim, f, code = args[:3]
        return f"field_fwd_kernel<Li{dim}ELi{f}E{PTXAS_TYPE[code]}>"
    if kind == "mlp_fwd":
        return f"mlp_fwd_kernel<Li{64 if args[1] <= 64 else 128}>"
    return f"composite_fwd_kernel<Lb{args[0]}>"


def analysis_phase(ptxas, dev, gpu):
    """The port's linter in a child (``python -m repro_torch.analysis
    src/repro_torch --json``: 0 errors), then ``analysis.budget``'s numbers
    for every kernel instantiation of the 12 Table-I configs x 4 table
    dtypes (the encode plans at this card's SM count), and every encode
    and encode_bwd instantiation in the library besides, against CUDA's:
    shared memory per block (the plan's against the launcher's dynamic
    bytes plus the kernel's static ones), threads, registers (ptxas' log
    against the loaded kernel's attributes) and blocks per SM
    (``budget.blocks_per_sm`` of ptxas' registers against
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); the encode
    kernels must reach the plans' BLOCKS_PER_SM. Returns the phase line."""
    from repro_torch.analysis import budget
    from repro_torch.kernels import info as kinfo
    from repro_torch.kernels.hashgrid import hashgrid
    from repro_torch.kernels.hashgrid.hashgrid import sm_count
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis",
             os.path.join(SRC, "repro_torch"), "--json"],
            capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S,
            cwd=ROOT, env={**os.environ, "PYTHONPATH": SRC})
    except subprocess.TimeoutExpired:
        fail(f"analysis: the linter ran past {ANALYSIS_TIMEOUT_S} s")
    lint_s = time.perf_counter() - t0
    try:
        rep = json.loads(out.stdout)
    except json.JSONDecodeError:
        rep = None
    if out.returncode != 0 or not rep or rep["summary"]["errors"]:
        fail(f"analysis: the linter exited {out.returncode}: "
             f"{out.stdout[-3000:]} {out.stderr[-3000:]}")
    n_sms = sm_count(dev.index)
    regs = {name: r for name, r, _ in ptxas}
    # instance -> (threads, plan shared memory, the estimates' configs)
    wanted = {}
    for est in budget.table1_estimates(n_sms):
        if est.verdict not in ("fits", "degraded"):
            fail(f"analysis: {est.where} is {est.verdict}")
        wanted.setdefault(est.instance, {
            "kernel": est.kernel, "threads": est.threads,
            "smem": est.smem_bytes, "configs": []})["configs"].append(
                est.where)
    for name in regs:
        m = ENCODE_PTXAS.fullmatch(name)
        if m:
            code = {v: k for k, v in PTXAS_TYPE.items()}[m.group(4)]
            inst = (m.group(1), int(m.group(2)), int(m.group(3)), code,
                    int(m.group(5)))
            wanted.setdefault(inst, {"kernel": m.group(1), "threads":
                                     hashgrid.ENCODE_ROWS, "smem": 0,
                                     "configs": []})
    rows, bad = [], []
    for inst, w in sorted(wanted.items(), key=lambda kv: str(kv[0])):
        name = ptxas_name(inst)
        cuda = kinfo.kernel_info(inst, dev.index)
        r = regs.get(name)
        est_blocks = None if r is None else budget.blocks_per_sm(
            r, w["threads"], w["smem"])
        row = {"instance": list(inst), "kernel": name,
               "configs": len(w["configs"]), "threads": w["threads"],
               "smem_plan": w["smem"],
               "smem_cuda": cuda["dynamic_smem"] + cuda["static_smem"],
               "registers_ptxas": r, "registers_cuda": cuda["registers"],
               "local_bytes": cuda["local_bytes"],
               "blocks_per_sm_est": est_blocks,
               "blocks_per_sm_cuda": cuda["blocks_per_sm"]}
        rows.append(row)
        if (r is None or row["smem_plan"] != row["smem_cuda"]
                or w["threads"] != cuda["threads"]
                or r != cuda["registers"]
                or est_blocks != cuda["blocks_per_sm"]
                or (w["kernel"].startswith("encode")
                    and est_blocks < hashgrid.BLOCKS_PER_SM)):
            bad.append(row)
    if bad:
        fail(f"analysis: the budget and CUDA disagree: {bad}")
    return {"phase": "analysis", "seconds": time.perf_counter() - t0,
            "lint_s": lint_s, "lint_summary": rep["summary"],
            "lint_warnings": [f["path"] for f in rep["findings"]
                              if f["severity"] == "warning"
                              and not f["suppressed"]],
            "sm_count": n_sms, "instantiations": len(rows), "rows": rows,
            **gpu}



def lm_inputs(cfg, batch, prompt, seed):
    """numpy prompt (tokens, or embeddings and (3, B, S) M-RoPE positions
    for the vision stub; whisper's frame embeddings) and decode tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt + LM_GEN))
    out = {"tokens": toks[:, :prompt], "decode": toks[:, prompt:]}
    if cfg.is_encdec or cfg.frontend == "vision":
        out["embeddings"] = rng.standard_normal(
            (batch, prompt, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(prompt), (3, batch, prompt)).copy()
        pos[1] //= 2
        pos[2] %= 4
        out["positions"] = pos
    return out


def lm_batch(cfg, inp, dev):
    import torch
    tok = torch.from_numpy(inp["tokens"]).to(dev)
    if cfg.is_encdec:
        return {"tokens": tok, "enc_embeddings": torch.from_numpy(
            inp["embeddings"]).to(dev)}
    if cfg.frontend == "vision":
        return {"embeddings": torch.from_numpy(inp["embeddings"]).to(dev),
                "positions": torch.from_numpy(inp["positions"]).to(dev)}
    return {"tokens": tok}


def lm_max_err(got, ref):
    """max |got - ref| and whether it is within LM_TOL (atol + rtol)."""
    d = (got.double().cpu() - ref.double().cpu()).abs()
    bound = LM_TOL + LM_TOL * ref.double().cpu().abs()
    return float(d.max()), bool((d <= bound).all())


def lm_launcher(argv):
    """``python -m repro_torch.launch.serve --mode lm`` + argv in a child:
    (exit code, its JSON records, its stderr, wall seconds)."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "lm"] + argv, capture_output=True, text=True,
            timeout=LM_LAUNCH_TIMEOUT_S, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=SRC))
    except subprocess.TimeoutExpired:
        fail(f"lm: the launcher {argv} did not exit within "
             f"{LM_LAUNCH_TIMEOUT_S} s")
    recs = [json.loads(l) for l in out.stdout.splitlines()
            if l.startswith("{")]
    return out.returncode, recs, out.stderr, time.perf_counter() - t0


HEAD_RAYS = 460_800    # a 1280x720 frame's tile in nerf_hash.frames_720p
HEAD_TOL = 1e-6        # one-launch head vs op-by-op head: the same f32 ops


def head_phase(dev, gpu):
    """Nerf's colour head at a 720p tile's rows (``HEAD_RAYS`` rays x
    ``N_SAMPLES``; each ray's direction repeated over its samples, as the
    tile repeats it): ``mlp_ops.nerf_head`` (``mlp_fwd_head``, one launch,
    counted once as ``mlp_fwd``) against ``mlp_ops.plain_head`` (exp, the
    SH, the colour input's cat, ``mlp_fwd``, sigmoid, cat) to HEAD_TOL; the
    device time of each, the head's counted bound, and ``mlp_fwd`` alone on
    the (B, 32) colour input with its own bound. Random f32 inputs: the
    density features N(0, 1), the weights N(0, 1/fan_in)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import fields
    from repro_torch.core.encoding import sh_encode
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.fused_mlp import ops as mlp_ops
    from repro_torch.launch.roofline import H100_SXM, kernel_ops_s
    cfg = fields.make_field_config("nerf", "hash").mlp
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = HEAD_RAYS * N_SAMPLES
    dfeat = torch.randn((n, 16), generator=gen, device=dev)
    d = torch.randn((HEAD_RAYS, 3), generator=gen, device=dev)
    dirs = torch.repeat_interleave(d / d.norm(dim=-1, keepdim=True),
                                   N_SAMPLES, dim=0)
    w = {k: torch.randn(s, generator=gen, device=dev) / float(np.sqrt(s[-2]))
         for k, s in fields._mlp_shapes(cfg).items()}
    before = K.launch_counts()
    got = mlp_ops.nerf_head(dfeat, dirs, w, cfg)
    torch.cuda.synchronize()
    after = K.launch_counts()
    if {k: after[k] - before[k] for k in after if after[k] != before[k]} \
            != {"mlp_fwd": 1, "mlp_fwd_head": 1}:
        fail(f"head: launches {before} -> {after}, want one mlp_fwd_head "
             "counted once as mlp_fwd")
    want = mlp_ops.plain_head(dfeat, dirs, w, cfg)
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > HEAD_TOL:
        fail(f"head: max abs error {err} against the op-by-op head "
             f"(tol {HEAD_TOL})")
    del got, want

    def bound(work):
        t_bytes = work["bytes"] / H100_SXM["hbm_bw"] * 1e3
        t_ops = kernel_ops_s(work) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    wbytes = kcost.tensor_bytes(w.values())
    work = kcost.mlp_fwd_head(n, cfg, wbytes)
    bound_ms, bound_by = bound(work)
    ms = device_ms(lambda: mlp_ops.nerf_head(dfeat, dirs, w, cfg), reps=10)
    plain_ms = device_ms(lambda: mlp_ops.plain_head(dfeat, dirs, w, cfg),
                         reps=3)
    color_in = torch.cat([sh_encode(dirs), dfeat], -1)
    mlp_ms = device_ms(lambda: mlp_ops.mlp(w, color_in, cfg), reps=10)
    mlp_bound_ms = bound(kcost.mlp_fwd(n, cfg, wbytes))[0]
    del color_in, dfeat, dirs
    torch.cuda.empty_cache()
    return {"phase": "head", "rows": n, "max_abs_err": err, "tol": HEAD_TOL,
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_pct": 100 * bound_ms / ms, "plain_ms": plain_ms,
            "mlp_fwd_ms": mlp_ms, "mlp_fwd_bound_ms": mlp_bound_ms,
            "bytes": work["bytes"], "flops": work["flops"],
            "mlp_flops": work["mlp_flops"], **gpu}


# one Mamba-2 layer of granite_4_0_h_small.train_8k_seq: 2 rows of 8,192
# tokens in chunks of 256, 128 heads of 64, one group of d_state 128
SSD_SHAPE = {"b": 2, "s": 8192, "q": 256, "h": 128, "p": 64, "g": 1,
             "n": 128}
# the kernels against the plain term: y within one bf16 step (2^-7 of the
# value) beside the f32 sums' order; each gradient within 1e-2 of its
# largest value of autograd's (autograd rounds dM to bf16, the kernel keeps
# it in f32)
SSD_GRAD_TOL = 1e-2
# ssd_intra_bwd against its f32 twin (ref.ssd_intra_bwd_ref): dcums and ddt
# within 1e-4 of their largest value (the f32 sums' order), dCB and dx
# within one bf16 step beside that
SSD_TWIN_TOL = 1e-4


def ssd_phase(dev, gpu):
    """Mamba-2's intra-chunk SSD at one granite layer's shape
    (``SSD_SHAPE``): ``ssd_ops.ssd_intra`` (one ``ssd_intra_fwd`` launch;
    its backward one ``ssd_intra_bwd``, the counts set to 0 first) against
    the plain term (``ref.ssd_intra_ref`` and autograd through it), the
    backward also against its f32 twin (``ref.ssd_intra_bwd_ref``); the
    device time of each kernel beside its counted bound, on one chunk and
    head (``floor_ms``) and the plain route's time (its forward; its
    backward under autograd), and each kernel's resources
    (``kinfo.kernel_info``: registers, shared memory, blocks per SM).
    Inputs as ``ssd_chunked`` makes them: C.B of N(0, 1/4) bf16 C and B,
    dt = softplus(N(-1, 1)), A = -exp(U(0, log 16)), x N(0, 1) bf16. The
    ``kernels`` rows of ``ssd_intra_fwd`` and ``ssd_intra_bwd`` take
    ``results``' keys from here."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import info as kinfo
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_intra_bwd_ref, ssd_intra_ref
    from repro_torch.kernels.ssd.ssd import ssd_intra_bwd_cuda
    sh = SSD_SHAPE
    b, q, h, p, g = sh["b"], sh["q"], sh["h"], sh["p"], sh["g"]
    nc = sh["s"] // q
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)
    C, B = (randn(b, nc, q, g, sh["n"], scale=0.5) for _ in range(2))
    CB = torch.einsum("bcigm,bcjgm->bcijg", C, B)
    dt = torch.nn.functional.softplus(randn(b, nc, q, h, dtype=torch.float32)
                                      - 1.0)
    A = -torch.exp(torch.rand(h, generator=gen, device=dev)
                   * float(np.log(16.0)))
    cums = torch.cumsum(dt * A, dim=2)
    x = randn(b, nc, q, h, p)
    dy = randn(b, nc, q, h, p)
    leaves = [t.requires_grad_() for t in (CB, cums, dt, x)]
    ins = [t.detach() for t in leaves]
    names = ("CB", "cums", "dt", "x")

    K.reset_launch_counts()
    y = ssd_ops.ssd_intra(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    launched = {k: n for k, n in K.launch_counts().items() if n}
    if launched != {"ssd_intra_fwd": 1, "ssd_intra_bwd": 1}:
        fail(f"ssd: launches {launched}, want one ssd_intra_fwd and one "
             "ssd_intra_bwd")
    finite = bool(torch.isfinite(y).all()) and all(
        bool(torch.isfinite(a).all()) for a in got)
    # the f32 twin first, then autograd through the plain term, one at a
    # time: each holds several (b, nc, q, q, h) f32 tensors of 2.15 GB
    twin_err, twin_excess = {}, {}
    for name, a, t in zip(names, got, ssd_intra_bwd_ref(dy, *ins)):
        a, t = a.float(), t.float()
        d = (a - t).abs()
        scale = float(t.abs().max())
        step = 2.0 ** -7 * t.abs() if name in ("CB", "x") else 0.0
        twin_err[name] = float(d.max())
        twin_excess[name] = float((d - step).max()) / scale
        del a, t, d
    torch.cuda.empty_cache()
    y_ref = ssd_intra_ref(*leaves)
    want = torch.autograd.grad(y_ref, leaves, dy)
    y_ref = y_ref.detach().float()
    d = (y.detach().float() - y_ref).abs()
    y_excess = float((d - 2.0 ** -7 * y_ref.abs()).max())
    y_err = float(d.max())
    grad_err = {name: float((a.float() - w.float()).abs().max()
                            / w.float().abs().max())
                for name, a, w in zip(names, got, want)}
    if not finite or y_excess > 1e-4 * float(y_ref.abs().max()) or \
            max(grad_err.values()) > SSD_GRAD_TOL or \
            max(twin_excess.values()) > SSD_TWIN_TOL:
        fail(f"ssd: y max abs error {y_err} ({y_excess} past one bf16 "
             f"step), gradients' errors over their max {grad_err} (tol "
             f"{SSD_GRAD_TOL}), past the twin over its max {twin_excess} "
             f"(tol {SSD_TWIN_TOL}), finite {finite}")
    del y, got, want, y_ref, d
    torch.cuda.empty_cache()

    fwd_w = kcost.ssd_intra_fwd(b * nc, q, h, p, g)
    bwd_w = kcost.ssd_intra_bwd(b * nc, q, h, p, g)
    fwd_bound, fwd_by = ssd_bound(fwd_w)
    bwd_bound, bwd_by = ssd_bound(bwd_w)
    fwd_ms = device_ms(lambda: ssd_ops.ssd_intra(*ins), reps=10)
    bwd_ms = device_ms(lambda: ssd_intra_bwd_cuda(dy, *ins), reps=10)
    # one chunk of one head: the launch's fixed cost
    one = [ins[0][:1, :1].contiguous()] + [
        t[:1, :1, :, :1].contiguous() for t in ins[1:]]
    dy_one = dy[:1, :1, :, :1].contiguous()
    fwd_floor = device_ms(lambda: ssd_ops.ssd_intra(*one), reps=20)
    bwd_floor = device_ms(lambda: ssd_intra_bwd_cuda(dy_one, *one), reps=20)
    with torch.no_grad():
        plain_fwd_ms = device_ms(lambda: ssd_intra_ref(*ins), reps=2,
                                 rounds=3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ssd_intra_bwd_cuda(dy, *ins)
    kernel_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    y_plain = ssd_intra_ref(*leaves)
    torch.autograd.grad(y_plain, leaves, dy, retain_graph=True)
    plain_peak = torch.cuda.max_memory_allocated() - base
    plain_bwd_ms = device_ms(lambda: torch.autograd.grad(
        y_plain, leaves, dy, retain_graph=True), reps=1, rounds=3)
    res = {name: kinfo.kernel_info((name, q, p))
           for name in ("ssd_intra_fwd", "ssd_intra_bwd")}
    del y_plain, leaves, ins, one, dy, dy_one, C, B, CB, dt, cums, x
    torch.cuda.empty_cache()
    inter = ssd_inter_part(dev)
    res.update(inter.pop("resources"))
    return {"phase": "ssd", **sh, **inter, "y_max_abs_err": y_err,
            "y_past_one_bf16_step": y_excess, "grad_err": grad_err,
            "twin_max_abs_err": twin_err, "twin_excess": twin_excess,
            "fwd_ms": fwd_ms, "fwd_floor_ms": fwd_floor,
            "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
            "fwd_roofline_pct": 100 * fwd_bound / fwd_ms,
            "bwd_ms": bwd_ms, "bwd_floor_ms": bwd_floor,
            "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
            "bwd_roofline_pct": 100 * bwd_bound / bwd_ms,
            "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
            "bwd_peak_bytes": kernel_peak,
            "plain_fwd_bwd_peak_bytes": plain_peak,
            "fwd_work": fwd_w, "bwd_work": bwd_w, "resources": res, **gpu}


def ssd_bound(w):
    """(the least ms of the counted work ``w`` on an H100, what bounds it):
    bytes at the HBM rate, or the bf16 products and f32 operations at
    their peaks."""
    from repro_torch.launch.roofline import H100_SXM
    t_bytes = w["bytes"] / H100_SXM["hbm_bw"] * 1e3
    t_ops = max(w["bf16_flops"] / H100_SXM["peak_flops_bf16"],
                w["flops"] / H100_SXM["peak_flops_f32"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ssd_inter_part(dev):
    """The inter-chunk half of ``ssd_phase`` at ``SSD_SHAPE``: x, B and C
    as views of one (b, s, h p + 2 g n) bf16 tensor, as the in-projection's
    split gives them (x N(0, 1), B and C N(0, 1/4)), dt and cums as the
    intra half draws them, dy N(0, 1), no gradient of the final state (the
    training path's). ``ssd_ops.ssd_inter`` (one ``ssd_inter_fwd`` call;
    its backward one ``ssd_inter_bwd``) against the plain term
    (``ref.ssd_inter_ref``, autograd through it) and the backward's twin
    (``ref.ssd_inter_bwd_ref``): each result's largest error over one bf16
    step at its largest value (``*_steps``, at most 1), the states before
    each chunk bit for bit the plain loop's on the kernels' chunk states;
    each entry point's device time, bound, floor (one chunk of one head)
    and the plain route's time, the peaks of the kernels' backward and of
    the plain forward and backward, and each kernel's resources."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import info as kinfo
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ssd as ssd_launch
    from repro_torch.kernels.ssd.ref import ssd_inter_bwd_ref, ssd_inter_ref
    sh = SSD_SHAPE
    b, q, h, p, g, n = (sh[k] for k in ("b", "q", "h", "p", "g", "n"))
    s = sh["s"]
    nc = s // q
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)
    conv = torch.cat([randn(b, s, h * p), randn(b, s, 2 * g * n, scale=0.5)],
                     dim=-1).requires_grad_()
    dt = torch.nn.functional.softplus(
        randn(b, nc, q, h, dtype=torch.float32) - 1.0).requires_grad_()
    A = -torch.exp(torch.rand(h, generator=gen, device=dev)
                   * float(np.log(16.0)))
    cums = torch.cumsum(dt.detach() * A, dim=2).requires_grad_()
    dy = randn(b, nc, q, h, p)

    def views(c):
        x, B, C = torch.split(c, [h * p, g * n, g * n], dim=-1)
        return (x.reshape(b, nc, q, h, p), B.reshape(b, nc, q, g, n),
                C.reshape(b, nc, q, g, n))
    leaves = [cums, dt, conv]
    args = [cums, dt, *views(conv)]
    ins = [t.detach() for t in (cums, dt)] + list(views(conv.detach()))
    names = ("cums", "dt", "x", "B", "C")

    def parts(grads):
        return list(grads[:2]) + [t.reshape(u.shape) for t, u in zip(
            torch.split(grads[2], [h * p, g * n, g * n], dim=-1), ins[2:])]

    def steps(got, want):
        # the largest error over one bf16 step at want's largest magnitude
        want = want.detach().float()
        top = float(want.abs().max())
        return float((got.detach().float() - want).abs().max()) / (
            2.0 ** (np.floor(np.log2(top)) - 7))

    K.reset_launch_counts()
    y, state = ssd_ops.ssd_inter(*args)
    got = parts(torch.autograd.grad(y, leaves, dy))
    torch.cuda.synchronize()
    launched = {k: c for k, c in K.launch_counts().items() if c}
    if launched != {"ssd_inter_fwd": 1, "ssd_inter_bwd": 1}:
        fail(f"ssd: launches {launched}, want one ssd_inter_fwd and one "
             "ssd_inter_bwd")
    finite = bool(torch.isfinite(y).all()) and all(
        bool(torch.isfinite(a).all()) for a in got)
    twin_steps = {name: steps(a, t) for name, a, t in zip(
        names, got, ssd_inter_bwd_ref(dy, None, *ins))}
    torch.cuda.empty_cache()
    y_ref, state_ref = ssd_inter_ref(*args)
    want = parts(torch.autograd.grad(y_ref, leaves, dy))
    y_steps = {"y": steps(y, y_ref), "state": steps(state, state_ref)}
    grad_steps = {name: steps(a, w) for name, a, w in zip(names, got, want)}
    y_err = float((y.detach().float() - y_ref.detach().float()).abs().max())
    twin_err = max(twin_steps.values())
    _, final, prev, states = ssd_launch.ssd_inter_fwd_cuda(*ins)
    decay = torch.exp(ins[0][:, :, -1]).to(torch.bfloat16)
    carried = torch.zeros_like(final)
    bitwise = True
    for c in range(nc):
        bitwise = bitwise and torch.equal(prev[:, c], carried)
        carried = carried * decay[:, c, :, None, None] + states[:, c]
    bitwise = bitwise and torch.equal(final, carried)
    if not finite or not bitwise or max(y_steps.values()) > 1 or \
            max(grad_steps.values()) > 1 or twin_err > 1:
        fail(f"ssd: inter-chunk errors in bf16 steps at the largest value: "
             f"{y_steps}, gradients {grad_steps}, against the twin "
             f"{twin_steps}; prev bit for bit {bitwise}, finite {finite}")
    del y, got, want, y_ref, state_ref, states, final
    torch.cuda.empty_cache()

    fwd_w = kcost.ssd_inter_fwd(b, nc, q, h, p, g, n)
    bwd_w = kcost.ssd_inter_bwd(b, nc, q, h, p, g, n)
    fwd_bound, fwd_by = ssd_bound(fwd_w)
    bwd_bound, bwd_by = ssd_bound(bwd_w)
    fwd_ms = device_ms(lambda: ssd_launch.ssd_inter_fwd_cuda(*ins), reps=10)
    bwd_ms = device_ms(lambda: ssd_launch.ssd_inter_bwd_cuda(
        dy, None, *ins, prev), reps=10)
    one = [t[:1, :1, :, :1].contiguous() for t in ins[:3]] + [
        t[:1, :1].contiguous() for t in ins[3:]]
    _, _, prev_one, _ = ssd_launch.ssd_inter_fwd_cuda(*one)
    dy_one = dy[:1, :1, :, :1].contiguous()
    fwd_floor = device_ms(lambda: ssd_launch.ssd_inter_fwd_cuda(*one),
                          reps=20)
    bwd_floor = device_ms(lambda: ssd_launch.ssd_inter_bwd_cuda(
        dy_one, None, *one, prev_one), reps=20)
    with torch.no_grad():
        plain_fwd_ms = device_ms(lambda: ssd_inter_ref(*ins), reps=2,
                                 rounds=3)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ssd_launch.ssd_inter_bwd_cuda(dy, None, *ins, prev)
    kernel_peak = torch.cuda.max_memory_allocated() - base
    del prev
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y_plain, _ = ssd_inter_ref(*args)
    torch.autograd.grad(y_plain, leaves, dy, retain_graph=True)
    plain_peak = torch.cuda.max_memory_allocated() - base
    plain_bwd_ms = device_ms(lambda: torch.autograd.grad(
        y_plain, leaves, dy, retain_graph=True), reps=1, rounds=3)
    res = {f"ssd_inter_{d}[{i}]": kinfo.kernel_info((f"ssd_inter_{d}", q, p,
                                                      n, i))
           for d, stages in (("fwd", 3), ("bwd", 5)) for i in range(stages)}
    del y_plain, leaves, args, ins, one, dy, dy_one, conv, dt, cums
    torch.cuda.empty_cache()
    return {"inter_y_max_abs_err": y_err, "inter_steps": y_steps,
            "inter_grad_steps": grad_steps, "inter_twin_steps": twin_steps,
            "inter_prev_bitwise": bitwise,
            "inter_fwd_ms": fwd_ms, "inter_fwd_floor_ms": fwd_floor,
            "inter_fwd_bound_ms": fwd_bound, "inter_fwd_bound_by": fwd_by,
            "inter_fwd_roofline_pct": 100 * fwd_bound / fwd_ms,
            "inter_bwd_ms": bwd_ms, "inter_bwd_floor_ms": bwd_floor,
            "inter_bwd_bound_ms": bwd_bound, "inter_bwd_bound_by": bwd_by,
            "inter_bwd_roofline_pct": 100 * bwd_bound / bwd_ms,
            "plain_inter_fwd_ms": plain_fwd_ms,
            "plain_inter_bwd_ms": plain_bwd_ms,
            "inter_bwd_peak_bytes": kernel_peak,
            "plain_inter_fwd_bwd_peak_bytes": plain_peak,
            "inter_fwd_work": fwd_w, "inter_bwd_work": bwd_w,
            "resources": res}


def ssd_results(line):
    """The ``kernels`` rows' numbers of the four SSD entry points from
    ``ssd_phase``'s line, keyed as ``results``: the intra forward's error
    is y's against the plain term, its backward's the largest of its
    gradients' against the f32 twin; the inter forward's y_inter's against
    the plain term, its backward's the largest over its twin's of one bf16
    step at each gradient's largest value."""
    return {(name, None): {
        "max_abs_err": err, "ms": line[f"{k}_ms"],
        "floor_ms": line[f"{k}_floor_ms"],
        "plain_ms": line[f"plain_{k}_ms"],
        "bound_ms": line[f"{k}_bound_ms"], "bound_by": line[f"{k}_bound_by"],
        "library_ms": None}
        for name, k, err in (
            ("ssd_intra_fwd", "fwd", line["y_max_abs_err"]),
            ("ssd_intra_bwd", "bwd", max(line["twin_max_abs_err"].values())),
            ("ssd_inter_fwd", "inter_fwd", line["inter_y_max_abs_err"]),
            ("ssd_inter_bwd", "inter_bwd",
             max(line["inter_twin_steps"].values())))}


# Mamba-2's SSD kernels (kernels/ssd): the LM paths take them for bf16
# chunks on the card; no other kernel of the port runs on them
SSD_KERNELS = ("ssd_intra_fwd", "ssd_intra_bwd", "ssd_inter_fwd",
               "ssd_inter_bwd")


def non_ssd(launches):
    """The launches of kernels other than Mamba-2's SSD kernels."""
    return {k: n for k, n in launches.items() if n and k not in SSD_KERNELS}


def ssd_launches_per_step(cfg, seq, dev, inter=False):
    """``ssd_intra_bwd`` (``inter``: ``ssd_inter_bwd``) launches of one
    train step of ``cfg`` on rows of ``seq`` tokens on ``dev``: one a
    Mamba-2 layer where the kernels fit its SSD (``ssd.takes``, or
    ``ssd.inter_takes``, at the chunk ``apply_ssm`` runs), else 0."""
    from repro_torch.kernels.ssd.ssd import inter_takes, takes
    from repro_torch.models import ssm
    if cfg.ssm is None:
        return 0
    q = ssm.ssd_chunk(cfg, seq)
    if not (inter_takes(dev, cfg.adtype, q, cfg.ssm.head_dim,
                        cfg.ssm.d_state) if inter
            else takes(dev, cfg.adtype, q, cfg.ssm.head_dim)):
        return 0
    return sum(cfg.layer_kind(l) == "ssm" for l in range(cfg.n_layers))


def lm_phase(dev, gpu):
    """The LM stack's serving path on the card (no kernel of the port
    but Mamba-2's SSD pair runs on it): parity of the ten reduced archs against the CPU, five
    archs at full width and depth (decode against forward in f32, then
    ``serve_lm`` timed in bf16), and the launcher's ``--mode lm`` in
    children."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.common.param import tree_map
    from repro_torch.configs import registry
    from repro_torch.launch import serve as lserve
    from repro_torch.models import encdec as tencdec, layers as tlayers
    from repro_torch.models import lm as tlm
    from repro_torch.parallel import api
    # by path: the card's site-packages may hold a package named tests
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    K.reset_launch_counts()

    def mods(cfg):
        return tencdec if cfg.is_encdec else tlm

    def forward(cfg, params, b):
        if cfg.is_encdec:
            enc = tencdec.encode(params, cfg, b["enc_embeddings"])
            return tencdec.decode_train(params, cfg, b["tokens"], enc)
        return tlm.forward(params, cfg, b)[0]

    def serve(cfg, params, b, dec_tokens, prompt, greedy, d=dev):
        """prefill, then LM_DECODE (teacher-forced) or LM_GEN (greedy)
        steps through the ``parallel/api`` steps: (prefill logits, each
        step's logits, tokens fed)."""
        batch = b["embeddings" if "embeddings" in b else "tokens"].shape[0]
        enc = prompt if cfg.is_encdec else 0
        shape = dict(capacity=prompt + LM_GEN, batch_size=batch,
                     enc_len=enc)
        prefill = api.make_prefill_step(cfg, **shape)[0]
        decode = api.make_decode_step(cfg, **shape)[0]
        cache = api.make_cache(cfg, batch, prompt + LM_GEN, enc_len=enc,
                               device=d)
        pl, cache = prefill(params, b, cache)
        steps, fed = [], []
        tok = torch.argmax(pl, -1)[:, None] if greedy else dec_tokens[:, :1]
        for i in range(LM_GEN if greedy else LM_DECODE):
            fed.append(tok)
            lg, cache = decode(params, cache, tok, prompt + i)
            steps.append(lg)
            tok = torch.argmax(lg, -1)[:, None] if greedy \
                else dec_tokens[:, i + 1:i + 2]
        del cache
        return pl, steps, torch.cat(fed, 1)

    # -- 1. the ten archs at reduced_config: the card against the CPU
    parity = {}
    with f32_unembed():
        for arch in registry.list_archs():
            cfg = dataclasses.replace(registry.reduced_config(arch),
                                      act_dtype="float32")
            inp = lm_inputs(cfg, LM_REDUCED_BATCH, LM_REDUCED_PROMPT, SEED)
            p_cpu = api.init_params(cfg, SEED, device="cpu")
            p_gpu = tree_map(lambda a: a.to(dev), p_cpu)
            row = {}
            outs = {}
            for name, d, p in (("cpu", torch.device("cpu"), p_cpu),
                               ("gpu", dev, p_gpu)):
                b = lm_batch(cfg, inp, d)
                dec = torch.from_numpy(inp["decode"]).to(d)
                lb = dict(b)
                if cfg.frontend == "vision":
                    lb["labels"] = torch.from_numpy(inp["tokens"]).to(d)
                loss = mods(cfg).loss_fn(p, cfg, lb)[0]
                pl, steps, _ = serve(cfg, p, b, dec, LM_REDUCED_PROMPT,
                                     greedy=False, d=d)
                outs[name] = {"forward": forward(cfg, p, b),
                              "loss": loss.reshape(1), "prefill": pl,
                              "decode": torch.stack(steps)}
            ok = True
            for k in outs["cpu"]:
                err, good = lm_max_err(outs["gpu"][k], outs["cpu"][k])
                row[f"{k}_max_abs_err"] = err
                ok = ok and good
            if not ok:
                fail(f"lm[{arch}]: the card against the CPU beyond "
                     f"{LM_TOL}: {row}")
            parity[arch] = row
            del p_cpu, p_gpu, outs
    # the shipped unembed (bf16 operands, f32 sums: one bf16 GEMM with an
    # f32 output on the card) on the same inputs on both devices
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((64, 3584), generator=gen)
    table = torch.randn((4096, 3584), generator=gen) * 0.02
    u_cpu = tlayers.unembed({"table": table}, x)
    u_gpu = tlayers.unembed({"table": table.to(dev)}, x.to(dev))
    unembed_err = float((u_gpu.cpu() - u_cpu).abs().max())
    if not unembed_err <= 1e-5 * float(u_cpu.abs().max()):
        fail(f"lm: the bf16 unembed on the card against the CPU: "
             f"{unembed_err}")

    # -- 2. full width and depth in f32: decode against the forward
    full = {}
    for arch, ((b32, s32), (b16, s16)) in LM_FULL.items():
        cfg0 = registry.get_config(arch)
        cfg = dataclasses.replace(cfg0, act_dtype="float32")
        if cfg.moe is not None:     # no drops: every expert takes a group
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts
                / cfg.moe.top_k))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = api.init_params(cfg, SEED, device=dev)
        torch.cuda.synchronize()
        row = {"param_count": cfg.param_count(),
               "param_bytes_f32": api.param_bytes(cfg),
               "init_s": time.perf_counter() - t0}
        with f32_unembed():
            inp = lm_inputs(cfg, b32, s32, SEED)
            b = lm_batch(cfg, inp, dev)
            pl, steps, fed = serve(cfg, params, b, None, s32, greedy=True)
            fb = dict(b)
            fb["tokens"] = torch.cat([b["tokens"], fed], 1)
            ref = forward(cfg, params, fb)[:, s32 + LM_GEN - 1]
        d = (steps[-1].double() - ref.double()).abs()
        bound = LM_FULL_TOL + LM_FULL_TOL * ref.double().abs()
        row.update(f32_batch=b32, f32_prompt=s32,
                   f32_decode_vs_forward_max_abs_err=float(d.max()),
                   f32_peak_bytes=torch.cuda.max_memory_allocated(dev))
        if not bool((d <= bound).all()):
            fail(f"lm[{arch}]: f32 decode step {LM_GEN} against the "
                 f"forward: max error {float(d.max())} beyond {LM_FULL_TOL}")
        del params, pl, steps, ref, d, fb, b

        # -- 3. the served path, serve_lm, in the config's own act dtype
        # (params drawn in it: the same seed's values, cast): a first
        # call of one decode step warms the libraries, the second is timed
        runs = []
        for gen_len in (1, LM_GEN):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            logged = io.StringIO()
            with contextlib.redirect_stdout(logged):
                times = lserve.serve_lm(arch, reduced=False, batch=b16,
                                        prompt_len=s16, gen_len=gen_len,
                                        seed=SEED, device=dev)
            runs.append((times, logged.getvalue()))
        (prefill_s, decode_s), logged = runs[-1]
        recs = {r["event"]: r for r in map(json.loads, logged.splitlines())}
        if set(recs) != {"lm_served", "lm_sample"}:
            fail(f"lm[{arch}]: serve_lm logged {sorted(recs)}")
        row.update(bf16_batch=b16, bf16_prompt=s16,
                   bf16_param_bytes=api.param_bytes(cfg0, cfg0.adtype),
                   bf16_prefill_ms=prefill_s * 1e3,
                   bf16_decode_ms_per_token=decode_s * 1e3 / LM_GEN,
                   bf16_tokens_per_s=b16 * LM_GEN / decode_s,
                   bf16_peak_bytes=torch.cuda.max_memory_allocated(dev),
                   bf16_first_tokens=recs["lm_sample"]["tokens"])
        full[arch] = row
        torch.cuda.empty_cache()

    launches = K.launch_counts()
    if non_ssd(launches):
        fail(f"lm: the LM path launched a kernel of the port: {launches}")

    # -- 4. the launcher's --mode lm in children, on the card
    launcher = {}
    for name, argv in (("reduced", ["--arch", LM_LAUNCH_ARCH]),
                       ("full", ["--arch", LM_LAUNCH_FULL_ARCH, "--full"])):
        rc, recs, err, wall = lm_launcher(argv)
        served = [r for r in recs if r.get("event") == "lm_served"]
        if rc != 0 or len(served) != 1:
            fail(f"lm: the launcher {argv}: exit {rc}, records {recs}, "
                 f"{err[-3000:]}")
        launcher[name] = {"wall_s": wall, "arch": served[0]["arch"],
                          **{k: served[0][k] for k in (
                              "prefill_ms", "decode_ms", "tok_per_s")}}
    argv = ["--arch", LM_LAUNCH_REFUSED_ARCH, "--full"]
    rc, recs, err, wall = lm_launcher(argv)
    refusal = f"MemoryError: {LM_LAUNCH_REFUSED_ARCH}: its params take"
    if rc == 0 or refusal not in err or recs:
        fail(f"lm: the launcher {argv} was not refused: exit {rc}, "
             f"records {recs}, {err[-3000:]}")
    launcher["refused"] = {"wall_s": wall, "arch": LM_LAUNCH_REFUSED_ARCH,
                           "error": err.strip().splitlines()[-1]}
    return {"phase": "lm", "seconds": time.perf_counter() - t_phase,
            "launches": launches,
            "note": "the LM path runs plain PyTorch but for Mamba-2's "
                    "SSD kernels; no other kernel of the port launches on "
                    "it",
            "parity": parity, "unembed_bf16_max_abs_err": unembed_err,
            "full": full, "launcher": launcher, **gpu}


# the LM launcher's child (``python -m repro_torch.launch.train``, or a
# script): runs it as ``python -m`` does, writing each step's loss to a
# JSON-lines file as it comes (a killed child leaves the steps it
# reached), then its kernels' launch counts
LM_TRAIN_CHILD = """
import json, runpy, sys
sys.path.insert(0, {src!r})
from repro_torch import kernels
from repro_torch.train import loop
out = open({out!r}, "w", buffering=1)
run = loop.TrainEngine.run
def logged(self, state, on_metrics=None):
    def each(step, row, st):
        out.write(json.dumps({{"step": step, "loss": row["loss"]}}) + "\\n")
        if on_metrics is not None:
            on_metrics(step, row, st)
    return run(self, state, on_metrics=each)
loop.TrainEngine.run = logged
sys.argv = [{target!r}] + {argv!r}
try:
    if {target!r}.endswith(".py"):
        runpy.run_path({target!r}, run_name="__main__")
    else:
        runpy.run_module({target!r}, run_name="__main__", alter_sys=True)
finally:
    out.write(json.dumps({{"launches": kernels.launch_counts()}}) + "\\n")
"""


def lm_train_child(target, argv, out, env=None):
    """A ``LM_TRAIN_CHILD`` process (stdout and stderr to files beside
    ``out``)."""
    with open(out + ".stdout", "w") as so, open(out + ".stderr", "w") as se:
        return subprocess.Popen(
            [sys.executable, "-c", LM_TRAIN_CHILD.format(
                src=SRC, target=target, argv=argv, out=out)],
            cwd=ROOT, stdout=so, stderr=se,
            env=dict(os.environ, PYTHONPATH=SRC, **(env or {})))


def lm_train_child_result(child, out, what):
    """(per-step losses {step: loss}, launch counts, stdout) of a finished
    child; fails on a non-zero exit or a missing launch record."""
    try:
        rc = child.wait(timeout=LM_LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        fail(f"lm_train: {what} did not exit within {LM_LAUNCH_TIMEOUT_S} s")
    with open(out + ".stderr") as f:
        err = f.read()
    if rc != 0:
        fail(f"lm_train: {what} exited {rc}: {err[-3000:]}")
    recs = [json.loads(l) for l in open(out)]
    launches = [r["launches"] for r in recs if "launches" in r]
    if len(launches) != 1:
        fail(f"lm_train: {what} wrote no launch counts")
    with open(out + ".stdout") as f:
        stdout = f.read()
    return ({r["step"]: r["loss"] for r in recs if "step" in r},
            launches[0], stdout)


def lm_token_batch(cfg, src, step, dev):
    """Full-width step ``step``'s batch: the stream's S + 1 tokens a row as
    S tokens and their S next-token labels (whisper: S decoder tokens,
    shifted in its loss, and S frame embeddings), on ``dev``."""
    import numpy as np
    import torch
    toks = torch.from_numpy(src.batch(step)["tokens"])
    if cfg.is_encdec:
        rng = np.random.default_rng((SEED, step))
        emb = rng.standard_normal((toks.shape[0], toks.shape[1] - 1,
                                   cfg.d_model)).astype(np.float32)
        return {"tokens": toks[:, :-1].to(dev),
                "enc_embeddings": torch.from_numpy(emb).to(dev)}
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}


def lm_train_phase(dev, gpu):
    """LM training on the card (no kernel of the port but Mamba-2's SSD
    pair runs on it): the ten
    reduced archs' gradients and steps against the CPU, three archs
    trained at full width and depth in bf16 with an f32 master, a
    directional-derivative check at full width, a full-width refusal, and
    the launcher and the ``train_lm`` twin in children (a killed child
    resumed)."""
    import math
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.common.param import tree_leaves, tree_map
    from repro_torch.configs import registry
    from repro_torch.data import tokens as tdata
    from repro_torch.launch.roofline import H100_SXM
    from repro_torch.models import encdec as tencdec, lm as tlm
    from repro_torch.parallel import api
    from repro_torch.train import loop, optim
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    K.reset_launch_counts()

    def mods(cfg):
        return tencdec if cfg.is_encdec else tlm

    # -- 1. the ten archs at reduced_config in f32: the card against the CPU
    parity = {}
    with f32_unembed():
        for arch in registry.list_archs():
            cfg = registry.reduced_config(arch)
            ch = {"act_dtype": "float32", "attn_q_chunk": LM_TRAIN_Q_CHUNK}
            if cfg.swa_window is not None:
                ch["swa_window"] = LM_TRAIN_WINDOW
            cfg = dataclasses.replace(cfg, **ch)
            inp = lm_inputs(cfg, LM_REDUCED_BATCH, LM_REDUCED_PROMPT, SEED)
            src = tdata.SyntheticTokens(tdata.DataConfig(
                cfg.vocab_size, LM_REDUCED_PROMPT + 1, LM_REDUCED_BATCH,
                seed=SEED))
            p_cpu = api.init_params(cfg, SEED, device="cpu")
            outs = {}
            for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
                p = tree_map(lambda a: a.to(d, copy=True), p_cpu)
                b = lm_batch(cfg, inp, d)
                if cfg.frontend == "vision":
                    b["labels"] = torch.from_numpy(inp["tokens"]).to(d)
                (loss, _), grads = loop.value_and_grad(
                    lambda q, bb: mods(cfg).loss_fn(q, cfg, bb), p, b,
                    has_aux=True)
                step, _ = api.build_train_step(cfg)
                state = api.make_train_state(p)
                curve = []
                for i in range(LM_TRAIN_PARITY_STEPS):
                    state, m = step(state, lm_token_batch(cfg, src, i, d))
                    curve.append(torch.stack([m["loss"], m["grad_norm"]]))
                outs[name] = {"loss": loss.reshape(1),
                              "grads": tree_leaves(grads),
                              "steps": torch.stack(curve)}
            row, ok = {}, True
            for k in ("loss", "steps"):
                err, good = lm_max_err(outs["gpu"][k], outs["cpu"][k])
                row[f"{k}_max_abs_err"] = err
                ok = ok and good
            errs = [lm_max_err(g, c) for g, c in zip(outs["gpu"]["grads"],
                                                     outs["cpu"]["grads"])]
            row["grad_leaves"] = len(errs)
            row["grad_max_abs_err"] = max(e for e, _ in errs)
            ok = ok and all(g for _, g in errs)
            if not ok:
                fail(f"lm_train[{arch}]: the card against the CPU beyond "
                     f"{LM_TOL}: {row}")
            parity[arch] = row
            del p_cpu, outs, state

    # -- 2. full width and depth: bf16 compute, f32 master, TrainConfig's
    # Adam; a warm-up step, then LM_TRAIN_STEPS - 1 timed
    full = {}
    tc = api.TrainConfig()
    for arch, (batch, seq) in LM_TRAIN_FULL.items():
        cfg = registry.get_config(arch)
        ssd_before = {k: K.launch_counts()[k] for k in SSD_KERNELS}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = api.init_params(cfg, SEED, device=dev, train_cfg=tc)
        n_params = sum(a.numel() for a in tree_leaves(params))
        state = api.make_train_state(params)
        step, _ = api.build_train_step(cfg, train_cfg=tc)
        src = tdata.SyntheticTokens(tdata.DataConfig(
            cfg.vocab_size, seq + 1, batch, seed=SEED))
        batches = [lm_token_batch(cfg, src, i, dev)
                   for i in range(LM_TRAIN_STEPS)]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses = []
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            if i == 1:      # after the warm-up step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (LM_TRAIN_STEPS - 1)
        losses = torch.stack(losses).tolist()
        tokens = batch * seq
        bound_s = 8 * n_params * tokens / H100_SXM["peak_flops_bf16"]
        row = {"batch": batch, "tokens_per_row": seq, "params": n_params,
               "train_state_bytes": api.train_state_bytes(cfg, tc),
               "init_s": init_s, "step_ms": step_s * 1e3,
               "tokens_per_s": tokens / step_s,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "ln_vocab": math.log(cfg.vocab_size),
               "first_loss": losses[0], "losses": losses,
               "bound_ms": bound_s * 1e3, "step_over_bound": step_s / bound_s}
        # one more step under a CUDA-only trace: where its time goes
        prof_batch = lm_token_batch(cfg, src, LM_TRAIN_STEPS, dev)
        held = [state]

        def one_step():
            held[0], _ = step(held[0], prof_batch)
            torch.cuda.synchronize()
        row["profile"] = trace_device(one_step, [ProfilerActivity.CUDA], 1,
                                      "step", top=8)
        state = held[0]
        ssd = {k: K.launch_counts()[k] - ssd_before[k] for k in SSD_KERNELS}
        row["ssd_launches"] = ssd
        # bf16 Mamba-2 layers the kernels fit must take them: one
        # ssd_intra_bwd and ssd_inter_bwd a layer and step, one or two
        # ssd_intra_fwd and ssd_inter_fwd (the forward, and the recompute
        # under remat)
        for term in ("intra", "inter"):
            want = ssd_launches_per_step(cfg, seq, dev, term == "inter") * (
                LM_TRAIN_STEPS + 1)
            if ssd[f"ssd_{term}_bwd"] != want or ssd[f"ssd_{term}_fwd"] \
                    not in (want, 2 * want):
                fail(f"lm_train[{arch}]: SSD launches {ssd} over "
                     f"{LM_TRAIN_STEPS + 1} steps, want {want} "
                     f"ssd_{term}_bwd and as many or twice as many "
                     f"ssd_{term}_fwd")
        full[arch] = row
        if not all(math.isfinite(l) for l in losses):
            fail(f"lm_train[{arch}]: a loss is not finite: {losses}")
        if not sum(losses[-4:]) < sum(losses[:4]):
            fail(f"lm_train[{arch}]: the loss did not fall over "
                 f"{LM_TRAIN_STEPS} steps: {losses}")
        del params, state, held, batches, prof_batch, m
        torch.cuda.empty_cache()

    # -- 3. the gradient at full width (f32, a small batch): autograd's
    # directional derivative along g / |g| (= |g|) against a central
    # difference of the loss
    arch, batch, seq = LM_GRAD_CHECK
    cfg = dataclasses.replace(registry.get_config(arch), act_dtype="float32")
    params = api.init_params(cfg, SEED, device=dev)
    src = tdata.SyntheticTokens(tdata.DataConfig(cfg.vocab_size, seq + 1,
                                                 batch, seed=SEED))
    b = lm_token_batch(cfg, src, 0, dev)
    with f32_unembed():
        loss, grads = loop.value_and_grad(
            lambda p, bb: tlm.loss_fn(p, cfg, bb)[0], params, b)
        gnorm = float(optim.global_norm(grads))
        eps = LM_GRAD_CHECK_DELTA / gnorm

        def moved(alpha):
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.add_(g, alpha=alpha / gnorm)
            with torch.no_grad():
                return float(tlm.loss_fn(params, cfg, b)[0])
        l_plus = moved(eps)
        l_minus = moved(-2 * eps)
    fd = (l_plus - l_minus) / (2 * eps)
    grad_check = {"arch": arch, "batch": batch, "tokens_per_row": seq,
                  "loss": float(loss), "grad_norm": gnorm, "eps": eps,
                  "central_difference": fd,
                  "rel_err": abs(fd - gnorm) / gnorm}
    if not grad_check["rel_err"] <= LM_GRAD_CHECK_TOL:
        fail(f"lm_train: the full-width gradient check: {grad_check}")
    del params, grads, b
    torch.cuda.empty_cache()

    # -- 4. a full-width train state that does not fit: refused before
    # anything is drawn
    before = torch.cuda.memory_allocated(dev)
    cfg = registry.get_config(LM_TRAIN_REFUSED_ARCH)
    try:
        api.init_params(cfg, SEED, device=dev, train_cfg=tc)
        fail(f"lm_train: {LM_TRAIN_REFUSED_ARCH}'s train state was not "
             "refused")
    except MemoryError as e:
        refusal = {"arch": LM_TRAIN_REFUSED_ARCH, "error": str(e),
                   "train_state_bytes": api.train_state_bytes(cfg, tc)}
    if torch.cuda.memory_allocated(dev) != before:
        fail("lm_train: the refused init drew memory")

    launches = K.launch_counts()
    if non_ssd(launches):
        fail(f"lm_train: the LM train path launched a kernel of the port: "
             f"{launches}")

    # -- 5. the launcher and the twin in children: an uninterrupted run and
    # the example (side by side), then a child killed after its first
    # checkpoint and re-run
    work = os.path.join(ROOT, "build", "chip_smoke_lm_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "tmp"))
    t0 = time.perf_counter()
    steps = ["--steps", str(LM_TRAIN_LAUNCH_STEPS)]
    runs = {
        "full": lm_train_child(
            "repro_torch.launch.train", LM_TRAIN_LAUNCH_ARGV + steps
            + ["--ckpt-dir", os.path.join(work, "full")],
            os.path.join(work, "full.jsonl")),
        "example": lm_train_child(
            os.path.join(ROOT, "examples", "torch", "train_lm.py"), [],
            os.path.join(work, "example.jsonl"),
            env={"TMPDIR": os.path.join(work, "tmp")})}
    kdir = os.path.join(work, "kill")
    killed = lm_train_child(
        "repro_torch.launch.train", LM_TRAIN_LAUNCH_ARGV
        + ["--steps", "100000", "--ckpt-dir", kdir],
        os.path.join(work, "kill.jsonl"))
    while store.latest_step(kdir) is None:
        if killed.poll() is not None:
            fail(f"lm_train: the killed child exited {killed.returncode} "
                 "before its first checkpoint")
        if time.perf_counter() - t0 > LM_LAUNCH_TIMEOUT_S:
            killed.kill()
            fail("lm_train: the killed child saved no checkpoint")
        time.sleep(0.02)
    killed.send_signal(signal.SIGKILL)
    killed.wait()
    killed_at = store.latest_step(kdir)
    if killed_at >= LM_TRAIN_LAUNCH_STEPS - 1:
        fail(f"lm_train: the child was killed only after step {killed_at}")
    runs["resumed"] = lm_train_child(
        "repro_torch.launch.train", LM_TRAIN_LAUNCH_ARGV + steps
        + ["--ckpt-dir", kdir], os.path.join(work, "resumed.jsonl"))
    res = {name: lm_train_child_result(c, os.path.join(work, name
                                                       + ".jsonl"), name)
           for name, c in runs.items()}
    children_s = time.perf_counter() - t0
    full_l, resumed_l = res["full"][0], res["resumed"][0]
    if sorted(full_l) != list(range(LM_TRAIN_LAUNCH_STEPS)):
        fail(f"lm_train: the launcher ran steps {sorted(full_l)}")
    fl = [full_l[i] for i in range(LM_TRAIN_LAUNCH_STEPS)]
    if not sum(fl[-4:]) < sum(fl[:4]):
        fail(f"lm_train: the launcher's loss did not fall: {fl}")
    if sorted(resumed_l) != list(range(killed_at + 1,
                                       LM_TRAIN_LAUNCH_STEPS)):
        fail(f"lm_train: resumed after step {killed_at}, it ran steps "
             f"{sorted(resumed_l)}")
    resume_err = max(abs(resumed_l[i] - full_l[i]) for i in resumed_l)
    if not resume_err <= LM_RESUME_TOL:
        fail(f"lm_train: resumed losses {resumed_l} against {full_l}: "
             f"{resume_err}")
    ex_lines = [l for l in res["example"][2].splitlines()
                if not l.startswith("{")]
    ex = re.match(r"loss: (\S+) -> (\S+) ", ex_lines[-1]) if ex_lines \
        else None
    if ex is None or not float(ex.group(2)) < float(ex.group(1)):
        fail(f"lm_train: the train_lm twin printed {ex_lines}")
    child_launches = {n: r[1] for n, r in res.items()}
    if any(non_ssd(c) for c in child_launches.values()):
        fail(f"lm_train: a child launched a kernel of the port: "
             f"{child_launches}")
    shutil.rmtree(work, ignore_errors=True)
    launcher = {"children_s": children_s, "steps": LM_TRAIN_LAUNCH_STEPS,
                "loss_first": fl[0], "loss_last": fl[-1],
                "killed_after_step": killed_at,
                "resumed_max_abs_err": resume_err,
                "example": ex_lines}
    return {"phase": "lm_train", "seconds": time.perf_counter() - t_phase,
            "launches": launches,
            "note": "the LM train path runs plain PyTorch but for "
                    "Mamba-2's SSD kernels; no other kernel of the port "
                    "launches on it",
            "parity": parity, "full": full, "grad_check": grad_check,
            "refused": refusal, "launcher": launcher, **gpu}



# the lm_shard phase: the LM sharding on meshes of the one card repeated,
# (2, 2) and (4, 1) ("data", "model"). (a) reduced archs in f32: the
# sharded steps against the unsharded ones on the card within
# LM_SHARD_TOL; (b) h2o-danube-1.8b at full width in bf16 on an f32
# master, LM_SHARD_FULL_STEPS steps of (batch, tokens a row), each loss
# within LM_SHARD_FULL_TOL of the unsharded step's; (c) memory plans from
# meta inits on 80 GB devices, each expected to fit (the serving plans
# since the tensor-parallel steps gather one block at a time: before, the
# whole gathered copy refused jamba and qwen2-vl); (d) a reduced danube
# state saved on (4, 1) and recovered onto the (2, 1) plan of two
# survivors
LM_SHARD_MESHES = ((2, 2), (4, 1))
LM_SHARD_ARCHS = {"h2o-danube-1.8b": "baseline", "olmoe-1b-7b": "baseline",
                  "mamba2-2.7b": "baseline", "jamba-v0.1-52b": "baseline",
                  "whisper-base": "tinydp"}
LM_SHARD_STEPS = 3
LM_SHARD_BATCH, LM_SHARD_SEQ, LM_SHARD_DECODE = 4, 16, 4
LM_SHARD_TOL = 1e-5
LM_SHARD_FULL = ("h2o-danube-1.8b", 2, 3072)
LM_SHARD_FULL_STEPS = 4
LM_SHARD_FULL_TOL = 2e-2
LM_SHARD_PLANS = (("olmoe-1b-7b", "train", (4, 1)),
                  ("olmoe-1b-7b", "train", (2, 2)),
                  ("jamba-v0.1-52b", "serve", (2, 2)),
                  ("jamba-v0.1-52b", "serve", (4, 1)),
                  ("qwen2-vl-72b", "serve", (2, 2)),
                  ("qwen2-vl-72b", "serve", (4, 1)))


def lm_shard_phase(dev, gpu):
    """The LM sharding on the one card repeated as (2, 2) and (4, 1)
    meshes (plain PyTorch: no kernel of the port but Mamba-2's SSD pair
    may launch on it)."""
    import math
    from types import SimpleNamespace
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.data import tokens as tdata
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.roofline import H100_SXM
    from repro_torch.models import encdec as tencdec, lm as tlm
    from repro_torch.parallel import api, sharded as sh
    from repro_torch.runtime import elastic
    from repro_torch.train import optim
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    K.reset_launch_counts()

    def card_mesh2(shape):
        return Mesh(np.array([dev] * (shape[0] * shape[1]), dtype=object)
                    .reshape(shape), ("data", "model"))

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    def shapes_ok(tree):
        return all(tuple(s.shape) == l.sharding.shard_shape(l.shape)
                   for l in optim.tree_leaves(tree) for s in l.shards)

    # -- (a) the reduced archs in f32: sharded against unsharded
    reduced = {}
    with f32_unembed():
        for arch, preset in LM_SHARD_ARCHS.items():
            cfg = dataclasses.replace(registry.reduced_config(arch),
                                      act_dtype="float32")
            mod = tencdec if cfg.is_encdec else tlm
            src = tdata.SyntheticTokens(tdata.DataConfig(
                cfg.vocab_size, LM_SHARD_SEQ + 1, LM_SHARD_BATCH, seed=SEED))
            batches = [lm_token_batch(cfg, src, i, dev)
                       for i in range(LM_SHARD_STEPS)]
            inp = lm_inputs(cfg, LM_SHARD_BATCH, LM_SHARD_SEQ, SEED)
            enc = LM_SHARD_SEQ if cfg.is_encdec else 0
            cap = LM_SHARD_SEQ + LM_SHARD_DECODE
            one_p = api.init_params(cfg, SEED, device=dev)
            # every gradient leaf, not only the loss and the norm
            _, one_g = api.make_value_and_grad(cfg)(one_p, batches[0])
            one_state = api.make_train_state(
                optim.tree_map(torch.clone, one_p))
            one_step, _ = api.make_train_step(cfg)
            one_losses = []
            for b in batches:
                one_state, m = one_step(one_state, b)
                one_losses.append(m["loss"])
            pre1, _ = api.make_prefill_step(cfg, capacity=cap,
                                            batch_size=LM_SHARD_BATCH,
                                            enc_len=enc)
            dec1, _ = api.make_decode_step(cfg, capacity=cap,
                                           batch_size=LM_SHARD_BATCH,
                                           enc_len=enc)
            c1 = api.make_cache(cfg, LM_SHARD_BATCH, cap, enc, device=dev)
            l1, c1 = pre1(one_p, lm_batch(cfg, inp, dev), c1)
            one_logits = [l1]
            for i in range(LM_SHARD_DECODE):
                t = torch.from_numpy(inp["decode"][:, i:i + 1]).to(dev)
                l1, c1 = dec1(one_p, c1, t, LM_SHARD_SEQ + i)
                one_logits.append(l1)
            rows = {}
            for shape in LM_SHARD_MESHES:
                mesh, rules = card_mesh2(shape), rule_preset(preset)
                sp = api.init_params(cfg, SEED, mesh, rules)
                init_equal = all(torch.equal(sh.gather(a, dev), b) for a, b
                                 in zip(optim.tree_leaves(sp),
                                        optim.tree_leaves(one_p)))
                _, g = api.make_value_and_grad(cfg, mesh, rules)(
                    sp, batches[0])
                grad_err = max(max_err(sh.gather(a, dev), b) for a, b in
                               zip(optim.tree_leaves(g),
                                   optim.tree_leaves(one_g)))
                del g
                state = api.make_train_state(sp)
                step, _ = api.make_train_step(cfg, mesh, rules)
                losses = []
                for b in batches:
                    state, m = step(state, b)
                    losses.append(m["loss"])
                loss_err = max(abs(float(a) - float(b))
                               for a, b in zip(losses, one_losses))
                param_err = max(max_err(sh.gather(a, dev), b) for a, b in
                                zip(optim.tree_leaves(state["params"]),
                                    optim.tree_leaves(one_state["params"])))
                pre, info = api.make_prefill_step(
                    cfg, mesh, rules, capacity=cap,
                    batch_size=LM_SHARD_BATCH, enc_len=enc)
                dec, _ = api.make_decode_step(
                    cfg, mesh, rules, capacity=cap,
                    batch_size=LM_SHARD_BATCH, enc_len=enc)
                cache = api.make_cache(cfg, LM_SHARD_BATCH, cap, enc,
                                       shardings=info["cache"])
                sp = api.init_params(cfg, SEED, mesh, rules)
                lg, cache = pre(sp, lm_batch(cfg, inp, dev), cache)
                logit_err = max_err(lg, one_logits[0])
                for i in range(LM_SHARD_DECODE):
                    t = torch.from_numpy(inp["decode"][:, i:i + 1]).to(dev)
                    lg, cache = dec(sp, cache, t, LM_SHARD_SEQ + i)
                    logit_err = max(logit_err, max_err(lg,
                                                       one_logits[i + 1]))
                row = {"rows": len(cache.rows),
                       "loss_max_abs_err": loss_err,
                       "param_max_abs_err": param_err,
                       "grad_max_abs_err": grad_err,
                       "logit_max_abs_err": logit_err,
                       "init_equal": init_equal,
                       "shard_shapes_ok": shapes_ok(state["params"])
                       and shapes_ok(state["opt"].mu),
                       "position_bytes": sh.shard_bytes(state["params"])}
                rows["x".join(map(str, shape))] = row
                if not (init_equal and row["shard_shapes_ok"]
                        and loss_err <= LM_SHARD_TOL
                        and param_err <= LM_SHARD_TOL
                        and grad_err <= LM_SHARD_TOL
                        and logit_err <= LM_SHARD_TOL):
                    fail(f"lm_shard[{arch} {shape}]: sharded against "
                         f"unsharded beyond {LM_SHARD_TOL}: {row}")
                del sp, state, cache
            reduced[arch] = rows
            del one_p, one_g, one_state, c1
    torch.cuda.empty_cache()

    # -- (b) full width: danube in bf16 on an f32 master, the (2, 2) mesh
    # against one device, the same batches
    arch, batch, seq = LM_SHARD_FULL
    cfg = registry.get_config(arch)
    tc = api.TrainConfig()
    src = tdata.SyntheticTokens(tdata.DataConfig(cfg.vocab_size, seq + 1,
                                                 batch, seed=SEED))
    full = {}
    mesh, rules = card_mesh2((2, 2)), rule_preset("baseline")
    for name, m_ in (("unsharded", None), ("2x2", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if m_ is None:
            params = api.init_params(cfg, SEED, device=dev, train_cfg=tc)
        else:
            params = api.init_params(cfg, SEED, m_, rules, train_cfg=tc)
        state = api.make_train_state(params)
        step, _ = api.make_train_step(cfg, m_, rules if m_ else None,
                                      train_cfg=tc)
        batches = [lm_token_batch(cfg, src, i, dev)
                   for i in range(LM_SHARD_FULL_STEPS)]
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            if i == 1:                      # after the warm-up step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / (LM_SHARD_FULL_STEPS - 1)
        row = {"step_ms": step_s * 1e3,
               "tokens_per_s": batch * seq / step_s,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "losses": torch.stack(losses).tolist()}
        if m_ is not None:
            n_rows = len(api.batch_row_devices(m_, rules, batch))
            coll = api.step_collective_bytes(cfg, m_, rules, batch,
                                             seq=seq)
            row.update({
                "rows": n_rows,
                # counted on meta tensors (one rank, given to every rank
                # of every row's group), not measured in the run: the
                # groups' collectives and the block gathers with their
                # backward's reduce-scatters, summed over the positions
                **{f"{k}_bytes_a_step_counted": sum(c[k] for c in coll)
                   for k in ("all-gather", "all-reduce", "reduce-scatter")},
                "position_bytes": sh.shard_bytes(state),
                "note": "the four positions share one card: its peak holds "
                        "them all, not a per-device saving"})
        full[name] = row
        del params, state, batches, m
    torch.cuda.empty_cache()
    fl, sl = full["unsharded"]["losses"], full["2x2"]["losses"]
    full_err = max(abs(a - b) for a, b in zip(fl, sl))
    full["loss_max_abs_err"] = full_err
    if not all(math.isfinite(l) for l in fl + sl) or full_err > \
            LM_SHARD_FULL_TOL or not (fl[-1] < fl[0] and sl[-1] < sl[0]):
        fail(f"lm_shard[{arch} full]: losses {sl} against {fl}: "
             f"{full_err} (tol {LM_SHARD_FULL_TOL}; each must fall)")

    # -- (c) memory plans from meta inits, on 80 GB devices
    plans = []
    for arch_, kind, shape in LM_SHARD_PLANS:      # each must fit
        cfg_ = registry.get_config(arch_)
        stand = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
        dt = None if kind == "train" else cfg_.adtype
        stored = api.shard_param_bytes(cfg_, stand, compute_dtype=dt)
        need = (api.train_state_bytes(cfg_, tc, mesh=stand) if kind ==
                "train" else api.param_bytes(cfg_, dt, mesh=stand))
        try:
            api.check_fits(cfg_, compute_dtype=dt,
                           train_cfg=tc if kind == "train" else None,
                           mesh=stand, device_bytes=H100_SXM["hbm_bytes"])
            verdict = "fits"
        except MemoryError as e:
            verdict = f"refused: {e}"
        plans.append({"arch": arch_, "what": kind, "mesh": list(shape),
                      "max_stored_bytes": max(stored),
                      "max_position_bytes": max(need),
                      "verdict_80GB": verdict})
        if verdict != "fits":
            fail(f"lm_shard: the {kind} plan of {arch_} on {shape} does "
                 f"not fit 80 GB: {verdict}")

    # -- (d) elastic: a reduced danube state saved on (4, 1), recovered
    # onto the (2, 1) plan of two survivors, one more step
    work = os.path.join(ROOT, "build", "chip_smoke_lm_shard")
    shutil.rmtree(work, ignore_errors=True)
    cfg = dataclasses.replace(registry.reduced_config("h2o-danube-1.8b"),
                              act_dtype="float32")
    mesh41, rules = card_mesh2((4, 1)), rule_preset("baseline")
    state = api.make_train_state(api.init_params(cfg, SEED, mesh41, rules))
    step, _ = api.make_train_step(cfg, mesh41, rules)
    src = tdata.SyntheticTokens(tdata.DataConfig(
        cfg.vocab_size, LM_SHARD_SEQ + 1, LM_SHARD_BATCH, seed=SEED))
    state, _ = step(state, lm_token_batch(cfg, src, 0, dev))
    store.save(state, 1, work)
    plan = elastic.remesh_plan(2, 4, 1)
    mesh21, step_fn, got, at = elastic.recover(
        work, cfg, plan, devices=[dev] * 2,
        make_step=lambda c, m_, r: api.make_train_step(
            c, m_, r, train_cfg=api.TrainConfig(
                num_microbatches=plan.microbatch_multiplier))[0])
    bit_equal = all(
        torch.equal(sh.gather(a, dev), sh.gather(b, dev)) for a, b in zip(
            optim.tree_leaves({"p": got["params"], "m": got["opt"].mu,
                               "v": got["opt"].nu}),
            optim.tree_leaves({"p": state["params"], "m": state["opt"].mu,
                               "v": state["opt"].nu})))
    got, m = step_fn(got, lm_token_batch(cfg, src, 1, dev))
    recovered = {"saved_on": [4, 1], "plan": [plan.data, plan.model],
                 "microbatch_multiplier": plan.microbatch_multiplier,
                 "resumed_step": at, "bit_equal": bit_equal,
                 "next_loss": float(m["loss"]),
                 "mesh": mesh21.shape}
    shutil.rmtree(work, ignore_errors=True)
    if not (bit_equal and at == 1 and got["opt"].step == 2
            and math.isfinite(recovered["next_loss"])):
        fail(f"lm_shard: elastic recovery: {recovered}")

    launches = K.launch_counts()
    if non_ssd(launches):
        fail(f"lm_shard: the LM sharding launched a kernel of the port: "
             f"{launches}")
    return {"phase": "lm_shard", "seconds": time.perf_counter() - t_phase,
            "launches": launches, "tol": LM_SHARD_TOL,
            "full_tol": LM_SHARD_FULL_TOL,
            "note": "one card repeated as each mesh: the positions share "
                    "its memory and run one after another",
            "reduced": reduced,
            "full": {"arch": arch, "batch": batch, "tokens_per_row": seq,
                     "steps": LM_SHARD_FULL_STEPS, **full},
            "plans": plans, "elastic": recovered, **gpu}


# the lm_tp phase: the tensor-parallel serving steps (parallel/tp.py) on
# the one card repeated. (a) every reduced arch in f32 on LM_TP_MESHES
# (baseline: sequence-parallel prefill; whisper baseline), logits and
# caches within LM_TP_TOL of unsharded; (b) qwen3-32b at full width in
# bf16 on (1, 4): one device first (its greedy tokens and each step's
# logits kept), then the mesh fed the same tokens: each step's logits
# within LM_TP_FULL_RTOL of the step's largest, and the same greedy token
# at every step but a near-tie (the one device's top two closer than
# twice the step's logit difference); peak memory within LM_TP_PEAK_TOL
# of the plan (api.serving_bytes over the four positions). Two bf16 runs
# that differ only in the order of f32 sums drift apart with depth, 2.4%
# of the largest logit at 64 layers (tools/tp_bf16_drift.py), so the
# tokens of two free-running greedy runs part at the first near-tie
#
# Then the train step on the groups (ROADMAP A14.5c), after (c0) ROADMAP C4:
# qwen2-7b at full width in f32 served on (1, 4) against one device
# (prefill LM_TP_F32's batch x prompt, its decode steps fed the one
# device's greedy tokens): each step's logits within LM_TP_F32_RTOL of its
# largest. (c) every reduced arch in f32 on LM_TP_MESHES: the loss and
# every gradient leaf within LM_TP_TOL of one device. (d) h2o-danube-1.8b
# at full width, LM_TP_TRAIN's batch x tokens: the f32 loss and every
# gradient leaf on (1, 4) within LM_TP_F32_RTOL of the leaf's largest
# against one device; then LM_TP_TRAIN_STEPS bf16 steps of
# build_train_step on one device, (1, 4) and (2, 2), each on the same
# batch: finite, falling, the
# meshes' peak memory within LM_TP_PEAK_TOL of the plan summed over the
# card's positions (api.train_state_bytes, as check_fits adds them)
#
# (e) the serving cache in cache_specs' layout (ROADMAP A14.5d): yi-6b at
# full width in f32 on (1, 8), its 4 KV heads not splitting 8 ways, so
# each rank holds its chunk of the positions for every KV head (before:
# the whole row's cache on every rank); LM_TP_SEQ_CACHE's prompt, then
# its decode steps fed the one device's greedy tokens: each step's
# logits within LM_TP_F32_RTOL of its largest; the peak while decoding
# (the shards and the cache, what the plan counts) within LM_TP_PEAK_TOL
# of api.serving_bytes summed over the card's positions. The prefill's
# peak is printed beside it: its f32 activations (each rank's gathered
# stream and f32 row-parallel terms, the ranks in turn) are not in the
# plan. The cache length (prompt + steps) must divide 8 to split
LM_TP_MESHES = ((1, 4), (2, 2))
LM_TP_BATCH, LM_TP_SEQ, LM_TP_DECODE = 4, 16, 4
LM_TP_TOL = 1e-5
LM_TP_FULL = ("qwen3-32b", 4, 512, 8)      # arch, batch, prompt, greedy
LM_TP_FULL_RTOL = 5e-2
LM_TP_PEAK_TOL = 0.10
LM_TP_F32 = ("qwen2-7b", 4, 512, 8)        # arch, batch, prompt, decode
LM_TP_F32_RTOL = 1e-4
LM_TP_TRAIN = ("h2o-danube-1.8b", 1, 2048)   # arch, batch, tokens a row
# arch, batch, prompt, decode steps, mesh
LM_TP_SEQ_CACHE = ("yi-6b", 1, 8192, 8, (1, 8))
LM_TP_TRAIN_STEPS = 3


def lm_tp_phase(dev, gpu):
    """Tensor, expert and sequence-parallel serving on the one card
    repeated as (1, 4) and (2, 2) meshes (plain PyTorch: no kernel of the
    port may launch on it)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import api
    from repro_torch.train import optim
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    K.reset_launch_counts()

    def card_mesh(shape):
        return Mesh(np.array([dev] * (shape[0] * shape[1]), dtype=object)
                    .reshape(shape), ("data", "model"))

    def serve(cfg, params, inp, n_gen, mesh=None, rules=None, greedy=False,
              feed=None):
        """(prefill logits, each step's logits, tokens fed, prefill ms,
        decode ms a token, cache): fed ``inp["decode"]``, the greedy
        tokens, or ``feed`` (B, n_gen)."""
        b, s = inp["tokens"].shape
        enc = s if cfg.is_encdec else 0
        cap = s + n_gen
        pre, info = api.make_prefill_step(cfg, mesh, rules, capacity=cap,
                                          batch_size=b, enc_len=enc)
        dec, _ = api.make_decode_step(cfg, mesh, rules, capacity=cap,
                                      batch_size=b, enc_len=enc)
        cache = (api.make_cache(cfg, b, cap, enc, device=dev) if mesh is None
                 else api.make_cache(cfg, b, cap, enc, rules=rules,
                                     shardings=info["cache"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache = pre(params, lm_batch(cfg, inp, dev), cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps, toks = [], []
        tok = torch.argmax(first, -1)[:, None]
        t0 = time.perf_counter()
        for i in range(n_gen):
            if feed is not None:
                tok = feed[:, i:i + 1].to(dev)
            elif not greedy:
                tok = torch.from_numpy(inp["decode"][:, i:i + 1]).to(dev)
            toks.append(tok)
            lg, cache = dec(params, cache, tok, s + i)
            steps.append(lg)
            tok = torch.argmax(lg, -1)[:, None]
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / n_gen
        return first, steps, torch.cat(toks, 1), t_pre * 1e3, t_dec * 1e3, \
            cache

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    # -- (a) the ten reduced archs in f32: tensor-parallel against one device
    reduced = {}
    with f32_unembed():
        for arch in registry.list_archs():
            cfg = dataclasses.replace(registry.reduced_config(arch),
                                      act_dtype="float32")
            inp = lm_inputs(cfg, LM_TP_BATCH, LM_TP_SEQ, SEED)
            one_p = api.init_params(cfg, SEED, device=dev)
            first, steps, _, _, _, one_c = serve(cfg, one_p, inp,
                                                 LM_TP_DECODE)
            want = [first] + steps
            one_c = optim.tree_leaves(one_c)
            rows = {}
            for shape in LM_TP_MESHES:
                mesh, rules = card_mesh(shape), rule_preset("baseline")
                sp = api.init_params(cfg, SEED, mesh, rules)
                first, steps, _, _, _, cache = serve(cfg, sp, inp,
                                                     LM_TP_DECODE, mesh,
                                                     rules)
                logit_err = max(max_err(a, b)
                                for a, b in zip([first] + steps, want))
                joined = optim.tree_leaves(cache.gather(dev))
                cache_err = max(float(((a.double() - b.double()).abs() / (
                    1 + b.double().abs())).max()) for a, b in zip(joined,
                                                                  one_c))
                row = {"groups": [len(g.positions) for g in cache.groups],
                       "kv_seq": cache.kv_seq, "logit_max_abs_err": logit_err,
                       "cache_max_rel_err": cache_err}
                rows["x".join(map(str, shape))] = row
                if logit_err > LM_TP_TOL or cache_err > LM_TP_TOL:
                    fail(f"lm_tp[{arch} {shape}]: tensor-parallel against "
                         f"one device beyond {LM_TP_TOL}: {row}")
                del sp, cache
            reduced[arch] = rows
            del one_p, one_c
    torch.cuda.empty_cache()

    # -- (b) qwen3-32b at full width in bf16: one device (greedy), then
    # (1, 4) fed the one device's tokens
    arch, batch, prompt, n_gen = LM_TP_FULL
    cfg = registry.get_config(arch)
    inp = lm_inputs(cfg, batch, prompt, SEED)
    full = {}
    mesh, rules = card_mesh((1, 4)), rule_preset("baseline")
    feed = None
    for name, m_ in (("one_device", None), ("1x4", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = (api.init_params(cfg, SEED, device=dev,
                                  compute_dtype=cfg.adtype) if m_ is None
                  else api.init_params(cfg, SEED, m_, rules,
                                       compute_dtype=cfg.adtype))
        first, steps, toks, t_pre, t_dec, cache = serve(
            cfg, params, inp, n_gen, m_, rules if m_ else None,
            greedy=True, feed=feed)
        torch.cuda.synchronize()
        feed = toks
        row = {"prefill_ms": t_pre, "decode_ms_per_token": t_dec,
               "peak_bytes": torch.cuda.max_memory_allocated(dev),
               "tokens": toks.cpu(),
               "logits": [l.float().cpu() for l in [first] + steps]}
        row["finite"] = all(bool(torch.isfinite(l).all())
                            for l in row["logits"])
        if m_ is not None:
            plan = api.serving_bytes(cfg, m_, rules, cfg.adtype,
                                     (batch, prompt + n_gen, 0))
            row["plan_bytes"] = sum(sum(t) for t in plan.values())
            row["plan_by_term"] = {k: sum(v) for k, v in plan.items()}
            row["groups"] = [len(g.positions) for g in cache.groups]
        full[name] = row
        del params, cache, first, steps
    torch.cuda.empty_cache()
    one, tp_ = full["one_device"], full["1x4"]
    # step i's logits (the prefill's first) pick token i of the one
    # device's greedy run (the last step's pick is not fed)
    picks = torch.cat([one["tokens"],
                       one["logits"][-1].argmax(-1)[:, None]], 1)
    rel, agree, ties, missed = [], 0, 0, []
    for i, (a, b) in enumerate(zip(tp_["logits"], one["logits"])):
        err = (a - b).abs().max(-1).values                  # per row
        rel.append(float(err.max()) / float(b.abs().max()))
        top2 = torch.topk(b, 2, -1).values
        near = (top2[:, 0] - top2[:, 1]) <= 2 * err
        same = a.argmax(-1) == picks[:, i]
        agree += int(same.sum())
        ties += int(near.sum())
        missed += [(i, r) for r in range(batch) if not same[r]
                   and not near[r]]
    peak_err = abs(tp_["peak_bytes"] - tp_["plan_bytes"]) / tp_["plan_bytes"]
    result = {"arch": arch, "batch": batch, "prompt": prompt,
              "greedy_tokens": n_gen, "fed": "the one device's tokens",
              "picks_equal": agree, "picks": batch * (n_gen + 1),
              "near_ties": ties, "picks_missed_beyond_near_ties": missed,
              "max_logits_rel_err": max(rel), "prefill_logits_rel_err":
              rel[0], "last_logits_rel_err": rel[-1],
              "peak_rel_err_vs_plan": peak_err,
              "rtol": LM_TP_FULL_RTOL, "peak_tol": LM_TP_PEAK_TOL}
    for name, row in full.items():
        result[name] = {k: v for k, v in row.items()
                        if k not in ("tokens", "logits")}
    if missed or max(rel) > LM_TP_FULL_RTOL or peak_err > LM_TP_PEAK_TOL \
            or not (one["finite"] and tp_["finite"]):
        fail(f"lm_tp[{arch} full]: {result}")

    c4 = lm_tp_f32_serving(dev, card_mesh, serve)
    seq_cache = lm_tp_seq_cache(dev, card_mesh)
    train = lm_tp_train(dev, card_mesh)

    launches = K.launch_counts()
    if non_ssd(launches):
        fail(f"lm_tp: the tensor-parallel steps launched a kernel of the "
             f"port: {launches}")
    return {"phase": "lm_tp", "seconds": time.perf_counter() - t_phase,
            "launches": launches, "tol": LM_TP_TOL,
            "note": "one card repeated as each mesh: the positions share "
                    "its memory and run one after another",
            "reduced": reduced, "full": result, "f32_serving": c4,
            "seq_cache": seq_cache, **train, **gpu}


def lm_tp_f32_serving(dev, card_mesh, serve):
    """(c0) ROADMAP C4: full-width tensor parallelism in f32, qwen2-7b
    served on (1, 4) against one device, fed the one device's greedy
    tokens: each step's logits within LM_TP_F32_RTOL of its largest."""
    import torch
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.parallel import api
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    arch, batch, prompt, n_gen = LM_TP_F32
    cfg = dataclasses.replace(registry.get_config(arch), act_dtype="float32")
    inp = lm_inputs(cfg, batch, prompt, SEED)
    mesh, rules = card_mesh((1, 4)), rule_preset("baseline")
    runs, feed = {}, None
    with f32_unembed():
        for name, m_ in (("one_device", None), ("1x4", mesh)):
            torch.cuda.empty_cache()
            params = (api.init_params(cfg, SEED, device=dev) if m_ is None
                      else api.init_params(cfg, SEED, m_, rules))
            first, steps, toks, t_pre, t_dec, cache = serve(
                cfg, params, inp, n_gen, m_, rules if m_ else None,
                greedy=True, feed=feed)
            feed = toks
            runs[name] = {"logits": [first] + steps, "prefill_ms": t_pre,
                          "decode_ms_per_token": t_dec}
            del params, cache
    torch.cuda.empty_cache()
    rel = [float((a - b).abs().max()) / float(b.abs().max())
           for a, b in zip(runs["1x4"]["logits"],
                           runs["one_device"]["logits"])]
    out = {"arch": arch, "batch": batch, "prompt": prompt,
           "decode_steps": n_gen, "fed": "the one device's tokens",
           "max_logits_rel_err": max(rel), "rtol": LM_TP_F32_RTOL,
           **{name: {k: v for k, v in r.items() if k != "logits"}
              for name, r in runs.items()}}
    if not max(rel) <= LM_TP_F32_RTOL:
        fail(f"lm_tp[{arch} f32 full]: (1, 4) against one device: {out}")
    return out


def lm_tp_seq_cache(dev, card_mesh):
    """(e) yi-6b in f32 on (1, 8), its cache split along the sequence,
    against one device (the comment above LM_TP_MESHES)."""
    import torch
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.parallel import api
    from repro_torch.train.optim import tree_leaves
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed

    arch, batch, prompt, n_dec, shape = LM_TP_SEQ_CACHE
    cfg = dataclasses.replace(registry.get_config(arch), act_dtype="float32")
    inp = lm_inputs(cfg, batch, prompt, SEED)
    mesh, rules = card_mesh(shape), rule_preset("baseline")
    mesh_name = "x".join(map(str, shape))
    cap = prompt + n_dec
    runs, feed = {}, None
    with f32_unembed():
        for name, m_ in (("one_device", None), (mesh_name, mesh)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            r_ = rules if m_ is not None else None
            params = (api.init_params(cfg, SEED, device=dev) if m_ is None
                      else api.init_params(cfg, SEED, m_, rules))
            pre, info = api.make_prefill_step(cfg, m_, r_, capacity=cap,
                                              batch_size=batch)
            dec, _ = api.make_decode_step(cfg, m_, r_, capacity=cap,
                                          batch_size=batch)
            cache = (api.make_cache(cfg, batch, cap, device=dev)
                     if m_ is None else
                     api.make_cache(cfg, batch, cap, rules=rules,
                                    shardings=info["cache"]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first, cache = pre(params, lm_batch(cfg, inp, dev), cache)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            prefill_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            logits, toks = [first.float().cpu()], []
            tok = torch.argmax(first, -1)[:, None]
            t0 = time.perf_counter()
            for i in range(n_dec):
                if feed is not None:
                    tok = feed[:, i:i + 1].to(dev)
                toks.append(tok)
                lg, cache = dec(params, cache, tok, prompt + i)
                logits.append(lg.float().cpu())
                tok = torch.argmax(lg, -1)[:, None]
            torch.cuda.synchronize()
            row = {"prefill_ms": t_pre * 1e3,
                   "decode_ms_per_token":
                       (time.perf_counter() - t0) / n_dec * 1e3,
                   "prefill_peak_bytes": prefill_peak,
                   "decode_peak_bytes": torch.cuda.max_memory_allocated(dev),
                   "logits": logits}
            if m_ is None:
                row["cache_bytes"] = sum(t.numel() * t.element_size()
                                         for t in tree_leaves(cache))
            else:
                plan = api.serving_bytes(cfg, m_, rules, cfg.adtype,
                                         (batch, cap, 0))
                row.update({
                    "plan_bytes": sum(sum(t) for t in plan.values()),
                    "plan_by_term": {k: sum(v) for k, v in plan.items()},
                    "cache_bytes": sum(t.numel() * t.element_size()
                                       for rank in cache.rows[0]
                                       for t in tree_leaves(rank)),
                    "layout": {k: str(v) for k, v in
                               cache.layout["sub0"].items()}})
            runs[name] = row
            feed = torch.cat(toks, 1)
            del params, cache, first, lg
    torch.cuda.empty_cache()
    one, tp_ = runs["one_device"], runs[mesh_name]
    rel = [float((a - b).abs().max()) / float(b.abs().max())
           for a, b in zip(tp_["logits"], one["logits"])]
    peak_err = abs(tp_["decode_peak_bytes"] - tp_["plan_bytes"]) \
        / tp_["plan_bytes"]
    out = {"arch": arch, "batch": batch, "prompt": prompt,
           "decode_steps": n_dec, "mesh": mesh_name,
           "fed": "the one device's tokens",
           "max_logits_rel_err": max(rel), "rtol": LM_TP_F32_RTOL,
           "decode_peak_rel_err_vs_plan": peak_err,
           "peak_tol": LM_TP_PEAK_TOL,
           # the layout before: every rank the whole row (the KV heads,
           # 4, do not split 8 ways)
           "cache_bytes_whole_on_every_rank":
               one["cache_bytes"] * shape[1],
           **{name: {k: v for k, v in r.items() if k != "logits"}
              for name, r in runs.items()}}
    finite = all(bool(torch.isfinite(l).all())
                 for r in runs.values() for l in r["logits"])
    if not (max(rel) <= LM_TP_F32_RTOL and peak_err <= LM_TP_PEAK_TOL
            and finite and tp_["layout"]["k"] == "2"
            and tp_["cache_bytes"] == one["cache_bytes"]):
        fail(f"lm_tp[{arch} f32 {mesh_name} sequence-split cache]: {out}")
    return out


def lm_tp_train(dev, card_mesh):
    """(c) the reduced archs' tensor-parallel train step in f32 against one
    device; (d) full-width danube: the f32 gradient on (1, 4), then bf16
    steps on one device, (1, 4) and (2, 2) (the comment above LM_TP_MESHES)."""
    import math
    import torch
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.data import tokens as tdata
    from repro_torch.parallel import api, sharded as sh
    from repro_torch.train import optim
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_f32 import f32_unembed
    rules = rule_preset("baseline")

    def leaf_errs(g, want):
        """(max abs error, max error over the leaf's largest) of the
        sharded gradient ``g`` against ``want``, leaf by leaf."""
        abs_err, rel_err = 0.0, 0.0
        for a, b in zip(optim.tree_leaves(g), optim.tree_leaves(want)):
            d = float((sh.gather(a, dev).double() - b.double()).abs().max())
            abs_err = max(abs_err, d)
            rel_err = max(rel_err, d / max(float(b.abs().max()), 1e-30))
        return abs_err, rel_err

    # -- (c) the ten reduced archs in f32
    reduced = {}
    with f32_unembed():
        for arch in registry.list_archs():
            cfg = dataclasses.replace(registry.reduced_config(arch),
                                      act_dtype="float32")
            src = tdata.SyntheticTokens(tdata.DataConfig(
                cfg.vocab_size, LM_TP_SEQ + 1, LM_TP_BATCH, seed=SEED))
            batch = lm_token_batch(cfg, src, 0, dev)
            (l1, _), g1 = api.make_value_and_grad(cfg)(
                api.init_params(cfg, SEED, device=dev), batch)
            rows = {}
            for shape in LM_TP_MESHES:
                mesh = card_mesh(shape)
                (l, _), g = api.make_value_and_grad(cfg, mesh, rules)(
                    api.init_params(cfg, SEED, mesh, rules), batch)
                grad_err, _ = leaf_errs(g, g1)
                row = {"loss_abs_err": abs(float(l) - float(l1)),
                       "grad_max_abs_err": grad_err}
                rows["x".join(map(str, shape))] = row
                if not (row["loss_abs_err"] <= LM_TP_TOL
                        and grad_err <= LM_TP_TOL):
                    fail(f"lm_tp[{arch} {shape} train]: against one device "
                         f"beyond {LM_TP_TOL}: {row}")
                del g
            reduced[arch] = rows
            del g1
    torch.cuda.empty_cache()

    # -- (d) full-width danube: the f32 gradient on (1, 4)
    arch, batch, seq = LM_TP_TRAIN
    src = tdata.SyntheticTokens(tdata.DataConfig(
        registry.get_config(arch).vocab_size, seq + 1, batch, seed=SEED))
    cfg = dataclasses.replace(registry.get_config(arch), act_dtype="float32")
    b0 = lm_token_batch(cfg, src, 0, dev)
    mesh14 = card_mesh((1, 4))
    with f32_unembed():
        (l1, _), g1 = api.make_value_and_grad(cfg)(
            api.init_params(cfg, SEED, device=dev), b0)
        torch.cuda.empty_cache()
        (l, _), g = api.make_value_and_grad(cfg, mesh14, rules)(
            api.init_params(cfg, SEED, mesh14, rules), b0)
    abs_err, rel_err = leaf_errs(g, g1)
    f32 = {"loss": float(l), "loss_abs_err": abs(float(l) - float(l1)),
           "grad_max_abs_err": abs_err, "grad_max_err_over_leaf_max":
           rel_err, "rtol": LM_TP_F32_RTOL}
    del g, g1
    torch.cuda.empty_cache()
    if not (rel_err <= LM_TP_F32_RTOL and abs(float(l) - float(l1))
            <= LM_TP_F32_RTOL * abs(float(l1))):
        fail(f"lm_tp[{arch} f32 train (1, 4)]: against one device: {f32}")

    # -- (d) then bf16 steps on one device, (1, 4) and (2, 2)
    cfg = registry.get_config(arch)
    tc = api.TrainConfig()
    # one batch at every step: the loss falls by a descent step's, not by
    # the next batch's luck
    b0 = lm_token_batch(cfg, src, 0, dev)
    steps = {}
    for name, shape in (("one_device", None), ("1x4", (1, 4)),
                        ("2x2", (2, 2))):
        m_ = card_mesh(shape) if shape else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = (api.init_params(cfg, SEED, device=dev, train_cfg=tc)
                  if m_ is None else
                  api.init_params(cfg, SEED, m_, rules, train_cfg=tc))
        state = api.make_train_state(params)
        step, _ = api.make_train_step(cfg, m_, rules if m_ else None,
                                      train_cfg=tc)
        losses, times = [], []
        for b in [b0] * LM_TP_TRAIN_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        plan = (api.train_state_bytes(cfg, tc) if m_ is None else
                sum(api.train_state_bytes(cfg, tc, mesh=m_, rules=rules)))
        peak = torch.cuda.max_memory_allocated(dev)
        steps[name] = {"losses": losses, "step_ms": times,
                       "peak_bytes": peak, "plan_bytes": plan,
                       "peak_rel_err_vs_plan": abs(peak - plan) / plan}
        del params, state, m
    torch.cuda.empty_cache()
    one_ms = min(steps["one_device"]["step_ms"][1:])
    for name, row in steps.items():
        row["ms_over_one_device"] = min(row["step_ms"][1:]) / one_ms
        ok = all(math.isfinite(x) for x in row["losses"]) and \
            row["losses"][-1] < row["losses"][0]
        if not ok or (name != "one_device" and row["peak_rel_err_vs_plan"]
                      > LM_TP_PEAK_TOL):
            fail(f"lm_tp[{arch} bf16 train {name}]: losses not finite or "
                 f"not falling, or the peak beyond {LM_TP_PEAK_TOL} of the "
                 f"plan: {row}")
    return {"train_reduced": reduced,
            "train_full": {"arch": arch, "batch": batch, "tokens_per_row":
                           seq, "f32_1x4": f32, "bf16_steps": steps,
                           "peak_tol": LM_TP_PEAK_TOL}}


# the dryrun phase: the children of (a) and (b), started together; (b)
# is a subset of --all --mesh both (the whole sweep takes minutes on one
# process): a train cell and two serving cells that the whole gathered
# copy kept from fitting; all fit since the tensor-parallel steps and the
# cache split along the sequence (qwen2-vl's decode on (16, 16): its
# 85.9 GB cache row, whose 8 KV heads do not split 16 ways, is 5.4 GB a
# device)
DRYRUN_LM_CELLS = (("whisper-base", "train_4k"),
                   ("jamba-v0.1-52b", "decode_32k"),
                   ("qwen2-vl-72b", "decode_32k"))
DRYRUN_NOT_FITTING = ()
DRYRUN_TIMEOUT_S = 300
# (c): one position's share of the 4k render step on 256 positions
DRYRUN_APPS = ("nerf", "gia", "nsdf")
DRYRUN_PIXELS = (1 << 21) // 256
# (d): the card's own shapes on a one-position mesh: batch x tokens a row
# (a train row comes with its labels, as lm_train_phase's rows do)
DRYRUN_CARD = (("h2o-danube-1.8b", "train", 1, 6144, None),
               ("qwen2-7b", "prefill", 4, 512, None),
               # a tensor-parallel serving cell: the one card as (1, 4),
               # the whole group counted (dryrun.count_group)
               ("qwen2-7b", "prefill", 4, 512, (1, 4)),
               # a tensor-parallel train cell: the one card as (2, 2), two
               # rows of two ranks, the whole mesh counted
               # (dryrun.count_mesh_train); full width, since at reduced
               # size the peak (tens of MB) is within the cuBLAS workspace
               ("h2o-danube-1.8b", "train", 2, 2048, (2, 2)))
DRYRUN_PEAK_TOL = 0.10


def dryrun_children(work):
    """Start ``python -m repro_torch.launch.dryrun`` children, all
    together: (a) ``--fields``, (b) each of DRYRUN_LM_CELLS on both meshes;
    name -> (Popen, its --out file)."""
    env = {**os.environ, "PYTHONPATH": SRC}
    argvs = {"fields": ["--fields"]}
    for arch, shape in DRYRUN_LM_CELLS:
        argvs[f"{arch}/{shape}"] = ["--arch", arch, "--shape", shape,
                                   "--mesh", "both"]
    out = {}
    for i, (name, argv) in enumerate(argvs.items()):
        path = os.path.join(work, f"dryrun_{i}.json")
        log = open(os.path.join(work, f"dryrun_{i}.log"), "w")
        out[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), path, log)
    return out


def dryrun_child_records(child, name):
    proc, path, log = child
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"dryrun[{name}]: the child ran past {DRYRUN_TIMEOUT_S} s")
    log.close()
    if rc != 0:
        with open(log.name) as f:
            tail = f.read()[-3000:]
        fail(f"dryrun[{name}]: the child exited {rc}: {tail}")
    with open(path) as f:
        return json.load(f)


def dryrun_phase(dev, gpu):
    """The dry run (``python -m repro_torch.launch.dryrun``) on the CPU in
    children, and its counts held to this card: the render step's
    launches and time, and the counted peak memory, matrix FLOPs and
    bound of two LM steps at the card's shapes."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels as K
    from repro_torch.common.partitioning import rule_preset
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core import fields, pipeline
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.parallel import api

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    children = dryrun_children(work)
    rules = rule_preset("baseline")

    # -- (d) LM steps at the card's shapes, counted on meta and run here
    card = {}
    for arch, step_kind, batch, seq, mesh_shape in DRYRUN_CARD:
        cfg = registry.get_config(arch)
        cell = ShapeCell("card", seq, batch, step_kind)
        names = ("tokens", "labels") if step_kind == "train" else ("tokens",)
        specs = {"batch": {n: torch.empty((batch, seq), dtype=torch.int32,
                                          device="meta") for n in names}}
        if mesh_shape is None:
            counted, _ = dryrun.build_and_count(cfg, cell,
                                                dryrun.ONE_POSITION, rules,
                                                specs=specs)
        else:
            mesh = Mesh(np.array([dev] * int(np.prod(mesh_shape)),
                                 dtype=object).reshape(mesh_shape),
                        ("data", "model"))
            counted = (dryrun.count_mesh_train(cfg, cell, mesh_shape, rules,
                                               specs=specs)
                       if step_kind == "train" else
                       dryrun.count_group(cfg, cell, mesh, rules,
                                          specs=specs))
        rec = roofline.summarize(f"{arch}/card", counted, 1, 0.0)
        rng = np.random.default_rng(SEED)
        inputs = {n: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(dev)
            for n in names}
        torch.cuda.empty_cache()
        if step_kind == "train":
            tc = api.TrainConfig()
            state = api.make_train_state(
                api.init_params(cfg, SEED, device=dev, train_cfg=tc)
                if mesh_shape is None else
                api.init_params(cfg, SEED, mesh, rules, train_cfg=tc))
            step, _ = api.make_train_step(
                cfg, None if mesh_shape is None else mesh, rules,
                train_cfg=tc)

            def run():
                return step(state, inputs)
        elif mesh_shape is None:
            params = api.init_params(cfg, SEED, device=dev,
                                     compute_dtype=cfg.adtype)
            cache = api.make_cache(cfg, batch, seq, device=dev)
            step, _ = api.make_prefill_step(cfg, capacity=seq,
                                            batch_size=batch)

            def run():
                return step(params, inputs, cache)
        else:
            params = api.init_params(cfg, SEED, mesh, rules,
                                     compute_dtype=cfg.adtype)
            step, info = api.make_prefill_step(cfg, mesh, rules,
                                               capacity=seq,
                                               batch_size=batch)
            cache = api.make_cache(cfg, batch, seq, shardings=info["cache"],
                                   rules=rules)

            def run():
                return step(params, inputs, cache)
        run()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        with FlopCounterMode(display=False) as fc:
            run()
        torch.cuda.synchronize()
        flops = fc.get_total_flops()
        counted_peak = rec["memory_analysis"]["peak_bytes"]
        row = {"batch": batch, "tokens_per_row": seq, "step": step_kind,
               "mesh": mesh_shape, "counted_peak_bytes": counted_peak,
               "max_memory_allocated": peak,
               "peak_rel_err": abs(counted_peak - peak) / peak,
               "counted_matmul_flops": counted["flops"],
               "flop_counter_mode_flops": flops,
               "bound_s": rec["bound_s"], "dominant": rec["dominant"],
               "step_ms": step_ms,
               "step_over_bound": step_ms / 1e3 / rec["bound_s"]}
        card[arch if mesh_shape is None else
             f"{arch} {'x'.join(map(str, mesh_shape))}"] = row
        del run, step
        state = params = cache = None
        if row["peak_rel_err"] > DRYRUN_PEAK_TOL or flops != counted["flops"] \
                or step_ms / 1e3 < rec["bound_s"]:
            fail(f"dryrun[{arch} {step_kind} {batch}x{seq}]: counted "
                 f"against the card beyond {DRYRUN_PEAK_TOL} of the peak, "
                 f"FLOPs unequal, or faster than the bound: {row}")
    torch.cuda.empty_cache()

    # -- (a) the field cells
    frecs = dryrun_child_records(children["fields"], "fields")
    if len(frecs) != 12 or any(
            "error" in r or not r["bound_s"] > 0
            or not r["memory_analysis"]["fits_h100_80g"]
            for r in frecs.values()):
        fail(f"dryrun[fields]: {len(frecs)} records, not 12 fitting ones "
             f"with a bound > 0: {sorted(frecs)}")

    # -- (c) one position's share of the render step on the card: the
    # launches the record counts, a time at least its bound
    gen = torch.Generator(device=dev).manual_seed(SEED)
    apps = {}
    launches = dict.fromkeys(K.launch_counts(), 0)
    for app in DRYRUN_APPS:
        rec = frecs[f"field-{app}-hash/single"]
        fcfg = fields.make_field_config(app, "hash")

        def draw(shapes, grid=False):
            if isinstance(shapes, dict):
                return {k: draw(v, k == "grid") for k, v in shapes.items()}
            t = torch.empty(shapes, dtype=torch.float32, device=dev)
            if grid:
                return t.uniform_(-1.0, 1.0, generator=gen)
            return t.normal_(generator=gen) / float(np.sqrt(shapes[-2]))
        fp = draw(fields.param_shapes(fcfg))
        render = pipeline.make_render_step(fcfg)
        ids = torch.arange(DRYRUN_PIXELS, dtype=torch.int32, device=dev)
        K.reset_launch_counts()                # the path: one render step
        rgb = render(fp, ids)
        torch.cuda.synchronize()
        got = {k: n for k, n in K.launch_counts().items() if n}
        for k, n in got.items():
            launches[k] += n
        # the record counts kernels: an entry point that launches another's
        # kernel (nerf's colour head, mlp_fwd_head) is counted as that one
        got = {k: n for k, n in got.items()
               if K.kernels()[k].counts_as is None}
        want = {k: w["launches"] for k, w in rec["kernels"].items()}
        ms = device_ms(lambda: render(fp, ids), reps=5)
        apps[app] = {"launches": got, "record_launches": want,
                     "ms": ms, "bound_ms": rec["bound_s"] * 1e3,
                     "dominant": rec["dominant"],
                     "ms_over_bound": ms / (rec["bound_s"] * 1e3),
                     "finite": bool(torch.isfinite(rgb).all())}
        del fp, rgb
        if got != want or ms < rec["bound_s"] * 1e3 or \
                not apps[app]["finite"]:
            fail(f"dryrun[{app}]: the card against the record: "
                 f"{apps[app]}")
    torch.cuda.empty_cache()

    # -- (b) the LM cells: no failure, each position's state as the memory
    # plans give it on the same stand-in mesh, the refused archs refused
    cells = {}
    for arch, shape in DRYRUN_LM_CELLS:
        recs = dryrun_child_records(children[f"{arch}/{shape}"],
                                    f"{arch}/{shape}")
        cfg = registry.get_config(arch)
        for key, rec in recs.items():
            if "error" in rec:
                fail(f"dryrun[{key}]: {rec['error']}")
            mesh = make_production_mesh(multi_pod=key.endswith("multi"))
            tc = api.TrainConfig(**(rec["train_overrides"] or {}))
            plan = (api.train_state_bytes(cfg, tc, mesh=mesh, rules=rules)
                    if shape.startswith("train") else
                    api.param_bytes(cfg, cfg.adtype, mesh=mesh, rules=rules))
            ma = rec["memory_analysis"]
            cells[key] = {"state_bytes": ma["state_bytes"],
                          "plan_bytes": plan[rec["position"]],
                          "argument_bytes": ma["argument_bytes"],
                          "temp_bytes": ma["temp_bytes"],
                          "fits_h100_80g": ma["fits_h100_80g"],
                          "dominant": rec["dominant"],
                          "bound_s": rec["bound_s"]}
            if ma["state_bytes"] != plan[rec["position"]] or (
                    key in DRYRUN_NOT_FITTING) == ma["fits_h100_80g"]:
                fail(f"dryrun[{key}]: state bytes against the plan, or the "
                     f"fit verdict: {cells[key]}")
    shutil.rmtree(work, ignore_errors=True)
    return {"phase": "dryrun", "seconds": time.perf_counter() - t_phase,
            "launches": launches, "pixels": DRYRUN_PIXELS,
            "fields": {"records": len(frecs)}, "apps": apps,
            "lm_cells": cells, "card_steps": card,
            "peak_tol": DRYRUN_PEAK_TOL, **gpu}


def paths_phase(dev, gpu):
    """One short drive of each field main path, for the launch counts of
    the final ``kernels`` line: PATH_REQUESTS nerf requests at Table-I
    width through ``RenderEngine`` on an f32 scene, then as many on its
    int8 twin, then one chunk of nerf steps through ``train_field``
    (TrainEngine). The counts are set to 0 before each run and read after
    it; nothing here is timed or held to a reference (the card tests hold
    the paths' outputs)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import fields, pipeline
    from repro_torch.core import train as ctrain
    from repro_torch.data import scenes
    from repro_torch.quant import QuantSpec, quantize_field
    from repro_torch.serve import RenderEngine, RenderRequest

    cfg = fields.make_field_config("nerf", "hash")
    p0 = fields.from_jax_params(np_params(cfg, SEED), cfg, dev)
    spec = QuantSpec("int8")
    engine = RenderEngine(pipeline.RenderSettings(
        tile_pixels=TILE_PIXELS, n_samples=N_SAMPLES), device=dev)
    engine.add_scene("f32", cfg, p0)
    engine.add_scene("int8", cfg.with_quant(spec), quantize_field(p0, spec))
    rng = np.random.default_rng(SEED)
    cam = scenes.orbit_camera(FRAME, FRAME, 0.0)
    launches = {}
    for path, scene in (("serve", "f32"), ("serve_quant", "int8")):
        K.reset_launch_counts()
        tickets = [engine.submit(RenderRequest(
            scene, cam, rng.integers(0, FRAME * FRAME, TILE_PIXELS)))
            for _ in range(PATH_REQUESTS)]
        engine.flush()
        for t in tickets:
            t.result()
        launches[path] = K.launch_counts()
    del engine, p0
    K.reset_launch_counts()
    ctrain.train_field(cfg, steps=TRAIN_CHUNK, batch_size=TRAIN_BATCH,
                       seed=SEED, chunk_steps=TRAIN_CHUNK,
                       gt_samples=GT_SAMPLES, device=dev)
    torch.cuda.synchronize()
    launches["train"] = K.launch_counts()
    torch.cuda.empty_cache()
    return {"phase": "paths", "requests": PATH_REQUESTS,
            "tile_pixels": TILE_PIXELS, "n_samples": N_SAMPLES,
            "train_steps": TRAIN_CHUNK, "train_batch": TRAIN_BATCH,
            "launches": launches, **gpu}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    import numpy as np
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
    from repro_torch.kernels.hashgrid import vjp as hvjp
    from repro_torch.kernels.common import TABLE_DTYPE_CODE
    from repro_torch.kernels.hashgrid.hashgrid import (ENCODE_BWD,
                                                       encode_bwd_plan,
                                                       encode_plan,
                                                       level_meta, sm_count)
    from repro_torch.kernels.hashgrid.ref import encode_ref
    from repro_torch.kernels.ray_march import ops as rm_ops
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.roofline import H100_SXM, kernel_ops_s
    from repro_torch.quant import QuantSpec, quantize_field

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
    if not any(r[0].startswith("encode_bwd_kernel<Li3E") for r in ptxas) \
            or not any(r[0].startswith("encode_bwd_kernel<Li2E")
                       for r in ptxas):
        fail("build: no 3-D and 2-D encode_bwd kernels in ptxas' report, so "
             "their spills went unchecked")

    # --------------------------------------------------------- analysis
    emit(analysis_phase(ptxas, dev, gpu))

    # --------------------------------------------------------------- lm
    # the LM stack's serving path, before the field phases take memory
    emit(lm_phase(dev, gpu))
    line = lm_train_phase(dev, gpu)
    lt_launches = line["launches"]
    emit(line)
    emit(lm_shard_phase(dev, gpu))
    emit(lm_tp_phase(dev, gpu))

    # ----------------------------------------------------------- dryrun
    # the dry run counted on meta in children, its counts held to the card
    line = dryrun_phase(dev, gpu)
    dr_launches = line["launches"]
    emit(line)

    # ---------------------------------------------------------- kernels
    p0 = fields.from_jax_params(np_params(cfg, SEED), cfg, dev)
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
    dcfg, ccfg, g = cfg.density_mlp, cfg.mlp, cfg.grid

    # gia: one scene of 2 GiB f32 tables (numpy, then the card), and its
    # int8 and fp8 stacks quantized on the card
    g0 = fields.from_jax_params(np_params(gcfg, SEED + 10), gcfg, dev)
    gqtab = {"gia_int8": quantize_field(g0, QuantSpec("int8")),
             "gia_fp8": quantize_field(g0, QuantSpec("fp8_e4m3"))}
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

    def wbytes(tree):
        return kcost.tensor_bytes(tree.values())

    # each app's grid tile: (points, grid config, distinct rows it touches)
    tiles = {"nerf": (flat_pts, g, touched_rows(flat_pts, g)),
             "gia": (gia_pts, gcfg.grid, touched_rows(gia_pts, gcfg.grid)),
             "nsdf": (nsdf_pts, ncfg.grid, touched_rows(nsdf_pts,
                                                        ncfg.grid))}
    # the dense and tiled grids at Table-I width on the same tiles: nerf's
    # (3-D, 2^19 rows, density MLP 16->64x3->16) and gia's (2-D, 2^24 rows:
    # 1 GiB of f32 tables each, MLP 16->64x4->3); U(-1, 1) tables
    grid_scenes = {}
    for i, kind in enumerate(GRID_VARIANTS):
        for app, x in (("nerf", flat_pts), ("gia", gia_pts)):
            c = fields.make_field_config(app, kind)
            v = f"{app}_{kind}"
            grid_scenes[v] = (c, fields.from_jax_params(
                np_params(c, SEED + 40 + 2 * i + (app == "gia")), c, dev))
            tiles[v] = (x, c.grid, touched_rows(x, c.grid))

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
    for v, (c, gp) in grid_scenes.items():
        head = "density_mlp" if c.app == "nerf" else "mlp"
        field_inputs[v] = (v, gp["grid"], None, gp[head], getattr(c, head))

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
        n = tiles[app][0].shape[0]
        runs["field_fwd" if sc is None else "field_fwd_q", v] = (
            field_call(v, True), field_call(v, False), None,
            kcost.field_fwd(n, tiles[app][1], m, tab.element_size(),
                            sc is not None, wbytes(w), tiles[app][2]),
            field_call(v, True, 1))
    for v in ("f32", "bf16", "int8", "fp8", "gia_f32", "gia_bf16",
              "gia_int8", "gia_fp8", *grid_scenes):
        app, tab, sc, _, _ = field_inputs[v]
        x, gg, _ = tiles[app]
        plan = encode_plan(gg, tab.dtype, x.shape[0],
                           sm_count(x.device.index))
        runs["encode_fwd", v] = (
            encode_call(v, True), encode_call(v, False), None,
            {**kcost.encode_fwd(x.shape[0], gg, tab.element_size(),
                                sc is not None, tiles[app][2]),
             # every corner of every level: the gather requests it issues
             "gathers": x.shape[0] * gg.n_levels * (1 << gg.dim),
             "plan": {k: plan[k] for k in ("group_levels",
                                           "points_per_block", "n_groups",
                                           "blocks", "store_bytes")}},
            encode_call(v, True, 1))
    def matmul_chain(w, x, m):
        """The yardstick: the cuBLAS matmul + relu chain at the MLP's
        shapes."""
        h = torch.relu(x @ w["w_in"])
        for i in range(m.n_hidden - 1):
            h = torch.relu(h @ w["w_hidden"][i])
        return h @ w["w_out"]

    def mlp_run(w, x, m):
        return (lambda: mlp_ops.mlp(w, x, m), lambda: apply_mlp(w, x, m),
                lambda: matmul_chain(w, x, m),
                kcost.mlp_fwd(x.shape[0], m, wbytes(w)),
                lambda: mlp_ops.mlp(w, x[:1], m))
    runs["mlp_fwd", None] = mlp_run(p0["mlp"], color_in, ccfg)
    # the unfused route's grid heads on the dense and tiled grids: the MLP
    # on the encode's (B, 16) features
    for v in grid_scenes:
        _, tab, _, w, m = field_inputs[v]
        x, gg, _ = tiles[v]
        runs["mlp_fwd", v] = mlp_run(w, encode_ref(x, tab, gg), m)
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
            kcost.composite_fwd(TILE_PIXELS, N_SAMPLES, dt.numel()),
            lambda c=c, sg=sg, dt=dt: rm_ops.composite(c[:1], sg[:1],
                                                       dt[:1]))

    results = {}
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
        # the least time on the units the kernel uses: HBM bytes, the MLP
        # products on the tensor cores (3 TF32 passes), the rest in f32 on
        # the CUDA cores, which run beside the tensor cores; and, for the
        # record, with every flop in f32 on the CUDA cores
        t_bytes = w["bytes"] / H100_SXM["hbm_bw"] * 1e3
        t_ops = kernel_ops_s(w) * 1e3
        t_f32 = (w["flops"] + w["mlp_flops"]) / H100_SXM["peak_flops_f32"] \
            * 1e3
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
    # encode_bwd, the table gradient's scatter-add (the training path has
    # no points' gradient), against its plain twin on a random cotangent
    for v, (app, tab) in {"f32": ("nerf", p0["grid"]),
                          "bf16": ("nerf", grid_bf16),
                          "gia_f32": ("gia", g0["grid"])}.items():
        x, gg, _ = tiles[app]
        cot = torch.from_numpy(rng.uniform(
            -1, 1, (x.shape[0], gg.out_dim)).astype(np.float32)).to(dev)

        def kern(x=x, tab=tab, gg=gg, cot=cot, n=None):
            return hops.encode_vjp(x[:n], tab, gg, cot[:n], False)[1]

        def plain(x=x, tab=tab, gg=gg, cot=cot):
            return hvjp.encode_bwd(x, tab, gg, cot, False)[1]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        tol = GRAD_TOL if tab.dtype == torch.float32 else GRAD_TOL_BF16
        if not bool(torch.isfinite(got).all()) or rel > tol:
            fail(f"encode_bwd[{v}]: max error {err}, {rel} of the gradient's "
                 f"max abs value, over {tol}")
        del got, ref
        rows, vals = table_grad_scatter(x, gg, cot)
        acc = torch.zeros((gg.n_levels * gg.table_size, gg.n_features),
                          dtype=torch.float32, device=dev)
        atomics = x.shape[0] * gg.n_levels * (1 << gg.dim) * gg.n_features
        bw = kcost.encode_bwd(x.shape[0], gg, tab.numel(), tab.element_size())
        nbytes, flops = bw["bytes"], bw["flops"]
        t_bytes = nbytes / H100_SXM["hbm_bw"] * 1e3
        t_ops = kernel_ops_s(bw) * 1e3
        ms = device_ms(kern, reps=20)
        results["encode_bwd", v] = {
            "max_abs_err": err, "rel_err": rel, "tol": tol, "ms": ms,
            "floor_ms": device_ms(lambda: kern(n=1), reps=20),
            "host_ms_per_call": host_ms(kern),
            "plain_ms": device_ms(plain, reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": device_ms(lambda: acc.index_add_(0, rows, vals),
                                    reps=20),
            "bytes": nbytes, "flops": flops, "atomics": atomics,
            "atomics_per_s": atomics / ms * 1e3,
            "plan": encode_bwd_plan(gg, x.shape[0], sm_count(dev.index))}
        if v == "f32":
            # the accumulator's zero fill alone, and the scatter at each
            # level group the kernel takes (the plan's among them): does a
            # group's accumulator (G x 4 MiB) staying in L2 matter?
            meta = level_meta(gg)

            def at_group(group, x=x, tab=tab, gg=gg, cot=cot):
                out = torch.zeros(tab.shape, dtype=torch.float32, device=dev)
                ENCODE_BWD(dev, x.data_ptr(), tab.data_ptr(),
                           TABLE_DTYPE_CODE[tab.dtype], cot.data_ptr(),
                           meta.ctypes.data, gg.n_levels, gg.log2_table_size,
                           gg.dim, gg.n_features, group, out.data_ptr(), 0,
                           x.shape[0])
                return out
            twin = plain()
            for group in (1, 2, 4, 8):
                gerr = rel_err(at_group(group), twin)[1]
                if gerr > GRAD_TOL:
                    fail(f"encode_bwd[{v}] at G={group}: {gerr} of the "
                         "gradient's max abs value")
            del twin
            results["encode_bwd", v].update(
                group_ms={g_: device_ms(lambda g_=g_: at_group(g_), reps=20)
                          for g_ in (1, 2, 4, 8)},
                zero_fill_ms=device_ms(lambda: torch.zeros(
                    tab.shape, dtype=torch.float32, device=dev), reps=20))
        del rows, vals, acc, cot
    emit({"phase": "kernels",
          "points": {app: t[0].shape[0] for app, t in tiles.items()},
          "rays": TILE_PIXELS,
          "table_rows_touched": {app: t[2] for app, t in tiles.items()},
          "results": {n if v is None else f"{n}[{v}]": r
                      for (n, v), r in results.items()}, **gpu})
    emit(head_phase(dev, gpu))
    line = ssd_phase(dev, gpu)
    results.update(ssd_results(line))
    emit(line)

    # ------------------------------------------------------------ paths
    # the serving and training paths, driven once for their launch counts
    line = paths_phase(dev, gpu)
    emit(line)

    # ----------------------------------------------------------- report
    # kernel -> (source, TPU kernel it replaces, path its launches are
    # read from, variant of the row's own numbers). The path is a phase of
    # this script that launches the kernel.
    paths = {**line["launches"], "dryrun": dr_launches,
             "lm_train": lt_launches}
    report = {
        "field_fwd": ("src/repro_torch/csrc/field.cu",
                      "src/repro/kernels/fused_field/fused_field.py:111",
                      "serve", "f32"),
        "field_fwd_q": ("src/repro_torch/csrc/field.cu",
                        "src/repro/kernels/fused_field/fused_field.py:111",
                        "serve_quant", "int8"),
        "encode_fwd": ("src/repro_torch/csrc/encode.cu",
                       "src/repro/kernels/hashgrid/hashgrid.py:183",
                       "train", "f32"),
        # no TPU kernel: the JAX package's encode VJP is XLA
        "encode_bwd": ("src/repro_torch/csrc/encode_bwd.cu",
                       "src/repro/kernels/hashgrid/vjp.py:27",
                       "train", "f32"),
        "mlp_fwd": ("src/repro_torch/csrc/mlp.cu",
                    "src/repro/kernels/fused_mlp/fused_mlp.py:74",
                    "serve", None),
        "composite_fwd": ("src/repro_torch/csrc/composite.cu",
                          "src/repro/kernels/ray_march/ray_march.py:53",
                          "serve", "packed"),
        # no TPU kernel: the JAX package's intra-chunk SSD term is XLA
        "ssd_intra_fwd": ("src/repro_torch/csrc/ssd.cu",
                          "src/repro/models/ssm.py:110", "lm_train", None),
        "ssd_intra_bwd": ("src/repro_torch/csrc/ssd.cu",
                          "src/repro/models/ssm.py:110", "lm_train", None),
        # no TPU kernel: the JAX package's inter-chunk term is XLA
        "ssd_inter_fwd": ("src/repro_torch/csrc/ssd_inter.cu",
                          "src/repro/models/ssm.py:121", "lm_train", None),
        "ssd_inter_bwd": ("src/repro_torch/csrc/ssd_inter.cu",
                          "src/repro/models/ssm.py:121", "lm_train", None)}
    unlaunched = [n for n, r in report.items() if not paths[r[2]][n]]
    if unlaunched:
        fail(f"kernels: never launched on the path their row names: "
             f"{unlaunched} ({paths})")
    keys = ("max_abs_err", "ms", "floor_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows_out = []
    for n, (src, tpu, path, main_v) in report.items():
        row = {"name": n, "route": "cuda", "source": src, "replaces": tpu,
               "launches": paths[path][n], "path": path,
               "launches_by_path": {p: c[n] for p, c in paths.items()},
               **{k: results[n, main_v][k] for k in keys}}
        if main_v is not None:
            row["variant"] = main_v
        variants = {v: r for (kn, v), r in results.items() if kn == n}
        if len(variants) > 1:         # mlp_fwd's own row: the colour MLP
            row["variants"] = {v or "colour": {k: r[k] for k in keys}
                               for v, r in variants.items()}
        rows_out.append(row)
    emit({"kernels": rows_out, "script_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
