#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's serving paths through ``RenderEngine`` and its training
path through ``TrainEngine`` at Table-I width and depth, and holds every
CUDA kernel on them against its plain PyTorch version: ``nerf_hash`` (L=16 levels of 2^19 x 2 f32 tables, density MLP
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
           block, groups, blocks); encode_bwd, the encode's table-gradient
           scatter-add, at nerf's tile with f32 and bf16 tables and at
           gia's, against its plain twin (index_add_ per level and corner)
           by max error over the gradient's max abs value, with its atomic
           adds (B x L x 2^d x F) and one index_add_ of the precomputed
           rows as the PyTorch yardstick
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
  serve_occ  the two nerf scenes, each with the analytic volume's 64^3
           occupancy grid, served culled at a quarter of the dense sample
           count (``RenderSettings(occupancy=True, sample_budget=32768)``):
           as serve, plus the live-sample share, dropped samples and the
           dense stream's numbers beside them; field_fwd, mlp_fwd and
           composite_fwd must launch
  profile_occ  one CUDA-only window of 20 culled requests, and the culled
           branch's own ops (mask, argsort compaction, gathers; the scatter
           back) on one request's tile, timed alone with CUDA events
  parity_occ  an all-occupied grid at the full budget: the culled frame
           equals the dense frame bit for bit; the culled 32x32 frame
           against render_frame on the CPU; the card's grid words equal the
           CPU's built from the same densities
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
  train    after the serving phases, with their engines and gia's 2 GiB
           stacks freed: train_field on each Table-I app (TrainEngine,
           chunks of 8 steps, 4096 points or rays x 32 samples a step, nerf
           32 steps, the others 16; nerf's and nvr's targets composited
           with 64 samples): the first and last loss (the last must be
           lower), ms per step, device memory allocated before and at the
           peak (the initial params, kept for train_parity, count), and
           each kernel's launches per step: field_fwd, encode_fwd (the
           backward's recomputed features), encode_bwd (the table
           gradient) and, for nerf, mlp_fwd must launch every step,
           composite_fwd never
  profile_train  nerf's and gia's device busy time, idle share and time
           by kernel over 4 more training steps, from one CUDA-only trace
  train_parity  nerf's and gia's first training step's gradient of every
           leaf (its params and batch), the kernel route against the plain
           versions on the card (the wrappers swapped for them; no kernel
           may launch): max error over the leaf's max abs value, which must
           not be 0
  serve_trained  the trained nerf scene and its initial params in one
           RenderEngine: a 32x32 frame of each from the training camera
           against the analytic volume's pixels (gt_render_rays, 64
           samples); the trained frame's MSE must be the lower (an
           all-black frame's is printed beside them)
  train_runtime  nerf: the first step's loss and gradients with
           grad_accum=2 against one pass (ACCUM_TOL), then 16 steps each
           with grad_accum=2, top-k (5%) and int8 compression of the table
           gradient (the loss must fall; kept + efb_new == g + efb_old on
           the next step's gradient, exactly for top-k, COMP_TOL for int8),
           then 32 steps with a 64^3 occupancy grid: its occupied share at
           each refresh, and the last refresh against the plain versions'
           recomputation on the same params and previous grid
  resume   nerf: two uninterrupted 48-step runs (their loss difference is
           the card's run-to-run noise); a run stopped at step 16 whose
           checkpoint restores bit for bit, resumed to 48; a child process
           SIGKILLed after its first commit (no temporary directory left,
           latest_step the last commit), resumed to 48; every resumed loss
           within max(4 x the noise, 1e-5 of the loss) of the first run's;
           the checkpoint's bytes and the seconds each save blocked; then
           gia's 6 GiB train state saved and restored once when the disk
           has room for it

then the ``{"kernels": [...]}`` line (every kernel, launches from the path
that runs it and per path, ``train`` among them, ``floor_ms``, the rows of other table types,
apps and layouts under ``variants``), the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}`` last. Any
failure exits non-zero before that line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
GPU and the CUDA toolkit (nvcc); imports nothing of JAX.
"""
import contextlib
import dataclasses
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
# encode_bwd against its twin: both sum each table row's terms in f32, the
# kernel with atomics in an order that changes from run to run, so f32
# gradients differ by the rounding of those sums: max error at most this
# share of the gradient's max abs value; bf16 tables add one rounding of
# sums that differ in their last bits, up to one bf16 ulp (2^-7 relative)
GRAD_TOL = 1e-5
GRAD_TOL_BF16 = 2.0 ** -7
# one training step's gradients, kernels against plain versions on the
# card: the kernels' 3xTF32 forward products (the exp and sigmoid heads
# magnify them, as for TOL) feed the loss's cotangent, and every sum runs
# in another order: max error over the leaf's max abs value
TRAIN_PARITY_TOL = 1e-4
TRAIN_STEPS = {"nerf": 32, "gia": 16, "nsdf": 16, "nvr": 16}
TRAIN_BATCH = 4096           # points (gia, nsdf) or rays (nerf, nvr)
TRAIN_CHUNK = 8
GT_SAMPLES = 64
PROFILE_STEPS = 4
OCC_RES = 64                 # occupancy grid cells per side
OCC_BUDGET = TILE_PIXELS * N_SAMPLES // 4   # culled field evaluations
OCC_THRESHOLD = 0.01         # train_field's default occupancy threshold
# the last occupancy refresh in training against the plain versions': the
# densities within TOL of their size (exp of 3xTF32 products), and the
# same bits but for cells within OCC_EPS of the threshold
OCC_EPS = 1e-3
RUNTIME_STEPS = 16           # steps of each compressed and accumulated run
RUNTIME_OCC_STEPS = 32       # four chunks: a build and three refreshes
TOPK_FRAC = 0.05
# grad_accum=2 against one pass on the card: f32 sums and atomics in
# another order; max error over the leaf's max abs value (and the loss's)
ACCUM_TOL = 1e-5
# int8's kept + efb_new against g + efb_old: one f32 rounding of acc - deq
# and one of the sum, against the tensor's max abs value
COMP_TOL = 1e-6
RESUME_STEPS = 48            # the uninterrupted runs
RESUME_STOP = 16             # the stopped run's steps
KILL_EVERY = 16              # the killed child saves every 16 steps
KILL_TIMEOUT_S = 300
# a resumed run's loss against an uninterrupted one's: at most this many
# times the largest difference between two uninterrupted runs (one draw
# of the atomics' rounding against another's maximum), or this share of
# the loss, whichever is larger
RESUME_NOISE_FACTOR = 4.0
RESUME_FLOOR = 1e-5


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


def tree_items(tree, prefix=""):
    """(path, leaf) of a param tree, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@contextlib.contextmanager
def plain_wrappers():
    """The field and MLP wrappers that ``apply_field`` calls, swapped for
    their plain versions (autograd through plain PyTorch ops on the card)
    inside the block and restored after: the plain side of train_parity."""
    from repro_torch.core import fields
    from repro_torch.kernels.fused_field.ref import field_ref
    from repro_torch.kernels.fused_mlp.ref import mlp_ref
    saved = fields.ff_ops.field, fields.mlp_ops.mlp

    def field(points, tables, w, grid_cfg, mlp_cfg, table_scales=None):
        return field_ref(points, tables, w, grid_cfg, mlp_cfg, table_scales)
    fields.ff_ops.field, fields.mlp_ops.mlp = field, mlp_ref
    try:
        yield
    finally:
        fields.ff_ops.field, fields.mlp_ops.mlp = saved


# the kill-and-resume child: trains nerf with checkpoints until killed
KILL_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.core import fields, train
cfg = fields.make_field_config("nerf", "hash")
train.train_field(cfg, steps=100000, batch_size={batch}, seed={seed},
                  chunk_steps={chunk}, ckpt_dir={ckpt!r}, ckpt_every={every},
                  gt_samples={gt}, device="cuda")
"""


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def resume_phase(cfg, gcfg, dev, clone_tree, nerf_init, nerf_batch,
                 nerf_loss, gpu):
    """The ``resume`` phase: (its JSON line, the kernels' launches in it).

    nerf at Table-I width, the checkpoint store and TrainEngine's resume:
    two uninterrupted runs of RESUME_STEPS (their per-step loss difference
    is the card's run-to-run noise: encode_bwd's atomics sum in a varying
    order); a run stopped at RESUME_STOP whose checkpoint restores the
    state bit for bit, then resumed; a child process SIGKILLed after its
    first commit, then resumed. Each resumed loss must be within
    max(RESUME_NOISE_FACTOR x the noise, RESUME_FLOOR x the loss) of the
    uninterrupted run's. Then gia's 6 GiB train state (tables, Adam's mu
    and nu) saved and restored once, when the disk has room."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.core import fields
    from repro_torch.core import train as ctrain
    from repro_torch.train import loop as tloop
    from repro_torch.train import optim as toptim

    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    common = dict(batch_size=TRAIN_BATCH, seed=SEED, chunk_steps=TRAIN_CHUNK,
                  gt_samples=GT_SAMPLES, device=dev)

    def losses(steps, **kw):
        rows = []
        ctrain.train_field(cfg, steps=steps, on_metrics=lambda i, r, st:
                           rows.append((i, r["loss"])), **common, **kw)
        return rows

    K.reset_launch_counts()
    a, b = losses(RESUME_STEPS), losses(RESUME_STEPS)
    noise = [abs(x - y) for (_, x), (_, y) in zip(a, b)]

    def check(resumed, what):
        """Each resumed step's loss against run a's, within the bound."""
        worst = 0.0
        for i, x in resumed:
            y = a[i][1]
            bound = max(RESUME_NOISE_FACTOR * max(noise), RESUME_FLOOR * abs(y))
            worst = max(worst, abs(x - y) / bound)
            if abs(x - y) > bound:
                fail(f"resume: {what} step {i} loss {x} vs uninterrupted {y}: "
                     f"over the bound {bound}")
        return worst

    # (1) stop at RESUME_STOP through TrainEngine (its checkpointer's
    # blocking times), the state at the last step kept on the side
    d1 = os.path.join(root, "stop")
    saved = {}

    def grab(i, r, st):
        if i == RESUME_STOP - 1:
            saved.update({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in ckpt_store._flatten(st)})
    eng = tloop.TrainEngine(
        tloop.EngineConfig(steps=RESUME_STOP, chunk_steps=TRAIN_CHUNK,
                           ckpt_dir=d1, ckpt_every=TRAIN_CHUNK),
        tloop.make_scanned_step(nerf_loss, toptim.AdamConfig()),
        batch_fn=nerf_batch)
    eng.run(tloop.init_train_state(nerf_init()), on_metrics=grab)
    blocked = list(eng.checkpointer.blocked_s)
    t0 = time.perf_counter()
    restored = dict(ckpt_store._flatten(ckpt_store.restore(
        d1, tloop.init_train_state(nerf_init()), step=RESUME_STOP - 1)))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored.keys() != saved.keys() or not all(
            torch.equal(restored[k], v) if torch.is_tensor(v)
            else restored[k] == v for k, v in saved.items()):
        fail("resume: the restored state is not the saved one bit for bit")
    ckpt_bytes = dir_bytes(os.path.join(d1, f"step_{RESUME_STOP - 1:08d}"))
    del saved, restored
    r1 = losses(RESUME_STEPS, ckpt_dir=d1, ckpt_every=TRAIN_CHUNK)
    if [i for i, _ in r1] != list(range(RESUME_STOP, RESUME_STEPS)):
        fail(f"resume: the resumed run ran steps {[i for i, _ in r1]}")
    worst1 = check(r1, "stopped-and-resumed")

    # (2) a child process killed (SIGKILL) after its first commit
    d2 = os.path.join(root, "kill")
    child = subprocess.Popen([sys.executable, "-c", KILL_CHILD.format(
        src=SRC, batch=TRAIN_BATCH, seed=SEED, chunk=TRAIN_CHUNK, ckpt=d2,
        every=KILL_EVERY, gt=GT_SAMPLES)])
    t0 = time.perf_counter()
    try:
        while ckpt_store.latest_step(d2) is None:
            if child.poll() is not None:
                fail(f"resume: the child exited ({child.returncode}) before "
                     "its first commit")
            if time.perf_counter() - t0 > KILL_TIMEOUT_S:
                fail("resume: the child made no commit in "
                     f"{KILL_TIMEOUT_S} s")
            time.sleep(0.005)
        first_commit_s = time.perf_counter() - t0
        os.kill(child.pid, signal.SIGKILL)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    committed = sorted(int(p.split("_")[1]) for p in os.listdir(d2)
                       if p.startswith("step_") and os.path.exists(
                           os.path.join(d2, p, ckpt_store.MANIFEST)))
    temps = [p for p in os.listdir(d2) if p.startswith(".tmp_step_")]
    last = ckpt_store.latest_step(d2)
    if temps or last != committed[-1] or last >= RESUME_STEPS - 1:
        fail(f"resume: after the kill: temp directories {temps}, "
             f"latest_step {last}, committed {committed}")
    r2 = losses(RESUME_STEPS, ckpt_dir=d2, ckpt_every=KILL_EVERY)
    if [i for i, _ in r2] != list(range(last + 1, RESUME_STEPS)):
        fail(f"resume: the run resumed after the kill ran steps "
             f"{[i for i, _ in r2]}")
    worst2 = check(r2, "killed-and-resumed")
    launches = K.launch_counts()

    # (3) gia's train state at Table-I width: 2 GiB tables and Adam's
    # moments, after one step so the moments are not zero
    gia = {"state_bytes": None}
    gstate = tloop.init_train_state(fields.init_field(
        gcfg, torch.Generator().manual_seed(SEED), dev))
    gstate, _ = tloop.make_scanned_step(
        lambda p, bb: ctrain.field_loss(p, gcfg, bb), toptim.AdamConfig())(
        gstate, 0, ctrain.make_batch(gcfg, ctrain.batch_generator(
            SEED, 0, dev), TRAIN_BATCH))
    nbytes = sum(v.numel() * v.element_size()
                 for _, v in ckpt_store._flatten(gstate)
                 if torch.is_tensor(v))
    free = shutil.disk_usage(root).free
    gia.update(state_bytes=nbytes, disk_free_bytes=free)
    if free < 2 * nbytes:
        gia["skipped"] = "not enough free disk for a second copy"
    else:
        d3 = os.path.join(root, "gia")
        ck = ckpt_store.AsyncCheckpointer(d3, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(gstate, 0)
        ck.wait()
        gia.update(save_blocked_s=ck.blocked_s[0],
                   save_total_s=time.perf_counter() - t0,
                   checkpoint_bytes=dir_bytes(d3))
        t0 = time.perf_counter()
        got = ckpt_store.restore(d3, gstate)
        torch.cuda.synchronize()
        gia["restore_s"] = time.perf_counter() - t0
        same = all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                   for (_, x), (_, y) in zip(ckpt_store._flatten(got),
                                             ckpt_store._flatten(gstate)))
        if not same:
            fail("resume: gia's restored state is not the saved one")
        gia["restored_equal"] = True
        del got
    del gstate
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"phase": "resume", "config": cfg.name, "steps": RESUME_STEPS,
            "stop_at": RESUME_STOP, "chunk_steps": TRAIN_CHUNK,
            "noise_max": max(noise), "noise_by_step": noise,
            "bound": {"noise_factor": RESUME_NOISE_FACTOR,
                      "floor": RESUME_FLOOR},
            "stopped": {"worst_over_bound": worst1,
                        "checkpoint_bytes": ckpt_bytes,
                        "save_blocked_s": blocked, "restore_s": restore_s,
                        "restored_equal": True},
            "killed": {"first_commit_s": first_commit_s,
                       "committed": committed, "resumed_from": last + 1,
                       "worst_over_bound": worst2, "temp_dirs": temps},
            "gia_state": gia, "launches": launches, **gpu}, launches


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
    from repro_torch.kernels.hashgrid import vjp as hvjp
    from repro_torch.kernels.common import TABLE_DTYPE_CODE
    from repro_torch.kernels.hashgrid.hashgrid import (ENCODE_BWD,
                                                       encode_bwd_plan,
                                                       encode_plan,
                                                       level_meta, sm_count)
    from repro_torch.kernels.hashgrid.ref import encode_ref
    from repro_torch.kernels.ray_march import ops as rm_ops
    from repro_torch.quant import QuantSpec, quantize_field
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.core import occupancy as occ_mod
    from repro_torch.core import train as ctrain
    from repro_torch.train import compression as tcomp
    from repro_torch.serve import RenderEngine, RenderRequest
    from repro_torch.train import loop as tloop
    from repro_torch.train import optim as toptim
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
    if not any(r[0].startswith("encode_bwd_kernel<Li3E") for r in ptxas) \
            or not any(r[0].startswith("encode_bwd_kernel<Li2E")
                       for r in ptxas):
        fail("build: no 3-D and 2-D encode_bwd kernels in ptxas' report, so "
             "their spills went unchecked")

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
        corners = x.shape[0] * gg.n_levels * (1 << gg.dim)
        atomics = corners * gg.n_features
        # points and cotangent in, the gradient of the whole table out at
        # the table's dtype; per corner d weight multiplies, F products and
        # F atomic adds (f32 operations)
        nbytes = (x.numel() + cot.numel()) * 4 + tab.numel() \
            * tab.element_size()
        flops = corners * (gg.dim + 2 * gg.n_features)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
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
    dense_line = line

    # ---------------------------------------------------------- profile
    # Device busy time, idle share and time by kernel, each from one trace
    # of one steady window of PROFILE_REQUESTS served requests. Two windows:
    # CPU + CUDA activity (the breakdown), and CUDA activity alone, whose
    # host overhead is smaller, so its idle share is nearer the unprofiled
    # stream's.
    def trace(run, acts, n, unit, top=10):
        """Device busy time, idle share, device events and time by kernel
        (the ``top`` longest) of one traced call of ``run``, which does
        ``n`` ``unit``s of work (requests, training steps) and waits for
        the device."""
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
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
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
        return {f"{unit}s": n, "wall_ms": wall_ms,
                "device_busy_ms": busy_ms if spans else "not measured",
                f"device_busy_ms_per_{unit}": busy_ms / n
                if spans else "not measured",
                "device_idle_share": (1 - busy_ms / wall_ms) if spans
                else "not measured",
                "device_events": len(spans), "top_device_ms": top}

    def profile_window(engine, window_reqs, acts, top=10):
        """``trace`` of one window of served requests."""
        def run():
            for r in window_reqs:
                engine.submit(r)
            engine.flush()
        return trace(run, acts, len(window_reqs), "request", top)

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

    # -------------------------------------------------------- serve_occ
    # The same two Table-I scenes, each with the analytic volume's 64^3
    # occupancy grid, served culled at a quarter of the dense sample count
    # (the JAX occupancy test's budget): the field runs on at most
    # OCC_BUDGET samples a request.
    def volume_sigma(p):
        return scenes.volume_field(p * 4.0 - 2.0)[:, 3]
    t0 = time.perf_counter()
    grid = occ_mod.build_occupancy_from_fn(volume_sigma, res=OCC_RES,
                                           device=dev)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    occ_settings = dataclasses.replace(settings, occupancy=True,
                                       sample_budget=OCC_BUDGET)
    oengine = RenderEngine(occ_settings, device=dev)
    for s_ in range(2):
        oengine.add_scene(f"scene{s_}", cfg, occ_mod.attach(
            fields.from_jax_params(np_params(cfg, SEED + s_), cfg, dev),
            grid))
    oreqs, olaunches, line = serve(oengine, ["scene0", "scene1"],
                                   "serve_occ")
    if min(olaunches[k] for k in dense_path) <= 0:
        fail(f"serve_occ: a kernel of the culled path never launched: "
             f"{olaunches}")
    st = oengine.stats()
    line.update(
        sample_budget=OCC_BUDGET, grid_res=OCC_RES, grid_build_s=grid_s,
        grid_occupied_fraction=occ_mod.occupied_fraction(grid),
        effective_mpix_per_s=st["effective_mpix_per_s"],
        live_sample_frac=st["live_sample_frac"],
        samples_total=st["samples_total"],
        samples_dropped=st["samples_dropped"],
        dense={k: dense_line[k] for k in ("p50_ms", "p90_ms", "mpix_per_s",
                                          "launches")})
    emit(line)

    # ------------------------------------------------------ profile_occ
    # One CUDA-only trace of 20 culled requests, and the culled branch's
    # own ops outside the field (the live mask, the argsort compaction,
    # the gathers of the budget's points, the scatter back) on one
    # request's tile, timed alone with CUDA events.
    prof = profile_window(oengine, oreqs[:PROFILE_REQUESTS],
                          [ProfilerActivity.CUDA], top=20)
    o_, d_ = render.make_rays(cams[0], torch.from_numpy(oreqs[0].pixel_ids)
                              .to(dev))
    o_pts, o_dts = render.sample_along_rays(o_, d_, 0.5, 4.5, N_SAMPLES)
    o_flat = render.normalize_to_unit(o_pts.reshape(-1, 3))
    o_dirs = torch.repeat_interleave(d_, N_SAMPLES, dim=0)
    o_live, o_sel = render.compact_samples(grid, o_flat, o_dts, N_SAMPLES,
                                           OCC_BUDGET, 1e-3)
    o_out = torch.zeros((OCC_BUDGET, 4), device=dev)

    def compaction():
        live, sel = render.compact_samples(grid, o_flat, o_dts, N_SAMPLES,
                                           OCC_BUDGET, 1e-3)
        return o_flat[sel], o_dirs[sel], live, sel

    # few calls queued behind the spin: the compaction is ~45 launches, and
    # 20 calls' enqueue can outlast the spin, which times the host instead
    emit({"phase": "profile_occ", "window": "cuda", **prof,
          "compaction_ms": device_ms(compaction, reps=4),
          "scatter_ms": device_ms(lambda: render.scatter_samples(
              o_out, o_sel, o_live), reps=20),
          "tile_live_samples": int(o_live.sum()), **gpu})

    # ------------------------------------------------------- parity_occ
    # (1) an all-occupied grid at the full budget: the culled frame equals
    # the dense frame on the card, bit for bit; (2) the quarter-budget
    # culled frame on the card against render_frame on the CPU; (3) the
    # card's grid words equal the CPU's built from the same densities.
    aengine = RenderEngine(dataclasses.replace(settings, occupancy=True),
                           device=dev)
    aengine.add_scene("scene0", cfg, occ_mod.attach(
        p0, occ_mod.all_occupied(OCC_RES, dev)))
    all_frame = aengine.render_frame("scene0", pcam)
    if not np.array_equal(all_frame, dense_frame):
        fail(f"parity_occ: the all-occupied culled frame differs from the "
             f"dense frame by {float(np.abs(all_frame - dense_frame).max())}")
    del aengine
    occ_frame = oengine.render_frame("scene0", pcam)
    cpu_grid = fields.to_device(grid, torch.device("cpu"))
    ref = pipeline.render_frame(occ_mod.attach(cpu_params, cpu_grid), cfg,
                                pcam, occ_settings, device="cpu").numpy()
    oerr = float(np.abs(occ_frame - ref).max())
    if not np.isfinite(occ_frame).all() or oerr > PARITY_TOL:
        fail(f"parity_occ: culled engine vs CPU render_frame max abs error "
             f"{oerr}")
    same_sigma = occ_mod.build_occupancy_from_fn(
        lambda p: cpu_grid["sigma"], res=OCC_RES, device="cpu")
    if not torch.equal(grid["bits"].cpu(), same_sigma["bits"]):
        fail("parity_occ: the card's occupancy words differ from the CPU's "
             "on the same densities")
    emit({"phase": "parity_occ", "frame": [32, 32],
          "all_occupied_equals_dense": True, "max_abs_err": oerr,
          "tol": PARITY_TOL, "bits_equal_cpu": True,
          "max_abs_diff_to_dense": float(np.abs(occ_frame - dense_frame)
                                         .max()), **gpu})
    del oengine, cpu_grid

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

    # ------------------------------------------------------------ train
    # Every app at Table-I width through train_field (TrainEngine), after
    # the serving engines and gia's stacks are gone. Gradients flow through
    # the field and MLP wrappers' autograd Functions: the kernels forward,
    # encode_fwd and encode_bwd backward; the loss composites in plain ops.
    del qengine, qscenes, qtab, grid_bf16, dmlp_bf16
    torch.cuda.empty_cache()
    train_launches, parity_rows, train_ms = {}, {}, {}
    tpath = {"nerf": ("field_fwd", "mlp_fwd", "encode_fwd", "encode_bwd")}
    for app in ("nerf", "gia", "nsdf", "nvr"):
        tcfg = fields.make_field_config(app, "hash")
        steps = TRAIN_STEPS[app]
        rows = []
        # the params train_field starts from with this seed
        init = fields.init_field(tcfg, torch.Generator().manual_seed(SEED),
                                 dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mem_before = torch.cuda.memory_allocated(dev)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        trained, _ = ctrain.train_field(
            tcfg, steps=steps, batch_size=TRAIN_BATCH, seed=SEED,
            chunk_steps=TRAIN_CHUNK, gt_samples=GT_SAMPLES, device=dev,
            params=init, on_metrics=lambda i, r, st: rows.append(r))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = K.launch_counts()
        for k, n in counts.items():
            train_launches[k] = train_launches.get(k, 0) + n
        per_step = {k: n / steps for k, n in counts.items()}
        losses = [r["loss"] for r in rows]
        line = {"phase": "train", "app": app, "config": tcfg.name,
                "steps": steps, "batch": TRAIN_BATCH,
                "points_per_step": TRAIN_BATCH * (N_SAMPLES if app in (
                    "nerf", "nvr") else 1),
                "chunk_steps": TRAIN_CHUNK, "loss_first": losses[0],
                "loss_last": losses[-1], "loss_min": min(losses),
                "psnr_last": rows[-1]["psnr"],
                "ms_per_step": 1e3 * statistics.mean(
                    r["dt"] for r in rows[TRAIN_CHUNK:]),
                "ms_per_step_first_chunk": 1e3 * rows[0]["dt"],
                "wall_s": wall_s,
                "mem_before_bytes": mem_before,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "table_bytes": tcfg.grid.params_bound() * 4,
                "launches_per_step": per_step, **gpu}
        emit(line)
        train_ms[app] = line["ms_per_step"]
        need = tpath.get(app, ("field_fwd", "encode_fwd", "encode_bwd"))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train[{app}]: the loss did not fall: {losses}")
        if min(per_step[k] for k in need) <= 0 \
                or counts["composite_fwd"] != 0:
            fail(f"train[{app}]: {need} must launch every step and "
                 f"composite_fwd never: {counts}")

        # --------------------------------------------------- profile_train
        # CUDA-only trace of PROFILE_STEPS more steps of the trained state
        # (a copy of its params, fresh Adam moments), batches made inside
        if app in ("nerf", "gia"):
            step = ctrain.make_field_train_step(tcfg)
            pstate = {"params": {k: (v.clone() if torch.is_tensor(v) else
                                     {kk: vv.clone() for kk, vv in v.items()})
                                 for k, v in trained.items()}}
            pstate["opt"] = toptim.adam_init(pstate["params"])
            cam = scenes.default_camera()

            def run_steps(n, first, tcfg=tcfg, step=step, pstate=pstate,
                          cam=cam):
                for i in range(first, first + n):
                    pstate["params"], pstate["opt"], _ = step(
                        pstate["params"], pstate["opt"], ctrain.make_batch(
                            tcfg, ctrain.batch_generator(SEED, i, dev),
                            TRAIN_BATCH, cam, gt_samples=GT_SAMPLES))
                torch.cuda.synchronize()
            run_steps(2, steps)                          # warm
            emit({"phase": "profile_train", "app": app, "window": "cuda",
                  **trace(lambda: run_steps(PROFILE_STEPS, steps + 2),
                          [ProfilerActivity.CUDA], PROFILE_STEPS, "step"),
                  **gpu})
            del pstate, step, run_steps

        # -------------------------------------------------- train_parity
        # the first step's gradients: at the trained params nerf's are
        # exactly 0 (its density has collapsed, PERF.md), so they would
        # compare nothing
        if app in ("nerf", "gia"):
            batch = ctrain.make_batch(
                tcfg, ctrain.batch_generator(SEED, 0, dev), TRAIN_BATCH,
                scenes.default_camera(), gt_samples=GT_SAMPLES)

            def loss_fn(p, b, tcfg=tcfg):
                return ctrain.field_loss(p, tcfg, b)
            K.reset_launch_counts()
            loss_k, grads_k = tloop.value_and_grad(loss_fn, init, batch)
            torch.cuda.synchronize()
            kcounts = K.launch_counts()
            with plain_wrappers():
                K.reset_launch_counts()
                loss_p, grads_p = tloop.value_and_grad(loss_fn, init, batch)
                torch.cuda.synchronize()
                pcounts = K.launch_counts()
            if kcounts["encode_bwd"] != 1 or any(pcounts.values()):
                fail(f"train_parity[{app}]: the kernel route must launch "
                     f"encode_bwd once and the plain route no kernel: "
                     f"{kcounts}, {pcounts}")
            leaves = {}
            plain_leaves = dict(tree_items(grads_p))
            for path, gk in tree_items(grads_k):
                err, rel = rel_err(gk, plain_leaves[path])
                leaves[path] = {"max_abs_err": err, "rel_err": rel,
                                "max_abs": float(plain_leaves[path].abs()
                                                 .max())}
            parity_rows[app] = {"loss_kernels": float(loss_k),
                                "loss_plain": float(loss_p),
                                "leaves": leaves}
            worst = max(r["rel_err"] for r in leaves.values())
            if not np.isfinite(worst) or worst > TRAIN_PARITY_TOL \
                    or min(r["max_abs"] for r in leaves.values()) <= 0:
                fail(f"train_parity[{app}]: a gradient is 0 or differs by "
                     f"{worst} of its max abs value: {leaves}")
            del grads_k, grads_p, plain_leaves, batch
        if app == "nerf":
            trained_nerf, init_nerf = trained, init
        del trained, init
        torch.cuda.empty_cache()
    emit({"phase": "train_parity", "tol": TRAIN_PARITY_TOL,
          "batch": TRAIN_BATCH, "apps": parity_rows, **gpu})

    # ---------------------------------------------------- serve_trained
    # The trained nerf scene and the params its training started from, in
    # one engine; a frame of each from the training camera against the
    # analytic volume, and, for the record, an all-black frame's MSE.
    cam32 = scenes.default_camera(32, 32)
    tengine = RenderEngine(settings, device=dev)
    tengine.add_scene("trained", cfg, trained_nerf)
    tengine.add_scene("untrained", cfg, init_nerf)
    tengine.warmup()
    K.reset_launch_counts()
    frames = {n: tengine.render_frame(n, cam32)
              for n in ("trained", "untrained")}
    slaunches = K.launch_counts()
    o, d = render.make_rays(cam32, torch.arange(32 * 32, device=dev))
    gt = scenes.gt_render_rays(o, d, n_samples=GT_SAMPLES).reshape(
        32, 32, 3).cpu().numpy()
    mse = {n: float(((f - gt) ** 2).mean()) for n, f in frames.items()}
    mse_black = float((gt ** 2).mean())
    emit({"phase": "serve_trained", "frame": [32, 32], "mse_black": mse_black,
          "gt_samples": GT_SAMPLES, "mse": mse,
          "psnr": {n: ctrain.psnr(m) for n, m in mse.items()},
          "launches": slaunches, **gpu})
    if not all(np.isfinite(m) for m in mse.values()) \
            or not mse["trained"] < mse["untrained"]:
        fail(f"serve_trained: the trained frame's MSE is not below the "
             f"untrained one's: {mse}")
    if min(slaunches[k] for k in dense_path) <= 0:
        fail(f"serve_trained: a serving kernel never launched: {slaunches}")
    del tengine, trained_nerf, init_nerf

    # ---------------------------------------------------- train_runtime
    # nerf at Table-I width through the rest of the training runtime:
    # gradient accumulation, error-feedback compression of the table
    # gradient, and an occupancy grid kept off the chunk ends.
    cam_t = scenes.default_camera()

    def nerf_batch(step):
        return ctrain.make_batch(cfg, ctrain.batch_generator(SEED, step, dev),
                                 TRAIN_BATCH, cam_t, gt_samples=GT_SAMPLES)

    def nerf_loss(p, b):
        return ctrain.field_loss(p, cfg, b)

    def nerf_init():
        return fields.init_field(cfg, torch.Generator().manual_seed(SEED),
                                 dev)

    def clone_tree(tree):
        return {k: (clone_tree(v) if isinstance(v, dict) else v.clone())
                for k, v in tree.items()}

    runtime = {}
    K.reset_launch_counts()
    init = nerf_init()
    batch0 = nerf_batch(0)
    l1, g1 = tloop.value_and_grad(nerf_loss, init, batch0)
    l2, g2 = tloop.accumulated_value_and_grad(nerf_loss, init, batch0, 2)
    accum = {"loss_1": float(l1), "loss_2": float(l2),
             "loss_rel_err": abs(float(l2) - float(l1)) / abs(float(l1)),
             "leaves": {path: rel_err(b_, dict(tree_items(g1))[path])[1]
                        for path, b_ in tree_items(g2)}}
    if accum["loss_rel_err"] > ACCUM_TOL \
            or max(accum["leaves"].values()) > ACCUM_TOL:
        fail(f"train_runtime: grad_accum=2 differs from one pass: {accum}")
    rows = []
    ctrain.train_field(cfg, steps=RUNTIME_STEPS, batch_size=TRAIN_BATCH,
                       seed=SEED, chunk_steps=TRAIN_CHUNK, grad_accum=2,
                       gt_samples=GT_SAMPLES, device=dev, params=init,
                       on_metrics=lambda i, r, st: rows.append(r))
    accum.update(steps=RUNTIME_STEPS, loss_first=rows[0]["loss"],
                 loss_last=rows[-1]["loss"], ms_per_step=1e3 * statistics.mean(
                     r["dt"] for r in rows[TRAIN_CHUNK:]))
    runtime["grad_accum"] = accum
    del g1, g2, init
    for scheme in ("topk", "int8"):
        rows, last = [], {}

        # the state after the first step: nerf's density collapses within
        # tens of steps, and with it every later gradient
        def grab(i, r, st, rows=rows, last=last):
            rows.append(r)
            if i == 0:
                last.update(params=clone_tree(st["params"]),
                            efb=st["efb"]["grid"].clone())
        ctrain.train_field(cfg, steps=RUNTIME_STEPS, batch_size=TRAIN_BATCH,
                           seed=SEED, chunk_steps=TRAIN_CHUNK,
                           compression=scheme, compression_topk=TOPK_FRAC,
                           gt_samples=GT_SAMPLES, device=dev,
                           on_metrics=grab)
        losses = [r["loss"] for r in rows]
        # the invariant on step 1's table gradient with the feedback step 0
        # left: what was not sent is kept, nothing is lost
        _, g = tloop.value_and_grad(nerf_loss, last["params"], nerf_batch(1))
        acc = g["grid"] + last["efb"]
        kept, efb_new = (tcomp.compress_topk(g["grid"], last["efb"],
                                             TOPK_FRAC) if scheme == "topk"
                         else tcomp.compress_int8(g["grid"], last["efb"]))
        inv_err = rel_err(kept + efb_new, acc)[1]
        row = {"loss_first": losses[0], "loss_last": losses[-1],
               "ms_per_step": 1e3 * statistics.mean(
                   r["dt"] for r in rows[TRAIN_CHUNK:]),
               "ms_per_step_uncompressed": train_ms["nerf"],
               "sent_nonzero_frac": float((kept != 0).float().mean()),
               "grad_max_abs": float(g["grid"].abs().max()),
               "efb_old_max_abs": float(last["efb"].abs().max()),
               "efb_max_abs": float(efb_new.abs().max()),
               "invariant_rel_err": inv_err,
               "invariant_tol": 0.0 if scheme == "topk" else COMP_TOL}
        runtime[scheme] = row
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"train_runtime[{scheme}]: the loss did not fall: {losses}")
        if inv_err > row["invariant_tol"] or not row["efb_old_max_abs"] > 0:
            fail(f"train_runtime[{scheme}]: kept + efb_new differs from g + "
                 f"efb_old by {inv_err} of its max")
        del last, g, acc, kept, efb_new
    # occupancy: every grid the run builds or refreshes, and the params of
    # the chunk end it came from; the last refresh recomputed with the
    # plain versions (the field wrappers swapped for them) on the same
    # params and previous grid
    refreshes = []
    real_build, real_update = occ_mod.build_occupancy, \
        occ_mod.update_occupancy

    def rec_build(params, c, **kw):
        g_ = real_build(params, c, **kw)
        refreshes.append((None, clone_tree(params), g_))
        return g_

    def rec_update(prev, params, c, **kw):
        g_ = real_update(prev, params, c, **kw)
        refreshes.append((prev, clone_tree(params), g_))
        return g_
    occ_mod.build_occupancy, occ_mod.update_occupancy = rec_build, rec_update
    try:
        rows = []
        trained_occ, _ = ctrain.train_field(
            cfg, steps=RUNTIME_OCC_STEPS, batch_size=TRAIN_BATCH, seed=SEED,
            chunk_steps=TRAIN_CHUNK, gt_samples=GT_SAMPLES, device=dev,
            occupancy_res=OCC_RES, on_metrics=lambda i, r, st: rows.append(r))
    finally:
        occ_mod.build_occupancy, occ_mod.update_occupancy = real_build, \
            real_update
    prev, last_params, last_grid = refreshes[-1]
    if not torch.equal(trained_occ["occupancy"]["bits"], last_grid["bits"]):
        fail("train_runtime: the attached grid is not the last refresh's")
    centers = occ_mod.cell_centers(OCC_RES, dev)
    fresh = occ_mod.field_sigma(last_params, cfg, centers)
    runtime_launches = K.launch_counts()
    with plain_wrappers():
        plain_grid = occ_mod.update_occupancy(prev, last_params, cfg)
        fresh_ref = occ_mod.field_sigma(last_params, cfg, centers)
    if K.launch_counts() != runtime_launches:
        fail("train_runtime: the plain grid launched a kernel")
    # the refresh's own field evaluation (field_fwd's density pass), which
    # the EMA's max may hide once the density falls
    fresh_err = float(((fresh - fresh_ref).abs() / fresh_ref.abs().clamp(
        min=1e-30)).max())
    if fresh_err > TOL:
        fail(f"train_runtime: field_fwd's densities at the cell centres "
             f"differ from the plain versions' by {fresh_err} relative")
    sig, sig_ref = last_grid["sigma"], plain_grid["sigma"]
    sig_err = float(((sig - sig_ref).abs() / sig_ref.abs().clamp(
        min=1e-30)).max())
    near = (sig_ref - OCC_THRESHOLD).abs() <= OCC_EPS * OCC_THRESHOLD
    differ = occ_mod.unpack_bits(last_grid["bits"]) \
        != occ_mod.unpack_bits(plain_grid["bits"])
    if sig_err > TOL or bool((differ & ~near).any()):
        fail(f"train_runtime: the last refresh differs from the plain "
             f"versions': sigma {sig_err} relative, {int(differ.sum())} "
             f"cells ({int((differ & ~near).sum())} away from the "
             f"threshold)")
    runtime["occupancy"] = {
        "steps": RUNTIME_OCC_STEPS, "res": OCC_RES,
        "threshold": OCC_THRESHOLD, "refresh_steps": [
            TRAIN_CHUNK * (i + 1) - 1 for i in range(len(refreshes))],
        "occupied_fraction": [occ_mod.occupied_fraction(r[2])
                              for r in refreshes],
        "sigma_max": [float(r[2]["sigma"].max()) for r in refreshes],
        "loss_first": rows[0]["loss"], "loss_last": rows[-1]["loss"],
        "fresh_sigma_max": float(fresh_ref.max()),
        "fresh_vs_plain_sigma_rel_err": fresh_err,
        "last_refresh_vs_plain_sigma_rel_err": sig_err, "tol": TOL,
        "cells_differing": int(differ.sum()),
        "cells_near_threshold": int(near.sum()), "eps": OCC_EPS}
    del refreshes, prev, last_params, last_grid, plain_grid, trained_occ, \
        fresh, fresh_ref
    emit({"phase": "train_runtime", "config": cfg.name, "batch": TRAIN_BATCH,
          "topk_frac": TOPK_FRAC, "accum_tol": ACCUM_TOL, **runtime,
          "launches": runtime_launches, **gpu})
    if min(runtime_launches[k] for k in tpath["nerf"]) <= 0:
        fail(f"train_runtime: a kernel of the training path never launched: "
             f"{runtime_launches}")

    # ----------------------------------------------------------- resume
    resume_line, resume_launches = resume_phase(
        cfg, gcfg, dev, clone_tree, nerf_init, nerf_batch, nerf_loss, gpu)
    emit(resume_line)

    # ----------------------------------------------------------- report
    # kernel -> (source, TPU kernel it replaces, path its launches are
    # read from, launches on that path, variant of the row's own numbers)
    paths = {"serve": launches, "serve_quant": qlaunches,
             "serve_gia": glaunches, "serve_nsdf": nlaunches,
             "unfused": unfused_launches, "train": train_launches,
             "serve_occ": olaunches, "train_runtime": runtime_launches,
             "resume": resume_launches}
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
        # no TPU kernel: the JAX package's encode VJP is XLA
        "encode_bwd": ("src/repro_torch/csrc/encode_bwd.cu",
                       "src/repro/kernels/hashgrid/vjp.py:27",
                       "train", train_launches, "f32"),
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
