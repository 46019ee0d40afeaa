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
           on it, and full-width bf16 mamba2 must launch ssd_intra_bwd
           once a layer and step and ssd_intra_fwd once or twice (its
           launches are the SSD rows' of the final ``kernels`` line). The
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
     ssd   Mamba-2's intra-chunk SSD at one granite-4.0-h-small layer's
           shape (2 x 8,192 tokens in chunks of 256, 128 heads of 64):
           ssd_intra_fwd and ssd_intra_bwd (one launch each, the counts
           set to 0 first) against the plain term and autograd through it
           (y within one bf16 step, each gradient within SSD_GRAD_TOL of
           its largest value) and the backward against its f32 twin
           (within SSD_TWIN_TOL of each gradient's largest value, dCB and
           dx beside one bf16 step), each kernel's device time beside its
           counted bound, on one chunk and head and the plain route's, and
           its registers, shared memory and blocks per SM; these numbers
           are the two kernels' rows of the final ``kernels`` line
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
  unfused_serve  the two serve scenes through an engine on the unfused
           route (``RenderSettings(fused=False)``), the same 120 requests:
           encode_fwd once and mlp_fwd twice a request, field_fwd never;
           p50 and Mpix/s beside the fused stream's; its 32x32 frame against
           the fused engine's (TOL) and the CPU's (PARITY_TOL); then 8 steps
           of ``train_field(fused=False)`` on nerf (the loss must fall) and
           the first step's gradients against the fused route's
           (TRAIN_PARITY_TOL)
  trace    the serve engine with the process tracer off (no event) and on,
           8 rounds of 20 requests each, in turns (off, on, on, off, ...):
           on, each request's 4 serve.<phase> spans, its serve.tile device
           interval and each phase it names as a host span and a device
           interval, all with its req, and serve.backpressure at most once
           a request past max_inflight; the median p50 with it on within
           the off rounds' spread (or 20% of their median); the host cost
           of one tracer event and of the tracer in the engine a request;
           annotate's calls a request and their cost;
           one torch.profiler window (CPU + CUDA) that must show the
           encode_mlp, mlp, raymarch and composite ranges, with the device
           time under each; a training run's engine snapshot, validated
           against the checked-in schema, with train.steps, train.step_s,
           health.step_s.host0 and health.silent_hosts
  serve_shard  the serve phase's scenes and 120 requests through a
           RenderEngine on a mesh of 4 pixel shards (4 cards where there
           are 4, else the one card 4 times): field_fwd, mlp_fwd and
           composite_fwd 4 times a request; p50, p90 and Mpix/s beside the
           serve phase's; the 32x32 frame within 1e-6 of the unsharded
           engine's and PARITY_TOL of the CPU render; the gather's device
           time; one gia f32 Table-I scene on the mesh, each shard on the
           stack's device reading the stack's own 2 GiB tables (the same
           data_ptr), its frame within 1e-6 of the unsharded tile's
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
  serve_shard_occ  serve_occ's culled scenes and requests on the 4-shard
           mesh, 8,192 of the 32,768 samples a shard: the summed live share
           and dropped samples beside serve_occ's, the shards' own rows of
           the first requests; an all-occupied culled frame on the mesh
           equal bit for bit to serve_shard's dense frame
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
           SIGKILLed after its first commit (every step directory
           committed, latest_step the last commit, a temporary directory
           only for a save the kill cut short), resumed to 48; every
           resumed loss
           within max(4 x the noise, 1e-5 of the loss) of the first run's;
           the checkpoint's bytes and the seconds each save blocked; then
           gia's 6 GiB train state saved and restored once when the disk
           has room for it
  train_dp  nerf data-parallel over the mesh of the sharded phases (4
           shards: 4 cards where there are 4, else the one card 4 times):
           the first step's loss and gradients against the unsharded step
           (TRAIN_PARITY_TOL), 16 steps of ``train_field(mesh=)`` whose
           loss must fall, ms per step beside the unsharded run's, each
           training kernel 4 times a step, peak memory
  elastic  nerf on that mesh, saving every 8 steps: two uninterrupted
           48-step runs (the noise); a run whose second host (shards 2
           and 3) stops beating, so the health stack's FailurePolicy emits
           a FailureEvent at the step-15 chunk end, which stops it;
           ``remesh_plan(2, 4, 1)`` == (2, 1, 2); ``recover`` onto 2 shards
           restores the step-15 state bit for bit; it goes on with
           grad_accum=2 to step 48, every loss within the resume phase's
           bound of the uninterrupted run's
  launch   ``python -m repro_torch.launch.serve`` in a child process, four
           times: at its defaults (gia, hash, 2^14 tables, 150 steps, 2
           scenes, 8 requests), ``--app nerf --occupancy``,
           ``--app nsdf --quant int8`` and ``--shard`` (its 1 x 1 local
           mesh; it must serve as many requests as the defaults), each
           with ``--trace-out`` and
           ``--metrics-out``: exit code 0, every stdout line one JSON
           object, ``served`` with 8 requests and finite p50 and Mpix/s, one
           tile function per bucket, the snapshot valid against the schema,
           the trace a valid Chrome trace whose serve.submit, dispatch,
           block and slice events number what the histograms count; wall
           seconds and p50 of each
  launch_apps  ``serve_render`` in this process for each app and encoding
           (12 runs) at Table-I width (``log2_table_size=None``), 2 scenes
           of 16 training steps each, 8 requests: scene 0's first and last
           loss (it must fall), p50, Mpix/s, and the launches of
           field_fwd, encode_fwd and encode_bwd (> 0), mlp_fwd (> 0 for
           nerf) and composite_fwd (> 0 for nerf and nvr)
  examples  the twins of the JAX examples (``examples/torch/``), each in
           a child at its defaults on the card: quickstart's and
           train_nerf's PSNR within 1.0 dB of the JAX example's (measured
           on the CPU by ``tools/jax_example_psnr.py``), serve_render's
           ``served`` event (p50, Mpix/s); the kernels each twin runs must
           launch (counts written by the child at exit)

then the ``{"kernels": [...]}`` line (every kernel, launches from the path
that runs it and per path, ``train`` among them, ``floor_ms``, the rows of other table types,
apps and layouts under ``variants``), the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}`` last. Any
failure exits non-zero before that line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Needs one CUDA
GPU and the CUDA toolkit (nvcc); imports nothing of JAX.
"""
import collections
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
# the grids of Table I besides the hash grid: dense (L=8, F=2) and tiled
# (L=2, F=8); their MLPs take L*F = 16 inputs
GRID_VARIANTS = ("dense", "tiled")
UNFUSED_TRAIN_STEPS = 8      # train_field(fused=False) on nerf
LAUNCH_REQUESTS = 8          # the launcher's default stream
LAUNCH_APPS_STEPS = 16       # training steps per scene in launch_apps
LAUNCH_TIMEOUT_S = 300
TRACE_ROUNDS = 8             # rounds of the tracer off and on, in turns
# the tracer on must keep p50 within the host's spread with it off: the
# range of the off rounds' p50s, or this share of their median if larger
TRACE_P50_SLACK = 0.2
# the phases obs.trace.annotate names in torch.profiler traces
PHASES = ("encode", "mlp", "encode_mlp", "raymarch", "compact", "composite",
          "host")
SERVE_PHASES = ("submit", "dispatch", "block", "slice")
# the sharded phases: the pixel or batch shards of their mesh; the sharded
# frame against the unsharded one (the JAX engine test's bar: the same
# kernels on each ray, point and row, whatever the tile's size)
SHARDS = 4
SHARD_TOL = 1e-6
DP_STEPS = 16                # train_field(mesh=) on nerf
ELASTIC_STEPS = 48           # the elastic phase's uninterrupted runs
ELASTIC_SAVE = 8             # its checkpoints' interval
ELASTIC_LOST = 15            # the chunk end where the lost host shows
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


def phase_device_ms(prof):
    """{phase: {ranges, device_ms, gpu_span_ms}} of one trace's
    ``annotate`` ranges: ``ranges`` and ``device_ms`` (the device time of
    the work the profiler links to them) count the outermost range of each
    name (a composite range inside a composite range counts once);
    ``gpu_span_ms`` is the union of the ranges' device-side mirrors, each
    from its first kernel's start to its last kernel's end."""
    import torch
    out, spans = {}, {}
    for ev in prof.events():
        if ev.name not in PHASES:
            continue
        row = out.setdefault(ev.name, {"ranges": 0, "device_ms": 0.0})
        if ev.device_type != torch.autograd.DeviceType.CPU:
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start / 1e3, ev.time_range.end / 1e3))
            continue
        parent = ev.cpu_parent
        if parent is not None and parent.name == ev.name:
            continue
        row["ranges"] += 1
        row["device_ms"] += ev.device_time_total / 1e3
    for name, row in out.items():
        row["gpu_span_ms"] = union_ms(spans.get(name, []))
    return out


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


# the launcher's child: runs the module as ``python -m`` does, then writes
# its kernels' launch counts to a file
LAUNCH_CHILD = """
import json, runpy, sys
sys.path.insert(0, {src!r})
sys.argv = ["repro_torch.launch.serve"] + {argv!r}
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__",
                     alter_sys=True)
finally:
    from repro_torch import kernels
    with open({launches!r}, "w") as f:
        json.dump(kernels.launch_counts(), f)
"""


def annotate_calls(run):
    """Calls of ``obs.trace.annotate`` that ``run()`` makes, by phase name
    (a ``collections.Counter``), counted through every module of the port
    that imported it."""
    from repro_torch.obs import trace as ttrace
    real, n = ttrace.annotate, collections.Counter()

    def counting(name):
        n[name] += 1
        return real(name)
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.")
            and getattr(m, "annotate", None) is real]
    for m in mods:
        m.annotate = counting
    try:
        run()
    finally:
        for m in mods:
            m.annotate = real
    return n


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
    step_dirs = [p for p in os.listdir(d2) if p.startswith("step_")]
    committed = sorted(int(p.split("_")[1]) for p in step_dirs
                       if os.path.exists(os.path.join(d2, p,
                                                      ckpt_store.MANIFEST)))
    # a kill during a save leaves that save's temporary directory (the
    # store commits by renaming it; latest_step never reads it): one may
    # be left, for a step after the last commit only
    temps = [p for p in os.listdir(d2) if p.startswith(".tmp_step_")]
    temp_steps = [int(re.match(r"\.tmp_step_(\d+)_", p).group(1))
                  for p in temps]
    last = ckpt_store.latest_step(d2)
    if len(committed) != len(step_dirs) or last != committed[-1] \
            or last >= RESUME_STEPS - 1 \
            or any(t <= last for t in temp_steps):
        fail(f"resume: after the kill: step directories {step_dirs}, "
             f"committed {committed}, latest_step {last}, temporary "
             f"directories {temps}")
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
                       "worst_over_bound": worst2,
                       "temp_dirs_of_steps": temp_steps},
            "gia_state": gia, "launches": launches, **gpu}, launches


def card_mesh(n=None):
    """The mesh of the sharded phases: SHARDS shards, over that many
    cards where there are as many, else the one card repeated (its shards
    then run one after another on it, as the JAX package's tests run
    shards on forced host devices)."""
    import torch
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    n = n or SHARDS
    if torch.cuda.device_count() >= n:
        return make_local_mesh(n)
    return Mesh([torch.device("cuda", 0)] * n, ("data",))


def mesh_info(mesh):
    return {"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]}


def serve_shard_phase(serve, mesh, settings, cfg, scene_params, reqs,
                      dense_line, pcam, dense_frame, cpu_frame, gcfg, gia_p,
                      dev, gpu):
    """The ``serve_shard`` phase: (its JSON line, the kernels' launches in
    its stream, its 32x32 frame).

    The serve phase's two nerf scenes and 120 requests through a
    RenderEngine on ``mesh``: each kernel of the path launches once per
    shard a request; p50, p90 and Mpix/s beside the unsharded stream's;
    the 32x32 frame within SHARD_TOL of the unsharded engine's and
    PARITY_TOL of the CPU render; the gather's device time; then one gia
    f32 Table-I scene served on the mesh, every shard's replica of its
    2 GiB tables at the stack's own address where the shard runs on the
    stack's device (no copy), its frame within SHARD_TOL of the
    unsharded tile on the card."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import pipeline
    from repro_torch.launch.mesh import shard_devices
    from repro_torch.serve import RenderEngine, sharding

    shards = sharding.pixel_shard_count(mesh)
    engine = RenderEngine(settings, mesh=mesh, device=dev)
    for s, p in enumerate(scene_params):
        engine.add_scene(f"scene{s}", cfg, p)
    _, launches, line = serve(engine, ["scene0", "scene1"], "serve_shard",
                              reqs=reqs)
    want = {k: shards * len(reqs) for k in ("field_fwd", "mlp_fwd",
                                            "composite_fwd")}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"serve_shard: launches {launches}, want {want}")
    frame = engine.render_frame("scene0", pcam)
    to_dense = float(np.abs(frame - dense_frame).max())
    to_cpu = float(np.abs(frame - cpu_frame).max())
    if not np.isfinite(frame).all() or to_dense > SHARD_TOL \
            or to_cpu > PARITY_TOL:
        fail(f"serve_shard: the sharded frame differs from the unsharded "
             f"engine's by {to_dense} (tol {SHARD_TOL}) and from the CPU "
             f"render by {to_cpu} (tol {PARITY_TOL})")
    # the gather alone: the shards' pieces of one tile's pixels copied to
    # the first device and joined in shard order
    per = settings.tile_pixels // shards
    pieces = [torch.rand((per, 3), device=d) for d in
              shard_devices(mesh)]
    first = mesh.devices[0]
    gather_ms = device_ms(lambda: torch.cat([p.to(first) for p in pieces]),
                          reps=20)
    del engine, pieces

    # gia: one Table-I f32 scene (2 GiB of tables) on the mesh
    gengine = RenderEngine(settings, mesh=mesh, device=dev)
    key = gengine.add_scene("gia0", gcfg, gia_p)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    gengine.warmup()
    stacked = gengine._get_stacked(key)
    fn = gengine._buckets[key].fn
    torch.cuda.synchronize()
    stack_bytes = stacked["grid"].numel() * stacked["grid"].element_size()
    extra = torch.cuda.memory_allocated(dev) - mem0 - stack_bytes
    shared = {str(d): fn.replicas[d]["grid"].data_ptr()
              == stacked["grid"].data_ptr() for d in fn.devices}
    if any(not shared[str(d)] for d in fn.devices if d == dev):
        fail(f"serve_shard: a shard on the stack's device reads a copy of "
             f"gia's tables: {shared}")
    gframe = gengine.render_frame("gia0", pcam)
    gref = pipeline.render_frame(gia_p, gcfg, pcam, settings,
                                 device=dev).cpu().numpy()
    gerr = float(np.abs(gframe - gref).max())
    if not np.isfinite(gframe).all() or gerr > SHARD_TOL:
        fail(f"serve_shard: the sharded gia frame differs from the "
             f"unsharded tile's by {gerr}")
    del gengine, stacked, fn
    line.update(
        mesh=mesh_info(mesh), shards=shards,
        launches_per_request={k: launches[k] / len(reqs) for k in want},
        unsharded={k: dense_line[k] for k in ("p50_ms", "p90_ms",
                                              "mpix_per_s", "launches")},
        frame_max_abs_diff_to_unsharded=to_dense, frame_max_abs_err_cpu=to_cpu,
        tol=SHARD_TOL, parity_tol=PARITY_TOL, gather_ms=gather_ms,
        gia={"replica_shares_stack": shared,
             "stack_bytes": stack_bytes,
             "allocated_beyond_the_stack_bytes": extra,
             "frame_max_abs_diff_to_unsharded": gerr})
    return line, launches, frame


def serve_shard_occ_phase(serve, mesh, occ_settings, cfg, scene_params,
                          oreqs, occ_line, shard_frame, p0, grid, pcam, dev,
                          gpu):
    """The ``serve_shard_occ`` phase: (its JSON line, the launches in its
    stream).

    serve_occ's two culled nerf scenes and requests on ``mesh``, each
    shard with a share of the budget (OCC_BUDGET / shards): the summed
    live share and dropped samples beside the unsharded stream's, the
    per-shard rows of the first requests; then an all-occupied grid at
    the full budget: the culled sharded frame equals the dense sharded
    frame bit for bit."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import occupancy as occ_mod
    from repro_torch.serve import RenderEngine, sharding

    shards = sharding.pixel_shard_count(mesh)
    engine = RenderEngine(occ_settings, mesh=mesh, device=dev)
    keys = [engine.add_scene(f"scene{s}", cfg, p)
            for s, p in enumerate(scene_params)]
    _, launches, line = serve(engine, ["scene0", "scene1"],
                              "serve_shard_occ", reqs=oreqs)
    want = {k: shards * len(oreqs) for k in ("field_fwd", "mlp_fwd",
                                             "composite_fwd")}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"serve_shard_occ: launches {launches}, want {want}")
    st = engine.stats()
    # the shards' own rows for the first requests, through the bucket's
    # sharded tile function
    fn, stacked = engine._buckets[keys[0]].fn, engine._get_stacked(keys[0])
    rows = torch.zeros((shards, 3), dtype=torch.float64)
    for r in oreqs[:PROFILE_REQUESTS]:
        if r.scene != "scene0":
            continue
        ids = torch.from_numpy(np.asarray(r.pixel_ids, np.int64)).to(dev)
        mask = torch.ones(ids.shape[0], dtype=torch.bool, device=dev)
        rows += fn(stacked, 0, r.camera, ids, mask, ids.shape[0])[1].cpu()
    del engine, fn, stacked
    aengine = RenderEngine(dataclasses.replace(occ_settings,
                                               sample_budget=None),
                           mesh=mesh, device=dev)
    aengine.add_scene("scene0", cfg, occ_mod.attach(
        p0, occ_mod.all_occupied(OCC_RES, dev)))
    all_frame = aengine.render_frame("scene0", pcam)
    if not np.array_equal(all_frame, shard_frame):
        fail(f"serve_shard_occ: the all-occupied culled frame differs from "
             f"the dense sharded frame by "
             f"{float(np.abs(all_frame - shard_frame).max())}")
    del aengine
    line.update(
        mesh=mesh_info(mesh), shards=shards, sample_budget=OCC_BUDGET,
        shard_budget=occ_settings.tile_budget(
            occ_settings.tile_pixels // shards),
        live_sample_frac=st["live_sample_frac"],
        samples_total=st["samples_total"],
        samples_dropped=st["samples_dropped"],
        effective_mpix_per_s=st["effective_mpix_per_s"],
        launches_per_request={k: launches[k] / len(oreqs) for k in want},
        shard_rows_scene0_first_requests=rows.tolist(),
        all_occupied_equals_dense_sharded=True,
        unsharded={k: occ_line[k] for k in (
            "p50_ms", "p90_ms", "mpix_per_s", "live_sample_frac",
            "samples_total", "samples_dropped")})
    return line, launches


def train_dp_phase(mesh, cfg, dev, nerf_init, nerf_batch, nerf_loss,
                   unsharded_ms, gpu):
    """The ``train_dp`` phase: (its JSON line, the launches in it).

    nerf at Table-I width, TRAIN_BATCH rays x 32 samples a step, data
    parallel over ``mesh``: the first step's loss and gradients against
    the unsharded step's (TRAIN_PARITY_TOL of each leaf's max), then
    DP_STEPS steps of train_field(mesh=) whose loss must fall, ms per
    step beside the unsharded run's, launches per step (each kernel of
    the training path once per shard a step) and the peak memory."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import train as ctrain
    from repro_torch.serve import sharding
    from repro_torch.train import loop as tloop

    shards = sharding.pixel_shard_count(mesh)
    init = nerf_init()
    batch = nerf_batch(0)
    l1, g1 = tloop.value_and_grad(nerf_loss, init, batch)
    ln, gn = tloop.data_parallel_grad_fn(nerf_loss, mesh)(init, batch)
    plain = dict(tree_items(g1))
    leaves = {path: rel_err(g, plain[path])[1] for path, g in tree_items(gn)}
    loss_rel = abs(float(ln) - float(l1)) / abs(float(l1))
    if loss_rel > TRAIN_PARITY_TOL or max(leaves.values()) \
            > TRAIN_PARITY_TOL or min(float(v.abs().max())
                                      for v in plain.values()) <= 0:
        fail(f"train_dp: the sharded first step differs from the unsharded "
             f"one: loss {loss_rel}, leaves {leaves}")
    del g1, gn, plain, batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem_before = torch.cuda.memory_allocated(dev)
    rows = []
    K.reset_launch_counts()       # the DP path's run alone from here
    ctrain.train_field(cfg, steps=DP_STEPS, batch_size=TRAIN_BATCH,
                       seed=SEED, chunk_steps=TRAIN_CHUNK,
                       gt_samples=GT_SAMPLES, device=dev, mesh=mesh,
                       params=init, on_metrics=lambda i, r, st: rows.append(r))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    per_step = {k: launches[k] / DP_STEPS for k in launches}
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train_dp: the loss did not fall: {losses}")
    path = ("field_fwd", "mlp_fwd", "encode_fwd", "encode_bwd")
    if any(per_step[k] != shards for k in path) \
            or per_step["composite_fwd"] != 0:
        fail(f"train_dp: {path} must launch {shards} times a step and "
             f"composite_fwd never: {per_step}")
    line = {"phase": "train_dp", "config": cfg.name, "mesh": mesh_info(mesh),
            "shards": shards, "batch": TRAIN_BATCH,
            "rays_per_shard": TRAIN_BATCH // shards, "steps": DP_STEPS,
            "first_step": {"loss_rel_err": loss_rel, "leaves": leaves,
                           "tol": TRAIN_PARITY_TOL},
            "loss_first": losses[0], "loss_last": losses[-1],
            "ms_per_step": 1e3 * float(np.mean(
                [r["dt"] for r in rows[TRAIN_CHUNK:]])),
            "ms_per_step_unsharded": unsharded_ms,
            "launches_per_step": per_step,
            "mem_before_bytes": mem_before,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), **gpu}
    del init
    torch.cuda.empty_cache()
    return line, launches


class _HostLost(Exception):
    """Raised by the elastic phase's failure handler to stop the run."""


def elastic_phase(mesh, cfg, dev, nerf_init, nerf_batch, nerf_loss, gpu):
    """The ``elastic`` phase: (its JSON line, the launches in it).

    nerf on ``mesh`` (4 shards, two hosts of two), checkpoints every
    ELASTIC_SAVE steps: two uninterrupted ELASTIC_STEPS runs give the
    card's run-to-run noise; in a third run the second host beats at the
    first chunk end only, so at the step-ELASTIC_LOST chunk end the
    health stack's FailurePolicy emits a FailureEvent, which stops it; remesh_plan(2, 4, 1) must be (2, 1, 2);
    ``recover`` restores the newest checkpoint onto the 2-shard mesh, bit
    for bit the saved state, and the run goes on with grad_accum=2 (the
    same global batch) to ELASTIC_STEPS, every resumed loss within the
    resume phase's bound of the first uninterrupted run's."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.core import train as ctrain
    from repro_torch.runtime import elastic
    from repro_torch.runtime.health import HeartbeatMonitor
    from repro_torch.train import loop as tloop
    from repro_torch.train import optim as toptim

    root = os.path.join(ROOT, "build", "chip_smoke_elastic")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    opt = toptim.AdamConfig(lr=1e-2)      # train_field's
    K.reset_launch_counts()

    def losses():
        rows = []
        ctrain.train_field(cfg, steps=ELASTIC_STEPS, batch_size=TRAIN_BATCH,
                           seed=SEED, chunk_steps=TRAIN_CHUNK,
                           gt_samples=GT_SAMPLES, device=dev, mesh=mesh,
                           on_metrics=lambda i, r, st: rows.append(r["loss"]))
        return rows
    a, b = losses(), losses()
    noise = max(abs(x - y) for x, y in zip(a, b))

    clock = [0.0]
    mon = HeartbeatMonitor(timeout_s=5.0, clock=lambda: clock[0])

    def beat(end, state):        # host0 drives the engine; host1 goes quiet
        clock[0] += 10.0
        mon.beat("host0")
        if end < ELASTIC_LOST:
            mon.beat("host1")
    events, saved = [], {}

    def lost(ev):
        events.append(ev)
        raise _HostLost

    def grab(i, row, state):
        if i == ELASTIC_LOST:
            saved.update({k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in ckpt_store._flatten(state)})
    d = os.path.join(root, "ckpt")
    engine = tloop.TrainEngine(
        tloop.EngineConfig(steps=ELASTIC_STEPS, chunk_steps=TRAIN_CHUNK,
                           ckpt_dir=d, ckpt_every=ELASTIC_SAVE,
                           host="host0"),
        tloop.make_scanned_step(nerf_loss, opt, mesh=mesh),
        batch_fn=nerf_batch, monitor=mon, on_chunk_end=beat, on_event=lost)
    try:
        engine.run(tloop.init_train_state(nerf_init()), on_metrics=grab)
        fail("elastic: the run ended without a FailureEvent")
    except _HostLost:
        pass
    ev = events[0] if events else None
    if ev is None or (ev.kind, ev.hosts, ev.step) != (
            "dead", ("host1",), ELASTIC_LOST) \
            or ckpt_store.latest_step(d) != ELASTIC_LOST:
        fail(f"elastic: events {events}, latest checkpoint "
             f"{ckpt_store.latest_step(d)}")
    plan = elastic.remesh_plan(2, 4, 1)
    if (plan.data, plan.model, plan.microbatch_multiplier) != (2, 1, 2):
        fail(f"elastic: remesh_plan(2, 4, 1) gave {plan}")
    t0 = time.perf_counter()
    mesh2, step_fn, state, step = elastic.recover(
        d, tloop.init_train_state(nerf_init()), plan,
        devices=mesh.devices,
        make_step=lambda m, rules: tloop.make_scanned_step(
            nerf_loss, opt, grad_accum=plan.microbatch_multiplier, mesh=m,
            rules=rules))
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    restored = dict(ckpt_store._flatten(state))
    if step != ELASTIC_LOST or restored.keys() != saved.keys() or not all(
            torch.equal(restored[k], v) if torch.is_tensor(v)
            else restored[k] == v for k, v in saved.items()):
        fail("elastic: the recovered state is not the saved one bit for bit")
    del saved, restored
    resumed = []
    tloop.TrainEngine(
        tloop.EngineConfig(steps=ELASTIC_STEPS, chunk_steps=TRAIN_CHUNK,
                           ckpt_dir=d, ckpt_every=ELASTIC_SAVE),
        step_fn, batch_fn=nerf_batch).run(
        state, on_metrics=lambda i, r, st: resumed.append((i, r["loss"])))
    if [i for i, _ in resumed] != list(range(ELASTIC_LOST + 1,
                                             ELASTIC_STEPS)):
        fail(f"elastic: the recovered run ran steps "
             f"{[i for i, _ in resumed]}")
    worst = 0.0
    for i, x in resumed:
        bound = max(RESUME_NOISE_FACTOR * noise, RESUME_FLOOR * abs(a[i]))
        worst = max(worst, abs(x - a[i]) / bound)
        if abs(x - a[i]) > bound:
            fail(f"elastic: step {i} loss {x} vs uninterrupted {a[i]}: "
                 f"over the bound {bound}")
    launches = K.launch_counts()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"phase": "elastic", "config": cfg.name,
            "mesh": mesh_info(mesh), "recovered_mesh": mesh_info(mesh2),
            "steps": ELASTIC_STEPS, "save_every": ELASTIC_SAVE,
            "event": {"kind": ev.kind, "hosts": list(ev.hosts),
                      "step": ev.step},
            "plan": {"data": plan.data, "model": plan.model,
                     "microbatch_multiplier": plan.microbatch_multiplier},
            "recovered_step": step, "recover_s": recover_s,
            "restored_equal": True, "noise_max": noise,
            "bound": {"noise_factor": RESUME_NOISE_FACTOR,
                      "floor": RESUME_FLOOR},
            "worst_over_bound": worst, "resumed_from": ELASTIC_LOST + 1,
            "launches": launches, **gpu}, launches


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


# the examples phase: each twin of examples/torch/ in a child at its
# defaults, which writes its kernels' launch counts to a file at exit
EXAMPLE_CHILD = """
import json, runpy, sys
sys.argv = [{script!r}]
try:
    runpy.run_path({script!r}, run_name="__main__")
finally:
    sys.path.insert(0, {src!r})
    from repro_torch import kernels
    with open({launches!r}, "w") as f:
        json.dump(kernels.launch_counts(), f)
"""
EXAMPLE_TIMEOUT_S = 300
# The JAX examples' PSNRs at their defaults (seed 0) and with training seed
# 1, on the CPU: tools/jax_example_psnr.py --example <name> --seed 0|1.
# The twins' random numbers are PyTorch's, so a twin lands within the JAX
# seeds' spread (0.3 and 0.0 dB), bounded here at PSNR_BOUND_DB.
# train_nerf's frame is all black in both packages (nerf's density
# collapses at lr 1e-2: a black frame's PSNR, 16.9 dB).
JAX_EXAMPLE_PSNR = {"quickstart": (27.7, 27.4), "train_nerf": (16.9, 16.9)}
PSNR_BOUND_DB = 1.0
PSNR_LINE = re.compile(r"(?:reconstruction|novel-view) PSNR[^:]*: "
                       r"(-?[0-9.]+) dB")


def examples_phase(kernel_names, gpu):
    """Each twin (``examples/torch/``) in a child at its defaults on the
    card: quickstart and train_nerf's PSNR within PSNR_BOUND_DB of the JAX
    example's (seed 0), serve_render's ``served`` event; the kernels each
    must launch. Returns (phase line, launches summed over the twins)."""
    import numpy as np
    out_dir = os.path.join(ROOT, "build", "chip_smoke_examples")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    need = {"quickstart": ("field_fwd", "encode_fwd", "encode_bwd"),
            "train_nerf": ("field_fwd", "mlp_fwd", "encode_fwd",
                           "encode_bwd", "composite_fwd"),
            "serve_render": ("field_fwd", "encode_fwd", "encode_bwd")}
    total = dict.fromkeys(kernel_names, 0)
    runs = {}
    t_phase = time.perf_counter()
    for name, must in need.items():
        script = os.path.join(ROOT, "examples", "torch", f"{name}.py")
        launches = os.path.join(out_dir, f"{name}_launches.json")
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [sys.executable, "-c", EXAMPLE_CHILD.format(
                    script=script, src=SRC, launches=launches)],
                capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S,
                cwd=out_dir)
        except subprocess.TimeoutExpired:
            fail(f"examples[{name}]: no exit within {EXAMPLE_TIMEOUT_S} s")
        wall_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"examples[{name}]: exit code {out.returncode}: "
                 f"{out.stderr[-3000:]}")
        with open(launches) as f:
            counts = json.load(f)
        for k, n in counts.items():
            total[k] += n
        if min(counts[k] for k in must) <= 0:
            fail(f"examples[{name}]: {must} must launch: {counts}")
        row = {"wall_s": wall_s, "launches": counts}
        if name in JAX_EXAMPLE_PSNR:
            found = PSNR_LINE.findall(out.stdout)
            if len(found) != 1:
                fail(f"examples[{name}]: no PSNR line: {out.stdout[-2000:]}")
            jax0, jax1 = JAX_EXAMPLE_PSNR[name]
            row.update(psnr_db=float(found[0]), jax_psnr_db=[jax0, jax1],
                       bound_db=PSNR_BOUND_DB)
            if not abs(row["psnr_db"] - jax0) <= PSNR_BOUND_DB:
                fail(f"examples[{name}]: PSNR {row['psnr_db']} dB, the JAX "
                     f"example's {jax0} dB (bound {PSNR_BOUND_DB})")
        else:
            served = [json.loads(l) for l in out.stdout.splitlines()
                      if l.startswith("{") and '"served"' in l]
            if len(served) != 1 or not all(
                    np.isfinite(served[0].get(k, np.nan))
                    for k in ("p50_ms", "mpix_per_s")):
                fail(f"examples[{name}]: served {served}")
            row.update({k: served[0][k] for k in (
                "n_requests", "p50_ms", "p99_ms", "mpix_per_s", "compiles")})
        runs[name] = row
    shutil.rmtree(out_dir, ignore_errors=True)
    return ({"phase": "examples", "seconds": time.perf_counter() - t_phase,
             "runs": runs, "launches": total, **gpu}, total)

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
    from repro_torch.launch.roofline import H100_SXM
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

    def bound(w):
        t_bytes = w["bytes"] / H100_SXM["hbm_bw"] * 1e3
        t_ops = max(w["bf16_flops"] / H100_SXM["peak_flops_bf16"],
                    w["flops"] / H100_SXM["peak_flops_f32"]) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    fwd_bound, fwd_by = bound(fwd_w)
    bwd_bound, bwd_by = bound(bwd_w)
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
    return {"phase": "ssd", **sh, "y_max_abs_err": y_err,
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


def ssd_results(line):
    """The ``kernels`` rows' numbers of ``ssd_intra_fwd`` and
    ``ssd_intra_bwd`` from ``ssd_phase``'s line, keyed as ``results``:
    the forward's error is y's against the plain term, the backward's the
    largest of its gradients' against the f32 twin."""
    return {(name, None): {
        "max_abs_err": err, "ms": line[f"{k}_ms"],
        "floor_ms": line[f"{k}_floor_ms"],
        "plain_ms": line[f"plain_{k}_ms"],
        "bound_ms": line[f"{k}_bound_ms"], "bound_by": line[f"{k}_bound_by"],
        "library_ms": None}
        for name, k, err in (
            ("ssd_intra_fwd", "fwd", line["y_max_abs_err"]),
            ("ssd_intra_bwd", "bwd", max(line["twin_max_abs_err"].values())))}


# Mamba-2's intra-chunk SSD kernels (kernels/ssd): the LM paths take them
# for bf16 chunks on the card; no other kernel of the port runs on them
SSD_KERNELS = ("ssd_intra_fwd", "ssd_intra_bwd")


def non_ssd(launches):
    """The launches of kernels other than Mamba-2's SSD pair."""
    return {k: n for k, n in launches.items() if n and k not in SSD_KERNELS}


def ssd_launches_per_step(cfg, seq, dev):
    """``ssd_intra_bwd`` launches of one train step of ``cfg`` on rows of
    ``seq`` tokens on ``dev``: one a Mamba-2 layer where the kernels fit
    its SSD (``ssd.takes`` at the chunk ``apply_ssm`` runs), else 0."""
    from repro_torch.kernels.ssd.ssd import takes
    from repro_torch.models import ssm
    if cfg.ssm is None or not takes(dev, cfg.adtype, ssm.ssd_chunk(cfg, seq),
                                    cfg.ssm.head_dim):
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
        # ssd_intra_bwd a layer and step, one or two ssd_intra_fwd (the
        # forward, and the recompute under remat)
        want = ssd_launches_per_step(cfg, seq, dev) * (LM_TRAIN_STEPS + 1)
        if ssd["ssd_intra_bwd"] != want or ssd["ssd_intra_fwd"] not in (
                want, 2 * want):
            fail(f"lm_train[{arch}]: SSD launches {ssd} over "
                 f"{LM_TRAIN_STEPS + 1} steps, want {want} ssd_intra_bwd "
                 f"and as many or twice as many ssd_intra_fwd")
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
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.roofline import H100_SXM, kernel_ops_s
    from repro_torch.quant import QuantSpec, quantize_field
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.core import occupancy as occ_mod
    from repro_torch.core import train as ctrain
    from repro_torch.train import compression as tcomp
    from repro_torch.serve import RenderEngine, RenderRequest
    from repro_torch.train import loop as tloop
    from repro_torch.train import optim as toptim
    from repro_torch.launch import serve as lserve
    from repro_torch.obs import export as texport
    from repro_torch.obs import metrics as tmetrics
    from repro_torch.obs import trace as ttrace
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
    del runs, outputs, unfused_out, field_inputs, tiles, gqtab, nsdf_rand, \
        grid_scenes

    # ------------------------------------------------------------ serve
    settings = pipeline.RenderSettings(tile_pixels=TILE_PIXELS,
                                       n_samples=N_SAMPLES)
    cams = [scenes.orbit_camera(FRAME, FRAME, a) for a in (0.0, 2.1, 4.2)]

    def serve(engine, scene_names, phase, cams=cams, reqs=None):
        """120 random-pixel requests, scene_names and cameras in turn (or
        the given ``reqs``), with the launch counts of exactly this stream
        and the peak device memory allocated while it runs (every live
        tensor counts)."""
        torch.cuda.reset_peak_memory_stats(dev)
        warm_s = engine.warmup()
        if reqs is None:
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
    trace = trace_device

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
    cpu_frame = ref
    perr = float(np.abs(dense_frame - ref).max())
    if not np.isfinite(dense_frame).all() or perr > PARITY_TOL:
        fail(f"parity: engine vs CPU render_frame max abs error {perr}")
    emit({"phase": "parity", "frame": [32, 32], "max_abs_err": perr,
          "tol": PARITY_TOL, "mean_rgb": float(dense_frame.mean()), **gpu})

    # ---------------------------------------------------- unfused_serve
    # The two serve scenes on the unfused route (``RenderSettings(fused=
    # False)``: encode_fwd writes the features to device memory, mlp_fwd
    # reads them back, once per head), over the same 120 requests: the
    # paper's fused-against-unfused comparison at the engine level; then
    # nerf trained on that route.
    usettings = dataclasses.replace(settings, fused=False)
    uengine = RenderEngine(usettings, device=dev)
    for s_ in range(2):
        uengine.add_scene(f"scene{s_}", cfg, fields.from_jax_params(
            np_params(cfg, SEED + s_), cfg, dev))
    _, ulaunches, line = serve(uengine, ["scene0", "scene1"],
                               "unfused_serve", reqs=reqs)
    want = {"encode_fwd": N_REQUESTS, "mlp_fwd": 2 * N_REQUESTS,
            "field_fwd": 0, "field_fwd_q": 0, "composite_fwd": N_REQUESTS}
    if any(ulaunches[k] != n for k, n in want.items()):
        fail(f"unfused_serve: launches {ulaunches}, want {want}")
    ufr = uengine.render_frame("scene0", pcam)
    uerr = float(np.abs(ufr - dense_frame).max())
    if not np.isfinite(ufr).all() or float(np.max(
            np.abs(ufr - dense_frame) - TOL * np.abs(dense_frame))) > TOL:
        fail(f"unfused_serve: the frame differs from the fused engine's by "
             f"{uerr}")
    uref = pipeline.render_frame(cpu_params, cfg, pcam, usettings,
                                 device="cpu").numpy()
    ucpu = float(np.abs(ufr - uref).max())
    if ucpu > PARITY_TOL:
        fail(f"unfused_serve: engine vs CPU render_frame max abs error "
             f"{ucpu}")
    del uengine
    uinit = fields.init_field(cfg, torch.Generator().manual_seed(SEED), dev)
    urows = []
    K.reset_launch_counts()
    ctrain.train_field(cfg, steps=UNFUSED_TRAIN_STEPS, batch_size=TRAIN_BATCH,
                       seed=SEED, chunk_steps=TRAIN_CHUNK, fused=False,
                       gt_samples=GT_SAMPLES, device=dev, params=uinit,
                       on_metrics=lambda i, r, st: urows.append(r))
    torch.cuda.synchronize()
    utrain = K.launch_counts()
    ulosses = [r["loss"] for r in urows]
    if not all(np.isfinite(ulosses)) or not ulosses[-1] < ulosses[0]:
        fail(f"unfused_serve: the unfused route's loss did not fall: "
             f"{ulosses}")
    if utrain["field_fwd"] != 0 or min(
            utrain[k] for k in ("encode_fwd", "mlp_fwd", "encode_bwd")) <= 0:
        fail(f"unfused_serve: training launched {utrain}")
    ubatch = ctrain.make_batch(cfg, ctrain.batch_generator(SEED, 0, dev),
                               TRAIN_BATCH, scenes.default_camera(),
                               gt_samples=GT_SAMPLES)
    grads = {f: tloop.value_and_grad(
        lambda p, b_, f=f: ctrain.field_loss(p, cfg, b_, fused=f), uinit,
        ubatch)[1] for f in (True, False)}
    fused_leaves = dict(tree_items(grads[True]))
    ugrad = {path: rel_err(gu, fused_leaves[path])[1]
             for path, gu in tree_items(grads[False])}
    if max(ugrad.values()) > TRAIN_PARITY_TOL or min(
            float(v.abs().max()) for v in fused_leaves.values()) <= 0:
        fail(f"unfused_serve: the unfused route's first gradients differ "
             f"from the fused route's: {ugrad}")
    del uinit, grads, fused_leaves, ubatch
    ulaunches = {k: ulaunches[k] + utrain[k] for k in ulaunches}
    line.update(
        fused={k: dense_line[k] for k in ("p50_ms", "p90_ms", "mpix_per_s",
                                          "launches")},
        frame_max_abs_diff_to_fused=uerr, frame_max_abs_err_cpu=ucpu,
        tol=TOL, parity_tol=PARITY_TOL,
        train={"steps": UNFUSED_TRAIN_STEPS, "loss_first": ulosses[0],
               "loss_last": ulosses[-1], "ms_per_step": 1e3 * statistics.mean(
                   r["dt"] for r in urows),
               "launches": utrain, "grad_rel_err_vs_fused": ugrad,
               "grad_tol": TRAIN_PARITY_TOL})
    emit(line)

    # ------------------------------------------------------------ trace
    # The process tracer and the profiler ranges on the serve engine:
    # rounds of PROFILE_REQUESTS requests with the tracer off (no event)
    # and on, in turns: on, each request has its 4 serve.<phase> spans,
    # its serve.tile device interval and each phase it names (counted
    # with the tracer off) as a host span and a device interval, all
    # carrying its req, and a serve.backpressure span at most; the calls
    # to annotate a request makes and their host cost; the tracer's host
    # time in the engine; one torch.profiler window (CPU + CUDA) with the
    # phases as ranges and the device time under each; a training run's
    # engine snapshot.
    window = reqs[:PROFILE_REQUESTS]

    def run_window():
        tickets = [engine.submit(r) for r in window]
        engine.flush()
        return 1e3 * statistics.median(t.latency_s for t in tickets)

    phase_calls = annotate_calls(run_window)
    want = {f"serve/serve.{ph}": len(window) for ph in SERVE_PHASES}
    want["device:serve/serve.tile"] = len(window)
    for ph, k in phase_calls.items():
        want[f"phase/{ph}"] = want[f"device:phase/{ph}"] = k
    p50s, counts_on, waits_on = {"off": [], "on": []}, [], []
    try:
        for i in range(TRACE_ROUNDS):        # off, on, on, off, off, on, ...
            for mode in ("off", "on") if i % 2 == 0 else ("on", "off"):
                ttrace.TRACER.clear()
                if mode == "on":
                    ttrace.TRACER.enable()
                p50s[mode].append(run_window())
                ttrace.TRACER.disable()
                evs = ttrace.TRACER.events()
                if mode == "off" and evs:
                    fail(f"trace: the disabled tracer recorded {len(evs)} "
                         "events")
                if mode == "on":
                    counts = collections.Counter(
                        f"{e['cat']}/{e['name']}" for e in evs)
                    waits = [e["args"]["req"] for e in evs
                             if e["name"] == "serve.backpressure"]
                    del counts["serve/serve.backpressure"]
                    counts_on.append(dict(counts))
                    waits_on.append(len(waits))
                    reqs_on = {e["args"].get("req") for e in evs}
                    if len(reqs_on) != len(window) or None in reqs_on:
                        fail(f"trace: a round's events carry the ids "
                             f"{sorted(reqs_on, key=str)}, want one each of "
                             f"{len(window)} requests")
                    if len(set(waits)) != len(waits) or len(waits) > len(
                            window) - engine.max_inflight:
                        fail(f"trace: serve.backpressure for the requests "
                             f"{waits}: at most one each past max_inflight "
                             f"{engine.max_inflight}")
    finally:
        ttrace.TRACER.disable()
        ttrace.TRACER.clear()
    if any(c != want for c in counts_on):
        fail(f"trace: events per round {counts_on}, want {want}")
    off_med = statistics.median(p50s["off"])
    bound = max(max(p50s["off"]) - min(p50s["off"]),
                TRACE_P50_SLACK * off_med)
    if abs(statistics.median(p50s["on"]) - off_med) > bound:
        fail(f"trace: p50 with the tracer on {p50s['on']} is not within "
             f"{bound} ms of off {p50s['off']}")
    # the tracer's host time where the engine calls it, in one more window
    # with the tracer on: every entry point of the tracer, its spans and
    # its scopes timed (its events, phase spans, device events and
    # intervals), a call inside another once
    spent, depth = [0.0], [0]

    def timed(fn):
        def call(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            t_in = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t_in
                depth[0] -= 1
        return call
    patched = [(cls, name, getattr(cls, name)) for cls, names in (
        (ttrace.Tracer, ("span", "phase", "scope", "add_event",
                         "device_event", "add_interval")),
        (ttrace._Span, ("__enter__", "__exit__")),
        (ttrace._Scope, ("__enter__", "__exit__"))) for name in names]
    for cls, name, fn in patched:
        setattr(cls, name, timed(fn))
    ttrace.TRACER.enable()
    try:
        run_window()
    finally:
        ttrace.TRACER.disable()
        for cls, name, fn in patched:
            setattr(cls, name, fn)
        ttrace.TRACER.clear()
    in_situ_ms = 1e3 * spent[0] / len(window)
    if ttrace.annotate("a") is not ttrace.annotate("b"):
        fail("trace: annotate is not the shared null context without a "
             "profiler")
    calls = sum(phase_calls.values()) / len(window)
    t0 = time.perf_counter()
    for _ in range(100_000):
        with ttrace.annotate("encode"):
            pass
    annotate_us = (time.perf_counter() - t0) / 100_000 * 1e6
    scratch_tracer = ttrace.Tracer()
    scratch_tracer.enable()
    t0 = time.perf_counter()
    for _ in range(10_000):
        scratch_tracer.add_event("serve.submit", t0, t0, cat="serve",
                                 bucket=0, scene="scene0")
    add_event_us = (time.perf_counter() - t0) / 10_000 * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_window()
    phases = phase_device_ms(prof)
    missing = {"encode_mlp", "mlp", "raymarch", "composite"} - {
        k for k, row in phases.items() if row["ranges"]}
    if missing:
        fail(f"trace: no {sorted(missing)} ranges in the profiler trace: "
             f"{phases}")
    reg = tmetrics.Registry()
    ctrain.train_field(cfg, steps=2 * TRAIN_CHUNK, batch_size=TRAIN_BATCH,
                       seed=SEED, chunk_steps=TRAIN_CHUNK,
                       gt_samples=GT_SAMPLES, device=dev,
                       metrics_registry=reg)
    snap = reg.snapshot()
    texport.validate_snapshot(snap)
    host = "host0"
    if snap["counters"].get("train.steps") != 2 * TRAIN_CHUNK \
            or snap["histograms"].get("train.step_s", {}).get("count") != 2 \
            or snap["histograms"].get(f"health.step_s.{host}", {}).get(
                "count") != 2 \
            or snap["gauges"].get("health.silent_hosts") != 0:
        fail(f"trace: the training engine's snapshot {snap}")
    emit({"phase": "trace", "requests_per_round": len(window),
          "rounds": TRACE_ROUNDS, "p50_ms_off": p50s["off"],
          "p50_ms_on": p50s["on"], "p50_bound_ms": bound,
          "events_per_round_on": counts_on[0],
          "backpressure_per_round_on": waits_on,
          "annotate_calls_per_request": calls,
          "annotate_us_per_call": annotate_us,
          "annotate_host_ms_per_request": calls * annotate_us / 1e3,
          "tracer_add_event_us": add_event_us,
          "tracer_host_ms_per_request": len(SERVE_PHASES) * add_event_us
          / 1e3,
          "tracer_in_engine_ms_per_request": in_situ_ms,
          "profiler_phases": {k: {m: v if v > 0 or m == "ranges"
                                  else "not measured"
                                  for m, v in row.items()}
                              for k, row in phases.items()},
          "train_snapshot": {"counters": snap["counters"],
                             "gauges": snap["gauges"],
                             "histograms": sorted(snap["histograms"])},
          **gpu})
    del engine

    # ------------------------------------------------------ serve_shard
    # The serve phase's scenes and requests split over SHARDS pixel shards
    # (serve/sharding.py), then one gia scene on the same mesh.
    mesh = card_mesh()
    line, sh_launches, shard_frame = serve_shard_phase(
        serve, mesh, settings, cfg,
        [fields.from_jax_params(np_params(cfg, SEED + s_), cfg, dev)
         for s_ in range(2)], reqs, dense_line, pcam, dense_frame, cpu_frame,
        gcfg, gia_params[0], dev, gpu)
    emit(line)

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
    occ_line = line

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

    # -------------------------------------------------- serve_shard_occ
    line, sho_launches = serve_shard_occ_phase(
        serve, mesh, occ_settings, cfg,
        [occ_mod.attach(fields.from_jax_params(np_params(cfg, SEED + s_), cfg,
                                               dev), grid)
         for s_ in range(2)], oreqs, occ_line, shard_frame, p0, grid, pcam,
        dev, gpu)
    emit(line)
    del oengine, cpu_grid, shard_frame

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

    # --------------------------------------------------------- train_dp
    line, dp_launches = train_dp_phase(mesh, cfg, dev, nerf_init, nerf_batch,
                                       nerf_loss, train_ms["nerf"], gpu)
    emit(line)

    # ---------------------------------------------------------- elastic
    line, el_launches = elastic_phase(mesh, cfg, dev, nerf_init, nerf_batch,
                                      nerf_loss, gpu)
    emit(line)

    # ----------------------------------------------------------- launch
    # The launcher as a user starts it, ``python -m
    # repro_torch.launch.serve``, in a child process three times: at its
    # defaults (gia, hash, 2^14 tables, 150 steps, 2 scenes, 8 requests),
    # nerf culled, nsdf with int8 tables; each traced
    # and with a metrics snapshot. The child writes its kernels' launch
    # counts to a file at exit.
    launch_dir = os.path.join(ROOT, "build", "chip_smoke_launch")
    shutil.rmtree(launch_dir, ignore_errors=True)
    os.makedirs(launch_dir)
    launch_runs = {"defaults": [],
                   "nerf_occupancy": ["--app", "nerf", "--occupancy"],
                   "nsdf_int8": ["--app", "nsdf", "--quant", "int8"],
                   "defaults_shard": ["--shard"]}
    launch_launches = dict.fromkeys(K.launch_counts(), 0)
    launch_rows = {}
    for name, flags in launch_runs.items():
        files = {k: os.path.join(launch_dir, f"{name}_{k}.json")
                 for k in ("trace", "metrics", "launches")}
        argv = flags + ["--trace-out", files["trace"], "--metrics-out",
                        files["metrics"]]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(
                [sys.executable, "-c", LAUNCH_CHILD.format(
                    src=SRC, argv=argv, launches=files["launches"])],
                capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S,
                cwd=launch_dir)
        except subprocess.TimeoutExpired:
            fail(f"launch[{name}]: no exit within {LAUNCH_TIMEOUT_S} s")
        wall_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"launch[{name}]: exit code {out.returncode}: "
                 f"{out.stderr[-3000:]}")
        recs = []
        for text in out.stdout.splitlines():
            try:
                rec = json.loads(text)
            except json.JSONDecodeError:
                rec = None
            if not isinstance(rec, dict):
                fail(f"launch[{name}]: a stdout line is not one JSON "
                     f"object: {text!r}")
            recs.append(rec)
        events = {r["event"]: r for r in recs}
        served = events.get("served", {})
        if served.get("n_requests") != LAUNCH_REQUESTS or not all(
                np.isfinite(served.get(k, float("nan")))
                for k in ("p50_ms", "mpix_per_s")):
            fail(f"launch[{name}]: served {served}")
        with open(files["metrics"]) as f:
            snap = json.load(f)
        texport.validate_snapshot(snap)
        with open(files["trace"]) as f:
            trace_obj = json.load(f)
        texport.validate_chrome_trace(trace_obj)
        names = [e["name"] for e in trace_obj["traceEvents"]]
        buckets = {k.rsplit(".bucket", 1)[1] for k in snap["histograms"]
                   if ".bucket" in k}
        for ph in SERVE_PHASES:
            n_hist = sum(h["count"] for k, h in snap["histograms"].items()
                         if k.startswith(f"serve.{ph}_s.bucket"))
            if names.count(f"serve.{ph}") != n_hist or n_hist == 0:
                fail(f"launch[{name}]: {names.count(f'serve.{ph}')} "
                     f"serve.{ph} events, {n_hist} in the histograms")
        if "bucket_leak" in events or served["compiles"] != len(buckets):
            fail(f"launch[{name}]: {served['compiles']} tile functions for "
                 f"{len(buckets)} buckets")
        with open(files["launches"]) as f:
            counts = json.load(f)
        for k, n in counts.items():
            launch_launches[k] += n
        trained = [r for r in recs if r["event"] == "scene_trained"]
        launch_rows[name] = {
            "argv": flags, "wall_s": wall_s,
            "requests": served["n_requests"], "p50_ms": served["p50_ms"],
            "p99_ms": served["p99_ms"], "mpix_per_s": served["mpix_per_s"],
            "compiles": served["compiles"], "buckets": len(buckets),
            "events": [r["event"] for r in recs],
            "trace_events": len(names), "loss_scene0": [
                trained[0]["loss_first"], trained[0]["loss_last"]],
            "launches": counts}
    shutil.rmtree(launch_dir, ignore_errors=True)
    if launch_rows["defaults_shard"]["requests"] \
            != launch_rows["defaults"]["requests"]:
        fail(f"launch: --shard served {launch_rows['defaults_shard']} "
             f"requests, the defaults {launch_rows['defaults']}")
    if min(launch_launches[k] for k in ("field_fwd", "field_fwd_q",
                                        "encode_fwd", "encode_bwd",
                                        "mlp_fwd", "composite_fwd")) <= 0:
        fail(f"launch: a kernel never launched: {launch_launches}")
    emit({"phase": "launch", "runs": launch_rows,
          "launches": launch_launches, **gpu})

    # ------------------------------------------------------ launch_apps
    # serve_render in this process for every app and encoding at Table-I
    # width (log2_table_size=None: nerf, nvr, nsdf at 2^19 rows, gia at
    # 2^24), 2 scenes of LAUNCH_APPS_STEPS training steps each, 8
    # requests; the first and last loss of scene 0 are read off the
    # training history.
    histories = []
    real_train = ctrain.train_field

    def recording_train(*a, **kw):
        trained, hist = real_train(*a, **kw)
        histories.append(hist)
        return trained, hist
    apps_launches = dict.fromkeys(K.launch_counts(), 0)
    app_rows = {}
    logs = io.StringIO()
    ctrain.train_field, lserve._LOG.stream = recording_train, logs
    try:
        for app in ("nerf", "nvr", "gia", "nsdf"):
            for kind in ("hash", "dense", "tiled"):
                histories.clear()
                K.reset_launch_counts()
                t0 = time.perf_counter()
                st = lserve.serve_render(
                    app, kind, train_steps=LAUNCH_APPS_STEPS,
                    n_requests=LAUNCH_REQUESTS, seed=SEED, device=dev,
                    log2_table_size=None)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                counts = K.launch_counts()
                for k, n in counts.items():
                    apps_launches[k] += n
                losses = [l_ for _, l_ in histories[0]]
                need = ["field_fwd", "encode_fwd", "encode_bwd"] + (
                    ["mlp_fwd"] if app == "nerf" else []) + (
                    ["composite_fwd"] if app in ("nerf", "nvr") else [])
                v = f"{app}_{kind}"
                app_rows[v] = {
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "p50_ms": st["p50_ms"], "mpix_per_s": st["mpix_per_s"],
                    "requests": st["n_requests"], "wall_s": wall_s,
                    "table_bytes": fields.make_field_config(
                        app, kind).grid.params_bound() * 4,
                    "launches": {k: counts[k] for k in (
                        "field_fwd", "encode_fwd", "encode_bwd", "mlp_fwd",
                        "composite_fwd")}}
                if not all(np.isfinite(losses)) \
                        or not losses[-1] < losses[0]:
                    fail(f"launch_apps[{v}]: the loss did not fall: "
                         f"{losses}")
                if st["n_requests"] != LAUNCH_REQUESTS or not np.isfinite(
                        st["p50_ms"]) or not np.isfinite(st["mpix_per_s"]):
                    fail(f"launch_apps[{v}]: served {st}")
                if min(counts[k] for k in need) <= 0:
                    fail(f"launch_apps[{v}]: {need} must launch: {counts}")
                del st
                torch.cuda.empty_cache()
    finally:
        ctrain.train_field, lserve._LOG.stream = real_train, None
    emit({"phase": "launch_apps", "scenes": 2,
          "train_steps": LAUNCH_APPS_STEPS, "requests": LAUNCH_REQUESTS,
          "runs": app_rows, "launches": apps_launches, **gpu})

    # --------------------------------------------------------- examples
    # the twins of the JAX examples as a user runs them, each in a child
    line, ex_launches = examples_phase(K.launch_counts(), gpu)
    emit(line)

    # ----------------------------------------------------------- report
    # kernel -> (source, TPU kernel it replaces, path its launches are
    # read from, launches on that path, variant of the row's own numbers)
    paths = {"serve": launches, "serve_quant": qlaunches,
             "serve_gia": glaunches, "serve_nsdf": nlaunches,
             "unfused": unfused_launches, "train": train_launches,
             "serve_occ": olaunches, "train_runtime": runtime_launches,
             "resume": resume_launches, "unfused_serve": ulaunches,
             "launch": launch_launches, "launch_apps": apps_launches,
             "serve_shard": sh_launches, "serve_shard_occ": sho_launches,
             "train_dp": dp_launches, "elastic": el_launches,
             "examples": ex_launches, "dryrun": dr_launches,
             "lm_train": lt_launches}
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
                          "serve", launches, "packed"),
        # no TPU kernel: the JAX package's intra-chunk SSD term is XLA
        "ssd_intra_fwd": ("src/repro_torch/csrc/ssd.cu",
                          "src/repro/models/ssm.py:110",
                          "lm_train", lt_launches, None),
        "ssd_intra_bwd": ("src/repro_torch/csrc/ssd.cu",
                          "src/repro/models/ssm.py:110",
                          "lm_train", lt_launches, None)}
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
