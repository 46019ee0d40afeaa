"""Hopper resource budget of every kernel plan (rule RT201): the port's
counterpart of the JAX package's VMEM estimator (``analysis/vmem.py``).

For each of the 12 Table-I ``(app, encoding)`` configurations, with f32,
bf16, int8 and fp8-e4m3 tables, it lists each kernel the configuration
launches and reads its resources from the kernels' own plan functions:

  * ``encode_fwd`` (the unfused route; in training the backward's
    recomputed features): ``hashgrid.encode_plan``'s level group G and the
    bytes its tables reach, against ``L2_SHARE_BYTES``;
  * ``encode_bwd`` (trainable f32 and bf16 tables only):
    ``hashgrid.encode_bwd_plan``'s group and its f32 accumulator bytes,
    against ``BWD_L2_SHARE_BYTES``;
  * ``field_fwd`` (``field_fwd_q`` for int8 and fp8 tables):
    ``fused_field.field_plan``'s shared memory per block and warps;
  * ``mlp_fwd`` (NeRF's colour MLP, and every head on the unfused route):
    ``fused_mlp.mlp_plan``'s;
  * ``composite_fwd`` (the ray apps' serving): ``ray_march.composite_plan``'s
    rays per block.

Assumptions, for the card these kernels are built for (an H100 SXM):
:data:`N_SMS` streaming multiprocessors; a serve tile of
:data:`SERVE_TILE_PIXELS` pixels x :data:`SERVE_SAMPLES` samples (131,072
points for the ray apps; gia's and nsdf's field calls take one point a
pixel); training batches of ``core/train.py``'s default
:data:`TRAIN_BATCH` rays (x 32 samples) or points. On the card,
``chip_smoke.py``'s ``analysis`` phase and ``tests/test_torch_cuda.py``'s
``test_budget_matches_cuda`` recompute the plans at the card's SM count.

Verdicts per estimate, as ``vmem.py`` has them:
  * fits        — the group's bytes fit their L2 share and the block's
    shared memory fits :data:`MAX_SMEM_BYTES`.
  * degraded    — at the smallest group the kernel takes (G = 1, or 2
    where F = 2 needs two levels for a 16-byte store) the group's rows are
    over the share. Documented; a WARNING. At Table-I width these are the
    3-D tiled grids' backward: a level of 2^19 x 8 f32 accumulator rows is
    16 MiB against the 8 MiB share. gia's 2^24-row levels are not among
    them: its points reach at most 512^2 rows a level (2 MiB of f32).
  * over-budget — a group over its share at a G the picker would not
    choose: the plan and ``_pick_group`` have drifted. ERROR.
  * over-smem   — a block over the 232,448 bytes of shared memory a block
    may use on Hopper. ERROR.

Occupancy (:func:`blocks_per_sm`) is no rule here: registers are known
only after ``ptxas``. ``chip_smoke.py``'s ``analysis`` phase applies it to
the registers in the build's log and holds it against CUDA's own
occupancy query (``kernels/info.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.registry import Finding
from repro_torch.core.fields import FieldConfig, make_field_config
from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.common import TABLE_DTYPE_CODE
from repro_torch.kernels.fused_field import fused_field
from repro_torch.kernels.fused_mlp import fused_mlp
from repro_torch.kernels.hashgrid import hashgrid
from repro_torch.kernels.ray_march import ray_march

# the port's own list of Table I's apps and encodings
FIELD_APPS = ("nerf", "nsdf", "gia", "nvr")
FIELD_ENCODINGS = ("hash", "dense", "tiled")
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8,
                torch.float8_e4m3fn)
TRAINABLE_DTYPES = (torch.float32, torch.bfloat16)
RAY_APPS = ("nerf", "nvr")

N_SMS = 132                  # H100 SXM5
SERVE_TILE_PIXELS = 4096     # RenderSettings.tile_pixels
SERVE_SAMPLES = 32           # RenderSettings.n_samples
TRAIN_BATCH = 2048           # core/train.train_field's batch_size
TRAIN_SAMPLES = 32           # core/train.field_loss's compositing depth

MAX_SMEM_BYTES = fused_mlp.MAX_SMEM_BYTES
# Hopper's per-SM limits (CUDA C Programming Guide, compute capability 9.0)
REGS_PER_SM = 65_536
THREADS_PER_SM = 2_048
BLOCKS_PER_SM = 32
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
REG_ALLOC_UNIT = 256         # registers are allocated per warp in these
SMEM_ALLOC_UNIT = 128
SUB_PARTITIONS = 4           # each holds a quarter of the register file
MAX_REGS_PER_THREAD = 255


def blocks_per_sm(regs_per_thread: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads, each using ``regs_per_thread``
    registers and ``smem`` bytes of shared memory, that fit on one Hopper
    SM at once: the least of the thread, block, shared-memory and register
    limits. Shared memory is allocated in 128-byte units with 1 KiB
    reserved per block; registers per warp in units of 256, each warp
    within one of the SM's four sub-partitions (a quarter of the register
    file), as CUDA's occupancy calculator counts them."""
    if threads < 1 or regs_per_thread > MAX_REGS_PER_THREAD:
        return 0
    warps = -(-threads // 32)
    by_threads = THREADS_PER_SM // (warps * 32)
    block_smem = (-(-(smem + SMEM_RESERVED_PER_BLOCK) // SMEM_ALLOC_UNIT)
                  * SMEM_ALLOC_UNIT)
    if smem > MAX_SMEM_BYTES:
        return 0
    by_smem = SMEM_PER_SM // block_smem
    regs_per_warp = (-(-(regs_per_thread * 32) // REG_ALLOC_UNIT)
                     * REG_ALLOC_UNIT)
    if regs_per_warp == 0:
        by_regs = BLOCKS_PER_SM
    elif regs_per_warp * warps > REGS_PER_SM:
        by_regs = 0
    else:
        per_partition = (REGS_PER_SM // SUB_PARTITIONS) // regs_per_warp
        by_regs = per_partition * SUB_PARTITIONS // warps
    return min(BLOCKS_PER_SM, by_threads, by_smem, by_regs)


@dataclasses.dataclass
class KernelEstimate:
    """The resources of one kernel launch under one Table-I config."""
    kernel: str                   # 'encode_fwd' | 'encode_bwd' | 'field_fwd'
                                  # | 'field_fwd_q' | 'mlp_fwd' | 'composite_fwd'
    app: str
    encoding: str
    dtype: str                    # the tables' dtype
    route: str                    # 'serve' | 'train'
    n_points: int                 # rows (points, MLP rows, rays) a launch takes
    threads: int                  # per block
    smem_bytes: int               # dynamic shared memory per block
    instance: Tuple               # the kernel's C++ instantiation
    level_group: Optional[int] = None
    min_group: Optional[int] = None
    group_bytes: Optional[int] = None   # tables (fwd) / accumulator (bwd)
    share_bytes: Optional[int] = None   # their L2 share
    plan: Optional[dict] = None

    @property
    def verdict(self) -> str:
        if self.smem_bytes > MAX_SMEM_BYTES:
            return "over-smem"
        if self.group_bytes is not None and self.group_bytes > \
                self.share_bytes:
            return ("degraded" if self.level_group == self.min_group
                    else "over-budget")
        return "fits"

    @property
    def where(self) -> str:
        return (f"{self.kernel}[{self.app}/{self.encoding}/{self.dtype}/"
                f"{self.route}]")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _points(cfg: FieldConfig, route: str) -> int:
    if route == "serve":
        return SERVE_TILE_PIXELS * (SERVE_SAMPLES if cfg.app in RAY_APPS
                                    else 1)
    return TRAIN_BATCH * (TRAIN_SAMPLES if cfg.app in RAY_APPS else 1)


def encode_estimate(cfg: FieldConfig, dtype: torch.dtype, route: str,
                    n_points: int, n_sms: int) -> KernelEstimate:
    grid = cfg.grid
    plan = hashgrid.encode_plan(grid, dtype, n_points, n_sms)
    return KernelEstimate(
        kernel="encode_fwd", app=cfg.app, encoding=grid.kind,
        dtype=_dtype_name(dtype), route=route, n_points=n_points,
        threads=hashgrid.ENCODE_ROWS, smem_bytes=0,
        instance=("encode_fwd", grid.dim, grid.n_features,
                  TABLE_DTYPE_CODE[dtype], plan["group_levels"]),
        level_group=plan["group_levels"],
        min_group=plan["group_sizes"][0],
        group_bytes=plan["group_table_bytes"],
        share_bytes=hashgrid.L2_SHARE_BYTES, plan=plan)


def encode_bwd_estimate(cfg: FieldConfig, dtype: torch.dtype, n_points: int,
                        n_sms: int) -> KernelEstimate:
    grid = cfg.grid
    plan = hashgrid.encode_bwd_plan(grid, n_points, n_sms)
    return KernelEstimate(
        kernel="encode_bwd", app=cfg.app, encoding=grid.kind,
        dtype=_dtype_name(dtype), route="train", n_points=n_points,
        threads=hashgrid.ENCODE_ROWS, smem_bytes=0,
        instance=("encode_bwd", grid.dim, grid.n_features,
                  TABLE_DTYPE_CODE[dtype], plan["group_levels"]),
        level_group=plan["group_levels"],
        min_group=plan["group_sizes"][0],
        group_bytes=plan["group_accumulator_bytes"],
        share_bytes=hashgrid.BWD_L2_SHARE_BYTES, plan=plan)


def _mlp_dims(m: MLPConfig) -> Tuple[int, int, int, int]:
    return (m.in_dim, m.hidden_dim, m.n_hidden, m.out_dim)


def field_estimate(cfg: FieldConfig, dtype: torch.dtype, route: str,
                   n_points: int) -> KernelEstimate:
    grid = cfg.grid
    head = cfg.density_mlp if cfg.app == "nerf" else cfg.mlp
    plan = fused_field.field_plan(head, check=False)
    name = "field_fwd" if dtype in TRAINABLE_DTYPES else "field_fwd_q"
    return KernelEstimate(
        kernel=name, app=cfg.app, encoding=grid.kind,
        dtype=_dtype_name(dtype), route=route, n_points=n_points,
        threads=32 * (plan["encode_warps"] + plan["mlp_warps"]),
        smem_bytes=plan["smem_bytes"],
        instance=("field_fwd", grid.dim, grid.n_features,
                  TABLE_DTYPE_CODE[dtype], *_mlp_dims(head)), plan=plan)


def mlp_estimate(cfg: FieldConfig, m: MLPConfig, dtype: torch.dtype,
                 route: str, n_points: int) -> KernelEstimate:
    plan = fused_mlp.mlp_plan(m, check=False)
    return KernelEstimate(
        kernel="mlp_fwd", app=cfg.app, encoding=cfg.grid.kind,
        dtype=_dtype_name(dtype), route=route, n_points=n_points,
        threads=32 * plan["warps"], smem_bytes=plan["smem_bytes"],
        instance=("mlp_fwd", *_mlp_dims(m)), plan=plan)


def composite_estimate(cfg: FieldConfig, dtype: torch.dtype
                       ) -> KernelEstimate:
    plan = ray_march.composite_plan(SERVE_SAMPLES)
    return KernelEstimate(
        kernel="composite_fwd", app=cfg.app, encoding=cfg.grid.kind,
        dtype=_dtype_name(dtype), route="serve",
        n_points=SERVE_TILE_PIXELS,
        threads=32 * ray_march.WARPS_PER_BLOCK, smem_bytes=0,
        # the served layout: the field's packed (R, S, 4) output
        instance=("composite_fwd", 1), plan=plan)


def estimate_config(app: str, encoding: str, dtype: torch.dtype,
                    n_sms: int = N_SMS) -> List[KernelEstimate]:
    """Every kernel launch one Table-I config makes with ``dtype`` tables,
    serving (fused and unfused routes) and, for trainable tables,
    training."""
    cfg = make_field_config(app, encoding)
    heads = ([cfg.density_mlp] if app == "nerf" else []) + [cfg.mlp]
    out: List[KernelEstimate] = []
    routes = ("serve", "train") if dtype in TRAINABLE_DTYPES else ("serve",)
    for route in routes:
        n = _points(cfg, route)
        out.append(field_estimate(cfg, dtype, route, n))
        out.append(encode_estimate(cfg, dtype, route, n, n_sms))
        if route == "serve":
            out.extend(mlp_estimate(cfg, m, dtype, route, n) for m in heads)
            if app in RAY_APPS:
                out.append(composite_estimate(cfg, dtype))
        else:
            if app == "nerf":
                out.append(mlp_estimate(cfg, cfg.mlp, dtype, route, n))
            out.append(encode_bwd_estimate(cfg, dtype, n, n_sms))
    return out


def table1_estimates(n_sms: int = N_SMS) -> List[KernelEstimate]:
    """All 12 Table-I configs x {f32, bf16, int8, fp8-e4m3} tables."""
    return [est for app in FIELD_APPS for encoding in FIELD_ENCODINGS
            for dtype in TABLE_DTYPES
            for est in estimate_config(app, encoding, dtype, n_sms)]


def check(n_sms: int = N_SMS) -> List[Finding]:
    """RT201 findings: drift and shared memory over the limit are errors,
    the documented degrades warnings."""
    findings: List[Finding] = []
    for est in table1_estimates(n_sms):
        verdict = est.verdict
        if verdict == "fits":
            continue
        if verdict == "over-smem":
            findings.append(Finding(
                rule="smem-budget", code="RT201", path=est.where, line=0,
                message=(f"{est.smem_bytes} bytes of shared memory a block, "
                         f"over the {MAX_SMEM_BYTES} a block may use")))
            continue
        mib = est.group_bytes / 2 ** 20
        share = est.share_bytes / 2 ** 20
        if verdict == "degraded":
            findings.append(Finding(
                rule="smem-budget", code="RT201", path=est.where, line=0,
                severity="warning",
                message=(f"a group of {est.level_group} levels reaches "
                         f"{mib:.1f} MiB, over its {share:.0f} MiB L2 share "
                         f"at the smallest group the kernel takes; "
                         f"documented degrade (not all its rows stay in L2)")))
        else:
            findings.append(Finding(
                rule="smem-budget", code="RT201", path=est.where, line=0,
                message=(f"a group of {est.level_group} levels reaches "
                         f"{mib:.1f} MiB, over its {share:.0f} MiB L2 share, "
                         f"at a group the picker would not choose — the "
                         f"plan and _pick_group have drifted")))
    return findings
