"""The training engine: the JAX package's ``train/loop.py`` on one device.

``TrainEngine.run`` walks the steps in chunks of ``chunk_steps`` whose ends
sit on the global grid of ``chunk_plan`` (multiples of ``chunk_steps``,
plus the last step), as the JAX engine's scanned chunks do. PyTorch runs
eagerly, so a chunk is a Python loop of steps, each enqueued without
waiting for the device; the chunk's end is its one sync point, where
every step's metrics (``loss``, ``psnr``, ``grad_norm`` when clipped)
come to the host at once. ``lr`` is a host number and ``dt`` is the
chunk's wall time over its steps. ``on_metrics(step, row, state)`` fires
per step after its chunk, and ``on_chunk_end(end_step, state)`` once per
chunk.

Batches come from ``batch_fn(step)``, a pure function of the global step
(``core.train`` seeds a generator from the run's seed and the step), so
a run's batches do not depend on its chunking.

Not ported yet, and refused: gradient accumulation and gradient
compression (``train/compression.py``), checkpoint save and resume
(``checkpoint/store.py``), and the data-parallel mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.train import optim


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Loop-shape knobs; everything task-specific lives in the step fn."""
    steps: int
    chunk_steps: int = 16          # chunk ends on this grid
    ckpt_dir: Optional[str] = None     # not ported: raises

    def __post_init__(self):
        if self.ckpt_dir is not None:
            raise NotImplementedError(
                "checkpointing (ckpt_dir) is not ported to repro_torch yet")
        if self.chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got "
                             f"{self.chunk_steps}")


def chunk_plan(start: int, steps: int,
               chunk_steps: int) -> List[Tuple[int, int]]:
    """Segment ``[start, steps)`` into (chunk_start, n) pieces whose ends
    sit on the global ``chunk_steps`` grid (plus the final step)."""
    plan = []
    cur = start
    while cur < steps:
        end = min((cur // chunk_steps + 1) * chunk_steps - 1, steps - 1)
        plan.append((cur, end - cur + 1))
        cur = end + 1
    return plan


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads of every leaf of ``params``): the loss runs on views
    of the leaves that require a gradient, so the caller's tensors stay as
    they are and can be updated in place afterwards."""
    views = optim.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(views, batch)
        flat = optim.tree_leaves(views)
        grads = torch.autograd.grad(loss, flat)
    by_id = {id(v): g for v, g in zip(flat, grads)}
    return loss.detach(), optim.tree_map(lambda v: by_id[id(v)], views)


def make_scanned_step(loss_fn: Callable, opt_cfg: optim.AdamConfig, *,
                      grad_accum: int = 1,
                      compression: Optional[str] = None,
                      mesh=None) -> Callable:
    """An engine step ``(state, step, batch) -> (state, metrics)`` from a
    ``loss_fn(params, batch)``: the loss and its gradients, then Adam.
    Metrics hold loss, lr and the PSNR of an MSE loss."""
    if grad_accum != 1:
        raise NotImplementedError(
            "gradient accumulation is not ported to repro_torch yet")
    if compression is not None:
        raise NotImplementedError(
            "gradient compression is not ported to repro_torch yet")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training (mesh) is not ported to repro_torch yet")

    def step_fn(state, step, batch):
        del step                         # batches are keyed upstream
        loss, grads = value_and_grad(loss_fn, state["params"], batch)
        params, opt, metrics = optim.adam_update(grads, state["opt"],
                                                 state["params"], opt_cfg)
        metrics["loss"] = loss
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp(loss, min=1e-12))
        return {"params": params, "opt": opt}, metrics

    return step_fn


def init_train_state(params, compression: Optional[str] = None) -> Dict:
    """Fresh engine state for :func:`make_scanned_step` tasks."""
    if compression is not None:
        raise NotImplementedError(
            "gradient compression is not ported to repro_torch yet")
    return {"params": params, "opt": optim.adam_init(params)}


class TrainEngine:
    """Chunked training loop (the module docstring has the contract).
    ``step_fn(state, step, batch) -> (state, metrics)``; ``batch_fn(step)
    -> batch``, on the device the state lives on."""

    def __init__(self, cfg: EngineConfig, step_fn: Callable, *,
                 batch_fn: Callable,
                 on_chunk_end: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.on_chunk_end = on_chunk_end

    def run(self, state, *, on_metrics: Optional[Callable] = None
            ) -> Tuple[Any, List[Dict[str, float]]]:
        """Run the loop from ``state``; returns ``(final_state, history)``,
        one ``{'step', 'loss', 'psnr', 'lr', 'dt', ...}`` row per step."""
        history: List[Dict[str, float]] = []
        for s0, n in chunk_plan(0, self.cfg.steps, self.cfg.chunk_steps):
            t0 = time.perf_counter()
            rows = []
            for i in range(n):
                state, metrics = self.step_fn(state, s0 + i,
                                              self.batch_fn(s0 + i))
                rows.append(metrics)
            on_device = sorted(k for k, v in rows[0].items()
                               if isinstance(v, torch.Tensor))
            # the chunk's one sync point: every step's device metrics
            # come to the host in one copy
            values = torch.stack([torch.stack([r[k].float() for r in rows])
                                  for k in on_device]).cpu().tolist()
            dt = time.perf_counter() - t0
            for i, metrics in enumerate(rows):
                row = {k: float(v) for k, v in metrics.items()
                       if k not in on_device}
                row.update({k: values[j][i] for j, k in enumerate(on_device)})
                row["step"] = s0 + i
                row["dt"] = dt / n
                history.append(row)
                if on_metrics is not None:
                    on_metrics(s0 + i, row, state)
            if self.on_chunk_end is not None:
                self.on_chunk_end(s0 + n - 1, state)
        return state, history
