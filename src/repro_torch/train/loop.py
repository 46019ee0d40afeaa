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

``make_scanned_step(grad_accum=k)`` splits every batch leaf along axis 0
into k micro-batches and averages their losses and gradients (summed in
micro-batch order, then divided by k, the JAX formula);
``compression=`` ("topk" or "int8", ``train/compression.py``) compresses
the ``compress_keys`` gradients with error feedback kept in
``state["efb"]``, after the gradient and before Adam.

With ``EngineConfig.ckpt_dir`` the engine resumes from the newest
checkpoint there (``checkpoint/store.py``, the JAX package's format) at
``latest_step + 1``, re-entering the same chunk grid, and saves at a chunk
end once ``ckpt_every`` steps have passed since the last save, and at the
last step, keeping ``ckpt_keep``. Since batches are a pure function of the
step, a resumed run replays the uninterrupted one: bit for bit on the CPU.
On the card ``encode_bwd`` sums with atomics in a varying order, so two
runs, resumed or not, differ by that rounding.

Not ported yet, and refused: the data-parallel mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import store
from repro_torch.train import compression as compression_mod
from repro_torch.train import optim


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Loop-shape knobs; everything task-specific lives in the step fn."""
    steps: int
    chunk_steps: int = 16          # chunk ends on this grid
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50           # min steps between saves (chunk-end snapped)
    ckpt_keep: int = 3

    def __post_init__(self):
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


@dataclasses.dataclass(frozen=True)
class _CompressionKnobs:
    """The attribute subset ``compression.apply_inline`` reads."""
    compression: str
    compression_topk: float


def accumulated_value_and_grad(loss_fn: Callable, params, batch,
                               grad_accum: int) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) averaged over ``grad_accum`` equal micro-batches, each
    batch leaf split along axis 0: summed in micro-batch order, then
    divided by ``grad_accum``, as the JAX package's scan does."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    if any(n % grad_accum for n in sizes.values()):
        raise ValueError(f"grad_accum={grad_accum} does not divide the "
                         f"batch: leading sizes {sizes}")
    parts = {k: v.chunk(grad_accum) for k, v in batch.items()}
    loss = grads = None
    for i in range(grad_accum):
        l_i, g_i = value_and_grad(loss_fn, params,
                                  {k: p[i] for k, p in parts.items()})
        if grads is None:
            loss, grads = l_i, g_i
        else:
            loss = loss + l_i
            grads = optim.tree_map(torch.add, grads, g_i)
    # a device divisor: a CUDA divide by a Python number multiplies by its
    # reciprocal, which is not the JAX package's division for every k
    k = torch.full((), float(grad_accum), device=loss.device)
    return loss / k, optim.tree_map(lambda g: g / k, grads)


def make_scanned_step(loss_fn: Callable, opt_cfg: optim.AdamConfig, *,
                      grad_accum: int = 1,
                      compression: Optional[str] = None,
                      compression_topk: float = 0.05,
                      compress_keys: Tuple[str, ...] = ("grid",),
                      mesh=None) -> Callable:
    """An engine step ``(state, step, batch) -> (state, metrics)`` from a
    ``loss_fn(params, batch)``: the loss and its gradients (over
    ``grad_accum`` micro-batches), the ``compress_keys`` gradients
    compressed when ``compression`` is set (``state["efb"]`` holds the
    error feedback: make the state with :func:`init_train_state`), then
    Adam. Metrics hold loss, lr and the PSNR of an MSE loss."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training (mesh) is not ported to repro_torch yet")
    knobs = (None if compression is None
             else _CompressionKnobs(compression, compression_topk))

    def step_fn(state, step, batch):
        del step                         # batches are keyed upstream
        params = state["params"]
        if grad_accum > 1:
            loss, grads = accumulated_value_and_grad(loss_fn, params, batch,
                                                     grad_accum)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        new_state = dict(state)
        if knobs is not None:
            sub, cstate = compression_mod.apply_inline(
                {k: grads[k] for k in compress_keys}, {"efb": state["efb"]},
                knobs)
            grads = {**grads, **sub}
            new_state["efb"] = cstate["efb"]
        params, opt, metrics = optim.adam_update(grads, state["opt"],
                                                 params, opt_cfg)
        metrics["loss"] = loss
        metrics["psnr"] = -10.0 * torch.log10(torch.clamp(loss, min=1e-12))
        new_state["params"], new_state["opt"] = params, opt
        return new_state, metrics

    return step_fn


def init_train_state(params, compression: Optional[str] = None,
                     compress_keys: Tuple[str, ...] = ("grid",)) -> Dict:
    """Fresh engine state for :func:`make_scanned_step` tasks; with
    ``compression``, zero error feedback for each ``compress_keys`` leaf."""
    state = {"params": params, "opt": optim.adam_init(params)}
    if compression is not None:
        state["efb"] = {k: torch.zeros_like(params[k])
                        for k in compress_keys}
    return state


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
        # the last run's checkpointer (None without ckpt_dir): its
        # ``blocked_s`` holds the seconds each save held the step thread
        self.checkpointer: Optional[store.AsyncCheckpointer] = None

    def run(self, state, *, on_metrics: Optional[Callable] = None
            ) -> Tuple[Any, List[Dict[str, float]]]:
        """Run (or, with a checkpoint in ``ckpt_dir``, resume) the loop
        from ``state``; returns ``(final_state, history)``, one ``{'step',
        'loss', 'psnr', 'lr', 'dt', ...}`` row per step run in this call."""
        cfg = self.cfg
        start, ckpt = 0, None
        if cfg.ckpt_dir is not None:
            ckpt = self.checkpointer = store.AsyncCheckpointer(
                cfg.ckpt_dir, keep=cfg.ckpt_keep)
            last = store.latest_step(cfg.ckpt_dir)
            if last is not None:
                state = store.restore(cfg.ckpt_dir, state, step=last)
                start = last + 1
        try:
            return self._run(state, start, ckpt, on_metrics)
        finally:
            if ckpt is not None:
                ckpt.wait()

    def _run(self, state, start, ckpt, on_metrics):
        history: List[Dict[str, float]] = []
        last_saved = start - 1
        for s0, n in chunk_plan(start, self.cfg.steps, self.cfg.chunk_steps):
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
            end = s0 + n - 1
            if ckpt is not None and (end == self.cfg.steps - 1
                                     or end - last_saved
                                     >= self.cfg.ckpt_every):
                ckpt.save(state, end)   # host snapshot before the next step
                last_saved = end
            if self.on_chunk_end is not None:
                self.on_chunk_end(end, state)
        return state, history
