"""The training engine: the JAX package's ``train/loop.py`` on one device.

``TrainEngine.run`` walks the steps in chunks of ``chunk_steps`` whose ends
sit on the global grid of ``chunk_plan`` (multiples of ``chunk_steps``,
plus the last step), as the JAX engine's scanned chunks do. PyTorch runs
eagerly, so a chunk is a Python loop of steps, each enqueued without
waiting for the device; the chunk's end is its one sync point, where
every step's device metrics come to the host at once. ``lr`` is a host
number and ``dt`` is the chunk's wall time over its steps.
``on_metrics(step, row, state)`` fires per step after its chunk, and
``on_chunk_end(end_step, state)`` once per chunk.

Batches come from exactly one of two sources, each a pure function of
the global step, so a run's batches do not depend on its chunking:
``batch_fn(step)`` makes the batch on the device (``core.train`` seeds a
generator from the run's seed and the step), ``host_batch_fn(step)``
returns numpy arrays (the LM's ``data/tokens.SyntheticTokens.batch``),
which the engine stacks per chunk, and a ``data/tokens.Prefetcher``
thread pins and copies to the state's device (``non_blocking``) while the
previous chunk runs, as the JAX engine's ``_host_chunk_iter`` does.
Metrics rows carry whatever the step returns: the field steps' ``loss``,
``psnr`` and ``lr``; the LM step's ``loss``, ``ce``, ``moe_aux_loss``,
``grad_norm`` and ``lr``.

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
On the card ``encode_bwd`` (fields) and the embedding gather's backward
(LMs, ``index_put_`` with accumulation) sum with atomics in a varying
order, so two runs, resumed or not, differ by that rounding.

Observability and health, as in the JAX engine: the engine owns a metrics
``Registry`` (its own, or the caller's ``metrics_registry``); while the
process tracer is enabled each step is a ``train.step`` span (the host
enqueue of the step, with its index) holding the ``forward``,
``backward`` and ``adam`` phases, each with its device interval; each
chunk, after its one host read, records a ``train.chunk`` event while the
tracer is enabled, a ``train.step_s`` histogram sample and the
``train.steps`` counter, logs a ``chunk`` row at debug level (``train``
logger), then beats the ``HeartbeatMonitor``, records the step time with
the ``StragglerDetector`` (whose per-host histograms are the registry's
``health.step_s.<host>``) and polls the ``FailurePolicy``, which sets the
``health.silent_hosts`` gauge. A ``FailureEvent`` is appended to
``engine.events`` and handed to ``on_event`` (default: logged as a
``failure_event`` warning).

Data parallelism, as in the JAX engine: ``make_scanned_step(mesh=)``
takes its loss and gradients from :func:`data_parallel_grad_fn`, which
splits every batch leaf over the mesh axes the rules bind to
``field_batch``, runs each shard's loss and gradients on its device from
the same params and averages them on the params' device (the JAX
package's ``pmean``); with ``grad_accum`` each micro-batch is split so,
and compression runs after the average. After a ``FailureEvent``,
``runtime/elastic.py`` plans the smaller mesh, restores the newest
checkpoint onto it and rebuilds the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common import partitioning
from repro_torch.data.tokens import Prefetcher
from repro_torch.launch.mesh import replicate, shard_devices, shard_rows
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER, annotate
from repro_torch.parallel.sharded import Sharded, map_sharded
from repro_torch.runtime.health import (FailurePolicy, HeartbeatMonitor,
                                        StragglerDetector)
from repro_torch.train import compression as compression_mod
from repro_torch.train import optim

_LOG = obs_log.get_logger("train")
# host chunks built and copied ahead of the one running (the JAX
# engine's default ``prefetch``)
PREFETCH_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Loop-shape knobs; everything task-specific lives in the step fn."""
    steps: int
    chunk_steps: int = 16          # chunk ends on this grid
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50           # min steps between saves (chunk-end snapped)
    ckpt_keep: int = 3
    heartbeat_timeout_s: float = 600.0
    host: Optional[str] = None     # health-hook host label

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


def value_and_grad(loss_fn: Callable, params, batch, has_aux: bool = False
                   ) -> Tuple[Any, Dict]:
    """(loss, grads of every leaf of ``params``): the loss runs on views
    of the leaves that require a gradient, so the caller's tensors stay as
    they are and can be updated in place afterwards. A leaf the loss does
    not use gets a zero gradient, as under ``jax.grad``. With ``has_aux``,
    ``loss_fn`` returns (loss, aux) and the first result is (loss, aux),
    aux's tensors detached, as ``jax.value_and_grad(has_aux=True)``."""
    views = optim.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        with annotate("forward"):
            out = loss_fn(views, batch)
        loss, aux = out if has_aux else (out, None)
        flat = optim.tree_leaves(views)
        with annotate("backward"):
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
    by_id = {id(v): g for v, g in zip(flat, grads)}
    grads = optim.tree_map(lambda v: by_id[id(v)], views)
    if has_aux:
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        return (loss.detach(), aux), grads
    return loss.detach(), grads


@dataclasses.dataclass(frozen=True)
class _CompressionKnobs:
    """The attribute subset ``compression.apply_inline`` reads."""
    compression: str
    compression_topk: float


def _batch_axis(name: str, v: torch.Tensor) -> int:
    """The axis of a batch leaf that holds its examples: 1 for the LM's
    (3, B, S) M-RoPE ``positions``, else 0."""
    return 1 if name == "positions" and v.ndim == 3 else 0


def accumulated_value_and_grad(loss_fn: Callable, params, batch,
                               grad_accum: int,
                               grad_fn: Optional[Callable] = None,
                               has_aux: bool = False
                               ) -> Tuple[Any, Dict]:
    """(loss, grads) averaged over ``grad_accum`` equal micro-batches, each
    batch leaf split along its example axis (axis 0; axis 1 of the M-RoPE
    ``positions``, as the JAX LM step's ``to_mb``): summed in micro-batch
    order, then divided by ``grad_accum``, as the JAX package's scan
    does. Each micro-batch goes through ``grad_fn(params, micro_batch)``
    (default: :func:`value_and_grad` of ``loss_fn``); a sharded gradient
    (``parallel/sharded.Sharded``) is summed and divided shard by shard,
    each shard on its own device. With ``has_aux``
    the first result is (loss, the last micro-batch's aux), as the JAX LM
    step keeps it."""
    if grad_fn is None:
        def grad_fn(p, b):
            return value_and_grad(loss_fn, p, b, has_aux=has_aux)
    sizes = {k: v.shape[_batch_axis(k, v)] for k, v in batch.items()}
    if any(n % grad_accum for n in sizes.values()):
        raise ValueError(f"grad_accum={grad_accum} does not divide the "
                         f"batch: leading sizes {sizes}")
    parts = {k: v.chunk(grad_accum, dim=_batch_axis(k, v))
             for k, v in batch.items()}
    loss = grads = aux = None
    for i in range(grad_accum):
        l_i, g_i = grad_fn(params, {k: p[i] for k, p in parts.items()})
        if has_aux:
            l_i, aux = l_i
        if grads is None:
            loss, grads = l_i, g_i
        else:
            loss = loss + l_i
            grads = optim.tree_map(
                lambda a, b: map_sharded(torch.add, a, b), grads, g_i)
    # a device divisor on each gradient's device (a sharded gradient's
    # shards may lie on several): a CUDA divide by a Python number
    # multiplies by its reciprocal, which is not the JAX package's division
    # for every k
    ks: Dict[torch.device, torch.Tensor] = {}

    def divide(g: torch.Tensor) -> torch.Tensor:
        if g.device not in ks:
            ks[g.device] = torch.full((), float(grad_accum), device=g.device)
        return g / ks[g.device]
    grads = optim.tree_map(lambda g: map_sharded(divide, g), grads)
    loss = divide(loss)
    return ((loss, aux) if has_aux else loss), grads


def data_parallel_grad_fn(loss_fn: Callable, mesh=None,
                          rules: Optional[partitioning.LogicalRules] = None,
                          batch_axis: str = "field_batch") -> Callable:
    """``(params, batch) -> (loss, grads)``, data-parallel over ``mesh``.

    Every batch leaf splits along axis 0 into equal contiguous pieces, one
    per shard of the mesh axes that ``rules`` bind to ``batch_axis``, in
    shard order (``launch.mesh.shard_devices``); the params replicate
    (the same tensors on their own device, copies elsewhere). Each shard's
    loss and gradients are its piece's mean; the result is their mean over
    the shards (summed in shard order, divided by a device scalar, as the
    micro-batches of :func:`accumulated_value_and_grad` are), which equals
    the unsharded global-batch gradient for equal shards, on the params'
    device. Without a mesh, or with one shard, it is
    :func:`value_and_grad` of ``loss_fn`` on the params' device."""
    def base(params, batch):
        return value_and_grad(loss_fn, params, batch)
    devices = (shard_devices(mesh, rules, batch_axis) if mesh is not None
               else None)
    if devices is None or len(devices) == 1:
        return base

    def sharded(params, batch):
        home = optim.tree_leaves(params)[0].device
        pers = {k: shard_rows(v.shape[0], len(devices))
                for k, v in batch.items()}
        loss = grads = None
        for i, dev in enumerate(devices):
            piece = {k: v[i * pers[k]:(i + 1) * pers[k]].to(dev)
                     for k, v in batch.items()}
            l_i, g_i = base(replicate(params, dev), piece)
            l_i = l_i.to(home)
            g_i = optim.tree_map(lambda g: g.to(home), g_i)
            if grads is None:
                loss, grads = l_i, g_i
            else:
                loss = loss + l_i
                grads = optim.tree_map(torch.add, grads, g_i)
        k = torch.full((), float(len(devices)), device=home)
        return loss / k, optim.tree_map(lambda g: g / k, grads)
    return sharded


def make_scanned_step(loss_fn: Callable, opt_cfg: optim.AdamConfig, *,
                      grad_accum: int = 1,
                      compression: Optional[str] = None,
                      compression_topk: float = 0.05,
                      compress_keys: Tuple[str, ...] = ("grid",),
                      mesh=None, rules=None,
                      batch_axis: str = "field_batch") -> Callable:
    """An engine step ``(state, step, batch) -> (state, metrics)`` from a
    ``loss_fn(params, batch)``: the loss and its gradients (over
    ``grad_accum`` micro-batches, each data-parallel over ``mesh``'s
    ``batch_axis`` shards: :func:`data_parallel_grad_fn`), the
    ``compress_keys`` gradients compressed when ``compression`` is set
    (``state["efb"]`` holds the error feedback: make the state with
    :func:`init_train_state`), then Adam. Metrics hold loss, lr and the
    PSNR of an MSE loss."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    grad_fn = data_parallel_grad_fn(loss_fn, mesh, rules, batch_axis)
    knobs = (None if compression is None
             else _CompressionKnobs(compression, compression_topk))

    def step_fn(state, step, batch):
        del step                         # batches are keyed upstream
        params = state["params"]
        if grad_accum > 1:
            loss, grads = accumulated_value_and_grad(loss_fn, params, batch,
                                                     grad_accum, grad_fn)
        else:
            loss, grads = grad_fn(params, batch)
        new_state = dict(state)
        if knobs is not None:
            sub, cstate = compression_mod.apply_inline(
                {k: grads[k] for k in compress_keys}, {"efb": state["efb"]},
                knobs)
            grads = {**grads, **sub}
            new_state["efb"] = cstate["efb"]
        with annotate("adam"):
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


def _first_tensor(tree) -> torch.Tensor:
    """The first tensor leaf of a state (dicts and NamedTuples; a sharded
    leaf's first shard)."""
    for _, leaf in store._flatten(tree):
        if isinstance(leaf, Sharded):
            return leaf.shards[0]
        if isinstance(leaf, torch.Tensor):
            return leaf
    raise ValueError("the state holds no tensor")


def _pinned_copy(stacked: Dict[str, Any], device: torch.device) -> Dict:
    """A chunk's stacked numpy batches on ``device``: through pinned host
    memory and a ``non_blocking`` copy for a CUDA device."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in stacked.items()}


class TrainEngine:
    """Chunked training loop (the module docstring has the contract).
    ``step_fn(state, step, batch) -> (state, metrics)``; exactly one of
    ``batch_fn(step) -> batch`` (on the device the state lives on) and
    ``host_batch_fn(step) -> {name: numpy array}``."""

    def __init__(self, cfg: EngineConfig, step_fn: Callable, *,
                 batch_fn: Optional[Callable] = None,
                 host_batch_fn: Optional[Callable] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 detector: Optional[StragglerDetector] = None,
                 policy: Optional[FailurePolicy] = None,
                 on_event: Optional[Callable] = None,
                 on_chunk_end: Optional[Callable] = None,
                 metrics_registry: Optional[obs_metrics.Registry] = None):
        if (batch_fn is None) == (host_batch_fn is None):
            raise ValueError(
                "exactly one of batch_fn / host_batch_fn required")
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.host_batch_fn = host_batch_fn
        # per-engine registry; the default straggler detector keeps its
        # per-host step-time histograms in it (health.step_s.<host>)
        self.obs = metrics_registry or obs_metrics.Registry()
        self.monitor = monitor or HeartbeatMonitor(
            timeout_s=cfg.heartbeat_timeout_s)
        self.detector = detector or StragglerDetector(registry=self.obs)
        self.policy = policy or FailurePolicy(self.monitor, self.detector,
                                              registry=self.obs)
        self.on_event = on_event if on_event is not None else (
            lambda ev: _LOG.warning("failure_event", kind=ev.kind,
                                    hosts=list(ev.hosts), step=ev.step,
                                    hint="see runtime/elastic.py"))
        self.on_chunk_end = on_chunk_end
        self.host = cfg.host or f"host{_process_index()}"
        self.events: List = []
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
                _LOG.info("resumed", step=last, ckpt_dir=str(cfg.ckpt_dir))
        plan = chunk_plan(start, cfg.steps, cfg.chunk_steps)
        prefetch = (self._host_chunk_iter(plan, _first_tensor(state).device)
                    if self.host_batch_fn is not None else None)
        try:
            return self._run(state, start, plan, ckpt, on_metrics, prefetch)
        finally:
            if prefetch is not None:
                prefetch.close()
            if ckpt is not None:
                ckpt.wait()

    def _host_chunk_iter(self, plan, device: torch.device) -> Prefetcher:
        """Prefetched iterator of each chunk's stacked batches on
        ``device``."""
        def chunks():
            for s0, n in plan:
                per_step = [self.host_batch_fn(s0 + i) for i in range(n)]
                yield {k: np.stack([b[k] for b in per_step])
                       for k in per_step[0]}

        return Prefetcher(chunks(), depth=PREFETCH_DEPTH,
                          to_device=lambda st: _pinned_copy(st, device))

    def _batches(self, s0: int, n: int, prefetch) -> Iterator[Dict]:
        """The chunk's per-step batches, in step order."""
        if prefetch is None:
            for i in range(n):
                yield self.batch_fn(s0 + i)
            return
        stacked = next(prefetch)
        for i in range(n):
            yield {k: v[i] for k, v in stacked.items()}

    def _run(self, state, start, plan, ckpt, on_metrics, prefetch):
        history: List[Dict[str, float]] = []
        last_saved = start - 1
        step_hist = self.obs.histogram("train.step_s")
        steps_ctr = self.obs.counter("train.steps")
        for s0, n in plan:
            tracing = TRACER.enabled
            t0 = time.perf_counter()
            rows = []
            for i, batch in enumerate(self._batches(s0, n, prefetch)):
                if tracing:
                    state, metrics = self._traced_step(state, s0 + i, batch)
                else:
                    state, metrics = self.step_fn(state, s0 + i, batch)
                rows.append(metrics)
            on_device, values = _read_metrics(rows)
            dt = time.perf_counter() - t0
            # the read above is the chunk's sync point, so the event and
            # the histogram cover device completion with no wait of their own
            if tracing:
                TRACER.add_event("train.chunk", t0, t0 + dt, cat="train",
                                 start=s0, n_steps=n, host=self.host)
            step_hist.record(dt / n)
            steps_ctr.inc(n)
            self.monitor.beat(self.host)
            self.detector.record(self.host, dt / n)
            _LOG.debug("chunk", start=s0, n_steps=n,
                       step_ms=round(dt / n * 1e3, 3))
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
            ev = self.policy.poll(end)
            if ev is not None:
                self.events.append(ev)
                self.on_event(ev)
        return state, history

    def _traced_step(self, state, step: int, batch):
        """One step under the tracer: the ``train.step`` span (the host
        enqueue of the step) in a scope that gives the step's phases
        (``forward``, ``backward``, ``adam``) its index and the state's
        device."""
        with TRACER.scope(_first_tensor(state).device, step=step), \
                TRACER.span("train.step", cat="train"):
            return self.step_fn(state, step, batch)


# repro: sync-boundary the chunk's one host read of every step's metrics
def _read_metrics(rows: List[Dict]) -> Tuple[List[str], List[List[float]]]:
    """The chunk's one sync point: (the names of its device metrics, their
    values, one list a name and one value a step), in one copy."""
    on_device = sorted(k for k, v in rows[0].items()
                       if isinstance(v, torch.Tensor))
    return on_device, torch.stack([torch.stack([r[k].float() for r in rows])
                                   for k in on_device]).cpu().tolist()


def _process_index() -> int:
    """This process's rank in the default process group (0 without one):
    the JAX engine's ``jax.process_index()``."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
