"""Training for neural fields: the JAX package's ``core/train.py``.

The loss is the MSE against the analytic ground-truth scene
(``data/scenes.py``): gia and nsdf evaluate the field at the batch's
points, nerf and nvr render rays (plain compositing, as the JAX training
route composites in XLA) and compare pixels. Gradients flow through the
field and MLP wrappers' ``torch.autograd.Function``s, so on the card the
forward runs ``field_fwd`` (and nerf's ``mlp_fwd``) and the backward
``encode_fwd`` (the features, recomputed) and ``encode_bwd`` (the table
gradient's scatter-add).

RNG contract (the counterpart of the JAX package's ``fold_in(k_data,
step)``): a run of ``seed`` draws its initial params on the CPU from a
generator seeded with ``seed`` (``fields.init_field``), and the batch of
global step ``step`` from a generator on the batch's device seeded with
``DATA_STREAM + seed * 2**32 + step`` (:func:`batch_generator`; 0 <= seed
< 2**30, 0 <= step < 2**32), so batches are a pure function of (seed,
step) and the engine's and the per-step loop's agree. The numbers are
PyTorch's, not ``jax.random``'s: parity tests inject the same numpy
batches into both packages (``batch_fn``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import fields, occupancy, render
from repro_torch.core.fields import FieldConfig
from repro_torch.data import scenes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import loop, optim

# seeds of the batch generators sit above every init seed
DATA_STREAM = 1 << 62


def field_loss(params, cfg: FieldConfig, batch: Dict,
               n_samples: Optional[int] = None,
               fused: bool = True) -> torch.Tensor:
    """MSE of the field (gia, nsdf) or its rendered pixels (nerf, nvr)
    against the batch's target. ``n_samples`` sets the ray apps'
    compositing depth (default 32); ``fused=False`` evaluates the field on
    the unfused route (``fields.apply_field``)."""
    if cfg.app in ("gia", "nsdf"):
        pred = fields.apply_field(params, cfg, batch["points"], fused=fused)
        return torch.mean((pred - batch["target"]) ** 2)
    pred = render.render_rays(
        lambda p, d: fields.apply_field(params, cfg, p, d, fused=fused),
        batch["origins"], batch["dirs"], n_samples=n_samples or 32)
    return torch.mean((pred - batch["target"]) ** 2)


def make_field_train_step(cfg: FieldConfig,
                          opt_cfg: Optional[optim.AdamConfig] = None,
                          n_samples: Optional[int] = None,
                          fused: bool = True) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss, its gradients and one Adam update (in place)."""
    opt_cfg = opt_cfg or optim.AdamConfig(lr=1e-2)

    def loss_fn(p, b):
        return field_loss(p, cfg, b, n_samples=n_samples, fused=fused)

    def step(params, opt_state, batch):
        loss, grads = loop.value_and_grad(loss_fn, params, batch)
        params, opt_state, metrics = optim.adam_update(grads, opt_state,
                                                       params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def batch_generator(seed: int, step: int,
                    device: torch.device) -> torch.Generator:
    """The generator of global step ``step``'s batch (the module's RNG
    contract)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(DATA_STREAM + seed * 2 ** 32 + step)
    return gen


def make_batch(cfg: FieldConfig, gen: torch.Generator, batch_size: int,
               cam: Optional[render.Camera] = None,
               gt_samples: int = 64) -> Dict:
    """One training batch on the generator's device."""
    if cfg.app == "gia":
        xy, target = scenes.gia_batch(gen, batch_size)
        return {"points": xy, "target": target}
    if cfg.app == "nsdf":
        p, target = scenes.nsdf_batch(gen, batch_size)
        return {"points": p, "target": target}
    cam = cam or scenes.default_camera()
    origins, dirs, target = scenes.nerf_ray_batch(gen, cam, batch_size,
                                                  gt_samples=gt_samples)
    return {"origins": origins, "dirs": dirs, "target": target}


def _device(device: DeviceLike, mesh) -> torch.device:
    """Where a run's params and batches live: ``device`` (CUDA unless
    named), or with a mesh its first device, which ``device`` must then be
    if given."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is not None and resolve_device(device) != first:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}")
    return first


def _start(cfg: FieldConfig, seed: int, params, dev: torch.device,
           batch_size: int, gt_samples: int,
           batch_fn: Optional[Callable]):
    """(initial params on the device, the step's batch function)."""
    if params is None:
        params = fields.init_field(cfg, torch.Generator().manual_seed(seed),
                                   device=dev)
    else:            # a copy: the updates are in place
        params = optim.tree_map(lambda p: p.to(dev, copy=True), params)
    if batch_fn is None:
        cam = scenes.default_camera() if cfg.app in ("nerf", "nvr") else None

        def batch_fn(step):
            return make_batch(cfg, batch_generator(seed, step, dev),
                              batch_size, cam, gt_samples=gt_samples)
    return params, batch_fn


def train_field(cfg: FieldConfig, steps: int = 200, batch_size: int = 2048,
                seed: int = 0, fused: bool = True, log_every: int = 50,
                opt_cfg: Optional[optim.AdamConfig] = None,
                callback: Optional[Callable] = None, *,
                chunk_steps: int = 16, grad_accum: int = 1,
                ckpt_dir=None, ckpt_every: int = 50,
                compression: Optional[str] = None,
                compression_topk: float = 0.05,
                mesh=None, rules=None,
                on_metrics: Optional[Callable] = None,
                n_samples: Optional[int] = None, gt_samples: int = 64,
                occupancy_res: Optional[int] = None,
                occupancy_every: int = 1,
                occupancy_threshold: float = 0.01,
                occupancy_decay: float = 0.95,
                params: Optional[Dict] = None,
                batch_fn: Optional[Callable] = None,
                device: DeviceLike = None,
                metrics_registry=None):
    """Field training against the analytic scene on the engine
    (``train/loop.py``), on ``device`` (CUDA unless the caller names
    another); ``fused=False`` trains on the unfused route. Returns
    ``(params, history)``, history holding ``(step, loss)`` at
    ``log_every`` boundaries and the final step; ``callback(step, loss,
    params)`` fires at the same points with the chunk-end params,
    ``on_metrics(step, row, state)`` at every step. ``metrics_registry``
    is the engine's registry (``train.*`` and ``health.*`` metrics;
    default: a fresh one).

    ``params`` starts from a given tree (copied; default: ``init_field``
    from ``seed``); ``batch_fn(step) -> batch`` replaces the seeded batch
    makers, so a test can feed the JAX package's batches. ``grad_accum``,
    ``compression`` ("topk" at ``compression_topk``, or "int8", on the
    table gradient) and ``ckpt_dir`` (resume from its newest checkpoint,
    save every ``ckpt_every`` steps at chunk ends and at the last step)
    are the engine's, and so is ``mesh`` (with ``rules``): each step's
    batch splits over the mesh's ``field_batch`` shards, each shard's
    gradient runs on its device, and their mean updates the params
    (``train/loop.data_parallel_grad_fn``). With a mesh the params and
    batches live on its first device (``device``, if given, must be it),
    and the batches follow the RNG contract unchanged, so a data-parallel
    run sees the unsharded run's global batches.

    ``occupancy_res`` (nerf, nvr) keeps an occupancy grid off the
    engine's chunk ends, as the JAX package does: built at the first chunk
    end, refreshed by ``update_occupancy`` (``occupancy_decay``,
    ``occupancy_threshold``) at every ``occupancy_every``-th chunk end
    after it, and attached to the returned params as ``'occupancy'``. It
    stays out of the optimizer state and the checkpoint."""
    if occupancy_res is not None and cfg.app not in ("nerf", "nvr"):
        raise ValueError("occupancy_res is only meaningful for the ray "
                         f"apps (nerf, nvr), not app={cfg.app!r}")
    opt_cfg = opt_cfg or optim.AdamConfig(lr=1e-2)
    step_fn = loop.make_scanned_step(
        lambda p, b: field_loss(p, cfg, b, n_samples=n_samples, fused=fused),
        opt_cfg, grad_accum=grad_accum, compression=compression,
        compression_topk=compression_topk, mesh=mesh, rules=rules)
    ecfg = loop.EngineConfig(steps=steps, chunk_steps=chunk_steps,
                             ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    params, batch_fn = _start(cfg, seed, params, _device(device, mesh),
                              batch_size, gt_samples, batch_fn)
    occ_box = {"occ": None, "chunks": 0}

    def refresh_occupancy(end, st):
        occ_box["chunks"] += 1
        if occ_box["occ"] is None:
            occ_box["occ"] = occupancy.build_occupancy(
                st["params"], cfg, res=occupancy_res,
                threshold=occupancy_threshold)
        elif occ_box["chunks"] % occupancy_every == 0:
            occ_box["occ"] = occupancy.update_occupancy(
                occ_box["occ"], st["params"], cfg, decay=occupancy_decay,
                threshold=occupancy_threshold)

    engine = loop.TrainEngine(
        ecfg, step_fn, batch_fn=batch_fn,
        on_chunk_end=refresh_occupancy if occupancy_res is not None
        else None, metrics_registry=metrics_registry)
    history = []

    def _on_metrics(i, row, st):
        if i % log_every == 0 or i == steps - 1:
            history.append((i, row["loss"]))
            if callback:
                callback(i, row["loss"], st["params"])
        if on_metrics:
            on_metrics(i, row, st)

    state, _ = engine.run(
        loop.init_train_state(params, compression=compression),
        on_metrics=_on_metrics)
    if occ_box["occ"] is not None:
        return occupancy.attach(state["params"], occ_box["occ"]), history
    return state["params"], history


def train_field_reference(cfg: FieldConfig, steps: int = 200,
                          batch_size: int = 2048, seed: int = 0,
                          fused: bool = True, log_every: int = 50,
                          opt_cfg: Optional[optim.AdamConfig] = None,
                          n_samples: Optional[int] = None,
                          gt_samples: int = 64,
                          params: Optional[Dict] = None,
                          batch_fn: Optional[Callable] = None,
                          device: DeviceLike = None):
    """The per-step loop without the engine, its parity oracle: one host
    read of the loss per logged step, the same RNG contract, so the loss
    histories agree."""
    params, batch_fn = _start(cfg, seed, params, resolve_device(device),
                              batch_size, gt_samples, batch_fn)
    opt_state = optim.adam_init(params)
    step_fn = make_field_train_step(cfg, opt_cfg, n_samples=n_samples,
                                    fused=fused)
    history = []
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, batch_fn(i))
        if i % log_every == 0 or i == steps - 1:
            history.append((i, float(metrics["loss"])))
    return params, history


def sparse_table_stats(cfg: FieldConfig, params, batch) -> Dict[str, float]:
    """Fraction of hash-table rows touched by one batch's gradient."""
    _, grads = loop.value_and_grad(lambda p, b: field_loss(p, cfg, b),
                                   params, batch)
    touched = torch.any(grads["grid"] != 0.0, dim=-1)      # (L, T)
    return {"touched_rows_frac": float(touched.float().mean()),
            "table_rows": int(touched.numel())}


def psnr(mse: float) -> float:
    """Host-side PSNR of an MSE."""
    return -10.0 * math.log10(max(mse, 1e-12))
