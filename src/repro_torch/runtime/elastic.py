"""Elastic scaling: rebuild the mesh after a node is lost, and resume.

The JAX package's ``runtime/elastic.py`` for the port. The checkpoint
layout does not depend on the mesh (``checkpoint/store.py``), so recovery
is policy:

  1. ``FailurePolicy`` emits a ``FailureEvent`` (dead hosts, stragglers).
  2. :func:`remesh_plan` picks the largest valid ``(data, model)`` grid on
     the surviving devices, shrinking 'data' first.
  3. :func:`recover` builds that mesh, restores the newest checkpoint onto
     its first device and rebuilds the step against it.

On a shrink the global batch is kept by raising each replica's
micro-batching (gradient accumulation, ``microbatch_multiplier``), so the
optimizer schedule is unchanged and the step counter continues from the
checkpoint.

:func:`recover` has two forms. Given an LM ``ModelConfig`` (the JAX
form) it restores the train state with the shardings of
``parallel/api.param_specs`` on the new mesh, each leaf placed shard by
shard (``checkpoint/store.restore(shardings=)``), and builds the step with
``make_step(cfg, mesh, rules)``. Given a field training state
(``train/loop.init_train_state``), whose params replicate on every
device, it restores that structure onto the new mesh's first device and
builds the step with ``make_step(mesh, rules)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.launch.mesh import Mesh, local_devices


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    microbatch_multiplier: int     # grad-accum factor to keep global batch

    @property
    def chips(self) -> int:
        return self.data * self.model


def _divisors_desc(n: int) -> List[int]:
    return sorted({d for i in range(1, int(math.isqrt(n)) + 1)
                   if n % i == 0 for d in (i, n // i)}, reverse=True)


def remesh_plan(surviving_chips: int, old_data: int, old_model: int,
                max_model: Optional[int] = None) -> MeshPlan:
    """Largest usable mesh on the survivors.

    Keeps 'model' as close to the old TP degree as possible (weight shard
    divisibility), shrinks 'data', and returns the grad-accum multiplier
    that preserves the global batch."""
    max_model = max_model or old_model
    best = None
    for model in _divisors_desc(surviving_chips):
        if model > max_model:
            continue
        if old_model % model != 0:   # keep weight divisibility
            continue
        data = surviving_chips // model
        score = (model == old_model, model, data)
        if best is None or score > best[0]:
            best = (score, MeshPlan(
                data=data, model=model,
                microbatch_multiplier=max(1, math.ceil(
                    old_data / data))))
    if best is None:
        raise ValueError(f"no valid mesh for {surviving_chips} chips")
    return best[1]


def build_mesh(plan: MeshPlan,
               devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``plan.chips`` of
    ``devices`` (default: the visible CUDA cards)."""
    devices = list(local_devices() if devices is None else devices)
    if len(devices) < plan.chips:
        raise ValueError(f"{plan} needs {plan.chips} devices, "
                         f"{len(devices)} given")
    return Mesh(np.array(devices[:plan.chips], dtype=object).reshape(
        plan.data, plan.model), ("data", "model"))


def _template_on(tree, device: torch.device):
    """``tree``'s structure with uninitialised tensors of each leaf's shape
    and dtype on ``device`` (ints, as Adam's step, stay)."""
    if isinstance(tree, dict):
        return {k: _template_on(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_template_on(getattr(tree, f), device)
                            for f in tree._fields))
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    return tree


def _lm_state(checkpoint_dir, cfg, mesh: Mesh, rules, step: int):
    """An LM train state restored onto ``mesh``: sharded by
    ``param_specs`` on a mesh of more than one device, else whole on its
    device."""
    from repro_torch.common.partitioning import specs_to_shardings
    from repro_torch.parallel import api
    from repro_torch.train import optim
    shapes, specs = api.param_specs(cfg, mesh, rules)
    target = {"params": shapes,
              "opt": optim.AdamState(step=0, mu=shapes, nu=shapes)}
    if mesh.size == 1:
        return store.restore(checkpoint_dir,
                             _template_on(target, mesh.devices[0]), step=step)
    shardings = specs_to_shardings(api.train_state_specs(specs), mesh)
    return store.restore(checkpoint_dir, target, step=step,
                         shardings=shardings)


def recover(checkpoint_dir, state, plan: MeshPlan, rules=None,
            make_step: Optional[Callable] = None,
            devices: Optional[Sequence] = None):
    """Rebuild ``(mesh, step_fn, state, resumed_step)`` on the
    post-failure mesh: the mesh of ``plan`` over ``devices``
    (:func:`build_mesh`) and the newest checkpoint under
    ``checkpoint_dir`` restored onto it.

    ``state`` is an LM ``ModelConfig`` (the JAX form: the train state
    ``{"params", "opt"}`` restored with ``param_specs``' shardings under
    ``rules``, default the JAX default rules, and ``make_step(cfg, mesh,
    rules)``) or a field training state (its structure, shapes and dtypes
    restored on the mesh's first device, and ``make_step(mesh, rules)``).
    The step should accumulate ``plan.microbatch_multiplier``
    micro-batches to keep the global batch; ``step_fn`` is None without
    ``make_step``."""
    from repro_torch.models.config import ModelConfig
    mesh = build_mesh(plan, devices)
    step = store.latest_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    if isinstance(state, ModelConfig):
        from repro_torch.common.partitioning import DEFAULT_RULES
        rules = rules or DEFAULT_RULES.copy_with()
        restored = _lm_state(checkpoint_dir, state, mesh, rules, step)
        step_fn = make_step(state, mesh, rules) if make_step else None
        return mesh, step_fn, restored, step
    restored = store.restore(checkpoint_dir,
                             _template_on(state, mesh.devices[0]), step=step)
    step_fn = make_step(mesh, rules) if make_step else None
    return mesh, step_fn, restored, step
