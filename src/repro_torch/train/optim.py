"""Adam over a param tree (nested dicts of tensors): the JAX package's
``train/optim.py`` in plain tensor ops, not ``torch.optim``.

The formula is the JAX one term for term: with the step t counted from 1,
``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, and
``p -= lr * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps))``, the
bias corrections and the learning rate taken in f32 as the JAX package
takes them. Two differences, both of form:

- the step is a host integer, so the learning rate and the corrections are
  host numbers and reading them never waits for the device;
- ``adam_update`` updates the params and the moments in place (the JAX
  version returns new trees): a Table-I gia stack is 2 GiB, and its two
  moments 4 GiB more, so new trees would double that every step. For the
  same reason it scales clipped gradients as it reads them, and updates a
  leaf larger than ``UPDATE_SLICE`` elements a slice of rows at a time
  (mamba2-2.7b's stacked ``w_in`` is 1.7 G elements): the update is
  elementwise, so the results are the same bits, and its temporaries are
  one slice's, not the leaf's.

``optimizer_spec`` gives the logical specs of an ``AdamState`` from the
params' ones, as the JAX function does.

Sharded leaves (``parallel/sharded.Sharded``, the LM train state on a
mesh): Adam runs shard by shard (it is elementwise, so shard-local Adam
is the unsharded Adam, and copies of a replicated slice, given the same
gradient, stay bit-equal), and the clip's global norm sums each distinct
slice once (a replicated slice's copies are not counted again), on the
first leaf's first shard's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel.sharded import Sharded, map_sharded

# elements of the largest piece of a leaf that ``adam_update`` and
# ``global_norm`` process at once
UPDATE_SLICE = 1 << 26


class AdamState(NamedTuple):
    step: int              # updates taken so far
    mu: Dict               # first moment, like params
    nu: Dict               # second moment, like params


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-2                 # instant-NGP uses 1e-2 for fields
    b1: float = 0.9
    b2: float = 0.99                 # instant-NGP: 0.99
    eps: float = 1e-10               # instant-NGP: 1e-10
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0          # cosine decay horizon; 0 = constant


def tree_map(fn, *trees):
    """``fn`` over the leaves of dicts of one structure."""
    first = trees[0]
    return {k: (tree_map(fn, *(t[k] for t in trees))
                if isinstance(first[k], Mapping) else fn(*(t[k] for t in trees)))
            for k in first}


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in sorted-key order, the order ``jax.tree.leaves`` gives
    a dict tree."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def zeros_like(x):
    """Zeros of a leaf's shape, dtype and layout (sharded or not)."""
    return map_sharded(torch.zeros_like, x)


def adam_init(params) -> AdamState:
    return AdamState(step=0, mu=tree_map(zeros_like, params),
                     nu=tree_map(zeros_like, params))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: AdamConfig, step: int) -> float:
    """Learning rate at optimizer step ``step`` (1-indexed: the first
    ``adam_update`` evaluates step=1), computed in f32 as the JAX package
    computes it. Linear warmup over ``lr_warmup_steps``, then cosine decay
    to 0 over ``lr_decay_steps``; with both at 0 the lr is constant."""
    lr = _f32(cfg.lr)
    if cfg.lr_warmup_steps > 0:
        lr = lr * torch.clamp(_f32(step + 1) / _f32(cfg.lr_warmup_steps),
                              max=1.0)
    if cfg.lr_decay_steps > 0:
        frac = torch.clamp(_f32(step) / _f32(cfg.lr_decay_steps), 0.0, 1.0)
        lr = lr * 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
    return float(lr)


def _row_slices(t: torch.Tensor) -> List[Any]:
    """Indices of pieces of ``t``'s first axis of at most ``UPDATE_SLICE``
    elements each (``...``, the whole, for a small leaf or a 0-d one)."""
    if t.ndim == 0 or t.numel() <= UPDATE_SLICE:
        return [...]
    rows = max(1, UPDATE_SLICE // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _sumsq(l: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(l[s].to(torch.float32)))
               for s in _row_slices(l))


def _leaf_sumsq(l, home: torch.device) -> torch.Tensor:
    if isinstance(l, Sharded):
        return sum(_sumsq(l.shards[p]).to(home) for p in l.owners())
    return _sumsq(l).to(home)


def _home(tree) -> torch.device:
    first = tree_leaves(tree)[0]
    return (first.shards[0] if isinstance(first, Sharded) else first).device


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of every leaf together, on the first leaf's device (a
    leaf larger than ``UPDATE_SLICE`` summed a slice of rows at a time; a
    sharded leaf's distinct slices once each)."""
    home = _home(tree)
    return torch.sqrt(sum(_leaf_sumsq(l, home) for l in tree_leaves(tree)))


def _clip_scale(grads, max_norm: float):
    """(the scale that clips ``grads`` to a global norm of at most
    ``max_norm``, the norm), both on the device."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before); the scale stays on the device."""
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: map_sharded(lambda t: t * scale.to(t.device),
                                          g), grads), norm


def adam_update(grads, state: AdamState, params, cfg: AdamConfig
                ) -> Tuple[Any, AdamState, Dict[str, Any]]:
    """One Adam step: updates ``params`` and the moments of ``state`` in
    place and returns (params, the new state, metrics: ``lr`` and, with
    clipping, ``grad_norm``)."""
    metrics: Dict[str, Any] = {}
    scale = None
    if cfg.grad_clip is not None:
        scale, metrics["grad_norm"] = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1.0 - _f32(b1) ** _f32(step))
    bc2 = float(1.0 - _f32(b2) ** _f32(step))

    def upd_rows(p, m, v, g):
        if scale is not None:
            g = g * scale.to(g.device)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            u.add_(p, alpha=cfg.weight_decay)
        p.sub_(u.mul_(lr).to(p.dtype))

    def upd_local(p, m, v, g):
        for s in _row_slices(p):
            upd_rows(p[s], m[s], v[s], g[s])
        return p

    def upd(p, m, v, g):
        if not isinstance(p, Sharded):
            return upd_local(p, m, v, g)
        for parts in zip(p.shards, m.shards, v.shards, g.shards):
            upd_local(*parts)
        return p

    with torch.no_grad():
        params = tree_map(upd, params, state.mu, state.nu, grads)
    metrics["lr"] = lr
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), metrics


def optimizer_spec(param_specs) -> AdamState:
    """Logical specs of an ``AdamState`` given the params' logical specs."""
    return AdamState(step=(), mu=param_specs, nu=param_specs)
