"""Recomputation in the LM backward: the port's ``jax.checkpoint``.

The JAX package bounds training memory by checkpointing in three places:
each block (``ModelConfig.remat``), the cross entropy's sequence chunk and
chunked attention's query block. The port does the same with
``torch.utils.checkpoint`` (non-reentrant): the wrapped function saves its
inputs only, and the backward runs it again to get what it needs.

``remat="dots"`` is selective: the block saves the outputs of its matrix
products that have no batch dimension (``aten.mm`` and ``aten.addmm``:
every ``x @ w`` of an activation and a weight) and recomputes the rest,
as ``jax.checkpoint_policies.checkpoint_dots_no_batch_dims`` does.
Batched products (attention's scores and values, the MoE experts'
``bmm``) are recomputed. The gradients are the same for every policy; only
memory and time differ.

Without autograd recording (serving, ``torch.no_grad``) every function
here runs its argument plainly.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils import checkpoint as tcp

_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def checkpoint(fn: Callable, *args):
    """``fn(*args)``, its intermediates recomputed by the backward."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return tcp.checkpoint(fn, *args, use_reentrant=False)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return tcp.CheckpointPolicy.MUST_SAVE
    return tcp.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_checkpoint(fn: Callable, *args):
    if not torch.is_grad_enabled():
        return fn(*args)
    return tcp.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=functools.partial(tcp.create_selective_checkpoint_contexts,
                                     _dots_policy))


def maybe_remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the block policy ``policy``: "full", "dots", or any
    other value for none (the JAX package's ``lm._maybe_remat``)."""
    if policy == "full":
        return functools.partial(checkpoint, fn)
    if policy == "dots":
        return functools.partial(_dots_checkpoint, fn)
    return fn
