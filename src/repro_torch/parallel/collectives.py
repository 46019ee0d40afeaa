"""Collectives over the positions of one tensor-parallel group, for the
one process that drives a whole mesh (``launch/mesh.Mesh``: no
``torch.distributed``, since the card machine has one card and repeats it
as every position).

A :class:`Group` is the mesh positions that compute one row of a sharded
step together: one per coordinate of the 'model' axis, in that
order (``parallel/api``), each with its device. Every collective takes one
tensor per rank of the group, in rank order, and returns one per rank, on
the rank's device:

* :func:`all_gather` joins the ranks' tensors along ``dim``;
* :func:`all_reduce` sums them;
* :func:`reduce_scatter` sums them and hands rank ``r`` the ``r``-th of
  ``size`` equal pieces along ``dim``;
* :func:`all_to_all` cuts each rank's tensor into ``size`` equal pieces
  along ``split_dim`` and hands rank ``r`` every rank's ``r``-th piece,
  joined along ``cat_dim`` in rank order.

A sum is taken in rank order (``((x0 + x1) + x2) + ...``, each term moved
to the receiving rank's device), so it is deterministic and bit-equal on
every rank. Each collective is a ``torch.autograd.Function`` whose
backward is its Megatron dual, the transpose of its forward: all-gather
and reduce-scatter are each other's, all-reduce is its own, and
all-to-all's is the all-to-all with its two dims swapped.

A group that counts one position of a mesh no process drives
(``launch/dryrun.py``, on meta tensors) runs only some of its ranks
(``Group.ranks``); the ranks it does not run contribute empty tensors of
the running ranks' shapes, which is what a receiving buffer costs.

:func:`tally` counts the bytes each collective moves into each running
rank, by kind (the memory plans' and the dry run's collective terms).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch


class Group:
    """``devices``: the device of each rank (the 'model' coordinate);
    ``positions``: each rank's mesh position; ``ranks``: the ranks this
    process runs (every one, unless a count stands in for the rest)."""

    def __init__(self, devices: Sequence[torch.device],
                 positions: Optional[Sequence[int]] = None,
                 ranks: Optional[Sequence[int]] = None):
        self.devices = list(devices)
        self.positions = (list(range(len(self.devices))) if positions is None
                          else list(positions))
        self.ranks = (list(range(len(self.devices))) if ranks is None
                      else list(ranks))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Group(positions={self.positions}, ranks={self.ranks})"


_TALLIES: List[Dict] = []


@contextlib.contextmanager
def tally():
    """Within the block every collective adds the bytes it moves into each
    running rank (those it receives from the other ranks) to the yielded
    dict: ``{kind: {rank's position: bytes}}``, kinds ``all-gather``,
    ``all-reduce``, ``reduce-scatter`` and ``all-to-all``, and under
    ``"spans"`` the
    positions each kind joined (``{kind: {sorted positions}}``)."""
    out: Dict = {}
    _TALLIES.append(out)
    try:
        yield out
    finally:
        _TALLIES.remove(out)


def record(kind: str, received: Dict[int, int], span: Sequence[int]
           ) -> None:
    """Add ``received`` (bytes into each position) to every open tally
    under ``kind``; ``span`` is the positions the collective joins (the
    tally keeps each distinct span under ``"spans"``)."""
    for t in _TALLIES:
        acc = t.setdefault(kind, {})
        for p, n in received.items():
            acc[p] = acc.get(p, 0) + int(n)
        t.setdefault("spans", {}).setdefault(kind, set()).add(
            tuple(sorted(span)))


def _record(group: Group, kind: str, received: Sequence[int]) -> None:
    if _TALLIES:
        record(kind, {group.positions[r]: n
                      for r, n in zip(group.ranks, received)},
               group.positions)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _every_rank(group: Group, xs: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """One tensor per rank of the group: the running ranks' own, empty
    stand-ins for the others (meta tensors only: a real run runs them
    all)."""
    if len(xs) != len(group.ranks):
        raise ValueError(f"{len(xs)} tensors for the {len(group.ranks)} "
                         f"running ranks of {group}")
    if len(group.ranks) == group.size:
        return list(xs)
    if not all(x.is_meta for x in xs):
        raise ValueError("only a count on meta tensors runs part of a group")
    out = [torch.empty_like(xs[0]) for _ in range(group.size)]
    for r, x in zip(group.ranks, xs):
        out[r] = x
    return out


def _sum_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def _gather(group: Group, xs, dim: int) -> List[torch.Tensor]:
    every = _every_rank(group, xs)
    _record(group, "all-gather",
            [sum(_nbytes(x) for q, x in enumerate(every) if q != r)
             for r in group.ranks])
    return [torch.cat([x.to(group.devices[r]) for x in every], dim=dim)
            for r in group.ranks]


def _reduce(group: Group, xs) -> List[torch.Tensor]:
    every = _every_rank(group, xs)
    _record(group, "all-reduce",
            [sum(_nbytes(x) for q, x in enumerate(every) if q != r)
             for r in group.ranks])
    return [_sum_to(every, group.devices[r]) for r in group.ranks]


def _scatter(group: Group, xs, dim: int) -> List[torch.Tensor]:
    every = _every_rank(group, xs)
    n = every[0].shape[dim] // group.size
    if n * group.size != every[0].shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(every[0].shape)} does not "
                         f"split over {group.size} ranks")
    _record(group, "reduce-scatter",
            [sum(_nbytes(x) for q, x in enumerate(every) if q != r)
             // group.size for r in group.ranks])
    return [_sum_to([x.narrow(dim, r * n, n) for x in every],
                    group.devices[r]) for r in group.ranks]


def _exchange(group: Group, xs, split_dim: int, cat_dim: int
              ) -> List[torch.Tensor]:
    every = _every_rank(group, xs)
    n = every[0].shape[split_dim] // group.size
    if n * group.size != every[0].shape[split_dim]:
        raise ValueError(f"dim {split_dim} of {tuple(every[0].shape)} does "
                         f"not split over {group.size} ranks")
    _record(group, "all-to-all",
            [sum(_nbytes(x) for q, x in enumerate(every) if q != r)
             // group.size for r in group.ranks])
    return [torch.cat([x.narrow(split_dim, r * n, n).to(group.devices[r])
                       for x in every], dim=cat_dim) for r in group.ranks]


class _AllGather(torch.autograd.Function):
    # autograd hands a backward zeros for an unused output (the default
    # materialize_grads), so every gradient is a tensor
    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        return tuple(_gather(group, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_scatter(ctx.group, gs, ctx.dim))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_reduce(group, xs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_reduce(ctx.group, gs))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *xs):
        ctx.group, ctx.dim = group, dim
        return tuple(_scatter(group, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_gather(ctx.group, gs, ctx.dim))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_dim, cat_dim, *xs):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return tuple(_exchange(group, xs, split_dim, cat_dim))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, cat_dim = ctx.dims
        return (None, None, None,
                *_exchange(ctx.group, gs, cat_dim, split_dim))


def all_gather(group: Group, xs: Sequence[torch.Tensor],
               dim: int) -> List[torch.Tensor]:
    """Every rank's tensors joined along ``dim``, on each running rank."""
    if group.size == 1:
        return list(xs)
    return list(_AllGather.apply(group, dim, *xs))


def all_reduce(group: Group, xs: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """The sum of every rank's tensor, in rank order, on each running
    rank."""
    if group.size == 1:
        return list(xs)
    return list(_AllReduce.apply(group, *xs))


def reduce_scatter(group: Group, xs: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
    """Rank ``r``'s piece along ``dim`` of the sum of every rank's
    tensor."""
    if group.size == 1:
        return list(xs)
    return list(_ReduceScatter.apply(group, dim, *xs))


def all_to_all(group: Group, xs: Sequence[torch.Tensor], split_dim: int,
               cat_dim: int) -> List[torch.Tensor]:
    """Rank ``r``'s ``r``-th piece along ``split_dim`` of every rank's
    tensor, joined along ``cat_dim`` in rank order."""
    if group.size == 1:
        return list(xs)
    return list(_AllToAll.apply(group, split_dim, cat_dim, *xs))
