"""Sharded leaves: what a ``jax.Array`` with a ``NamedSharding`` is to the
JAX package, for the port's one-process meshes (``launch/mesh.Mesh``).

A :class:`Sharded` leaf is a global shape, a
``common/partitioning.NamedSharding`` and one tensor per mesh position, in
the shape ``sharding.shard_shape(shape)`` gives, on that position's
device. A dimension the spec leaves whole is copied whole onto every
position, so the bytes each position holds (:func:`shard_bytes`) are those
each device holds under the JAX package. A mesh that repeats a device (one
card as a (2, 2) mesh) keeps each position's tensor separately on it: the
card then holds the sum of its positions.

* :func:`place` and :func:`shard_tree` make the shards of a tensor or of a
  ``common/param.LazyLeaf`` (a sharded init draws each shard on its
  device from the one-device init's draws); :func:`gather` and
  :func:`gather_tree` make the whole tensor on one device from the first
  position holding each distinct slice.
* :func:`gather_region` is the steps' block-wise gather: a region of one
  block of a leaf (per dim, global ranges) for one position, a view of
  its own shard when that is the region, else copied from the shards
  that hold it (``parallel/tp.BlockSource``). Given gradient buffers it
  is differentiable: its backward adds the region's gradient into the
  buffer of every position holding each piece (a reduce-scatter; every
  copy of a replicated slice gets the same sum, so the copies stay equal
  under Adam), so no device ever holds a whole leaf in a train step.
* :class:`RowContext` carries the rows of one sharded forward for the one
  layer whose result depends on other rows' tokens: the MoE's capacity
  slots count the assignments of the whole token group, which the JAX
  step's global batch holds (``models/moe.apply_moe``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.param import LazyLeaf
from repro_torch.common.partitioning import NamedSharding
from repro_torch.parallel import collectives as coll


class Sharded:
    """A global leaf of ``shape`` as one tensor per mesh position."""

    __slots__ = ("sharding", "shape", "shards")

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 shards: List[torch.Tensor]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.shards = list(shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def indices(self) -> List[Tuple[slice, ...]]:
        return self.sharding.indices(self.shape)

    def owners(self) -> List[int]:
        """The first position holding each distinct slice."""
        return self.sharding.owners(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, "
                f"{self.sharding.spec!r})")


def map_sharded(fn, *leaves):
    """``fn`` shard by shard over leaves of one sharding (a plain tensor
    leaf: ``fn`` once)."""
    if not isinstance(leaves[0], Sharded):
        return fn(*leaves)
    first = leaves[0]
    return Sharded(first.sharding, first.shape,
                   [fn(*parts) for parts in zip(*(l.shards for l in leaves))])


def place(leaf, sharding: NamedSharding) -> Sharded:
    """``leaf`` (a tensor anywhere, or a ``LazyLeaf``) as shards on the
    positions of ``sharding``: each its own contiguous tensor."""
    shape = tuple(leaf.shape)
    shard_shape = sharding.shard_shape(shape)
    indices = sharding.indices(shape)
    devices = sharding.mesh.devices
    shards = [torch.empty(shard_shape, dtype=leaf.dtype, device=d)
              for d in devices]
    if not isinstance(leaf, LazyLeaf):
        for out, idx in zip(shards, indices):
            out.copy_(leaf[idx])
        return Sharded(sharding, shape, shards)
    # a lazy leaf: the one-device init's draws, made once on each distinct
    # device and cut into the shards of the positions there
    for dev in dict.fromkeys(devices):
        mine = [p for p, d in enumerate(devices) if d == dev]
        for i, part in enumerate(leaf.parts(dev)):
            for p in mine:
                idx = indices[p]
                if len(shape) >= 3:
                    if idx[0].start <= i < idx[0].stop:
                        shards[p][i - idx[0].start].copy_(part[idx[1:]])
                else:
                    shards[p].copy_(part[idx])
    return Sharded(sharding, shape, shards)


def shard_tree(tree, shardings):
    """Every leaf of ``tree`` (dicts) placed by the NamedSharding at the
    same path of ``shardings``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings)


def gather(leaf, device: torch.device) -> torch.Tensor:
    """The whole tensor of ``leaf`` on ``device`` (a plain tensor: moved)."""
    if not isinstance(leaf, Sharded):
        return leaf.to(device)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    indices = leaf.indices()
    for p in leaf.owners():
        out[indices[p]].copy_(leaf.shards[p])
    return out


def _segments(have: slice, want) -> List[Tuple[int, int, int]]:
    """(source start, stop, destination start) of the global ``want``
    ranges (a list of (start, stop), laid end to end in the destination)
    that the slice ``have`` holds, the source relative to ``have``."""
    out, dst = [], 0
    for a, b in want:
        lo, hi = max(a, have.start), min(b, have.stop)
        if lo < hi:
            out.append((lo - have.start, hi - have.start, dst + lo - a))
        dst += b - a
    return out


def region_copies(leaf: Sharded, region, position: int,
                  prefer: Sequence[int] = ()) -> List[Tuple]:
    """How position ``position`` makes ``region`` of ``leaf`` (per dim a
    list of global (start, stop) ranges, or None for the whole dim): a
    list of (source position, source index, destination index), one for
    each distinct slice that holds part of the region, each taken from the
    position itself when it holds that slice, else from the first of
    ``prefer`` that does, else from the slice's first holder."""
    indices = leaf.indices()
    want = [[(0, n)] if r is None else list(r)
            for r, n in zip(region, leaf.shape)]
    holders: Dict = {}
    for q, idx in enumerate(indices):
        holders.setdefault(tuple((s.start, s.stop) for s in idx),
                           []).append(q)
    out = []
    for key, qs in holders.items():
        src = next((q for q in [position, *prefer] if q in qs), qs[0])
        segs = [_segments(s, w) for s, w in zip(indices[src], want)]
        if not all(segs):
            continue
        for parts in _product(segs):
            out.append((src, tuple(slice(a, b) for a, b, _ in parts),
                        tuple(slice(d, d + b - a) for a, b, d in parts)))
    return out


def _product(lists):
    if not lists:
        return [()]
    return [(x,) + rest for x in lists[0] for rest in _product(lists[1:])]


def region_shape(leaf: Sharded, region) -> Tuple[int, ...]:
    return tuple(n if r is None else sum(b - a for a, b in r)
                 for r, n in zip(region, leaf.shape))


def _holders(leaf: Sharded) -> Dict[int, List[int]]:
    """For each position, every position holding the same slice of
    ``leaf`` (itself included), in position order."""
    by_slice: Dict = {}
    for q, idx in enumerate(leaf.indices()):
        by_slice.setdefault(tuple((s.start, s.stop) for s in idx),
                            []).append(q)
    return {q: qs for qs in by_slice.values() for q in qs}


class _GatherRegion(torch.autograd.Function):
    """The block-wise gather with a way back. Forward: the region, a view
    of the source when it is the position's own shard (``view``), else a
    new tensor filled from the sources. Backward: each source's pieces of
    the region's gradient added, in the buffers' dtype on their devices,
    into the gradient buffer of every position holding that slice (the
    step's gradients; the sources themselves get none), so every copy of
    a replicated slice gets the same sum."""

    @staticmethod
    def forward(ctx, plan, sink, *sources):
        ctx.copies, ctx.sink = plan[3], sink
        out = _region(plan, sources)
        return out.view_as(out) if plan[4] else out

    @staticmethod
    def backward(ctx, grad):
        buffers, position, holders, srcs = ctx.sink
        sent, span = 0, {position}
        for i, sidx, didx in ctx.copies:
            piece = grad[didx]
            for q in holders[srcs[i]]:
                buf = buffers.shards[q]
                buf[sidx] += piece.to(buf.device, buf.dtype)
                if q != position:
                    sent += piece.numel() * piece.element_size()
                    span.add(q)
        if sent:      # the gathers' dual: what this rank sends back, which
            # the layout's symmetry makes what each position receives
            coll.record("reduce-scatter", {position: sent}, sorted(span))
        return (None, None) + (None,) * len(srcs)


def _region(plan, sources) -> torch.Tensor:
    """The region a gather ``plan`` makes of its ``sources``: the one
    source itself when it is the region (``view``), else a new tensor."""
    shape, dtype, device, copies, view = plan
    if view:
        return sources[0]
    out = torch.empty(shape, dtype=dtype, device=device)
    for i, sidx, didx in copies:
        out[didx].copy_(sources[i][sidx])
    return out


def gather_region(leaf: Sharded, region, position: int,
                  device: torch.device, dtype: torch.dtype,
                  block: Optional[int] = None,
                  prefer: Sequence[int] = (),
                  grad: Optional[Sharded] = None) -> torch.Tensor:
    """``region`` of ``leaf`` (of its slice ``block`` along the stack dim,
    when given; the region then names the remaining dims) in ``dtype`` on
    ``device``, for position ``position``: a view of its own shard when
    that is the region and no cast is needed, else a new tensor filled
    from the shards that hold it (:func:`region_copies`).

    With ``grad`` (a ``Sharded`` of gradient buffers laid out as
    ``leaf``) and autograd recording, the gather is differentiable
    (``_GatherRegion``): the backward adds the region's gradient into the
    buffers of the positions that hold it (a reduce-scatter over the axes
    the gather spans, each copy of a slice getting the whole sum), and
    records it in ``parallel/collectives.tally`` as the forward records
    its all-gather."""
    if block is not None:
        def inner(t: Sharded) -> Sharded:
            return Sharded(NamedSharding(t.sharding.mesh,
                                         tuple(t.sharding.spec)[1:]),
                           t.shape[1:], [s[block] for s in t.shards])
        return gather_region(inner(leaf), region, position, device, dtype,
                             prefer=prefer,
                             grad=None if grad is None else inner(grad))
    copies = region_copies(leaf, region, position, prefer)
    view = (len(copies) == 1 and copies[0][0] == position
            and leaf.dtype == dtype
            and leaf.shards[position].device == device
            and region_shape(leaf, region) == tuple(
                leaf.shards[position].shape))
    received = sum(leaf.shards[src][sidx].numel() * leaf.dtype.itemsize
                   for src, sidx, _ in copies if src != position)
    if received:      # the block-wise gather's share of the all-gathers
        coll.record("all-gather", {position: received},
                    [position] + [c[0] for c in copies])
    srcs = list(dict.fromkeys(src for src, _, _ in copies))
    plan = (region_shape(leaf, region), dtype, device,
            [(srcs.index(src), sidx, didx) for src, sidx, didx in copies],
            view)
    sources = [leaf.shards[q] for q in srcs]
    if grad is None or not torch.is_grad_enabled():
        return _region(plan, sources)
    return _GatherRegion.apply(plan, (grad, position, _holders(leaf), srcs),
                               *sources)


def gather_tree(tree, device: torch.device):
    """``tree`` (dicts, NamedTuples) with every leaf whole on ``device``;
    ints and other host leaves stay."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(getattr(tree, f), device)
                            for f in tree._fields))
    if isinstance(tree, (Sharded, torch.Tensor)):
        return gather(tree, device)
    return tree


def shard_bytes(tree) -> List[int]:
    """Bytes each mesh position holds of ``tree``'s sharded leaves (dicts,
    NamedTuples; other leaves are not counted)."""
    out: List[int] = []

    def visit(t):
        if isinstance(t, dict):
            for v in t.values():
                visit(v)
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                visit(getattr(t, f))
        elif isinstance(t, Sharded):
            if not out:
                out.extend([0] * len(t.shards))
            for p, s in enumerate(t.shards):
                out[p] += s.numel() * s.element_size()
    visit(tree)
    return out


class RowContext:
    """The rows of one sharded forward: ``n_rows`` equal pieces of the
    batch, run one after another in row order.

    For each layer key (``ActivationSharder.at_layer``) it keeps the MoE
    routing counts of the rows run so far, per global token group and
    expert, so a row's capacity slots continue its group's count as the
    JAX step's global cumsum does; ``prefix`` remembers the counts a
    (layer, row) started from, so the recomputation of a checkpointed
    block sees them again. ``stats`` holds each (layer, row)'s partial
    sums of the load-balance loss (``parallel/api`` forms the global loss
    from them)."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._running: Dict = {}
        self.prefix: Dict = {}
        self.stats: Dict = {}

    def start(self, layer, row: int, n_groups: int, n_experts: int,
              device: torch.device) -> Tuple[torch.Tensor, bool]:
        """(the counts that (``layer``, ``row``) starts from, True the
        first time it runs)."""
        key = (layer, row)
        if key in self.prefix:
            return self.prefix[key].to(device), False
        run = self._running.get(layer)
        if run is None:
            run = torch.zeros((n_groups, n_experts), dtype=torch.int64,
                              device=device)
        self.prefix[key] = run.to(device)
        return self.prefix[key], True

    def finish(self, layer, row: int, counts: torch.Tensor,
               stats: Dict) -> None:
        """Add (``layer``, ``row``)'s ``counts`` to the layer's running
        counts and keep its ``stats``."""
        self._running[layer] = self.prefix[(layer, row)] + counts
        self.stats[(layer, row)] = stats
