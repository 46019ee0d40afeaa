"""Tensor, expert and sequence parallelism of the sharded steps
(``parallel/api``: serving and training), on the port's one-process
meshes.

A row of a step's batch split (``api.row_positions``) runs on a
tensor-parallel group: the mesh positions along 'model' at the row's
coordinates (:func:`groups`), or the row's position alone when the batch
split itself uses 'model' (whisper's ``tinydp``). Each rank of the group
computes its own part (``models/blocks``: heads, ``mlp``, vocab, experts
and SSM heads split; the rest whole) and the ranks exchange what
``parallel/collectives`` moves.

* **Block-wise gathers.** :class:`BlockSource` hands each rank its slice
  of one block at a time (the embedding, each sub-layer of a period, the
  final norm, the unembedding): the leaf's 'model' chunk for the rank
  along a dim whose spec names 'model' (:func:`leaf_region`), whole along
  the rest, so a dim sharded over 'data' ('embed', FSDP) is gathered
  from the positions along 'data'. A rank whose own shard is the region
  takes a view (no copy); a leaf the compute copy narrows is cast as it
  is gathered (a train step hands it shards cast already). The model
  code drops a block's slices once it has run. In a train step the
  slices carry a way back: the gather's backward adds each slice's
  gradient into the step's buffers on the positions holding it
  (``sharded.gather_region``), and a block under remat gathers its
  slices again in the backward.
  The SSM's ``w_in`` (``[z | x | B | C | dt]``) and ``conv_w``/``conv_b``
  (``[x | B | C]``) are stored as the JAX package stores them, a
  contiguous 'model' chunk that is not one range of heads: a rank gathers
  its heads' columns of z, x and dt and the whole B and C (stated
  difference: GSPMD reshards the activations instead).
* **Every decision comes from the leaves' own specs**
  (``common/partitioning.divisible_fallback``): a dim that fell back is
  whole on every rank and computed whole there, as GSPMD computes it.
* **Caches** (:class:`RowCache`): each rank's leaf is the shard that
  JAX's ``cache_specs`` gives its position (:func:`cache_layout`): under
  ``baseline`` its contiguous chunk of the positions (or ring slots) for
  every KV head, when the cache length divides the group; else its KV
  heads when they divide; else the whole leaf; and the row's share of
  the batch. A sequence-split cache is filled by prefill with each rank's
  chunk (exchanged from the KV-head ranks by an all-to-all, or sliced
  where every rank computes every KV head), and decode attends it as a
  split softmax: each rank's partial over its own slots, combined across
  the group in f32 (``models/attention``). The SSM's state holds the
  rank's heads; its conv state the rank's x columns and the whole B and
  C (stated difference: JAX's shard is a contiguous chunk of
  ``[x | B | C]``, which would cost a gather every decode step).
* **Counting** (:func:`meta_params`, ``api.meta_serving_step``,
  ``api.meta_train_step``): one rank of one group on meta tensors, the
  other ranks' shards meta stand-ins and their collective terms empty
  buffers (``launch/dryrun.py``, ``api.step_collective_bytes``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.partitioning import (LogicalRules, NamedSharding,
                                             divisible_fallback)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharded import Sharded, gather_region

# the subtrees whose leaves are stacked over layers (one block a slice)
STACKED = ("blocks", "enc_layers", "dec_layers")
MODEL = "model"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def groups_for(mesh, batch_entry) -> List[List[int]]:
    """The positions of each row's group, in row order, for a batch split
    over the spec entry ``batch_entry``: the positions along 'model' at the
    row's coordinates (0 along the other axes the split does not use), or
    the row's position alone when the split uses 'model' or the mesh has
    no 'model' axis."""
    names = list(mesh.shape)
    shape = tuple(mesh.shape.values())
    used = _axes(batch_entry)
    pos = np.arange(math.prod(shape)).reshape(shape)
    index = tuple(slice(None) if a in used else 0 for a in names)
    kept = [a for a in names if a in used]
    rows = [int(p) for p in np.asarray(pos[index]).transpose(
        [kept.index(a) for a in used]).reshape(-1)]
    if MODEL not in mesh.shape or MODEL in used:
        return [[p] for p in rows]
    axis = names.index(MODEL)
    out = []
    for p in rows:
        coord = list(np.unravel_index(p, shape))
        group = []
        for m in range(mesh.shape[MODEL]):
            coord[axis] = m
            group.append(int(np.ravel_multi_index(coord, shape)))
        out.append(group)
    return out


def batch_entry(mesh, rules: LogicalRules, batch: int):
    """The spec entry of a batch of ``batch`` examples (a scratch rule
    set: a step records no fallback of its own)."""
    return divisible_fallback(mesh, (batch,), ("batch",),
                              LogicalRules(rules.rules))[0]


def groups(mesh, rules: LogicalRules, batch: int) -> List[List[int]]:
    return groups_for(mesh, batch_entry(mesh, rules, batch))


def seq_parallel(mesh, rules: LogicalRules, batch: int, seq: int,
                 size: int) -> bool:
    """True when a (batch, seq, embed) stream splits its sequence over
    'model' (the rules' 'act_seq', and ``seq`` divides), on a group of
    more than one rank."""
    spec = divisible_fallback(mesh, (batch, seq, 1),
                              ("batch", "act_seq", "act_embed"),
                              LogicalRules(rules.rules))
    return size > 1 and MODEL in _axes(spec[1])


def _chunk(n: int, rank: int, size: int) -> List[Tuple[int, int]]:
    k = n // size
    return [(rank * k, (rank + 1) * k)]


def ssm_split(cfg: ModelConfig, a_log_spec, size: int) -> bool:
    """True when a group of ``size`` ranks splits the SSM by heads: the
    heads divide (``A_log``'s 'model' entry) and one B/C group is shared
    by every head."""
    return (size > 1 and cfg.ssm.n_groups == 1
            and MODEL in _axes(tuple(a_log_spec)[-1]))


def _ssm_region(cfg: ModelConfig, name: str, shape, split: bool, rank: int,
                size: int):
    if not split:
        return (None,) * len(shape)
    di = cfg.ssm.d_inner(cfg.d_model)
    nh = cfg.ssm.n_heads(cfg.d_model)
    g = cfg.ssm.n_groups * cfg.ssm.d_state
    x = _chunk(di, rank, size)[0]
    heads = _chunk(nh, rank, size)
    if name == "w_in":        # [z | x | B | C | dt]
        cols = [x, (di + x[0], di + x[1]), (2 * di, 2 * di + 2 * g)] + [
            (2 * di + 2 * g + a, 2 * di + 2 * g + b) for a, b in heads]
        return (None, cols)
    if name in ("conv_w", "conv_b"):    # [x | B | C]
        cols = [x, (di, di + 2 * g)]
        return (None, cols) if name == "conv_w" else (cols,)
    if name in ("A_log", "D", "dt_bias"):
        return (heads,)
    if name == "norm_scale":
        return ([x],)
    if name == "w_out":
        return ([x], None)
    raise KeyError(name)


def leaf_region(cfg: ModelConfig, path: Tuple[str, ...], shape, spec,
                rank: int, size: int, ssm_heads: bool = False):
    """Rank ``rank``'s region of a block's leaf (``shape`` and ``spec``
    without the stack dim): per dim, its ranges, or None for the whole
    dim. The SSM's leaves take their heads' columns when ``ssm_heads``."""
    if "ssm" in path:
        return _ssm_region(cfg, path[-1], shape, ssm_heads, rank, size)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes(entry)
        if size > 1 and MODEL in axes:
            if axes[0] != MODEL:
                raise NotImplementedError(
                    f"{path}: 'model' must be the major axis of {entry}")
            out.append(_chunk(n, rank, size))
        else:
            out.append(None)
    return tuple(out)


def _casts(leaf, adtype: torch.dtype) -> bool:
    return (leaf.dtype == torch.float32 and len(leaf.shape) >= 2
            and adtype != torch.float32)


def walk(tree, path=()):
    """(path, leaf) pairs of a dict tree, or the one pair of a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _ssm_spec(tree):
    """The spec of the first SSM ``A_log`` leaf under ``tree`` (None
    without one)."""
    for path, leaf in walk(tree):
        if path[-2:] == ("ssm", "A_log"):
            return leaf.sharding.spec
    return None


class BlockSource:
    """Each running rank's slice of one block of the ``Sharded`` params
    tree ``params`` (the module docstring), in the compute dtype
    ``adtype``, for the group ``group``. With ``grads`` (a tree of
    ``Sharded`` gradient buffers laid out as ``params``: a train step) the
    slices are differentiable: the backward of each block's gather adds
    its gradient into the buffers of the positions holding it
    (``sharded.gather_region``)."""

    def __init__(self, params, cfg: ModelConfig, group: coll.Group,
                 adtype: torch.dtype, grads=None):
        self.params, self.cfg, self.group = params, cfg, group
        self.grads = grads
        self.adtype = adtype
        self.keys = set(params)
        spec = _ssm_spec(params)
        self.ssm_heads = spec is not None and ssm_split(
            cfg, tuple(spec)[1:], group.size)
        mesh = next(iter(walk(params)))[1].sharding.mesh
        # a rank's pieces come from its own 'model' column first
        self._prefer = {}
        if MODEL in mesh.shape:
            shape = tuple(mesh.shape.values())
            axis = list(mesh.shape).index(MODEL)
            coords = np.unravel_index(np.arange(math.prod(shape)), shape)
            for p in group.positions:
                m = coords[axis][p]
                self._prefer[p] = [int(q) for q in
                                   np.nonzero(coords[axis] == m)[0]]

    def block(self, path: Tuple[str, ...], index: Optional[int] = None
              ) -> List:
        """Each running rank's slice of the subtree at ``path`` (its stack
        slice ``index`` for a stacked subtree)."""
        tree, gtree = self.params, self.grads
        for k in path:
            tree = tree[k]
            gtree = None if gtree is None else gtree[k]
        out = []
        for r in self.group.ranks:
            p = self.group.positions[r]

            def take(sub, leaf: Sharded, r=r, p=p):
                grad = None
                if gtree is not None:
                    grad = gtree
                    for k in sub:
                        grad = grad[k]
                spec = tuple(leaf.sharding.spec) + (None,) * leaf.ndim
                shape, spec = ((leaf.shape[1:], spec[1:leaf.ndim])
                               if index is not None else
                               (leaf.shape, spec[:leaf.ndim]))
                region = leaf_region(self.cfg, path + sub, shape, spec, r,
                                     self.group.size, self.ssm_heads)
                dtype = self.adtype if _casts(leaf, self.adtype) \
                    else leaf.dtype
                return gather_region(leaf, region, p, self.group.devices[r],
                                     dtype, block=index,
                                     prefer=self._prefer.get(p, ()),
                                     grad=grad)
            out.append(_rebuild(tree, take))
        return out


# ------------------------------------------------------------------ caches
# a conv state's layout when the SSM splits by heads: its x columns and
# the whole B and C (the module docstring)
CONV = "conv"


def cache_layout(cfg: ModelConfig, cspecs, pspecs, size: int) -> Dict:
    """Each cache leaf's layout on a group of ``size`` ranks, from the
    cache's specs ``cspecs`` (``api.cache_specs``): the dim whose entry
    names 'model' (the sequence or the KV heads), of which rank ``r``
    holds the range ``[r * n, (r + 1) * n)``, ``n`` the dim over
    ``size``; None for a leaf whole on every rank. The SSM's leaves
    follow the params' split (``ssm_split`` of ``A_log``'s spec in
    ``pspecs``): ``ssm_state`` its heads' dim, ``conv_state`` ``CONV``."""
    spec = a_log_spec(pspecs)
    ssm = spec is not None and ssm_split(cfg, tuple(spec)[1:], size)

    def one(path, entry):
        if path[-1] == "ssm_state":
            return 2 if ssm else None
        if path[-1] == "conv_state":
            return CONV if ssm else None
        if size == 1:
            return None
        return next((d for d, e in enumerate(tuple(entry))
                     if MODEL in _axes(e)), None)
    return _rebuild(cspecs, one)


def a_log_spec(specs):
    """The spec of the first SSM ``A_log`` leaf of a spec tree (None
    without one)."""
    return next((spec for path, spec in walk(specs)
                 if path[-2:] == ("ssm", "A_log")), None)


def kv_seq(layout: Dict) -> Dict[str, bool]:
    """For each attention cache of a layout (``lm``'s ``sub{p}``,
    ``encdec``'s ``self`` and ``cross``), True when its keys and values
    (``(layers, batch, seq, kv_heads, head_dim)``) are split along the
    sequence."""
    return {k: node.get("k") == 2 for k, node in layout.items()}


def local_cache_shape(cfg: ModelConfig, shape, layout, size: int
                      ) -> Tuple[int, ...]:
    """A rank's shape of a (stacked) cache leaf of the global ``shape``
    (its batch already the row's) and the leaf's ``layout``."""
    shape = list(shape)
    if layout == CONV:
        di = cfg.ssm.d_inner(cfg.d_model)
        shape[-1] = di // size + (shape[-1] - di)
    elif layout is not None:
        shape[layout] //= size
    return tuple(shape)


def make_rank_cache(cfg: ModelConfig, shapes, layout, size: int,
                    device) -> Dict:
    """A rank's cache from the one-device cache's meta tree ``shapes``
    (the row's batch) and its ``layout``: zeros, ring slots -1 (empty)."""
    def make(path, leaf, lay):
        shape = local_cache_shape(cfg, leaf.shape, lay, size)
        if path[-1] == "slot_pos":
            return torch.full(shape, -1, dtype=leaf.dtype, device=device)
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return _zip(shapes, layout, make)


def _join_ranks(cfg: ModelConfig, parts, layout, size: int):
    """A cache leaf whole along the dim its ranks split."""
    if layout == CONV:
        n = cfg.ssm.d_inner(cfg.d_model) // size
        return torch.cat([p[..., :n] for p in parts] + [parts[0][..., n:]],
                         dim=-1)
    if layout is not None:
        return torch.cat(parts, dim=layout)
    return parts[0]


class RowCache:
    """A cache on a mesh: ``rows[r][k]`` is rank ``k``'s cache of row
    ``r`` (on ``groups[r].devices[k]``), updated in place by the steps;
    ``axes`` are the leaves' logical axes (which dim is the batch),
    ``layout`` each leaf's split (:func:`cache_layout`), so that each
    rank's leaf is the shard ``cache_specs`` gives its position."""

    def __init__(self, cfg: ModelConfig, rows: List[List[Dict]],
                 groups: List[coll.Group], axes: Dict, layout: Dict):
        self.cfg = cfg
        self.rows = rows
        self.groups = groups
        self.axes = axes
        self.layout = layout

    @property
    def devices(self) -> List[torch.device]:
        """Each row's device (its group's first rank's)."""
        return [g.devices[0] for g in self.groups]

    @property
    def kv_seq(self) -> Dict[str, bool]:
        return kv_seq(self.layout)

    def gather(self, device=None) -> Dict:
        """The whole cache on ``device`` (the first row's by default): each
        row's ranks joined along the dim they split, the rows along
        their batch dim; a leaf without one (a ring's slot positions, the
        same in every row) from row 0."""
        dev = self.devices[0] if device is None else torch.device(device)

        def walk(axes, layout, parts):
            if isinstance(axes, dict):
                return {k: walk(axes[k], layout[k],
                                [[p[k] for p in row] for row in parts])
                        for k in axes}
            rows = [_join_ranks(self.cfg, [t.to(dev) for t in row], layout,
                                len(row)) for row in parts]
            if "batch" not in axes:
                return rows[0]
            return torch.cat(rows, dim=axes.index("batch"))
        return walk(self.axes, self.layout, self.rows)


# ------------------------------------------------------------ the count
def meta_params(shapes, specs, mesh) -> Dict:
    """A ``Sharded`` tree of meta shards, one per position of ``mesh``
    (a stand-in: its positions have no devices)."""
    def make(_, leaf, spec):
        sharding = NamedSharding(mesh, spec)
        shard = sharding.shard_shape(tuple(leaf.shape))
        return Sharded(sharding, tuple(leaf.shape), [
            torch.empty(shard, dtype=leaf.dtype, device="meta")
            for _ in range(math.prod(mesh.shape.values()))])
    return _zip(shapes, specs, make)


def _zip(a, b, fn, path=()):
    if isinstance(a, dict):
        return {k: _zip(a[k], b[k], fn, path + (k,)) for k in a}
    return fn(path, a, b)
