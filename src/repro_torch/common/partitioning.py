"""Logical-axis to mesh-axis rules: the JAX package's
``common/partitioning.py``.

Every parameter or activation dimension carries a *logical* name
('batch', 'embed', 'mlp', 'field_batch', ...). A :class:`LogicalRules`
table maps each name to physical mesh axes ('pod', 'data', 'model'), and
applying the rules yields a :class:`PartitionSpec` per tensor. The table
is the JAX package's, entry for entry, so a rule set means the same in
both packages.

The field apps read one entry, ``'field_batch'``: the pixels of a render
tile (``serve/sharding.py``) and the rays or points of a training batch
(``train/loop.data_parallel_grad_fn``) split over the mesh axes it names
that the mesh has (:func:`present_axes`).

The LM stack reads the rest. :func:`divisible_fallback` turns a tensor's
logical axes into a spec, replicating (``None``) any dimension that the
size of its mesh axes does not divide and recording the event in
``LogicalRules.fallbacks`` as ``(path, dim, logical, axes, size)``, as the
JAX function does; :func:`logical_to_spec` maps a whole tree, with the
``jax.tree_util.keystr`` path of each leaf (``['blocks']['sub0']...``).
:class:`PartitionSpec` is a tuple equal to ``tuple(jax PartitionSpec)``
entry for entry, and :class:`NamedSharding` gives what the JAX class
gives: ``shard_shape`` and the slice of the global tensor that each mesh
position holds (``parallel/sharded.py`` stores one tensor per position).
Spec functions need only ``mesh.shape``, so a stand-in mesh
(``SimpleNamespace(shape={"data": 16, "model": 16})``) plans a pod's
layout without devices.

:func:`constrain` and :class:`ActivationSharder` are the models' activation
hints (``with_sharding_constraint`` in JAX). They leave the value as it is,
as the JAX constraint does, and record the same fallbacks: in the port a
train step's compute splits the batch over its rows (``parallel/api.py``),
so an activation's layout is its row's and there is nothing to constrain.
The serving steps compute over 'model' on each row's tensor-parallel
group instead (``parallel/tp.py``): their layout is explicit, one tensor a
rank, and they hint nothing; the sharder carries only the MoE's rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass
class LogicalRules:
    """Ordered mapping of logical axis name -> mesh axes."""
    rules: Dict[str, MeshAxes]
    # record of (path, dim, logical, axes, size) replication fallbacks
    fallbacks: List[Tuple] = dataclasses.field(default_factory=list)

    def copy_with(self, **overrides) -> "LogicalRules":
        new = dict(self.rules)
        new.update(overrides)
        return LogicalRules(new)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical, None)


# The JAX package's production default: 'data' does DP+FSDP (ZeRO-3
# weight sharding via 'embed'), 'model' TP/EP, 'pod' cross-pod DP; the
# field apps' pixels and rays are fully DP. Sequence parallelism maps
# 'act_seq' to 'model' (:func:`sequence_parallel_rules`).
DEFAULT_RULES = LogicalRules({
    # --- activations ---
    "batch": ("pod", "data"),
    "act_seq": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_expert": "model",
    # --- parameters ---
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "stage": None,
    # --- neural fields (the paper's models) ---
    "level": None,            # multi-res levels stay device-local
    "table": "data",          # hash tables sharded for training only (LM)
    "feature": None,
    "field_batch": ("pod", "data", "model"),  # pixels/rays: fully DP
    "width": None,
})


def sequence_parallel_rules(base: LogicalRules) -> LogicalRules:
    """Megatron-SP: shard the sequence dim of activations over 'model'."""
    return base.copy_with(act_seq="model")


def rule_preset(name: str) -> LogicalRules:
    """The JAX package's named rule sets (a fresh copy each call)."""
    presets = {
        "baseline": lambda: DEFAULT_RULES.copy_with(),
        "sp": lambda: DEFAULT_RULES.copy_with(),
        "nosp": lambda: DEFAULT_RULES.copy_with(act_seq=None),
        "noz": lambda: DEFAULT_RULES.copy_with(embed=None, table=None),
        "ep2d": lambda: DEFAULT_RULES.copy_with(expert=("model", "data")),
        "tinydp": lambda: DEFAULT_RULES.copy_with(
            batch=("pod", "data", "model"), act_seq=None, act_heads=None,
            act_mlp=None, act_expert=None, mlp=None, heads=None,
            kv_heads=None, vocab=None, expert=None, ssm_inner=None),
    }
    return presets[name]()


def _axes_size(mesh, axes: MeshAxes) -> int:
    """Devices along ``axes`` of ``mesh`` (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def present_axes(mesh, axes: MeshAxes) -> MeshAxes:
    """The subset of ``axes`` that ``mesh`` has (None if none): a
    single-pod mesh has no 'pod' axis."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.shape else None
    kept = tuple(a for a in axes if a in mesh.shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (whole), a mesh axis name, or
    a tuple of names (the first the major one). Equal to
    ``tuple(jax.sharding.PartitionSpec(...))`` entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def divisible_fallback(mesh, shape: Sequence[int],
                       logical: Sequence[Optional[str]],
                       rules: LogicalRules, path: str = "") -> PartitionSpec:
    """A spec for a tensor of ``shape`` whose dims are named ``logical``:
    each dim takes its rule's axes that the mesh has and that no earlier
    dim took, dropping trailing axes until their size divides the dim; a
    dim left with none replicates and is recorded in ``rules.fallbacks``."""
    spec = []
    used: set = set()
    for d, (dim, name) in enumerate(zip(shape, logical)):
        axes = present_axes(mesh, rules.mesh_axes(name))
        if axes is None:
            spec.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        # a mesh axis may appear at most once in a spec
        tup = tuple(a for a in tup if a not in used)
        while tup and dim % math.prod(mesh.shape[a] for a in tup) != 0:
            tup = tup[:-1]
        if not tup:
            rules.fallbacks.append((path, d, name, axes, dim))
            spec.append(None)
        else:
            used.update(tup)
            spec.append(tup if len(tup) > 1 else tup[0])
    return PartitionSpec(*spec)


def _keystr_walk(tree, path: str, fn):
    """``fn(path, leaf)`` over a tree of dicts (keys sorted, as
    ``jax.tree_util`` orders them; the paths are its ``keystr``) whose
    leaves are logical-axes tuples, keeping the structure."""
    if isinstance(tree, dict):
        return {k: _keystr_walk(tree[k], f"{path}[{k!r}]", fn)
                for k in sorted(tree)}
    return fn(path, tree)


def logical_to_spec(specs_tree, mesh, rules: LogicalRules,
                    shapes_tree=None):
    """A tree of logical-axes tuples as a tree of specs. ``shapes_tree``
    (the same structure; leaves with ``.shape``, or shape tuples) enables
    the divisibility fallback, each recorded under its leaf's keystr path;
    without it the mapping is unchecked."""
    if shapes_tree is None:
        return _keystr_walk(specs_tree, "", lambda _, axes: PartitionSpec(
            *[present_axes(mesh, rules.mesh_axes(a)) for a in axes]))

    def shape_of(leaf):
        return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)

    def walk(axes_t, shapes_t, path):
        if isinstance(axes_t, dict):
            return {k: walk(axes_t[k], shapes_t[k], f"{path}[{k!r}]")
                    for k in sorted(axes_t)}
        return divisible_fallback(mesh, shape_of(shapes_t), axes_t, rules,
                                  path=path)
    return walk(specs_tree, shapes_tree, "")


class NamedSharding:
    """A spec on a mesh (``launch/mesh.Mesh``), as
    ``jax.sharding.NamedSharding``: which slice of a global tensor each
    mesh position holds. Positions are the mesh's devices in row-major
    order (``mesh.devices``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _splits(self, ndim: int) -> List[Tuple[str, ...]]:
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [_entry_axes(e) for e in spec[:ndim]]

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """Each dim over the size of its axes (it must divide)."""
        out = []
        for dim, axes in zip(global_shape, self._splits(len(global_shape))):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if dim % n:
                raise ValueError(f"dim {dim} does not split over {axes}")
            out.append(dim // n)
        return tuple(out)

    def indices(self, global_shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """The slice each mesh position holds, in position order."""
        shard = self.shard_shape(global_shape)
        splits = self._splits(len(global_shape))
        names = list(self.mesh.shape)
        grid = tuple(self.mesh.shape.values())
        out = []
        for pos in range(math.prod(grid)):
            coord = dict(zip(names, np.unravel_index(pos, grid)))
            idx = []
            for size, axes in zip(shard, splits):
                k = 0
                for a in axes:                 # the first axis is major
                    k = k * self.mesh.shape[a] + int(coord[a])
                idx.append(slice(k * size, (k + 1) * size))
            out.append(tuple(idx))
        return out

    def owners(self, global_shape: Sequence[int]) -> List[int]:
        """The first position holding each distinct slice: a replicated
        dim's copies are counted once."""
        seen, out = set(), []
        for pos, idx in enumerate(self.indices(global_shape)):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out.append(pos)
        return out


def specs_to_shardings(spec_tree, mesh):
    """A tree of specs (dicts, ``AdamState``s) as NamedShardings."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: specs_to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(specs_to_shardings(getattr(spec_tree, f),
                                                    mesh)
                                 for f in spec_tree._fields))
    return spec_tree


def constrain(x, mesh, rules: LogicalRules, logical):
    """The JAX ``with_sharding_constraint`` by logical names: records the
    spec's fallbacks (path "act") and returns ``x`` as it is. Each
    distinct fallback is recorded once: JAX records them when it traces a
    step, the eager port would at every call of every step."""
    scratch = LogicalRules(rules.rules)
    divisible_fallback(mesh, tuple(x.shape), logical, scratch, path="act")
    for f in scratch.fallbacks:
        if f not in rules.fallbacks:
            rules.fallbacks.append(f)
    return x


class ActivationSharder:
    """Carries (mesh, rules) so model code can hint activation shardings,
    and, on a sharded step, which batch row of the step the forward runs
    (``rows``, a ``parallel/sharded.RowContext``, and ``row``) and in
    which layer (``layer``): the MoE layer reads them to keep the JAX
    step's global token groups."""

    def __init__(self, mesh=None, rules: Optional[LogicalRules] = None,
                 rows=None, row: int = 0, layer=None):
        self.mesh = mesh
        self.rules = rules
        self.rows = rows
        self.row = row
        self.layer = layer

    def for_row(self, rows, row: int) -> "ActivationSharder":
        """This sharder for row ``row`` of the split ``rows``."""
        return ActivationSharder(self.mesh, self.rules, rows, row)

    def at_layer(self, layer) -> "ActivationSharder":
        """This sharder inside the layer keyed ``layer``."""
        return ActivationSharder(self.mesh, self.rules, self.rows, self.row,
                                 layer)

    def __call__(self, x, *logical):
        if self.mesh is None or self.rules is None:
            return x
        if not hasattr(x, "shape") or len(logical) != x.ndim:
            return x
        return constrain(x, self.mesh, self.rules, logical)


NULL_SHARDER = ActivationSharder(None, None)
