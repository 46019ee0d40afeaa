"""Parameter trees with attached logical sharding axes: the JAX package's
``common/param.py`` for torch tensors.

Params are plain nested dicts of tensors. During ``init`` each leaf is a
``Boxed(value, axes)`` carrying the *logical* axis names of every dimension
(e.g. ``('embed', 'mlp')``); ``unbox`` strips the boxes into a
(params, specs) pair, and the sharding of the LM stack reads the specs.

Randomness comes from explicit ``torch.Generator``s in place of JAX keys:
``KeyGen(seed, device)`` hands out a fresh generator per call (in a
``Draw``), each seeded from a CPU stream of its own, so an init is a pure
function of its seed and device.
The draws differ from JAX's (another RNG), so parity with the JAX package
goes through carried-over weights, never through matching draws. The
initialisers take the full shape, a leading stack axis included, and are
told ``fan_in`` where the first dimension is not the fan-in.

``KeyGen(seed, device, lazy=True)`` makes a tree whose initialiser leaves
are :class:`LazyLeaf`s: the draw's seed, shape, dtype and scale, not its
values. ``parallel/sharded.py`` makes each shard of such a leaf on its
own device from the same draws, so a sharded init equals the one-device
init sliced, and no device ever holds a whole leaf that is not its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Boxed:
    """A parameter leaf annotated with logical axis names (one per dim)."""
    value: Any
    axes: Tuple[Optional[str], ...]


def tree_map(fn, tree, is_leaf=None):
    """``fn`` over the leaves of nested dicts (and ``Boxed`` when
    ``is_leaf`` says so), keeping the dict structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def unstack(tree, n: int):
    """The ``n`` slices along the leading (stack) axis of every leaf, as a
    list of trees: one ``unbind`` a leaf, so that autograd stacks each
    leaf's gradients once (indexing slice ``i`` would give every slice a
    zero-filled gradient of the whole stack to sum)."""
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], split) for i in range(n)]


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, Boxed):
        return [tree.value]
    return [tree]


def _is_box(x):
    return isinstance(x, Boxed)


def unbox(tree):
    """Split a Boxed tree into (params, logical_specs)."""
    params = tree_map(lambda b: b.value, tree, is_leaf=_is_box)
    specs = tree_map(lambda b: b.axes, tree, is_leaf=_is_box)
    return params, specs


def specs_of(tree):
    return tree_map(lambda b: b.axes, tree, is_leaf=_is_box)


def tree_bytes(tree) -> int:
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in tree_leaves(tree) if hasattr(leaf, "shape")))


def count_params(tree) -> int:
    return int(sum(int(np.prod(tuple(leaf.shape)))
                   for leaf in tree_leaves(tree)))


# ----------------------------------------------------------------------------
# Initializers: a Draw (``kg()``) and a full shape; the device is the draw's.
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Draw:
    """One leaf's randomness, as ``KeyGen`` hands it to an initialiser:
    its generator (None on the meta device), its device, and the compute
    dtype (None: none) that an f32 leaf of two or more dimensions is made
    in, the leaves ``parallel.api.cast_params_for_compute`` casts."""
    generator: Optional[torch.Generator]
    device: torch.device
    compute_dtype: Optional[torch.dtype] = None
    seed: Optional[int] = None       # the generator's seed (lazy draws)
    lazy: bool = False


@dataclasses.dataclass(frozen=True)
class LazyLeaf:
    """An initialiser's leaf not made yet: an N(0, 1) f32 draw from a
    generator seeded ``seed``, scaled in place by ``scale`` and rounded to
    ``dtype``; or, with ``seed`` None, the constant ``fill``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    seed: Optional[int]
    scale: Optional[Callable] = None
    fill: float = 0.0

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def parts(self, device: torch.device) -> Iterator[torch.Tensor]:
        """The leaf's values on ``device`` in draw order: one leading slice
        at a time for a leaf of three or more dims, else the whole; the
        values of the eager init, bit for bit."""
        if self.seed is None:
            shape, n = _part_shape(self.shape)
            for _ in range(n):
                yield torch.full(shape, self.fill, dtype=self.dtype,
                                 device=device)
            return
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        for r in _normal_parts(gen, device, self.shape, self.scale):
            yield r.to(self.dtype)


def _leaf_dtype(gen: Draw, shape, dtype) -> torch.dtype:
    if (gen.compute_dtype is not None and dtype == torch.float32
            and len(shape) >= 2):
        return gen.compute_dtype
    return dtype


def _part_shape(shape) -> Tuple[Tuple[int, ...], int]:
    """(the shape of one drawn part, the number of parts): a leaf of three
    or more dims is drawn one leading slice at a time."""
    shape = tuple(shape)
    return (shape[1:], shape[0]) if len(shape) >= 3 else (shape, 1)


def _normal_parts(generator, device, shape, scale) -> Iterator[torch.Tensor]:
    part, n = _part_shape(shape)
    for _ in range(n):
        yield scale(torch.randn(part, generator=generator, device=device,
                                dtype=torch.float32))


def _normal(gen: Draw, shape, dtype, scale) -> torch.Tensor:
    """N(0, 1) drawn in f32, ``scale``d in place and rounded to the leaf's
    dtype. A leaf of three or more dimensions (stacked over layers) is
    drawn one leading slice at a time, so a leaf made in its compute dtype
    never exists whole in f32; the draws are the same either way."""
    shape = tuple(shape)
    dt = _leaf_dtype(gen, shape, dtype)
    if gen.lazy:
        return LazyLeaf(shape, dt, gen.seed, scale)
    out = torch.empty(shape, dtype=dt, device=gen.device)
    if gen.device.type == "meta":
        return out
    for part, value in zip(out if len(shape) >= 3 else out[None],
                           _normal_parts(gen.generator, gen.device, shape,
                                         scale)):
        part.copy_(value)
    return out


def normal_init(gen: Draw, shape, dtype=torch.float32, stddev=0.02):
    return _normal(gen, shape, dtype, lambda r: r.mul_(stddev))


def scaled_init(gen: Draw, shape, dtype=torch.float32, fan_in=None):
    """LeCun-style 1/sqrt(fan_in); fan_in defaults to shape[0]."""
    fan = math.sqrt(float(max(fan_in if fan_in is not None else shape[0],
                              1)))
    return _normal(gen, shape, dtype, lambda r: r.div_(fan))


def zeros_init(gen: Draw, shape, dtype=torch.float32):
    if gen.lazy:
        return LazyLeaf(tuple(shape), _leaf_dtype(gen, shape, dtype), None)
    return torch.zeros(tuple(shape), dtype=_leaf_dtype(gen, shape, dtype),
                       device=gen.device)


def ones_init(gen: Draw, shape, dtype=torch.float32):
    if gen.lazy:
        return LazyLeaf(tuple(shape), _leaf_dtype(gen, shape, dtype), None,
                        fill=1.0)
    return torch.ones(tuple(shape), dtype=_leaf_dtype(gen, shape, dtype),
                      device=gen.device)


class KeyGen:
    """Deterministic generator splitter: ``kg = KeyGen(seed, device);
    g = kg()``. Each call returns a new ``Draw`` whose generator lives on
    ``device`` (CUDA unless named, as every entry point of the port),
    seeded from this one's own CPU stream, so the split never waits on
    the device. On ``device="meta"`` an init allocates nothing: it gives
    the tree's shapes, dtypes and axes. With ``compute_dtype`` the f32
    leaves of two or more dimensions are made in it (see ``Draw``). With
    ``lazy`` the initialisers return :class:`LazyLeaf`s (the few leaves
    made outside them are made on ``device``)."""

    def __init__(self, seed: int, device=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 lazy: bool = False):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.lazy = lazy
        self._gen = torch.Generator()
        self._gen.manual_seed(int(seed))

    def __call__(self) -> Draw:
        if self.device.type == "meta":
            return Draw(None, self.device, self.compute_dtype)
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._gen))
        if self.lazy:
            return Draw(None, self.device, self.compute_dtype, seed=seed,
                        lazy=True)
        sub = torch.Generator(device=self.device)
        sub.manual_seed(seed)
        return Draw(sub, self.device, self.compute_dtype)


def leaf_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype; bf16 (ml_dtypes, which
    ``torch.from_numpy`` refuses) through a uint16 view."""
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t if device is None else t.to(device)


def tree_from_numpy(np_tree, expected, device=None, path: str = ""):
    """``np_tree`` (nested dicts of numpy arrays) as tensors on ``device``,
    held to ``expected`` (nested dicts of tensors, e.g. a meta-device
    init): the same keys at every level and the same shape at every leaf,
    else ``ValueError`` naming the path. Dtypes are kept."""
    if isinstance(expected, dict):
        if not isinstance(np_tree, dict):
            raise ValueError(f"params{path}: expected a dict, got "
                             f"{type(np_tree).__name__}")
        missing = sorted(set(expected) - set(np_tree))
        extra = sorted(set(np_tree) - set(expected))
        if missing or extra:
            raise ValueError(f"params{path}: missing keys {missing}, extra "
                             f"keys {extra}")
        return {k: tree_from_numpy(np_tree[k], expected[k], device,
                                   f"{path}/{k}") for k in expected}
    arr = np.asarray(np_tree)
    if tuple(arr.shape) != tuple(expected.shape):
        raise ValueError(f"params{path}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(expected.shape)}")
    return leaf_from_numpy(arr, device)
