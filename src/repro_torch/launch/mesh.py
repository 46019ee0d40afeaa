"""Device meshes of the port: the JAX package's ``launch/mesh.py``.

A :class:`Mesh` is an array of ``torch.device``s with a name per axis,
as ``jax.sharding.Mesh`` is one of JAX devices. One process drives it: a
sharded path launches each shard's work on its own device and gathers the
results on the mesh's first device (``serve/sharding.py``,
``train/loop.data_parallel_grad_fn``, the LM steps of ``parallel/api``
on a mesh). A mesh may hold one device more
than once; its shards then run one after another on that device and share
its memory, as the JAX package's tests share one CPU split into forced
host devices.

``make_production_mesh`` is the JAX package's production mesh as a
stand-in (:class:`MeshShape`: axis names and sizes, no devices) for the
dry run (``launch/dryrun.py``), which plans it on H100 nodes without
having them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import partitioning
from repro_torch.common.partitioning import LogicalRules
from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """``devices``: an array (nested sequence or numpy object array) of
    devices, one dimension per name in ``axis_names``. Every device must
    exist: a CUDA index past the visible cards raises."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        flat = [_existing(d) for d in np.asarray(devices, dtype=object)
                .reshape(-1)]
        grid.reshape(-1)[:] = flat
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or len(set(axis_names)) \
                != len(axis_names):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} distinct axis names, got "
                             f"{axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.device_grid = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Ordered ``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.device_grid.shape))

    @property
    def devices(self) -> List[torch.device]:
        """Every device in mesh order (row-major over the axes)."""
        return list(self.device_grid.reshape(-1))

    @property
    def size(self) -> int:
        return self.device_grid.size

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"[{', '.join(str(d) for d in self.devices)}])")


def _existing(device: DeviceLike) -> torch.device:
    """``device`` as a torch.device that this process can use."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"mesh device {dev} does not exist: "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {dev}: the port runs on cuda or cpu")
    return dev


def local_devices(device: DeviceLike = None) -> List[torch.device]:
    """The devices of ``device``'s type this process sees, ``device``
    first: every visible CUDA card from the named (default: the current)
    one on in index order, wrapping round, or the one CPU."""
    dev = _existing(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        return [torch.device("cuda", (dev.index + i) % n) for i in range(n)]
    return [dev]


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh over the visible devices (CUDA unless
    ``device`` names another type), starting at ``device``
    (:func:`local_devices`); asked for more than there are, it clamps to
    ``(all of them, 1)``, as the JAX function does."""
    devices = local_devices(device)
    n = len(devices)
    if data * model > n:
        data, model = n, 1
    return Mesh(np.array(devices[:data * model], dtype=object)
                .reshape(data, model), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A stand-in mesh: axis names and their sizes, no devices. The memory
    plans (``parallel/api.check_fits``, ``shard_param_bytes``,
    ``train_state_bytes``, ``step_collective_bytes``) take it where they
    take a :class:`Mesh`, each position its own device."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The JAX package's production meshes as stand-ins: (16, 16) as
    ("data", "model"), and with ``multi_pod`` (2, 16, 16) as ("pod",
    "data", "model"). On H100s they stand for 32 or 64 nodes of 8 SXM
    cards, NVLink within a node (8 consecutive positions in row-major
    order) and InfiniBand between nodes. No process drives such a mesh:
    the dry run plans it (``launch/dryrun.py``)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def mesh_chip_count(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())


def shard_devices(mesh: Mesh, rules: Optional[LogicalRules] = None,
                  logical: str = "field_batch"):
    """The device of each shard of the split of the ``logical`` axis, in
    shard order, or None when the rules bind none of the mesh's axes to
    it. As in a ``PartitionSpec``, the first of the rules' axes is the
    major one; axes the split does not use replicate, and a shard runs on
    the first device along them."""
    rules = rules or partitioning.DEFAULT_RULES
    axes = partitioning.present_axes(mesh, rules.mesh_axes(logical))
    if axes is None:
        return None
    return axes_devices(mesh, axes)


def axes_devices(mesh: Mesh, axes) -> List[torch.device]:
    """The device of each shard of a split over the mesh axes ``axes`` (a
    spec entry: None, a name or a tuple of names, the first the major
    one), in shard order; a split over no axes is one shard on the first
    device. Axes the split does not use replicate, and a shard runs on the
    first device along them."""
    if axes is None or axes == ():
        return [mesh.devices[0]]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    index = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    kept = [a for a in mesh.axis_names if a in axes]
    return list(mesh.device_grid[index].transpose(
        [kept.index(a) for a in axes]).reshape(-1))


def shard_rows(n: int, shards: int) -> int:
    """Rows of each of ``shards`` equal pieces of ``n`` rows; raises when
    they are not equal."""
    if n % shards:
        raise ValueError(f"{n} rows do not split into {shards} equal "
                         "shards")
    return n // shards


def replicate(tree, device: torch.device):
    """``tree`` (nested dicts of tensors) on ``device``: the same tensors
    where they already lie there (``Tensor.to`` returns its input), copies
    elsewhere."""
    return {k: (replicate(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in tree.items()}
