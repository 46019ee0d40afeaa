"""Pixel-parallel sharding for the render engine: the JAX package's
``serve/sharding.py`` on a port :class:`~repro_torch.launch.mesh.Mesh`.

Rendering is pixel-parallel, so the unit of parallelism is a tile's pixel
axis: it splits over the mesh axes that the partitioning rules bind to
the ``field_batch`` logical axis (all of them by default), into equal
contiguous pieces in mesh order, while the stacked scene params, the
scene id and the camera are replicated on every shard's device. One
process drives the mesh (the JAX package's ``shard_map`` is
single-controller too): it launches each piece's tile on its device, then
gathers the pieces' pixels on the mesh's first device, in shard order.

The tile function of a piece is the one made for ``tile_pixels / shards``
rays, so a culled tile gets ``RenderSettings.tile_budget(tile_pixels /
shards)`` samples per shard: overflow sheds samples per shard, not over
the whole tile, as in the JAX package; exact whenever no shard overflows.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.common.partitioning import LogicalRules
from repro_torch.launch.mesh import Mesh, replicate, shard_devices, shard_rows


def pixel_shard_count(mesh: Mesh,
                      rules: Optional[LogicalRules] = None) -> int:
    """Number of pixel shards the engine's megabatch must divide by."""
    devices = shard_devices(mesh, rules)
    return 1 if devices is None else len(devices)


def check_sample_budget(settings, shards: int) -> None:
    """The static sample budget must divide across the pixel shards: each
    shard gets ``sample_budget / shards`` of it, and a budget that does not
    divide would round per shard and the tile's budget drift."""
    if not getattr(settings, "occupancy", False):
        return
    budget = settings.sample_budget
    if budget is not None and budget % shards != 0:
        raise ValueError(
            f"sample_budget={budget} not divisible by the mesh's "
            f"{shards} pixel shards")


def shard_tile_fn(tile_fn: Callable, mesh: Mesh,
                  rules: Optional[LogicalRules] = None,
                  with_aux: bool = False) -> Callable:
    """Wrap a multi-scene tile function with the pixel-parallel split.

    ``tile_fn(stacked_params, scene_id, cam, pixel_ids, mask,
    n_valid=None) -> rgb`` (with ``with_aux``: ``(rgb, (1, 3) sample
    row)``). ``pixel_ids`` and ``mask`` split along axis 0 into the
    shards' pieces; each piece's ``n_valid`` is the count of valid pixels
    inside it (the valid ones are a prefix of the tile). ``rgb`` comes
    back on the mesh's first device in shard order; with ``with_aux`` the
    ``(shards, 3)`` rows of the pieces, stacked there too.

    The stacked params are replicated per device once per stack object:
    the wrapper's ``replicas`` maps each shard's device to the tree its
    pieces read. On a device that already holds the stack, that tree is
    the stack's own tensors, so a mesh that repeats the device adds no
    copy."""
    devices = shard_devices(mesh, rules)
    if devices is None:
        return tile_fn
    first = mesh.devices[0]
    replicas: Dict[torch.device, dict] = {}
    source = {"stacked": None}

    def sharded(stacked, scene_id, cam, pixel_ids, mask, n_valid=None):
        if source["stacked"] is not stacked:      # a new stack: re-replicate
            replicas.clear()
            source["stacked"] = stacked
        per = shard_rows(pixel_ids.shape[0], len(devices))
        rgbs, rows = [], []
        for i, dev in enumerate(devices):
            params = replicas.get(dev)
            if params is None:
                params = replicas[dev] = replicate(stacked, dev)
            n_i = None if n_valid is None else min(max(n_valid - i * per, 0),
                                                   per)
            out = tile_fn(params, scene_id, cam,
                          pixel_ids[i * per:(i + 1) * per].to(dev),
                          mask[i * per:(i + 1) * per].to(dev), n_i)
            rgb, row = out if with_aux else (out, None)
            rgbs.append(rgb.to(first))
            if with_aux:
                rows.append(row.to(first))
        rgb = torch.cat(rgbs)
        return (rgb, torch.cat(rows)) if with_aux else rgb

    sharded.replicas = replicas
    sharded.devices = devices
    return sharded
