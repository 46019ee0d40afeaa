"""Frame rendering pipeline: one schedulable tile of pixels at a time.

A tile is ``tile_pixels`` rays x ``n_samples`` samples; the serve engine
pads every request to one tile. The camera is host data and the scene is a
view into a stack of scenes, so one tile function serves every viewpoint,
resolution and scene of a bucket.

Only the ray-marched apps (nerf, nvr) have a tile function so far; gia and
nsdf (sphere tracing) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core import fields, render
from repro_torch.core.fields import FieldConfig
from repro_torch.device import DeviceLike, resolve_device

RAY_APPS = ("nerf", "nvr")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    tile_pixels: int = 4096       # pixels per scheduled tile
    n_samples: int = 32           # ray-march samples
    near: float = 0.5
    far: float = 4.5


def make_tile_fn(cfg: FieldConfig, settings: RenderSettings) -> Callable:
    """(params, cam, pixel_ids (P,)) -> rgb (P, 3): one schedulable tile."""
    if cfg.app not in RAY_APPS:
        raise NotImplementedError(
            f"no tile function for app {cfg.app!r} yet (ported: {RAY_APPS})")

    def tile(params, cam: render.Camera, pixel_ids: torch.Tensor):
        origins, dirs = render.make_rays(cam, pixel_ids)
        return render.render_rays(
            lambda p, d: fields.apply_field(params, cfg, p, d), origins, dirs,
            near=settings.near, far=settings.far,
            n_samples=settings.n_samples)
    return tile


# --------------------------------------------------- multi-scene (stacked)
def stack_scene_params(params_list: Sequence[Mapping]) -> Dict:
    """Stack per-scene param trees along a new leading 'scene' axis. All
    trees must have identical structure and shapes (same FieldConfig)."""
    first = params_list[0]
    return {k: (stack_scene_params([p[k] for p in params_list])
                if isinstance(first[k], Mapping)
                else torch.stack([p[k] for p in params_list]))
            for k in first}


def select_scene(stacked_params: Mapping, scene_id: int) -> Dict:
    """One scene of a stack as views: no copy, and a kernel reads the
    scene's tables through its pointer."""
    return {k: (select_scene(v, scene_id) if isinstance(v, Mapping)
                else v[scene_id])
            for k, v in stacked_params.items()}


def make_multi_scene_tile_fn(cfg: FieldConfig, settings: RenderSettings
                             ) -> Callable:
    """(stacked_params, scene_id, cam, pixel_ids) -> rgb (P, 3)."""
    tile = make_tile_fn(cfg, settings)

    def mtile(stacked_params, scene_id: int, cam, pixel_ids):
        return tile(select_scene(stacked_params, scene_id), cam, pixel_ids)
    return mtile


def render_frame(params: Mapping, cfg: FieldConfig, cam: render.Camera,
                 settings: Optional[RenderSettings] = None,
                 device: DeviceLike = None) -> torch.Tensor:
    """Render a full frame tile by tile -> (H, W, 3) f32 on ``device``
    (CUDA unless the caller names another).

    Tail padding uses the serve engine's convention: pad lanes carry pixel
    id 0 with ``mask=False`` and are zeroed."""
    settings = settings or RenderSettings()
    dev = resolve_device(device)
    params = fields.to_device(params, dev)
    height, width = cam.resolution
    n_pixels = height * width
    tp = settings.tile_pixels
    n_tiles = -(-n_pixels // tp)
    padded = n_tiles * tp
    ids = torch.zeros(padded, dtype=torch.int64, device=dev)
    ids[:n_pixels] = torch.arange(n_pixels, dtype=torch.int64, device=dev)
    mask = torch.arange(padded, device=dev) < n_pixels
    tile_fn = make_tile_fn(cfg, settings)
    rgb = torch.cat([
        torch.where(mask[t * tp:(t + 1) * tp, None],
                    tile_fn(params, cam, ids[t * tp:(t + 1) * tp]), 0.0)
        for t in range(n_tiles)])
    return rgb[:n_pixels].reshape(height, width, 3)
