"""Frame rendering pipeline: one schedulable tile of pixels at a time.

A tile is ``tile_pixels`` pixels; the serve engine pads every request to
one tile. The camera is host data and the scene is a view into a stack of
scenes, so one tile function serves every viewpoint, resolution and scene
of a bucket. Per app, a tile is:

- nerf, nvr: rays ray-marched with ``n_samples`` samples each, composited;
  with ``occupancy`` the march is culled on the scene's
  ``params['occupancy']`` grid under a static sample budget;
- gia: the field at each pixel's (x, y) in the unit square;
- nsdf: rays sphere-traced through the signed-distance field for
  ``sphere_steps`` steps, then shaded with a central-difference normal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import fields, render
from repro_torch.core.fields import FieldConfig
from repro_torch.data import scenes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.trace import annotate

APPS = ("nerf", "nvr", "gia", "nsdf")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    tile_pixels: int = 4096       # pixels per scheduled tile
    n_samples: int = 32           # ray-march samples (nerf, nvr)
    near: float = 0.5
    far: float = 4.5
    sphere_steps: int = 48        # sphere-tracing iterations (nsdf)
    # False: the unfused route (``fields.apply_field(fused=False)``), the
    # encode's features through device memory, then the MLP
    fused: bool = True
    # Occupancy-culled sampling (nerf, nvr): march through
    # ``render.render_rays``' compaction on ``params['occupancy']``.
    # ``sample_budget`` is the field-evaluation budget of a full tile of
    # ``tile_pixels`` rays (None: tile_pixels * n_samples, the dense cost,
    # and culling is exact); a tile of fewer pixels scales it.
    occupancy: bool = False
    sample_budget: Optional[int] = None
    early_term_eps: float = 1e-3  # a sample dies once T_est < eps

    def tile_budget(self, n_pixels: int) -> Optional[int]:
        """The static budget of a tile of ``n_pixels`` rays."""
        if not self.occupancy:
            return None
        if self.sample_budget is None:
            return n_pixels * self.n_samples
        return max(1, self.sample_budget * n_pixels // self.tile_pixels)


def field_eval_fn(cfg: FieldConfig, settings: RenderSettings) -> Callable:
    """``(params, points[, dirs]) -> field output`` on the route
    ``settings`` names (``fields.apply_field``)."""
    def f(params, points, dirs=None):
        return fields.apply_field(params, cfg, points, dirs,
                                  fused=settings.fused)
    return f


# ------------------------------------------------------------- NSDF shading
def sphere_trace(sdf_fn: Callable, origins: torch.Tensor, dirs: torch.Tensor,
                 n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration sphere tracing: every ray takes ``n_steps`` steps,
    so the time does not depend on the scene. ``sdf_fn(p (R, 3)) -> (R, 1)``
    in world coordinates. Returns (hit points (R, 3), hit mask (R,))."""
    t = torch.full((origins.shape[0],), 0.05, dtype=torch.float32,
                   device=origins.device)
    for _ in range(n_steps):
        t = t + sdf_fn(origins + t[:, None] * dirs)[:, 0]
    p = origins + t[:, None] * dirs
    d = sdf_fn(p)[:, 0]
    return p, (torch.abs(d) < 5e-3) & (t < 6.0)


def _offset(p: torch.Tensor, axis: int, eps: float) -> torch.Tensor:
    """``p`` with ``eps`` added to one coordinate, on the device: the JAX
    package's ``p + [eps, 0, 0]`` (adding 0 leaves the others exact)."""
    q = p.clone()
    q[:, axis] = p[:, axis] + eps
    return q


def shade_nsdf(params, cfg: FieldConfig, origins: torch.Tensor,
               dirs: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """Sphere-trace the field, then Lambert-shade the hits with the normal
    from central differences (eps 2e-3); misses are black. (R, 3)."""
    feval = field_eval_fn(cfg, settings)

    def sdf_world(p):
        return feval(params, (p + 1.0) / 2.0)
    p, hit = sphere_trace(sdf_world, origins, dirs, settings.sphere_steps)
    eps = 2e-3
    g = [(sdf_world(_offset(p, i, eps)) - sdf_world(_offset(p, i, -eps)))[:, 0]
         for i in range(3)]
    norm = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    n = [c / (norm + 1e-8) for c in g]
    lambert = torch.clamp(n[0] * 0.577 + n[1] * 0.577 + n[2] * 0.577,
                          0.0, 1.0)
    shade = 0.15 + 0.85 * lambert
    color = torch.stack([c * shade for c in (0.8, 0.82, 0.9)], dim=-1)
    return torch.where(hit[:, None], color, 0.0)


def pixel_coords(cam: render.Camera, pixel_ids: torch.Tensor) -> torch.Tensor:
    """gia's sample points: pixel (row, col) as (col / W, row / H) in f32,
    (P, 2). Integer division, then one correctly rounded f32 divide by a
    tensor: a CUDA divide by a Python number multiplies by its reciprocal,
    which may differ in the last bit, and the finest level scales a
    coordinate by 511."""
    py = torch.div(pixel_ids, cam.width, rounding_mode="floor").float()
    px = torch.remainder(pixel_ids, cam.width).float()
    return torch.stack([px / torch.full_like(px, float(cam.width)),
                        py / torch.full_like(py, float(cam.height))], dim=-1)


# ---------------------------------------------------------------- tile step
def make_tile_fn(cfg: FieldConfig, settings: RenderSettings,
                 with_aux: bool = False) -> Callable:
    """(params, cam, pixel_ids (P,)) -> rgb (P, 3): one schedulable tile.

    With ``settings.occupancy`` the ray apps march culled on
    ``params['occupancy']`` under ``settings.tile_budget(P)``; a ray app
    without that leaf raises. ``with_aux=True`` also returns a (1, 3) f32
    ``[n_live, n_total, n_dropped]`` row of sample counts, made on the
    device (the dense path and the other apps: all live).
    ``tile(..., n_valid=n)`` counts only the first ``n`` pixels, the valid
    ones of a padded request."""
    if cfg.app not in APPS:
        raise ValueError(f"unknown app {cfg.app!r} (apps: {APPS})")
    feval = field_eval_fn(cfg, settings)

    def tile(params, cam: render.Camera, pixel_ids: torch.Tensor,
             n_valid: Optional[int] = None):
        n = pixel_ids.shape[0] if n_valid is None else n_valid

        def dense(rgb, samples_per_pixel=1):
            if not with_aux:
                return rgb
            row = torch.full((1, 3), float(n * samples_per_pixel),
                             dtype=torch.float32, device=pixel_ids.device)
            row[0, 2] = 0.0
            return rgb, row

        if cfg.app == "gia":
            return dense(feval(params, pixel_coords(cam, pixel_ids)))
        with annotate("raymarch"):
            origins, dirs = render.make_rays(cam, pixel_ids)
        if cfg.app == "nsdf":
            return dense(shade_nsdf(params, cfg, origins, dirs, settings))
        kw = dict(near=settings.near, far=settings.far,
                  n_samples=settings.n_samples, use_kernel_composite=True)

        def field(p, d):
            return feval(params, p, d)
        if not settings.occupancy:
            return dense(render.render_rays(field, origins, dirs, **kw),
                         settings.n_samples)
        if "occupancy" not in params:
            raise ValueError(
                "RenderSettings.occupancy=True but the scene params have no "
                "'occupancy' leaf: build one with "
                "core.occupancy.build_occupancy and attach()")
        rgb, aux = render.render_rays(
            field, origins, dirs, occupancy=params["occupancy"],
            sample_budget=settings.tile_budget(pixel_ids.shape[0]),
            early_term_eps=settings.early_term_eps, return_aux=True, **kw)
        if not with_aux:
            return rgb
        live = aux["live_per_ray"][:n].sum().float()
        return rgb, torch.stack([
            live, torch.full_like(live, float(n * settings.n_samples)),
            aux["dropped_per_ray"][:n].sum().float()])[None, :]
    return tile


def make_render_step(cfg: FieldConfig,
                     settings: Optional[RenderSettings] = None,
                     cam: Optional[render.Camera] = None) -> Callable:
    """The field's serve step: ``(params, pixel_ids (B,)) -> rgb (B, 3)``,
    one batched request of pixels against a trained field through
    :func:`make_tile_fn`, the camera fixed (default: the paper's 4k target,
    ``scenes.default_camera(2160, 3840)``). The dry run counts it
    (``launch/dryrun.field_cell``); a server passes the camera as data
    (``make_multi_scene_tile_fn``)."""
    settings = settings or RenderSettings()
    cam = cam or scenes.default_camera(2160, 3840)
    tile_fn = make_tile_fn(cfg, settings)

    def step(params, pixel_ids):
        return tile_fn(params, cam, pixel_ids)
    return step


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


def make_multi_scene_tile_fn(cfg: FieldConfig, settings: RenderSettings,
                             with_aux: bool = False) -> Callable:
    """(stacked_params, scene_id, cam, pixel_ids[, n_valid]) -> rgb (P, 3)
    (and the sample-count row with ``with_aux``, as :func:`make_tile_fn`)."""
    tile = make_tile_fn(cfg, settings, with_aux=with_aux)

    def mtile(stacked_params, scene_id: int, cam, pixel_ids,
              n_valid: Optional[int] = None):
        return tile(select_scene(stacked_params, scene_id), cam, pixel_ids,
                    n_valid)
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
