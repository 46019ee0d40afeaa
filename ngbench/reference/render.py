"""Rays, sampling, compositing, occupancy culling and sphere tracing in
plain PyTorch: what a served tile should hold.

The arithmetic is frozen from ``src/repro_torch/core/render.py``
(``make_rays``, ``sample_along_rays``, ``normalize_to_unit``,
``composite``, the cull mask of ``_cull_mask`` and ``compact_samples``,
``scatter_samples``), ``src/repro_torch/core/occupancy.py`` (``cell_index``,
``cell_occupied``) and ``src/repro_torch/core/pipeline.py``
(``sphere_trace``, ``shade_nsdf``), op for op where the result feeds a
grid lookup: the finest hash level scales a coordinate by about 8,000, so
a sample point must come out the same to the last bit on both sides, or a
point near a cell's face lands in another cell. Everything else (the
encode, the MLPs, the compositing) is the plain formula, evaluated here
and judged against the program's output within a limit.

A camera here is ``(height, width, focal, c2w)``: a (4, 4) float32 pose.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ngbench.reference.field import Field

# (field evaluations of a tile) / (rays of the tile) for nsdf: the trace's
# steps, the hit test and the six central differences of the normal
NSDF_EXTRA_EVALS = 1 + 6


def make_rays(cam, pixel_ids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    height, width, focal, c2w = cam
    py = torch.div(pixel_ids, width, rounding_mode="floor").float()
    px = torch.remainder(pixel_ids, width).float()
    focal_t = torch.full_like(px, float(np.float32(focal)))
    x = (px - float(np.float32(width)) * 0.5 + 0.5) / focal_t
    y = (py - float(np.float32(height)) * 0.5 + 0.5) / focal_t
    rot = np.asarray(c2w, np.float32)[:3, :3].astype(np.float64)
    d = [x * float(rot[i, 0]) + y * float(rot[i, 1]) + float(rot[i, 2])
         for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dirs = torch.stack([c / norm for c in d], dim=-1)
    origins = torch.stack([torch.full_like(x, float(e))
                           for e in np.asarray(c2w, np.float32)[:3, 3]],
                          dim=-1)
    return origins, dirs


def sample_along_rays(origins: torch.Tensor, dirs: torch.Tensor,
                      near: float, far: float, n_samples: int,
                      u: Optional[torch.Tensor] = None):
    """points (R, S, 3) and dts ((1, S) at the strata's middles, (R, S)
    with a stratified draw ``u``)."""
    dev = origins.device
    step = torch.arange(n_samples, dtype=torch.float32, device=dev) / n_samples
    t = torch.cat([near * (1.0 - step) + far * step,
                   torch.full((1,), far, dtype=torch.float32, device=dev)])
    lo, hi = t[:-1], t[1:]
    ts = lo[None, :] + (hi - lo)[None, :] * (0.5 if u is None else u)
    dts = (hi - lo)[None, :].expand(ts.shape)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    return pts, dts


def normalize_to_unit(points: torch.Tensor, lo: float = -2.0,
                      hi: float = 2.0) -> torch.Tensor:
    return torch.clamp((points - lo) / (hi - lo), 0.0, 1.0)


def composite(rgb: torch.Tensor, sigma: torch.Tensor, dts: torch.Tensor
              ) -> torch.Tensor:
    """Emission-absorption: (R, S, 3), (R, S), (R, S) -> (R, 3)."""
    log1m = -sigma * dts
    alpha = 1.0 - torch.exp(log1m)
    trans = torch.exp(torch.cumsum(log1m, dim=-1) - log1m)
    w = trans * alpha
    return (w[..., None] * rgb).sum(dim=-2)


def cell_index(points: torch.Tensor, res: int) -> torch.Tensor:
    ijk = torch.clamp((points * res).to(torch.int32), 0, res - 1)
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]


def cull_mask(occ: Dict[str, torch.Tensor], unit_pts: torch.Tensor,
              dts: torch.Tensor, eps: float) -> torch.Tensor:
    """Live samples (R, S): an occupied cell, and the exclusive prefix of
    the grid's optical depth below -log(eps)."""
    r, s, _ = unit_pts.shape
    res = round(occ["sigma"].shape[-1] ** (1.0 / 3.0))
    cells = cell_index(unit_pts.reshape(-1, 3), res)
    word = occ["bits"][cells >> 5]
    live = (((word >> (cells & 31)) & 1) != 0).reshape(r, s)
    od = occ["sigma"][cells].reshape(r, s) * dts
    acc = torch.cumsum(od, dim=-1) - od
    return live & (acc < -math.log(eps))


def nerf_tile(field: Field, cam, pixel_ids: torch.Tensor, st: Dict,
              occ: Optional[Dict] = None, budget: Optional[int] = None,
              points_seen=None):
    """A nerf tile's pixels (R, 3) and, culled, its sample counts
    ``{"live", "dropped", "evaluated"}``. ``st``: ``near``, ``far``,
    ``n_samples``, ``early_term_eps``. Culled, the field runs on the first
    ``budget`` live samples in (sample index, ray) order, the program's
    stated rule, and the rest composite as empty space.
    ``points_seen(unit_points)`` sees the field's input points."""
    n_s = st["n_samples"]
    origins, dirs = make_rays(cam, pixel_ids)
    pts, dts = sample_along_rays(origins, dirs, st["near"], st["far"], n_s)
    n_rays = origins.shape[0]
    flat_pts = normalize_to_unit(pts.reshape(-1, 3))
    flat_dirs = torch.repeat_interleave(dirs, n_s, dim=0)
    counts = None
    if occ is None:
        if points_seen is not None:
            points_seen(flat_pts)
        out = field.nerf(flat_pts, flat_dirs).reshape(n_rays, n_s, 4)
    else:
        live = cull_mask(occ, flat_pts.reshape(n_rays, n_s, 3), dts,
                         st["early_term_eps"])
        # live samples near to far across the tile: sample index, then ray
        s_idx = torch.arange(n_s, device=live.device).expand(n_rays, n_s)
        order = (s_idx * n_rays + torch.arange(
            n_rays, device=live.device)[:, None]).transpose(0, 1)
        live_t = live.transpose(0, 1).reshape(-1)
        ranked = order.reshape(-1)[live_t]             # live, in key order
        n_live = int(ranked.numel())
        sel_t = ranked[:budget]
        sel = (sel_t % n_rays) * n_s + sel_t // n_rays  # flat (ray, sample)
        out = torch.zeros((n_rays * n_s, 4), dtype=torch.float32,
                          device=live.device)
        if points_seen is not None:
            points_seen(flat_pts[sel])
        out[sel] = field.nerf(flat_pts[sel], flat_dirs[sel])
        out = out.reshape(n_rays, n_s, 4)
        counts = {"live": n_live, "evaluated": int(sel.numel()),
                  "dropped": n_live - int(sel.numel())}
    rgb = composite(out[..., :3], out[..., 3], dts.expand(n_rays, n_s))
    return rgb, counts


def sphere_trace(sdf, origins, dirs, n_steps: int):
    t = torch.full((origins.shape[0],), 0.05, dtype=torch.float32,
                   device=origins.device)
    for _ in range(n_steps):
        t = t + sdf(origins + t[:, None] * dirs)[:, 0]
    p = origins + t[:, None] * dirs
    d = sdf(p)[:, 0]
    return p, (torch.abs(d) < 5e-3) & (t < 6.0)


def _offset(p: torch.Tensor, axis: int, eps: float) -> torch.Tensor:
    q = p.clone()
    q[:, axis] = p[:, axis] + eps
    return q


def nsdf_tile(field: Field, cam, pixel_ids: torch.Tensor, st: Dict,
              points_seen=None):
    """An nsdf tile's pixels (R, 3): sphere-traced for ``sphere_steps``
    steps, Lambert-shaded by the central-difference normal (eps 2e-3).
    ``points_seen(unit_points)`` sees every batch of field inputs, in the
    program's call order."""
    origins, dirs = make_rays(cam, pixel_ids)

    def sdf_world(p):
        x = (p + 1.0) / 2.0
        if points_seen is not None:
            points_seen(x)
        return field.sdf(x)
    p, hit = sphere_trace(sdf_world, origins, dirs, st["sphere_steps"])
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
