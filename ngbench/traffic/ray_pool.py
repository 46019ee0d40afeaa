"""A pool of training batches of rays from views on the serving orbit,
with the analytic volume's pixels as targets: the generator of the
training mixes.

A mix file gives ``rays`` a batch, ``pool`` batches, ``gt_samples``
stratified samples a target ray, and the views: ``orbit_positions``
cameras of ``height`` x ``width`` on the orbit. The pool's rays are
distinct (view, pixel) pairs drawn at random. The pool is made on the device from the seed, in
set-up; a step takes batch ``step % pool``, so every seed gives the same
sizes and the first ``pool`` steps all see different rows.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ngbench.scenes import generator, gt_pixels, orbit_camera

STREAM = 1000          # the pool's generator stream, beside the weights'


def _view_table(params: Dict, device):
    """Each view's (eye (V, 3), rotation (V, 3, 3)) as f32 tensors."""
    cams = [orbit_camera(params["height"], params["width"],
                         2.0 * math.pi * k / params["orbit_positions"])
            for k in range(params["orbit_positions"])]
    c2w = np.stack([c[3] for c in cams]).astype(np.float32)
    return (torch.from_numpy(c2w[:, :3, 3].copy()).to(device),
            torch.from_numpy(c2w[:, :3, :3].copy()).to(device))


def rays(params: Dict, view: torch.Tensor, pixel: torch.Tensor, eyes, rots):
    """Origins and unit directions (R, 3) of pixels of views."""
    h, w = params["height"], params["width"]
    focal = 0.9 * w
    py = torch.div(pixel, w, rounding_mode="floor").float()
    px = torch.remainder(pixel, w).float()
    x = (px - w * 0.5 + 0.5) / focal
    y = (py - h * 0.5 + 0.5) / focal
    rot = rots[view]
    d = x[:, None] * rot[:, :, 0] + y[:, None] * rot[:, :, 1] + rot[:, :, 2]
    dirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eyes[view], dirs


def make(params: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    if params.get("generator") != "ray_pool":
        raise ValueError(f"not a ray_pool mix: {params.get('generator')!r}")
    gen = generator(seed, STREAM, device)
    eyes, rots = _view_table(params, device)
    n, views = params["rays"], params["orbit_positions"]
    n_pix = params["height"] * params["width"]
    # every ray of the pool a distinct (view, pixel)
    flat = torch.randperm(views * n_pix, generator=gen,
                          device=device)[:n * params["pool"]]
    pool = []
    for b in range(params["pool"]):
        pick = flat[b * n:(b + 1) * n]
        view, pixel = pick // n_pix, pick % n_pix
        origins, dirs = rays(params, view, pixel, eyes, rots)
        u = torch.rand((n, params["gt_samples"]), generator=gen,
                       device=device)
        pool.append({"origins": origins.contiguous(),
                     "dirs": dirs.contiguous(),
                     "target": gt_pixels(origins, dirs, u)})
    return pool
