"""The benchmark's inputs, made from the seed: cameras on the serving
orbit, the analytic volume (ground truth of the training rays and the
source of the occupancy grid), and each configuration's weights.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``look_at`` from ``src/repro_torch/core/render.py``;
* ``orbit_camera`` from ``src/repro_torch/data/scenes.py``;
* ``volume_field`` (its blobs and colours) from
  ``src/repro_torch/data/scenes.py``;
* ``baked_sdf`` from ``scenes.baked_sdf_params`` in the same file, drawn
  on the device from a ``torch.Generator`` in place of numpy's;
* the occupancy grid's cell centres and bit packing from
  ``src/repro_torch/core/occupancy.py`` (``cell_centers``,
  ``pack_bits``).

Weights are drawn on the device from one ``torch.Generator`` a scene, in
the type they are served in (f32), a few large calls each.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ngbench.reference.field import grid_of, mlp_of
from ngbench.reference.render import composite, normalize_to_unit, \
    sample_along_rays

ORBIT_RADIUS, ORBIT_HEIGHT = 2.2, 1.6


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.sqrt(np.sum(fwd * fwd))
    right = np.cross(fwd, up)
    right = right / np.sqrt(np.sum(right * right))
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def orbit_camera(height: int, width: int, angle: float):
    """(height, width, focal, c2w) on the orbit of radius 2.2 at z = 1.6,
    looking at the origin."""
    eye = (ORBIT_RADIUS * math.cos(angle), ORBIT_RADIUS * math.sin(angle),
           ORBIT_HEIGHT)
    return (height, width, 0.9 * width, look_at(eye, (0.0, 0.0, 0.0)))


_BLOBS = ((0.0, 0.0, 0.0, 4.0, 28.0),       # x, y, z, inv_radius, density
          (0.55, 0.2, 0.1, 7.0, 40.0),
          (-0.4, -0.35, 0.3, 6.0, 35.0),
          (0.1, 0.5, -0.4, 8.0, 45.0))
_COLORS = ((0.9, 0.3, 0.2),
           (0.2, 0.8, 0.3),
           (0.25, 0.35, 0.9),
           (0.9, 0.8, 0.2))


def volume_field(p: torch.Tensor, dirs=None) -> torch.Tensor:
    """Analytic (rgb, sigma) of four Gaussian blobs; p (B, 3) in world
    coordinates -> (B, 4)."""
    blobs = torch.tensor(_BLOBS, dtype=torch.float32, device=p.device)
    colors = torch.tensor(_COLORS, dtype=torch.float32, device=p.device)
    d2 = ((p[:, None, :] - blobs[None, :, :3]) ** 2).sum(dim=-1)
    g = torch.exp(-d2 * blobs[None, :, 3] ** 2)
    sigma = (g * blobs[None, :, 4]).sum(dim=-1, keepdim=True)
    w = g / (g.sum(dim=-1, keepdim=True) + 1e-6)
    rgb = (w[:, :, None] * colors[None]).sum(dim=1)
    if dirs is not None:
        dot = dirs[:, 0] * 0.577 + dirs[:, 1] * 0.577 + dirs[:, 2] * 0.577
        spec = 0.15 * torch.clamp(dot, min=0.0)[:, None]
        rgb = torch.clamp(rgb + spec, 0.0, 1.0)
    return torch.cat([rgb, sigma], dim=-1)


def gt_pixels(origins, dirs, u, near=0.5, far=4.5) -> torch.Tensor:
    """The analytic volume's pixels under stratified samples ``u`` (R, S):
    the training targets."""
    n_s = u.shape[1]
    pts, dts = sample_along_rays(origins, dirs, near, far, n_s, u)
    flat = normalize_to_unit(pts.reshape(-1, 3)) * 4.0 - 2.0
    out = volume_field(flat, torch.repeat_interleave(dirs, n_s, dim=0))
    out = out.reshape(origins.shape[0], n_s, 4)
    return composite(out[..., :3], out[..., 3], dts)


# ------------------------------------------------------------ occupancy
def cell_centers(res: int, device) -> torch.Tensor:
    ax = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    ax = ax / torch.full_like(ax, float(res))
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def pack_bits(occupied: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int64, device=occupied.device)
    words = (occupied.reshape(-1, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def analytic_occupancy(res: int, threshold: float, device
                       ) -> Dict[str, torch.Tensor]:
    """The analytic volume's density at the ``res^3`` cell centres of the
    unit cube (x-major) and its bits (``sigma > threshold``): the grid
    both sides are handed."""
    if res % 4:
        raise ValueError(f"occupancy res must be a multiple of 4, got {res}")
    sigma = volume_field(cell_centers(res, device) * 4.0 - 2.0)[:, 3]
    return {"bits": pack_bits(sigma > threshold), "sigma": sigma}


# --------------------------------------------------------------- weights
def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a run's draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return gen


def _normal(gen, shape, device) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), fan_in = shape[-2]."""
    return (torch.randn(shape, generator=gen, device=device)
            / math.sqrt(shape[-2]))


def _mlp_weights(gen, m, device) -> Dict[str, torch.Tensor]:
    w = {"w_in": _normal(gen, (m.in_dim, m.hidden_dim), device),
         "w_out": _normal(gen, (m.hidden_dim, m.out_dim), device)}
    if m.n_hidden > 1:
        w["w_hidden"] = _normal(gen, (m.n_hidden - 1, m.hidden_dim,
                                      m.hidden_dim), device)
    return w


def random_field(cfg: Dict, gen: torch.Generator, device,
                 table_scale: float) -> Dict:
    """Tables U(-table_scale, table_scale) and weights N(0, 1/fan_in):
    ``table_scale`` 1 for a served scene (a wrong row or level shows in
    its pixels), 1e-4 for training (instant-NGP's start)."""
    g = grid_of(cfg)
    tables = torch.rand((g.n_levels, g.table_size, g.n_features),
                        generator=gen, device=device)
    tables.mul_(2.0 * table_scale).sub_(table_scale)
    params = {"grid": tables, "mlp": _mlp_weights(gen, mlp_of(cfg, "mlp"),
                                                  device)}
    if cfg.get("density_mlp"):
        params["density_mlp"] = _mlp_weights(
            gen, mlp_of(cfg, "density_mlp"), device)
    return params


def baked_sdf(cfg: Dict, gen: torch.Generator, device) -> Dict:
    """An nsdf field whose value is the sphere of radius 0.8 plus a small
    perturbation that every level and weight feeds, so that sphere tracing
    converges: level 0 (dense) holds the sphere's SDF at its vertices in
    feature 0, carried through hidden units 0 and 1 as relu(s) - relu(-s);
    every other feature enters units 2.. with weight N(0, 1/in) times
    0.1 / (its level's resolution); every other table entry is U(-1, 1)."""
    g, m = grid_of(cfg), mlp_of(cfg, "mlp")
    if cfg["app"] != "nsdf" or g.dim != 3 or g.level_is_hashed(0) \
            or m.hidden_dim < 3:
        raise ValueError("a baked sdf needs nsdf with a dense level 0 and a "
                         "hidden width of at least 3")
    tables = torch.rand((g.n_levels, g.table_size, g.n_features),
                        generator=gen, device=device)
    tables.mul_(2.0).sub_(1.0)
    res = g.level_resolution(0)
    c = torch.arange(res + 1, dtype=torch.float32, device=device) / float(res)
    x = torch.stack(torch.meshgrid(c, c, c, indexing="ij")[::-1],
                    -1).reshape(-1, 3)
    p = x * 2.0 - 1.0
    tables[0, :x.shape[0], 0] = torch.linalg.vector_norm(p, dim=-1) - 0.8
    h = m.hidden_dim
    w_in = torch.zeros((m.in_dim, h), device=device)
    w_in[0, 0], w_in[0, 1] = 1.0, -1.0
    level_scale = torch.tensor(
        [0.1 / g.level_resolution(l) for l in range(g.n_levels)
         for _ in range(g.n_features)], dtype=torch.float32, device=device)
    w_in[1:, 2:] = (_normal(gen, (m.in_dim, h - 2), device)[1:]
                    * level_scale[1:, None])
    w_hidden = torch.zeros((m.n_hidden - 1, h, h), device=device)
    w_hidden[:, 0, 0] = 1.0
    w_hidden[:, 1, 1] = 1.0
    w_hidden[:, 2:, 2:] = _normal(gen, (m.n_hidden - 1, h - 2, h - 2), device)
    w_out = torch.zeros((h, m.out_dim), device=device)
    w_out[0], w_out[1] = 1.0, -1.0
    w_out[2:] = _normal(gen, (h - 2, m.out_dim), device)
    mlp = {"w_in": w_in, "w_out": w_out}
    if m.n_hidden > 1:
        mlp["w_hidden"] = w_hidden
    return {"grid": tables, "mlp": mlp}


def make_weights(cfg: Dict, kind: str, gen, device) -> Dict:
    """A scene's weights by the workload's ``weights`` kind."""
    if kind == "random":
        return random_field(cfg, gen, device, 1.0)
    if kind == "init":
        return random_field(cfg, gen, device, 1e-4)
    if kind == "baked_sdf":
        return baked_sdf(cfg, gen, device)
    raise ValueError(f"weights {kind!r}: random, init or baked_sdf")


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}
