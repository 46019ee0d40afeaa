"""Serving cameras, the analytic ground truths of the four apps, the
training batch makers, and a baked nsdf scene that sphere tracing
converges on.

``gigapixel_image``, ``sdf_sphere``, ``sdf_torus``, ``sdf_scene``,
``volume_field``, ``gt_render_rays``, ``gia_batch``, ``nsdf_batch`` and
``nerf_ray_batch`` are the JAX package's ``data/scenes.py`` functions, in
PyTorch. The batch makers draw from an explicit ``torch.Generator`` on the
batch's device where the JAX package draws from a ``jax.random`` key: the
two give other numbers from the same seed, so parity tests hand both
packages the same numpy batches.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import render
from repro_torch.core.fields import FieldConfig, param_shapes


def default_camera(height=256, width=256) -> render.Camera:
    return render.Camera(
        height=height, width=width, focal=0.9 * width,
        c2w=render.look_at((2.2, 1.6, 1.8), (0.0, 0.0, 0.0)))


def orbit_camera(height: int, width: int, angle: float) -> render.Camera:
    """Viewpoint on the canonical serving orbit (radius 2.2, z=1.6,
    looking at the origin)."""
    eye = (2.2 * math.cos(angle), 2.2 * math.sin(angle), 1.6)
    return render.Camera(height=height, width=width, focal=0.9 * width,
                         c2w=render.look_at(eye, (0.0, 0.0, 0.0)))


# ---------------------------------------------------------------- GIA image
def gigapixel_image(xy: torch.Tensor) -> torch.Tensor:
    """Procedural high-frequency RGB image; xy (B, 2) in [0,1] -> (B, 3)."""
    x, y = xy[..., 0], xy[..., 1]
    r = 0.5 + 0.5 * torch.sin(40.0 * x) * torch.cos(31.0 * y)
    g = 0.5 + 0.5 * torch.sin(57.0 * x * y + 3.0 * x)
    checker = torch.sign(torch.sin(87.0 * x) * torch.sin(93.0 * y))
    b = 0.5 + 0.25 * checker + 0.25 * torch.sin(13.0 * (x + y))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


# ----------------------------------------------------------------- NSDF SDFs
def sdf_sphere(p: torch.Tensor, radius: float = 0.8) -> torch.Tensor:
    return torch.linalg.vector_norm(p, dim=-1, keepdim=True) - radius


def sdf_torus(p: torch.Tensor, R: float = 0.7, r: float = 0.25
              ) -> torch.Tensor:
    q = torch.stack([torch.linalg.vector_norm(p[..., :2], dim=-1) - R,
                     p[..., 2]], dim=-1)
    return (torch.linalg.vector_norm(q, dim=-1) - r)[..., None]


def sdf_scene(p: torch.Tensor) -> torch.Tensor:
    """Union of torus + offset sphere; p in [-1,1]^3 world coords."""
    s = sdf_sphere(p - p.new_tensor([0.35, 0.0, 0.45]), 0.3)
    t = sdf_torus(p)
    return torch.minimum(s, t)


# ------------------------------------------------------- NeRF / NVR volume
_BLOBS = ((0.0, 0.0, 0.0, 4.0, 28.0),       # x, y, z, inv_radius, density
          (0.55, 0.2, 0.1, 7.0, 40.0),
          (-0.4, -0.35, 0.3, 6.0, 35.0),
          (0.1, 0.5, -0.4, 8.0, 45.0))
_COLORS = ((0.9, 0.3, 0.2),
           (0.2, 0.8, 0.3),
           (0.25, 0.35, 0.9),
           (0.9, 0.8, 0.2))


@functools.lru_cache(maxsize=None)
def _volume_constants(device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blobs and their colours as f32 tensors on ``device``, copied
    there once."""
    return (torch.tensor(_BLOBS, dtype=torch.float32, device=device),
            torch.tensor(_COLORS, dtype=torch.float32, device=device))


def volume_field(p: torch.Tensor, dirs: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Analytic (rgb, sigma) field of Gaussian blobs; p (B, 3) world
    coords -> (B, 4). A mild specular term in ``dirs`` exercises the NeRF
    colour MLP's direction input. The colour mix and the specular dot are
    written as sums, so a card set to TF32 products does not round them."""
    blobs, colors = _volume_constants(p.device)
    d2 = ((p[:, None, :] - blobs[None, :, :3]) ** 2).sum(dim=-1)
    g = torch.exp(-d2 * blobs[None, :, 3] ** 2)             # (B, K)
    sigma = (g * blobs[None, :, 4]).sum(dim=-1, keepdim=True)
    w = g / (g.sum(dim=-1, keepdim=True) + 1e-6)
    rgb = (w[:, :, None] * colors[None]).sum(dim=1)          # (B, 3)
    if dirs is not None:
        dot = dirs[:, 0] * 0.577 + dirs[:, 1] * 0.577 + dirs[:, 2] * 0.577
        spec = 0.15 * torch.clamp(dot, min=0.0)[:, None]
        rgb = torch.clamp(rgb + spec, 0.0, 1.0)
    return torch.cat([rgb, sigma], dim=-1)


def gt_render_rays(origins: torch.Tensor, dirs: torch.Tensor, *,
                   near: float = 0.5, far: float = 4.5, n_samples: int = 64,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ground-truth pixels (R, 3): the analytic volume composited with the
    renderer the network uses (plain compositing). ``u`` (R, n_samples) is
    the stratified draw, None for the middle of each stratum."""
    def field(p_unit, d):
        # the analytic field lives in world coords; undo the normalization
        return volume_field(p_unit * 4.0 - 2.0, d)
    return render.render_rays(field, origins, dirs, near=near, far=far,
                              n_samples=n_samples, u=u)


# ------------------------------------------------------------ batch makers
def gia_batch(gen: torch.Generator, n: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n pixel positions U[0, 1)^2 on the generator's device and their
    colours: ((n, 2), (n, 3))."""
    xy = torch.rand((n, 2), generator=gen, device=gen.device)
    return xy, gigapixel_image(xy)


def nsdf_batch(gen: torch.Generator, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A mix of uniform and near-surface samples (standard SDF training):
    n // 2 points U[-1, 1)^3, the rest U[-1, 1)^3 plus N(0, 0.02^2) noise.
    Returns the points in [0, 1]^3, as the network sees them, and
    ``sdf_scene`` at them: ((n, 3), (n, 1))."""
    dev = gen.device
    p_uni = torch.rand((n // 2, 3), generator=gen, device=dev) * 2.0 - 1.0
    p_srf = torch.rand((n - n // 2, 3), generator=gen, device=dev) * 2.0 - 1.0
    p_srf = p_srf + 0.02 * torch.randn(p_srf.shape, generator=gen,
                                       device=dev)
    p = torch.cat([p_uni, p_srf], dim=0)
    return (p + 1.0) / 2.0, sdf_scene(p)


def nerf_ray_batch(gen: torch.Generator, cam: render.Camera, n_rays: int,
                   gt_samples: int = 64
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random pixels of ``cam`` with the analytic volume's pixels as
    targets, on the generator's device: (origins (R, 3), dirs (R, 3),
    target (R, 3)). The targets are composited with ``gt_samples``
    stratified samples per ray."""
    dev = gen.device
    pix = torch.randint(0, cam.height * cam.width, (n_rays,), generator=gen,
                        device=dev)
    origins, dirs = render.make_rays(cam, pix)
    u = torch.rand((n_rays, gt_samples), generator=gen, device=dev)
    return origins, dirs, gt_render_rays(origins, dirs, n_samples=gt_samples,
                                         u=u)


# ------------------------------------------------------ baked nsdf scene
def baked_sdf_params(cfg: FieldConfig, seed: int) -> Dict:
    """An nsdf param tree (numpy f32, keyed as ``fields.param_shapes``)
    whose field is ``sdf_sphere`` plus a small perturbation that every
    level and every weight feeds, so that sphere tracing converges on it.

    A field with random U(-1, 1) tables is nowhere near 1-Lipschitz (the
    finest level scales a coordinate by about 2047), so sphere tracing
    amplifies any rounding difference without bound. Here:

    - level 0 (dense, 17^3 rows at Table-I width) holds the sphere's SDF
      at its vertices in feature 0: trilinear interpolation of it is about
      1-Lipschitz; every other table entry is U(-1, 1);
    - the MLP carries feature 0 through hidden units 0 and 1 as
      ``relu(s) - relu(-s) = s``, with identity weights between them;
    - hidden units 2.. take every other feature, its input weight
      N(0, 1/in) times ``0.1 / res_l`` (res_l: its level's resolution), so
      each level adds about 0.1 to the field's Lipschitz bound, through
      random N(0, 1/62) layers to a random output weight.

    The sphere (radius 0.8) and not ``sdf_scene``: its values stay
    positive on the unit cube's boundary cells, which the encoding repeats
    outside the cube, so rays that miss never see a zero there;
    ``sdf_scene``'s torus comes within 0.05 of the boundary and would."""
    g = cfg.grid
    if cfg.app != "nsdf" or g.dim != 3 or g.level_is_hashed(0):
        raise ValueError("a baked sdf needs nsdf with a dense level 0 "
                         f"(got {cfg.app}, dim {g.dim}, "
                         f"T=2^{g.log2_table_size})")
    if cfg.mlp.hidden_dim < 3:
        raise ValueError("a baked sdf needs a hidden width of at least 3")
    shapes = param_shapes(cfg)
    rng = np.random.default_rng(seed)
    tables = rng.random(shapes["grid"], dtype=np.float32)
    tables *= 2
    tables -= 1
    res = g.level_resolution(0)
    # dense row i + j (res+1) + k (res+1)^2 holds vertex (i, j, k), at
    # x = coord / res in the unit cube, p = 2x - 1 in world coordinates
    c = np.arange(res + 1, dtype=np.float32) / np.float32(res)
    x = np.stack(np.meshgrid(c, c, c, indexing="ij")[::-1], -1).reshape(-1, 3)
    p = torch.from_numpy(x * np.float32(2) - np.float32(1))
    tables[0, :len(x), 0] = sdf_sphere(p)[:, 0].numpy()

    m = cfg.mlp
    h = m.hidden_dim

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32)
                / np.float32(np.sqrt(shape[-2])))
    w_in = np.zeros((m.in_dim, h), np.float32)
    w_in[0, 0], w_in[0, 1] = 1.0, -1.0
    level_scale = np.repeat([0.1 / g.level_resolution(l)
                             for l in range(g.n_levels)], g.n_features)
    w_in[1:, 2:] = normal(m.in_dim, h - 2)[1:] * level_scale[1:, None]
    w_hidden = np.zeros((m.n_hidden - 1, h, h), np.float32)
    w_hidden[:, 0, 0] = w_hidden[:, 1, 1] = 1.0
    w_hidden[:, 2:, 2:] = normal(m.n_hidden - 1, h - 2, h - 2)
    w_out = np.zeros((h, m.out_dim), np.float32)
    w_out[0], w_out[1] = 1.0, -1.0
    w_out[2:] = normal(h - 2, m.out_dim)
    mlp = {"w_in": w_in, "w_out": w_out}
    if m.n_hidden > 1:
        mlp["w_hidden"] = w_hidden
    return {"grid": tables, "mlp": mlp}
