"""Ray generation, sampling and emission-absorption compositing.

Compositing: alpha_i = 1 - exp(-sigma_i dt_i), T_i = prod_{j<i}(1 - alpha_j),
C = sum_i T_i alpha_i c_i, with the transmittance realised as
``exp(cumsum(-sigma dt))`` exclusive, the formulation the compositing
kernel (``kernels/ray_march``) computes term for term.

A :class:`Camera` is host data (Python numbers and a numpy pose). Rays are
made on the device of the pixel ids with elementwise arithmetic only, so
the CPU and a GPU produce the same sample points bit for bit: the fine
hash levels multiply a coordinate by up to 8192, and would magnify even a
last-bit difference in a point.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Pinhole camera; ``c2w`` is the (4, 4) float32 camera-to-world pose."""
    height: int
    width: int
    focal: float
    c2w: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "c2w",
                           np.asarray(self.c2w, np.float32).reshape(4, 4))

    @property
    def resolution(self) -> Tuple[int, int]:
        return int(self.height), int(self.width)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """(4, 4) float32 camera-to-world pose looking from ``eye`` at
    ``target``, computed in float32 as the JAX package computes it."""
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


def make_rays(cam: Camera, pixel_ids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixel_ids (R,) flat integer indices -> (origins (R, 3), dirs (R, 3))
    f32 on the device of ``pixel_ids``."""
    py = torch.div(pixel_ids, cam.width, rounding_mode="floor").float()
    px = torch.remainder(pixel_ids, cam.width).float()
    # float32 scalars: the camera's values as the JAX package holds them;
    # the focal length divides as a tensor, since a CUDA divide by a Python
    # number multiplies by its reciprocal, which may differ in the last bit
    focal = torch.full_like(px, float(np.float32(cam.focal)))
    x = (px - float(np.float32(cam.width)) * 0.5 + 0.5) / focal
    y = (py - float(np.float32(cam.height)) * 0.5 + 0.5) / focal
    rot = cam.c2w[:3, :3].astype(np.float64)     # exact float32 values
    d = [x * float(rot[i, 0]) + y * float(rot[i, 1]) + float(rot[i, 2])
         for i in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dirs = torch.stack([c / norm for c in d], dim=-1)
    # filled on the device: a host-to-device copy here would synchronise
    origins = torch.stack([torch.full_like(x, float(e))
                           for e in cam.c2w[:3, 3]], dim=-1)
    return origins, dirs


def sample_along_rays(origins: torch.Tensor, dirs: torch.Tensor,
                      near: float, far: float, n_samples: int,
                      u: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified sampling -> points (R, S, 3), dts (1, S) or (R, S).

    ``u`` (R, S) in [0, 1) places each sample in its stratum; None puts it
    at the middle (u = 0.5), the deterministic serving path, and then dts
    is the one (1, S) row of intervals, which compositing broadcasts. With
    ``u`` it is that row expanded to (R, S) as a stride-0 view."""
    dev = origins.device
    # the JAX package's linspace: start * (1 - step) + stop * step
    step = torch.arange(n_samples, dtype=torch.float32, device=dev) / n_samples
    t = torch.cat([near * (1.0 - step) + far * step,
                   torch.full((1,), far, dtype=torch.float32, device=dev)])
    lo, hi = t[:-1], t[1:]
    ts = lo[None, :] + (hi - lo)[None, :] * (0.5 if u is None else u)
    dts = (hi - lo)[None, :].expand(ts.shape)
    pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    return pts, dts


def composite(rgb: torch.Tensor, sigma: torch.Tensor, dts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rgb (R, S, 3), sigma (R, S), dts (R, S) -> (pixel (R, 3),
    opacity (R,)). Since ``1 - alpha == exp(-sigma dt)`` exactly, no log
    and no epsilon are needed, and opaque samples stay finite."""
    log1m = -sigma * dts                                       # log(1-alpha)
    alpha = 1.0 - torch.exp(log1m)
    trans = torch.exp(torch.cumsum(log1m, dim=-1) - log1m)     # excl. scan
    w = trans * alpha
    return (w[..., None] * rgb).sum(dim=-2), w.sum(dim=-1)


def normalize_to_unit(points: torch.Tensor, lo: float = -2.0,
                      hi: float = 2.0) -> torch.Tensor:
    """World coords -> [0, 1]^d for the grid encoding."""
    return torch.clamp((points - lo) / (hi - lo), 0.0, 1.0)


def render_rays(field_apply: Callable, origins: torch.Tensor,
                dirs: torch.Tensor, *, near: float = 0.5, far: float = 4.5,
                n_samples: int = 32, u: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Dense per-ray pipeline: sample -> field -> composite. (R,) rays ->
    pixels (R, 3).

    ``field_apply(points (N, 3), dirs (N, 3)) -> (N, 4) [rgb, sigma]``.
    Compositing goes through the compositing kernel's wrapper, which reads
    the rgb and sigma columns of the field output in place."""
    n_rays = origins.shape[0]
    pts, dts = sample_along_rays(origins, dirs, near, far, n_samples, u)
    flat_pts = normalize_to_unit(pts.reshape(-1, 3))
    flat_dirs = torch.repeat_interleave(dirs, n_samples, dim=0)
    out = field_apply(flat_pts, flat_dirs).reshape(n_rays, n_samples, 4)
    rgb, sigma = out[..., :3], out[..., 3]
    # imported here: the wrapper's plain version is this module's composite
    from repro_torch.kernels.ray_march import ops as rm_ops
    pixel, _ = rm_ops.composite(rgb, sigma, dts)
    return pixel
