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

``render_rays`` optionally marches occupancy-culled: samples in empty
cells or behind an opaque prefix are compacted away and the field runs on
a static sample budget only (``core/occupancy.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import annotate


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


def _cull_mask(occupancy: Dict, unit_pts: torch.Tensor, dts: torch.Tensor,
               early_term_eps: float) -> torch.Tensor:
    """Live mask (R, S): the sample's cell is occupied AND the exclusive
    prefix of the grid's coarse optical depth (``sigma_est * dt``) is below
    ``-log(early_term_eps)``. No field evaluation happens before it."""
    from repro_torch.core import occupancy as occ_mod
    r, s, _ = unit_pts.shape
    # each sample's cell once: its bit and its coarse density
    cells = occ_mod.cell_index(unit_pts.reshape(-1, 3),
                               occ_mod.grid_res(occupancy))
    live = occ_mod.cell_occupied(occupancy, cells).reshape(r, s)
    od = occupancy["sigma"][cells].reshape(r, s) * dts
    acc = torch.cumsum(od, dim=-1) - od        # exclusive prefix
    return live & (acc < -math.log(early_term_eps))


def compact_samples(occupancy: Dict, flat_pts: torch.Tensor,
                    dts: torch.Tensor, n_samples: int, budget: int,
                    early_term_eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The culled march's compaction: (live mask (R, S), the flat indices
    (budget,) of the samples the field evaluates). A stable argsort on the
    key ``s`` (live) or ``s + S`` (dead) puts live samples first, near to
    far, so an overflowing budget sheds the farthest live samples."""
    n_rays = flat_pts.shape[0] // n_samples
    live = _cull_mask(occupancy, flat_pts.reshape(n_rays, n_samples, 3),
                      dts, early_term_eps)
    s_idx = torch.arange(n_samples, dtype=torch.int32,
                         device=flat_pts.device).expand(n_rays, n_samples)
    key = torch.where(live, s_idx, s_idx + n_samples).reshape(-1)
    return live, torch.argsort(key, stable=True)[:budget]


def scatter_samples(out_sel: torch.Tensor, sel: torch.Tensor,
                    live: torch.Tensor) -> torch.Tensor:
    """The field's (budget, 4) output scattered back into one packed
    (R, S, 4) buffer, zeros where it did not run, with the dead samples'
    sigma set to 0 in place (the field ran on some of them): the layout the
    compositing kernel reads with one 16-byte load per sample."""
    n_rays, n_samples = live.shape
    out = torch.zeros((n_rays * n_samples, 4), dtype=out_sel.dtype,
                      device=out_sel.device)
    out.index_copy_(0, sel, out_sel)
    out = out.reshape(n_rays, n_samples, 4)
    out[..., 3].masked_fill_(~live, 0.0)
    return out


def render_rays(field_apply: Callable, origins: torch.Tensor,
                dirs: torch.Tensor, *, near: float = 0.5, far: float = 4.5,
                n_samples: int = 32, u: Optional[torch.Tensor] = None,
                use_kernel_composite: bool = False,
                occupancy: Optional[Dict] = None,
                sample_budget: Optional[int] = None,
                early_term_eps: float = 1e-3, return_aux: bool = False):
    """Per-ray pipeline: sample -> field -> composite. (R,) rays -> pixels
    (R, 3).

    ``field_apply(points (N, 3), dirs (N, 3)) -> (N, 4) [rgb, sigma]``.
    ``u`` (R, S) is the stratified draw (None: each sample at the middle of
    its stratum). ``use_kernel_composite`` is the JAX package's
    ``use_pallas_composite``: the serving tiles composite with the
    compositing kernel's wrapper, which reads the rgb and sigma columns of
    the field output in place; by default (training, ground truth) this
    module's plain, differentiable ``composite`` runs.

    With ``occupancy`` (a ``core/occupancy.py`` grid) the march is culled:
    the field runs on the first ``sample_budget`` live samples, near to far
    (:func:`compact_samples`; default ``R*S``, the dense cost; a static
    count, so nothing waits for the device), and its output goes back into
    one packed buffer (:func:`scatter_samples`). Live samples beyond the
    budget stay transparent and count as dropped. With an all-occupied
    grid and the full budget the result is the dense path's, bit for bit,
    where the field's output per point does not depend on the batch
    around it.

    ``return_aux`` returns ``(pixels, aux)`` too: ``n_live`` and
    ``n_dropped`` (int32 device scalars), ``n_budget`` (the static count),
    and, per ray, ``live_per_ray`` and ``dropped_per_ray`` (int32 (R,)),
    which the serve engine sums over a request's valid pixels."""
    n_rays = origins.shape[0]
    dev = origins.device
    # phases: raymarch = sampling bookkeeping, compact = the cull mask,
    # the budget's selection and the scatter back, composite = integration
    with annotate("raymarch"):
        pts, dts = sample_along_rays(origins, dirs, near, far, n_samples, u)
        flat_pts = normalize_to_unit(pts.reshape(-1, 3))
        flat_dirs = torch.repeat_interleave(dirs, n_samples, dim=0)
    n_total = n_rays * n_samples
    if occupancy is None:
        out = field_apply(flat_pts, flat_dirs).reshape(n_rays, n_samples, 4)
        if return_aux:
            per_ray = torch.full((n_rays,), n_samples, dtype=torch.int32,
                                 device=dev)
            aux = {"n_live": torch.full((), n_total, dtype=torch.int32,
                                        device=dev),
                   "n_budget": n_total,
                   "n_dropped": torch.zeros((), dtype=torch.int32,
                                            device=dev),
                   "live_per_ray": per_ray,
                   "dropped_per_ray": torch.zeros_like(per_ray)}
    else:
        budget = (n_total if sample_budget is None
                  else max(1, min(int(sample_budget), n_total)))
        with annotate("compact"):
            live, sel = compact_samples(occupancy, flat_pts, dts, n_samples,
                                        budget, early_term_eps)
        out_sel = field_apply(flat_pts[sel], flat_dirs[sel])
        with annotate("compact"):
            out = scatter_samples(out_sel, sel, live)
        if return_aux:
            evaluated = torch.zeros(n_total, dtype=torch.bool, device=dev)
            evaluated[sel] = True
            dropped = live & ~evaluated.reshape(n_rays, n_samples)
            n_live = live.sum(dtype=torch.int32)
            aux = {"n_live": n_live, "n_budget": budget,
                   "n_dropped": torch.clamp(n_live - budget, min=0),
                   "live_per_ray": live.sum(-1, dtype=torch.int32),
                   "dropped_per_ray": dropped.sum(-1, dtype=torch.int32)}
    rgb, sigma = out[..., :3], out[..., 3]
    with annotate("composite"):
        if not use_kernel_composite:
            pixel, _ = composite(rgb, sigma, dts.expand(sigma.shape))
        else:
            # imported here: the wrapper's plain version is this module's
            from repro_torch.kernels.ray_march import ops as rm_ops
            pixel, _ = rm_ops.composite(rgb, sigma, dts)
    return (pixel, aux) if return_aux else pixel
