"""Binary occupancy grid for empty-space skipping: the JAX package's
``core/occupancy.py``.

A grid is a dict of two tensors over the unit cube ``[0, 1]^3`` at
resolution ``res`` (a multiple of 4), cells indexed x-major:

  * ``bits``: ``(res^3 // 32,)`` int32, the packed bitfield; bit ``i`` of
    word ``w`` is cell ``w * 32 + i``. The JAX package holds these words as
    uint32; the port holds the same 32 bits as int32, since PyTorch's
    uint32 lacks shifts on CUDA: a bit is ``(word >> i) & 1`` in int32
    (the arithmetic shift's sign bits never reach bit 0 of the mask).
    ``fields.from_jax_params`` takes a JAX grid's uint32 words as they are.
  * ``sigma``: ``(res^3,)`` f32, the coarse density (the pre-threshold
    field, kept by :func:`update_occupancy`'s EMA), which drives the
    early-termination estimate in ``render.render_rays``.

Build from a field with :func:`build_occupancy` (its density at the cell
centres: for nerf the density pass through the field kernel's wrapper),
refresh during training with :func:`update_occupancy` (``core.train``'s
``occupancy_res``), and :func:`attach` it to a scene's params, where the
serve engine stacks it with the tables. Everything is plain tensor ops on
the params' device, no host sync, except :func:`occupied_fraction`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import fields
from repro_torch.core.fields import FieldConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fused_field import ops as ff_ops


# ------------------------------------------------------------- bit packing
def pack_bits(occupied: torch.Tensor) -> torch.Tensor:
    """Boolean ``(n,)`` (n % 32 == 0) -> packed ``(n // 32,)`` int32
    holding the JAX package's uint32 words' bits."""
    n = occupied.shape[0]
    if n % 32 != 0:
        raise ValueError(f"pack_bits needs n % 32 == 0, got {n}")
    shifts = torch.arange(32, dtype=torch.int64, device=occupied.device)
    words = (occupied.reshape(-1, 32).to(torch.int64) << shifts).sum(-1)
    # words in [0, 2^32) as the same 32 bits in int32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Packed ``(w,)`` int32 -> boolean ``(w * 32,)`` (inverse of
    :func:`pack_bits`)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).reshape(-1).bool()


# ----------------------------------------------------------------- indexing
def grid_res(occ: Dict[str, torch.Tensor]) -> int:
    """The cell resolution, from the sigma leaf's shape."""
    n = occ["sigma"].shape[-1]
    res = round(n ** (1.0 / 3.0))
    if res ** 3 != n:
        raise ValueError(
            f"sigma leaf is not a cube: {tuple(occ['sigma'].shape)}")
    return res


def check_res(res: int) -> int:
    # res % 4 == 0 <=> res^3 % 32 == 0, so the bitfield packs exactly
    if res % 4 != 0 or res < 4:
        raise ValueError(f"occupancy res must be a multiple of 4, got {res}")
    return res


def cell_index(points: torch.Tensor, res: int) -> torch.Tensor:
    """Unit-domain points ``(N, 3)`` -> flat cell ids ``(N,)`` int32
    (x-major)."""
    ijk = torch.clamp((points * res).to(torch.int32), 0, res - 1)
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]


def cell_centers(res: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """``(res^3, 3)`` unit-domain cell centres in :func:`cell_index`
    order, f32 on ``device``."""
    ax = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    # a tensor divisor: a CUDA divide by a Python number multiplies by its
    # reciprocal, which differs from the quotient for some res
    ax = ax / torch.full_like(ax, float(res))
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


# ------------------------------------------------------------------ queries
def cell_occupied(occ: Dict[str, torch.Tensor],
                  cells: torch.Tensor) -> torch.Tensor:
    """Occupied? per flat cell id -> bool: one gather and a bit test."""
    word = occ["bits"][cells >> 5]
    return ((word >> (cells & 31)) & 1) != 0


def query(occ: Dict[str, torch.Tensor], points: torch.Tensor) -> torch.Tensor:
    """Occupied? per unit-domain point ``(N, 3)`` -> bool ``(N,)``."""
    return cell_occupied(occ, cell_index(points, grid_res(occ)))


def query_sigma(occ: Dict[str, torch.Tensor],
                points: torch.Tensor) -> torch.Tensor:
    """Coarse density per unit-domain point (its cell's)."""
    return occ["sigma"][cell_index(points, grid_res(occ))]


def occupied_fraction(occ: Dict[str, torch.Tensor]) -> float:
    """Host-side fraction of occupied cells (diagnostics): waits for the
    device."""
    return float(unpack_bits(occ["bits"]).float().mean())


# -------------------------------------------------------------- field sigma
def field_sigma(params: Dict, cfg: FieldConfig,
                points: torch.Tensor) -> torch.Tensor:
    """A field's density at unit-domain points -> ``(N,)``. nerf runs only
    its density pass (the field kernel's wrapper: ``field_fwd`` on the
    card; the colour MLP never runs); nvr runs ``apply_field``."""
    with torch.no_grad():
        if cfg.app == "nerf":
            dfeat = ff_ops.field(points, params["grid"],
                                 params["density_mlp"], cfg.grid,
                                 cfg.density_mlp,
                                 table_scales=params.get("grid_scale"))
            return torch.exp(dfeat[:, 0])
        if cfg.app == "nvr":
            return fields.apply_field(params, cfg, points)[:, 3]
    raise ValueError(
        f"occupancy culling applies to the ray-marched apps (nerf, nvr), "
        f"got {cfg.app!r}")


# ------------------------------------------------------------- build/update
def _grid(sigma: torch.Tensor, threshold: float) -> Dict[str, torch.Tensor]:
    return {"bits": pack_bits(sigma > threshold), "sigma": sigma}


def build_occupancy(params: Dict, cfg: FieldConfig, *, res: int = 64,
                    threshold: float = 0.01) -> Dict[str, torch.Tensor]:
    """Occupancy grid of a field: its density at the ``res^3`` cell
    centres; a cell is occupied iff ``sigma > threshold``. On the device of
    the field's tables."""
    check_res(res)
    pts = cell_centers(res, params["grid"].device)
    return _grid(field_sigma(params, cfg, pts).float(), threshold)


def build_occupancy_from_fn(fn: Callable, *, res: int = 64,
                            threshold: float = 0.01,
                            device: DeviceLike = None
                            ) -> Dict[str, torch.Tensor]:
    """As :func:`build_occupancy` from any density function ``(N, 3) unit
    points -> (N,) sigma``, evaluated on ``device`` (CUDA unless the caller
    names another)."""
    check_res(res)
    pts = cell_centers(res, resolve_device(device))
    with torch.no_grad():
        sigma = fn(pts).reshape(-1).float()
    return _grid(sigma, threshold)


def update_occupancy(occ: Dict[str, torch.Tensor], params: Dict,
                     cfg: FieldConfig, *, decay: float = 0.95,
                     threshold: float = 0.01, res: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """EMA refresh (instant-NGP's): ``sigma <- max(decay * sigma,
    sigma_now)``, then re-threshold. Cells dense a while ago fade instead
    of flickering off. ``res`` is taken from ``occ`` (pass it only to
    check it)."""
    r = grid_res(occ) if res is None else check_res(res)
    fresh = field_sigma(params, cfg, cell_centers(
        r, occ["sigma"].device)).float()
    return _grid(torch.maximum(decay * occ["sigma"], fresh), threshold)


# ------------------------------------------------------------------ helpers
def all_occupied(res: int = 64, device: DeviceLike = None
                 ) -> Dict[str, torch.Tensor]:
    """Every cell occupied, density estimate 0: culling is then an exact
    no-op (no skip, no early termination). On ``device`` (CUDA unless the
    caller names another)."""
    check_res(res)
    dev = resolve_device(device)
    return {"bits": torch.full((res ** 3 // 32,), -1, dtype=torch.int32,
                               device=dev),
            "sigma": torch.zeros((res ** 3,), dtype=torch.float32,
                                 device=dev)}


def attach(params: Dict, occ: Dict[str, torch.Tensor]) -> Dict:
    """Scene params with the grid as one more subtree, ``'occupancy'``."""
    return {**params, "occupancy": occ}
