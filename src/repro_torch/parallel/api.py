"""The LM serving steps of the port on one device: the serving half of the
JAX package's ``parallel/api.py``.

``init_params``, ``cast_params_for_compute``, ``make_cache``,
``make_prefill_step`` and ``make_decode_step`` keep the JAX signatures'
meaning. The JAX functions take a device mesh and build jitted steps with
explicit shardings; here ``mesh`` is ``None`` or a mesh of one device
(``launch/mesh.Mesh``), and any other mesh raises until the LM sharding
slice. The steps are plain Python functions; the cache is filled and
updated in place and returned (the JAX steps donate it).

The steps cast the f32 master params to ``cfg.adtype`` (leaves of two or
more dimensions; norms and biases stay f32), as the JAX steps do at every
call. A leaf already cast is passed through, so a server that needs no
f32 master draws its params straight into the compute dtype with
``init_params(cfg, compute_dtype=cfg.adtype)``: its peak memory is then
the compute tree, and a model that fits in bf16 but not in f32 (qwen3-32b
and qwen3-moe-30b-a3b on an 80 GB card) serves. A tree that does not fit
on the card at all is refused before anything is drawn.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.param import KeyGen, tree_bytes, tree_map, unbox
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig


def _check_mesh(mesh) -> Optional[torch.device]:
    """The one device of ``mesh`` (None: no mesh); more devices raise."""
    if mesh is None:
        return None
    if mesh.size != 1:
        raise NotImplementedError(
            f"the LM steps run on one device; a mesh of {mesh.size} waits "
            "for the LM sharding (ROADMAP A14.5)")
    return mesh.devices[0]


def _init_tree(cfg: ModelConfig, kg: KeyGen) -> Dict:
    tree = unbox(encdec.init_encdec(kg, cfg) if cfg.is_encdec
                 else lm.init_lm(kg, cfg))[0]
    if kg.compute_dtype is None:
        return tree
    # the leaves made outside the initialisers (SSM vectors: small)
    return cast_params_for_compute(tree, kg.compute_dtype)


def param_bytes(cfg: ModelConfig,
                compute_dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of ``init_params(cfg, compute_dtype=)``'s tree, from a
    meta-device init (nothing is allocated)."""
    return tree_bytes(_init_tree(cfg, KeyGen(0, "meta", compute_dtype)))


def check_fits(cfg: ModelConfig, device: torch.device,
               compute_dtype: Optional[torch.dtype] = None) -> None:
    """Raise ``MemoryError`` when the params would not fit in the memory
    free on the CUDA ``device`` (other devices are not checked)."""
    if device.type != "cuda":
        return
    need = param_bytes(cfg, compute_dtype)
    free = torch.cuda.mem_get_info(device)[0]
    if need > free:
        dtype = str(compute_dtype or cfg.pdtype).replace("torch.", "")
        raise MemoryError(
            f"{cfg.name}: its params take {need / 1e9:.1f} GB in {dtype}, "
            f"more than the {free / 1e9:.1f} GB free on {device}; one "
            "device cannot hold it (the LM sharding, ROADMAP A14.5, will "
            "spread it)")


def init_params(cfg: ModelConfig, seed: int = 0, mesh=None, *,
                device: DeviceLike = None,
                compute_dtype: Optional[torch.dtype] = None) -> Dict:
    """Materialize params on the device (CUDA unless named, or the one
    device of ``mesh``), drawn from ``torch.Generator``s there seeded by
    ``seed``. With ``compute_dtype`` the result equals
    ``cast_params_for_compute(init_params(...), compute_dtype)`` bit for
    bit, but each leaf that cast would narrow is made narrow as it is
    drawn (in f32 one layer's slice at a time), so no f32 master is ever
    held. A tree larger than the card's free memory raises
    ``MemoryError`` before anything is drawn."""
    mesh_dev = _check_mesh(mesh)
    dev = resolve_device(mesh_dev if mesh_dev is not None else device)
    check_fits(cfg, dev, compute_dtype)
    return _init_tree(cfg, KeyGen(seed, dev, compute_dtype))


def cast_params_for_compute(params, adtype: torch.dtype):
    """The compute copy of the f32 master params: every f32 leaf of two or
    more dimensions cast to ``adtype``, the rest as they are."""
    def cast(p):
        if p.dtype != torch.float32 or p.ndim < 2:
            return p
        return p.to(adtype)
    return tree_map(cast, params)


def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               enc_len: int = 0, *, device: DeviceLike = None) -> Dict:
    """Properly initialized cache (ring slot positions -1, not zeros) on
    the device (CUDA unless named)."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, capacity,
                                     enc_len or capacity, device=dev)
    return lm.init_cache(cfg, batch, capacity, device=dev)


def _cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                  enc_len: int) -> Dict:
    meta = torch.device("meta")
    if cfg.is_encdec:
        c = encdec.init_dec_cache(cfg, batch, capacity, enc_len or capacity,
                                  device=meta)
    else:
        c = lm.init_cache(cfg, batch, capacity, device=meta)
    return tree_map(lambda a: (tuple(a.shape), a.dtype), c)


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      capacity: Optional[int] = None, batch_size: int = 1,
                      enc_len: int = 0) -> Tuple[Callable, Dict]:
    """``prefill(params, batch, cache) -> (last-token logits (B, V),
    cache)``, with the params cast for compute at each call (a leaf
    already cast passes through). Returns (step, info) where info holds
    ``cache_shapes`` (shape, dtype per leaf) as the JAX info holds its
    cache's ShapeDtypeStructs."""
    _check_mesh(mesh)

    def step(params, batch, cache):
        params = cast_params_for_compute(params, cfg.adtype)
        if cfg.is_encdec:
            return encdec.prefill(params, cfg, batch, cache)
        return lm.prefill(params, cfg, batch, cache)

    return step, {"cache_shapes": _cache_shapes(cfg, batch_size,
                                                capacity or 0, enc_len)}


def make_decode_step(cfg: ModelConfig, mesh=None,
                     capacity: int = 1024, batch_size: int = 1,
                     enc_len: int = 0) -> Tuple[Callable, Dict]:
    """``decode(params, cache, tokens (B, 1), pos) -> (logits (B, V),
    cache)``; ``pos`` is a host int."""
    _check_mesh(mesh)

    def step(params, cache, tokens, pos):
        params = cast_params_for_compute(params, cfg.adtype)
        if cfg.is_encdec:
            return encdec.decode_step(params, cfg, tokens, pos, cache)
        return lm.decode_step(params, cfg, tokens, pos, cache)

    return step, {"cache_shapes": _cache_shapes(cfg, batch_size, capacity,
                                                enc_len)}
