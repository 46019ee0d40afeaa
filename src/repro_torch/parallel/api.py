"""The LM train and serving steps of the port on one device: the JAX
package's ``parallel/api.py`` without its sharding.

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

Training: ``TrainConfig``, ``make_train_state``, ``build_train_step`` and
``make_train_step`` keep the JAX meaning. The step casts the f32 master
to ``cfg.adtype`` inside the loss (``cast_params_once``), so the
gradients flow back into f32 leaves; with ``num_microbatches > 1`` it sums
the micro-batches' losses and gradients in order, then divides
(``train/loop.accumulated_value_and_grad``); ``compression`` runs
``train/compression.apply_inline`` over the whole gradient tree with the
error feedback in ``state["efb"]``; then Adam updates the params and
moments in place (``train/optim.adam_update``). Metrics: ``loss``,
``grad_norm``, ``lr`` and the loss's scalar aux (the LM's ``ce`` and
``moe_aux_loss``). ``init_params(train_cfg=)`` refuses a model whose
train state would not fit before drawing it (``train_state_bytes``).
``train_state_specs``, ``param_specs`` and ``batch_specs`` wait for the
LM sharding (ROADMAP A14.5), as meshes of more than one device do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.param import KeyGen, tree_bytes, tree_leaves, \
    tree_map, unbox
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import compression as compression_mod
from repro_torch.train import loop, optim


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: optim.AdamConfig = optim.AdamConfig(
        lr=3e-4, b2=0.95, eps=1e-8, grad_clip=1.0, lr_warmup_steps=100)
    num_microbatches: int = 1
    compression: Optional[str] = None      # None | 'topk' | 'int8'
    compression_topk: float = 0.05
    # cast the f32 master params to the act dtype once at the step's
    # start (inside the loss, so the gradients flow into the f32 master)
    cast_params_once: bool = True


def train_state_bytes(cfg: ModelConfig,
                      train_cfg: Optional[TrainConfig] = None) -> int:
    """Bytes that training ``cfg`` holds besides its activations, from a
    meta-device init: the params, their gradients and Adam's ``mu`` and
    ``nu`` (16 bytes a parameter in f32), the error feedback with
    compression (4 more) and the compute copy the step casts."""
    tc = train_cfg or TrainConfig()
    tree = _init_tree(cfg, KeyGen(0, "meta"))
    need = (4 + (tc.compression is not None)) * tree_bytes(tree)
    if tc.cast_params_once and cfg.adtype != torch.float32:
        item = torch.empty((), dtype=cfg.adtype).element_size()
        need += sum(a.numel() * item for a in tree_leaves(tree)
                    if a.dtype == torch.float32 and a.ndim >= 2)
    return int(need)


def check_fits(cfg: ModelConfig, device: torch.device,
               compute_dtype: Optional[torch.dtype] = None,
               train_cfg: Optional[TrainConfig] = None) -> None:
    """Raise ``MemoryError`` when the params (with ``train_cfg``: the
    train state, ``train_state_bytes``) would not fit in the memory free
    on the CUDA ``device`` (other devices are not checked)."""
    if device.type != "cuda":
        return
    if train_cfg is not None:
        need = train_state_bytes(cfg, train_cfg)
        what = (f"its train state takes {need / 1e9:.1f} GB (f32 params, "
                "gradients, Adam's mu and nu, the compute copy)")
    else:
        need = param_bytes(cfg, compute_dtype)
        dtype = str(compute_dtype or cfg.pdtype).replace("torch.", "")
        what = f"its params take {need / 1e9:.1f} GB in {dtype}"
    free = torch.cuda.mem_get_info(device)[0]
    if need > free:
        raise MemoryError(
            f"{cfg.name}: {what}, more than the {free / 1e9:.1f} GB free "
            f"on {device}; one device cannot hold it (the LM sharding, "
            "ROADMAP A14.5, will spread it)")


def init_params(cfg: ModelConfig, seed: int = 0, mesh=None, *,
                device: DeviceLike = None,
                compute_dtype: Optional[torch.dtype] = None,
                train_cfg: Optional[TrainConfig] = None) -> Dict:
    """Materialize params on the device (CUDA unless named, or the one
    device of ``mesh``), drawn from ``torch.Generator``s there seeded by
    ``seed``. With ``compute_dtype`` the result equals
    ``cast_params_for_compute(init_params(...), compute_dtype)`` bit for
    bit, but each leaf that cast would narrow is made narrow as it is
    drawn (in f32 one layer's slice at a time), so no f32 master is ever
    held. A tree larger than the card's free memory (with ``train_cfg``,
    a train state: ``train_state_bytes``) raises ``MemoryError`` before
    anything is drawn."""
    mesh_dev = _check_mesh(mesh)
    dev = resolve_device(mesh_dev if mesh_dev is not None else device)
    check_fits(cfg, dev, compute_dtype, train_cfg)
    return _init_tree(cfg, KeyGen(seed, dev, compute_dtype))


def cast_params_for_compute(params, adtype: torch.dtype):
    """The compute copy of the f32 master params: every f32 leaf of two or
    more dimensions cast to ``adtype``, the rest as they are."""
    def cast(p):
        if p.dtype != torch.float32 or p.ndim < 2:
            return p
        return p.to(adtype)
    return tree_map(cast, params)


# --------------------------------------------------------------- training
def make_train_state(params, compression: bool = False) -> Dict:
    """``{"params", "opt"}`` (and zero error feedback ``"efb"`` with
    ``compression``) over ``params``, which the step updates in place."""
    state = {"params": params, "opt": optim.adam_init(params)}
    if compression:
        state["efb"] = tree_map(torch.zeros_like, params)
    return state


def _loss_for(cfg: ModelConfig) -> Callable:
    return encdec.loss_fn if cfg.is_encdec else lm.loss_fn


def build_train_step(cfg: ModelConfig, mesh=None,
                     train_cfg: Optional[TrainConfig] = None
                     ) -> Tuple[Callable, Dict]:
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients, compression, Adam (the module docstring). ``batch`` holds
    ``tokens`` (B, S) int (and ``labels``; qwen2-vl's stub ``embeddings``
    and (3, B, S) ``positions``; whisper's ``enc_embeddings``) on the
    state's device. Returns (step, info); info is empty until the LM
    sharding gives it the JAX step's shardings. The metrics stay on the
    device (``lr`` is a host number)."""
    _check_mesh(mesh)
    tc = train_cfg or TrainConfig()
    loss_fn = _loss_for(cfg)
    nmb = tc.num_microbatches

    def loss_of(p, batch):
        if tc.cast_params_once:
            p = cast_params_for_compute(p, cfg.adtype)
        return loss_fn(p, cfg, batch)

    # repro: hot-path the step stays async: the engine's chunk read is its sync
    def step(state, batch):
        params = state["params"]
        if nmb > 1:
            (loss, aux), grads = loop.accumulated_value_and_grad(
                loss_of, params, batch, nmb, has_aux=True)
        else:
            (loss, aux), grads = loop.value_and_grad(
                loss_of, params, batch, has_aux=True)
        new_state = dict(state)
        if tc.compression is not None:
            grads, new_state = compression_mod.apply_inline(
                grads, new_state, tc)
        new_params, new_opt, metrics = optim.adam_update(
            grads, state["opt"], params, tc.optimizer)
        metrics["loss"] = loss
        metrics.update({k: v for k, v in aux.items()
                        if isinstance(v, torch.Tensor) and v.ndim == 0})
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, metrics

    return step, {}


def make_train_step(cfg: ModelConfig, mesh=None,
                    train_cfg: Optional[TrainConfig] = None
                    ) -> Tuple[Callable, Dict]:
    """The one-step form of :func:`build_train_step` (the JAX function
    jits and donates; the eager step already updates the state in
    place)."""
    return build_train_step(cfg, mesh, train_cfg)


# ---------------------------------------------------------------- serving
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
