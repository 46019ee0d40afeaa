"""The LM train and serving steps of the port: the JAX package's
``parallel/api.py``.

On one device (``mesh`` None or a mesh of one device,
``launch/mesh.Mesh``) the steps are plain Python functions over a tree of
tensors. ``init_params``, ``cast_params_for_compute``, ``make_cache``,
``make_prefill_step`` and ``make_decode_step`` keep the JAX meaning; the
cache is filled and updated in place and returned (the JAX steps donate
it). The steps cast the f32 master params to ``cfg.adtype`` (leaves of two
or more dimensions; norms and biases stay f32), as the JAX steps do at
every call. A leaf already cast is passed through, so a server that needs
no f32 master draws its params straight into the compute dtype with
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

On a mesh of more than one device (the LM sharding):

* **Placement is JAX's.** ``param_specs``, ``batch_specs``,
  ``train_state_specs`` and ``cache_specs`` are the JAX functions' specs
  (``common/partitioning.logical_to_spec`` with the divisibility
  fallback, recorded in ``rules.fallbacks``). ``init_params(mesh=,
  rules=)`` draws each shard on its position's device
  (``parallel/sharded.place`` of a lazy init): a tree of
  ``parallel/sharded.Sharded`` leaves, each position holding the slice
  ``NamedSharding.shard_shape`` gives, whose values are the one-device
  init's sliced. Adam's moments and the error feedback are sharded alike.
* **Both steps split the batch and compute over 'model'.** A step
  splits its batch over the mesh axes its batch spec gives the batch dim
  (replicated, one row, when the batch does not divide), into equal rows
  in the spec's order. Each row runs on its tensor-parallel group, the
  row's positions along 'model' (``parallel/tp.py``): every position
  computes its own heads, ``mlp`` columns, vocab rows, experts and SSM
  heads and the group sums or gathers what GSPMD's collectives would
  (``parallel/collectives.py``); under ``baseline``/``sp`` the stream
  between blocks is split along the sequence. No device holds a whole
  compute copy: each position gathers its slice of one block at a time,
  whole along 'data' (FSDP by block), and drops it after the block.
* **Training** (``make_value_and_grad``): each f32 master shard is cast
  to ``cfg.adtype`` once a step on its own device (``cast_params_once``);
  each row's loss runs on its group (``models/lm.loss_fn_tp``), each
  block under ``cfg.remat`` with its slices gathered inside the
  recomputed function, so the backward gathers them again, and the CE
  vocab-parallel, its logits never whole on a rank. The backward of a
  block's gather adds the slice's gradient, in f32, into the gradient
  buffers of the positions holding it (a reduce-scatter over 'data';
  every copy of a replicated slice gets the same sum, so the copies stay
  bit-equal under Adam). The rows run in row order: without a MoE each
  row's backward right after its forward; with one, every forward first
  (the load-balance density needs every row's counts). The sum is
  divided by the number of rows, as ``train/loop.data_parallel_grad_fn``
  does. With ``num_microbatches`` each micro-batch (the JAX step's: a
  contiguous slice of the global batch) goes through all of this in
  turn, and the micro-batches are summed in order and divided
  (``train/loop.accumulated_value_and_grad``). Compression and Adam run
  shard-locally; the clip's global norm counts each distinct slice once.
* **The MoE layer keeps the global batch's token groups**: a row's
  capacity slots continue the counts of the rows before it, and the
  load-balance loss is formed from every row's partial sums
  (``parallel/sharded.RowContext``), so the sharded step computes the
  function the JAX step computes, not one with per-row groups.
* **Serving caches** (``make_cache(shardings=)``): per row, each rank of
  its group holds the shard that ``cache_specs`` gives its position
  (``parallel/tp.RowCache``, ``tp.cache_layout``): under ``baseline`` its
  chunk of the positions for every KV head, the KV heads where the
  length does not divide the group or under ``nosp``; the SSM's state
  its heads (its conv state: stated difference, ``parallel/tp``). Tokens
  are split as the cache is; ``tok_sharding`` reports JAX's rule.
* **Memory**: ``train_state_bytes(mesh=)`` gives each position's bytes
  when training (``train_bytes``): its shards with their gradients and
  moments, the compute copy of its shards, the final norm's and the
  unembedding's slices (kept from the forward to the backward), and the
  largest block's copied slice with that slice's gradient. ``param_bytes(mesh=)`` gives
  them when serving (``serving_bytes``): its shards and the largest
  block's copied slice (``serving_bytes`` adds a cache).
  ``check_fits(mesh=)`` holds each device's sum (positions sharing a card
  add up) against its free memory or ``device_bytes``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.param import KeyGen, tree_bytes, tree_leaves, \
    tree_map, unbox
from repro_torch.common.partitioning import (
    DEFAULT_RULES, ActivationSharder, LogicalRules, NamedSharding,
    PartitionSpec as P, divisible_fallback, logical_to_spec,
    specs_to_shardings)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import axes_devices
from repro_torch.models import encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll, sharded as sh, tp
from repro_torch.parallel.sharded import Sharded
from repro_torch.parallel.tp import RowCache
from repro_torch.train import compression as compression_mod
from repro_torch.train import loop, optim


def _mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def _sharded_mesh(mesh) -> bool:
    """True for a mesh of more than one device (the sharded path)."""
    return mesh is not None and _mesh_size(mesh) > 1


def _mesh_device(mesh) -> Optional[torch.device]:
    """The one device of a one-device mesh (None: no mesh)."""
    return None if mesh is None else mesh.devices[0]


def _init_tree(cfg: ModelConfig, kg: KeyGen) -> Dict:
    tree = unbox(encdec.init_encdec(kg, cfg) if cfg.is_encdec
                 else lm.init_lm(kg, cfg))[0]
    if kg.compute_dtype is None:
        return tree
    # the leaves made outside the initialisers (SSM vectors: small)
    return cast_params_for_compute(tree, kg.compute_dtype)


# ------------------------------------------------------------------ specs
def abstract_params(cfg: ModelConfig, seed: int = 0,
                    compute_dtype: Optional[torch.dtype] = None):
    """(a tree of meta tensors, the tree of logical axes): the JAX
    function's (ShapeDtypeStruct tree, axes tree), allocating nothing."""
    kg = KeyGen(seed, "meta", compute_dtype)
    boxed = (encdec.init_encdec(kg, cfg) if cfg.is_encdec
             else lm.init_lm(kg, cfg))
    shapes, axes = unbox(boxed)
    if compute_dtype is not None:
        shapes = cast_params_for_compute(shapes, compute_dtype)
    return shapes, axes


def param_specs(cfg: ModelConfig, mesh, rules: LogicalRules,
                compute_dtype: Optional[torch.dtype] = None):
    """(meta shapes, PartitionSpec tree) of the params on ``mesh``."""
    shapes, axes = abstract_params(cfg, compute_dtype=compute_dtype)
    return shapes, logical_to_spec(axes, mesh, rules, shapes)


def batch_logical_axes(cfg: ModelConfig, batch: Dict) -> Dict:
    """Logical axes for every input tensor of a train/prefill batch."""
    out = {}
    for name, v in batch.items():
        if name == "positions" and v.ndim == 3:
            out[name] = (None, "batch", "act_seq")
        elif name in ("embeddings", "enc_embeddings"):
            out[name] = ("batch", "act_seq", "act_embed")
        else:                       # tokens / labels
            out[name] = ("batch", "act_seq")
    return out


def batch_specs(cfg: ModelConfig, batch, mesh, rules: LogicalRules):
    """Specs of a batch's leaves (anything with ``.shape`` and ``.ndim``)."""
    return logical_to_spec(batch_logical_axes(cfg, batch), mesh, rules,
                           batch)


def train_state_specs(pspecs, compression: bool = False) -> Dict:
    specs = {"params": pspecs, "opt": optim.AdamState(
        step=P(), mu=pspecs, nu=pspecs)}
    if compression:
        specs["efb"] = pspecs
    return specs


def abstract_cache(cfg: ModelConfig, batch: int, capacity: int,
                enc_len: int) -> Dict:
    meta = torch.device("meta")
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, capacity,
                                     enc_len or capacity, device=meta)
    return lm.init_cache(cfg, batch, capacity, device=meta)


def _cache_axes(cfg: ModelConfig) -> Dict:
    if not cfg.is_encdec:
        return lm.cache_logical_axes(cfg)
    from repro_torch.models.attention import cache_logical_axes
    kv = ("layers", "batch", "act_seq", "kv_heads", "head_dim")
    return {"self": {k: ("layers",) + v
                     for k, v in cache_logical_axes().items()},
            "cross": {"k": kv, "v": kv}}


def cache_specs(cfg: ModelConfig, mesh, rules: LogicalRules, batch: int,
                capacity: int, enc_len: int = 0):
    """(meta cache tree, its PartitionSpec tree)."""
    shapes = abstract_cache(cfg, batch, capacity, enc_len)
    return shapes, logical_to_spec(_cache_axes(cfg), mesh, rules, shapes)


def _row_devices(mesh, rules: LogicalRules, batch: int
                 ) -> List[torch.device]:
    """The device of each row of a batch of ``batch`` examples: the axes
    its batch spec gives the batch dim (a scratch rule set: a step records
    no fallback of its own, as a jitted JAX step records none)."""
    entry = divisible_fallback(mesh, (batch,), ("batch",),
                               LogicalRules(rules.rules))[0]
    return axes_devices(mesh, entry)


# ------------------------------------------------------------------ memory
def _dtype_size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _casts(leaf, adtype: torch.dtype) -> bool:
    """True where the compute copy narrows the leaf (f32, two or more
    dims, another act dtype)."""
    return (leaf.dtype == torch.float32 and leaf.ndim >= 2
            and adtype != torch.float32)


def _position_bytes(cfg: ModelConfig, mesh, rules: LogicalRules,
                    per_param: int, compute_dtype: Optional[torch.dtype],
                    cast: bool) -> List[int]:
    """Each mesh position's bytes: ``per_param`` bytes for every byte of
    its param shards (params, and for training gradients, moments, error
    feedback) and, with ``cast``, the compute copy of its shards."""
    shapes, specs = param_specs(cfg, mesh, LogicalRules(rules.rules),
                                compute_dtype)
    n = _mesh_size(mesh)
    out = [0] * n
    for leaf, spec in zip(optim.tree_leaves(shapes),
                          optim.tree_leaves(specs)):
        numel = int(np.prod(NamedSharding(mesh, spec).shard_shape(
            tuple(leaf.shape))))
        item = leaf.element_size()
        narrow = cast and _casts(leaf, cfg.adtype)
        extra = numel * _dtype_size(cfg.adtype) if narrow else 0
        for p in range(n):
            out[p] += per_param * numel * item + extra
    return out


def shard_param_bytes(cfg: ModelConfig, mesh,
                      rules: Optional[LogicalRules] = None,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> List[int]:
    """The bytes of ``init_params(cfg, mesh=, rules=, compute_dtype=)``'s
    shards at each mesh position (what each device stores under the JAX
    package), from a meta init; ``mesh`` needs only ``shape`` (a stand-in
    plans a mesh this process does not have)."""
    return _position_bytes(cfg, mesh, rules or DEFAULT_RULES, 1,
                           compute_dtype, cast=False)


def _row_positions(mesh, rules: LogicalRules,
                   batch: Optional[int] = None) -> List[int]:
    """The mesh positions that run a row of a batch of ``batch`` examples
    (default: one the batch axes divide), in row order: the first along
    the axes the split does not use. ``mesh`` needs only ``shape``."""
    n = _mesh_size(mesh)
    axes = divisible_fallback(mesh, (n if batch is None else batch,),
                              ("batch",), LogicalRules(rules.rules))[0]
    pos = np.arange(n).reshape(tuple(mesh.shape.values()))
    used = () if axes is None else ((axes,) if isinstance(axes, str)
                                    else tuple(axes))
    index = tuple(slice(None) if a in used else 0 for a in mesh.shape)
    grid = np.asarray(pos[index])
    kept = [a for a in mesh.shape if a in used]
    return [int(p) for p in grid.transpose(
        [kept.index(a) for a in used]).reshape(-1)]


def row_positions(mesh, rules: Optional[LogicalRules], batch: int
                  ) -> List[int]:
    """The mesh position of each row of a sharded step's batch of
    ``batch`` examples, in row order (:func:`batch_row_devices` as
    positions; ``mesh`` needs only ``shape``, so a stand-in plans a mesh
    this process does not have)."""
    return _row_positions(mesh, rules or DEFAULT_RULES, batch)


def param_bytes(cfg: ModelConfig,
                compute_dtype: Optional[torch.dtype] = None, *,
                mesh=None, rules: Optional[LogicalRules] = None):
    """Bytes of ``init_params(cfg, compute_dtype=)``'s tree, from a
    meta-device init (nothing is allocated). With a mesh of more than one
    device: each position's bytes when serving, its shards and the largest
    block's copied slice (:func:`serving_bytes`)."""
    if not _sharded_mesh(mesh):
        return tree_bytes(_init_tree(cfg, KeyGen(0, "meta", compute_dtype)))
    return [sum(t) for t in zip(*serving_bytes(
        cfg, mesh, rules or DEFAULT_RULES, compute_dtype).values())]


def _indices(sharding: NamedSharding, shape) -> List:
    return sharding.indices(tuple(shape))


def _slice_bytes(cfg: ModelConfig, mesh, rules: LogicalRules,
                 compute_dtype: Optional[torch.dtype], batch: int,
                 cast_shards: bool = False) -> List[Dict]:
    """For each position, the bytes of each block's slice that the
    block-wise gather copies onto it (``parallel/tp.BlockSource``), by
    block (a sub-layer of the stacked blocks, or a top-level subtree), in
    the compute dtype where the compute copy narrows the leaf: a slice
    that is its own shard, in its dtype, is a view and costs nothing.
    ``cast_shards``: the gather reads shards already cast (a train step's
    compute copy), so its own shard is a view whatever the master's
    dtype. A position outside every row's group of a batch of ``batch``
    copies nothing."""
    shapes, specs = param_specs(cfg, mesh, rules, compute_dtype)
    out = [{} for _ in range(_mesh_size(mesh))]
    groups = tp.groups(mesh, rules, batch)
    size = len(groups[0])
    a_log = tp.a_log_spec(specs)
    ssm_heads = a_log is not None and tp.ssm_split(
        cfg, tuple(a_log)[1:], size)
    for path, leaf in tp.walk(shapes):
        stacked = path[0] in tp.STACKED
        key = path[:2] if path[0] == "blocks" else path[:1]
        spec = tuple(_spec_at(specs, path)) + (None,) * leaf.ndim
        shape, spec = ((tuple(leaf.shape[1:]), spec[1:leaf.ndim]) if stacked
                       else (tuple(leaf.shape), spec[:leaf.ndim]))
        item = (_dtype_size(cfg.adtype) if _casts(leaf, cfg.adtype)
                else leaf.element_size())
        own = _indices(NamedSharding(mesh, spec), shape)
        for g in groups:
            for rank, p in enumerate(g):
                region = tp.leaf_region(cfg, path, shape, spec, rank,
                                        size, ssm_heads)
                want = [[(0, d)] if r is None else list(r)
                        for r, d in zip(region, shape)]
                view = (cast_shards or item == leaf.element_size()) and all(
                    len(w) == 1 and w[0] == (s.start, s.stop)
                    for w, s in zip(want, own[p]))
                if not view:
                    out[p][key] = out[p].get(key, 0) + item * int(np.prod(
                        [sum(b - a for a, b in w) for w in want]))
    return out


def train_held_keys(cfg: ModelConfig):
    """The slices a train step's forward keeps for its backward besides
    its activations: the final norm's and the unembedding table's (the
    CE's chunks read the table again in the backward), and whisper's
    encoder norm (every decoder layer reads its output)."""
    if cfg.is_encdec:
        return {("enc_ln",), ("dec_ln",), ("embedding",)}
    return {("final_norm",),
            ("embedding",) if cfg.tie_embeddings else ("unembedding",)}


def serving_bytes(cfg: ModelConfig, mesh, rules: LogicalRules,
                  compute_dtype: Optional[torch.dtype] = None,
                  cache: Optional[Tuple[int, int, int]] = None
                  ) -> Dict[str, List[int]]:
    """Each mesh position's serving bytes, by term: ``shards`` (its param
    shards as ``init_params(mesh=, compute_dtype=)`` stores them),
    ``block`` (the largest block's slice that the block-wise gather copies
    onto it while the block runs: :func:`_slice_bytes`) and ``cache``
    (its rank's shard of its row's cache, as ``cache_specs`` places it:
    ``tp.cache_layout``, with ``cache`` = (batch, capacity, enc_len)).
    A position outside every row's group (the batch does not
    split over 'data') computes nothing: shards only. ``mesh`` needs only
    ``shape``."""
    rules = LogicalRules(rules.rules)
    n = _mesh_size(mesh)
    batch = n if cache is None else cache[0]
    out = {"shards": shard_param_bytes(cfg, mesh, rules, compute_dtype),
           "block": [max(b.values(), default=0) for b in _slice_bytes(
               cfg, mesh, rules, compute_dtype, batch)],
           "cache": [0] * n}
    if cache is not None:
        groups = tp.groups(mesh, rules, batch)
        batch, capacity, enc_len = cache
        shapes, layout = _rank_cache_plan(cfg, mesh, rules, batch,
                                          len(groups), capacity, enc_len)
        size = len(groups[0])
        nbytes = sum(int(np.prod(tp.local_cache_shape(
            cfg, leaf.shape, _spec_at(layout, path), size)))
            * leaf.element_size() for path, leaf in tp.walk(shapes))
        for g in groups:
            for p in g:
                out["cache"][p] = nbytes
    return out


def _rank_cache_plan(cfg: ModelConfig, mesh, rules: LogicalRules,
                     batch: int, n_rows: int, capacity: int, enc_len: int):
    """(a row's one-device cache as a meta tree, each leaf's layout on
    the row's group) for a batch of ``batch`` examples in ``n_rows`` rows:
    the layout read from ``cache_specs`` (``tp.cache_layout``)."""
    rules = LogicalRules(rules.rules)
    _, cspecs = cache_specs(cfg, mesh, rules, batch, capacity, enc_len)
    _, pspecs = param_specs(cfg, mesh, rules)
    size = len(tp.groups(mesh, rules, batch)[0])
    return (abstract_cache(cfg, batch // n_rows, capacity, enc_len),
            tp.cache_layout(cfg, cspecs, pspecs, size))


def _spec_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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
                      train_cfg: Optional[TrainConfig] = None, *,
                      mesh=None, rules: Optional[LogicalRules] = None):
    """Bytes that training ``cfg`` holds besides its activations, from a
    meta-device init: the params, their gradients and Adam's ``mu`` and
    ``nu`` (16 bytes a parameter in f32), the error feedback with
    compression (4 more) and the compute copy the step casts. With a mesh
    of more than one device: a list, each position's bytes
    (:func:`train_bytes` summed)."""
    tc = train_cfg or TrainConfig()
    per = 4 + (tc.compression is not None)
    if _sharded_mesh(mesh):
        return [sum(t) for t in zip(*train_bytes(
            cfg, tc, mesh=mesh, rules=rules).values())]
    tree = _init_tree(cfg, KeyGen(0, "meta"))
    need = per * tree_bytes(tree)
    if tc.cast_params_once and cfg.adtype != torch.float32:
        item = torch.empty((), dtype=cfg.adtype).element_size()
        need += sum(a.numel() * item for a in tree_leaves(tree)
                    if a.dtype == torch.float32 and a.ndim >= 2)
    return int(need)


def train_bytes(cfg: ModelConfig, train_cfg: Optional[TrainConfig] = None,
                *, mesh, rules: Optional[LogicalRules] = None
                ) -> Dict[str, List[int]]:
    """Each mesh position's train bytes besides its activations, by term:
    ``state`` (its f32 param shards with their gradient, ``mu`` and ``nu``:
    16 bytes a parameter, 20 with compression's error feedback), ``cast``
    (the compute copy of its shards, cast at the step's start), ``held``
    (the slices the forward keeps for the backward: the final norm's and
    the unembedding's, :func:`train_held_keys`), ``block`` (the largest
    other block's slice the block-wise gather copies onto it,
    :func:`_slice_bytes`) and ``block_grad`` (that slice's gradient while
    the backward holds it: the same bytes). There is no whole copy.
    ``mesh`` needs only ``shape``."""
    tc = train_cfg or TrainConfig()
    rules = LogicalRules((rules or DEFAULT_RULES).rules)
    per = 4 + (tc.compression is not None)
    held_keys = train_held_keys(cfg)
    slices = _slice_bytes(cfg, mesh, rules, None, _mesh_size(mesh),
                          cast_shards=tc.cast_params_once)
    block = [max((n for k, n in b.items() if k not in held_keys),
                 default=0) for b in slices]
    return {"state": _position_bytes(cfg, mesh, rules, per, None, cast=False),
            "cast": _position_bytes(cfg, mesh, rules, 0, None,
                                    cast=tc.cast_params_once),
            "held": [sum(b.get(k, 0) for k in held_keys) for b in slices],
            "block": block, "block_grad": list(block)}


def check_fits(cfg: ModelConfig, device: DeviceLike = None,
               compute_dtype: Optional[torch.dtype] = None,
               train_cfg: Optional[TrainConfig] = None, *, mesh=None,
               rules: Optional[LogicalRules] = None,
               device_bytes: Optional[int] = None) -> None:
    """Raise ``MemoryError`` when the params (with ``train_cfg``: the
    train state, ``train_state_bytes``) would not fit in the memory free
    on the CUDA ``device`` (other devices are not checked). With a mesh of
    more than one device, each device's positions add up and are held
    against its free memory, or against ``device_bytes`` when given (then
    CPUs count too). A stand-in mesh (``mesh.shape`` only) plans devices
    this process does not have: each position its own device of
    ``device_bytes``."""
    if _sharded_mesh(mesh):
        need = (train_state_bytes(cfg, train_cfg, mesh=mesh, rules=rules)
                if train_cfg is not None else
                param_bytes(cfg, compute_dtype, mesh=mesh, rules=rules))
        devices = getattr(mesh, "devices", None)
        if devices is None:
            if device_bytes is None:
                raise ValueError("a stand-in mesh needs device_bytes")
            devices = [torch.device("meta", p) for p in range(len(need))]
        per_dev: Dict = {}
        for d, b in zip(devices, need):
            per_dev[d] = per_dev.get(d, 0) + b
        for d, b in per_dev.items():
            if device_bytes is None and d.type != "cuda":
                continue
            free = (device_bytes if device_bytes is not None
                    else torch.cuda.mem_get_info(d)[0])
            if b > free:
                what = "train state" if train_cfg is not None else "params"
                held = ("its positions' shards, their compute copy and "
                        "one block's gathered slices with their gradient"
                        if train_cfg is not None else
                        "its positions' shards and one block's gathered "
                        "slices")
                raise MemoryError(
                    f"{cfg.name}: its {what} on mesh {mesh.shape} take "
                    f"{b / 1e9:.1f} GB on {d} ({held}), more than the "
                    f"{free / 1e9:.1f} GB free there")
        return
    device = torch.device(device) if device is not None else \
        resolve_device(None)
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
            f"on {device}; one device cannot hold it: shard it over a "
            "mesh (init_params(mesh=))")


# ------------------------------------------------------------------ params
def init_params(cfg: ModelConfig, seed: int = 0, mesh=None,
                rules: Optional[LogicalRules] = None, *,
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
    anything is drawn. On a mesh of more than one device: a tree of
    ``Sharded`` leaves placed by ``param_specs(cfg, mesh, rules)``, each
    shard drawn on its device, equal to the one-device draw sliced."""
    if _sharded_mesh(mesh):
        rules = rules or DEFAULT_RULES
        check_fits(cfg, compute_dtype=compute_dtype, train_cfg=train_cfg,
                   mesh=mesh, rules=rules)
        _, specs = param_specs(cfg, mesh, rules, compute_dtype)
        lazy = _init_tree(cfg, KeyGen(seed, mesh.devices[0], compute_dtype,
                                      lazy=True))
        return sh.shard_tree(lazy, specs_to_shardings(specs, mesh))
    mesh_dev = _mesh_device(mesh)
    dev = resolve_device(mesh_dev if mesh_dev is not None else device)
    check_fits(cfg, dev, compute_dtype, train_cfg)
    return _init_tree(cfg, KeyGen(seed, dev, compute_dtype))


def cast_params_for_compute(params, adtype: torch.dtype):
    """The compute copy of the f32 master params: every f32 leaf of two or
    more dimensions cast to ``adtype`` (a sharded leaf shard by shard, on
    its devices), the rest as they are."""
    def cast(p):
        if p.dtype != torch.float32 or p.ndim < 2:
            return p
        return sh.map_sharded(lambda t: t.to(adtype), p)
    return tree_map(cast, params)


# --------------------------------------------------------------- training
def make_train_state(params, compression: bool = False) -> Dict:
    """``{"params", "opt"}`` (and zero error feedback ``"efb"`` with
    ``compression``) over ``params``, which the step updates in place;
    sharded params give sharded moments and feedback."""
    state = {"params": params, "opt": optim.adam_init(params)}
    if compression:
        state["efb"] = tree_map(optim.zeros_like, params)
    return state


def _loss_for(cfg: ModelConfig) -> Callable:
    return encdec.loss_fn if cfg.is_encdec else lm.loss_fn


def _batch_size(batch: Dict) -> int:
    k, v = next(iter(batch.items()))
    return v.shape[loop._batch_axis(k, v)]


def split_batch(batch: Dict, devices: Sequence[torch.device]) -> List[Dict]:
    """``batch`` in ``len(devices)`` equal contiguous rows along each
    leaf's example axis, row ``r`` on ``devices[r]``."""
    n = len(devices)
    size = _batch_size(batch)
    if size % n:
        raise ValueError(f"a batch of {size} does not split into {n} rows")
    per = size // n
    out = []
    for r, dev in enumerate(devices):
        out.append({k: v.narrow(loop._batch_axis(k, v), r * per, per).to(dev)
                    for k, v in batch.items()})
    return out


def _flatten(tree) -> Tuple[List, Callable]:
    """(the leaves in sorted-key order, a function rebuilding the tree
    from a list of new leaves)."""
    leaves = optim.tree_leaves(tree)
    ids = {id(l): i for i, l in enumerate(leaves)}

    def rebuild(new):
        return optim.tree_map(lambda l: new[ids[id(l)]], tree)
    return leaves, rebuild


def _moe_row_losses(cfg: ModelConfig, ctx: sh.RowContext, auxes: List,
                    devices: Sequence[torch.device]):
    """Each row's loss for the global MoE objective, and the global
    ``moe_aux_loss``: the load-balance loss of the whole batch is
    ``E sum_e density_e router_mean_e`` per layer, with the density (no
    gradient) from every row's counts and the router mean a sum over the
    rows, so row ``r``'s share is ``E sum_e density_e router_sum_re / N``;
    row ``r``'s loss is its CE plus ``0.01 R`` times its share over the
    layers, so the rows' mean is the JAX loss."""
    m = cfg.moe
    n_rows = len(devices)
    home = devices[0]
    shares = [torch.zeros((), dtype=torch.float32, device=d)
              for d in devices]
    for layer in dict.fromkeys(k for k, _ in ctx.stats):
        st = [ctx.stats[(layer, r)] for r in range(n_rows)]
        total = sum(s["tokens"] for s in st)
        counts = sum(s["counts"].to(home) for s in st)
        density = counts.float() / (total * m.top_k)
        for r, d in enumerate(devices):
            shares[r] = shares[r] + m.n_experts * torch.sum(
                density.to(d) * st[r]["router_sum"]) / total
    scale = 0.01 * n_rows / max(cfg.n_layers, 1)
    losses = [aux["ce"] + scale * a for aux, a in zip(auxes, shares)]
    aux_loss = sum(a.detach().to(home) for a in shares)
    return losses, aux_loss


def _loss_tp(cfg: ModelConfig, mesh, rules: LogicalRules, src, batch,
             sharder):
    """One row's loss on its group (``models/lm.loss_fn_tp``), its
    streams split along the sequence where the rules and the length
    allow (``parallel/tp.seq_parallel``)."""
    key = "tokens" if "tokens" in batch else "embeddings"
    b, s = batch[key].shape[:2]
    n = src.group.size
    sp = tp.seq_parallel(mesh, rules, b, s, n)
    if cfg.is_encdec:
        se = batch["enc_embeddings"].shape[1]
        return encdec.loss_fn_tp(src, cfg, batch, sp, tp.seq_parallel(
            mesh, rules, b, se, n), sharder=sharder)
    return lm.loss_fn_tp(src, cfg, batch, sp, sharder=sharder)


def _compute_shard(master: torch.Tensor, leaf, cfg: ModelConfig,
                   tc: TrainConfig) -> torch.Tensor:
    """A master shard's compute copy (cast where ``cast_params_once``
    narrows the leaf), a leaf of autograd: the block gathers read it and
    send its gradient to the step's buffers."""
    t = master.detach()
    if tc.cast_params_once and _casts(leaf, cfg.adtype):
        t = t.to(cfg.adtype)
    return t.requires_grad_(True)


def _sharded_value_and_grad(cfg: ModelConfig, mesh, rules: LogicalRules,
                            tc: TrainConfig) -> Callable:
    """``(params, batch) -> ((loss, aux), grads)`` of one (micro-)batch on
    a mesh (the module docstring): the batch split into rows, each master
    shard cast once on its device, each row's loss on its tensor-parallel
    group reading one block's slices at a time, the gradients added in
    f32 into buffers laid out as the params and divided by the number of
    rows. Without a MoE each row's backward runs right after its forward,
    so no row's activations outlive it; with one, the load-balance
    density needs every row's counts first, so the forwards all run
    before the backwards. The gradients are ``Sharded`` leaves laid out
    as the params."""
    sharder = ActivationSharder()

    def grad_fn(params, batch):
        groups = [_group(mesh, g)
                  for g in tp.groups(mesh, rules, _batch_size(batch))]
        devices = [g.devices[0] for g in groups]
        rows = split_batch(batch, devices)
        n_rows = len(groups)
        home = devices[0]
        leaves, rebuild = _flatten(params)
        grads = [Sharded(l.sharding, l.shape,
                         [torch.zeros_like(m) for m in l.shards])
                 for l in leaves]
        compute = rebuild([Sharded(l.sharding, l.shape, [
            _compute_shard(m, l, cfg, tc) for m in l.shards])
            for l in leaves])
        ctx = sh.RowContext(n_rows)
        losses, auxes = [], []
        with torch.enable_grad():
            for r, (group, piece) in enumerate(zip(groups, rows)):
                src = tp.BlockSource(compute, cfg, group, cfg.adtype,
                                     rebuild(grads))
                loss, aux = _loss_tp(cfg, mesh, rules, src, piece,
                                     sharder.for_row(ctx, r))
                if cfg.moe is None:
                    loss.backward()
                    loss = loss.detach()
                    aux = {k: v.detach() for k, v in aux.items()}
                losses.append(loss)
                auxes.append(aux)
            # a device divisor: a CUDA divide by a Python number multiplies
            # by its reciprocal (data_parallel_grad_fn divides so too)
            k = {d: torch.full((), float(n_rows), device=d)
                 for d in dict.fromkeys([home] + [m.device for l in leaves
                                                  for m in l.shards])}
            out_aux = {n: sum(a[n].detach().to(home) for a in auxes) / k[home]
                       for n, v in auxes[0].items()
                       if isinstance(v, torch.Tensor) and v.ndim == 0}
            if cfg.moe is not None:
                losses, out_aux["moe_aux_loss"] = _moe_row_losses(
                    cfg, ctx, auxes, devices)
                for loss in losses:
                    loss.backward()
        del ctx, auxes, compute
        total = sum(l.detach().to(home) for l in losses) / k[home]
        for g in grads:
            for t in g.shards:
                t.div_(k[t.device])
        return (total, out_aux), rebuild(grads)

    return grad_fn


def make_value_and_grad(cfg: ModelConfig, mesh=None,
                        rules: Optional[LogicalRules] = None,
                        train_cfg: Optional[TrainConfig] = None
                        ) -> Callable:
    """``(params, batch) -> ((loss, aux), grads)``: the train step's loss
    and gradients before compression and Adam (the module docstring), on
    one device or, for ``init_params(mesh=)``'s params, on a mesh (the
    gradients then ``Sharded`` as the params). With ``num_microbatches >
    1``: the micro-batches' sums, divided (``train/loop.
    accumulated_value_and_grad``), aux the last micro-batch's."""
    tc = train_cfg or TrainConfig()
    if _sharded_mesh(mesh):
        grad_fn = _sharded_value_and_grad(cfg, mesh, rules or DEFAULT_RULES,
                                          tc)
    else:
        loss_fn = _loss_for(cfg)

        def loss_of(p, batch):
            if tc.cast_params_once:
                p = cast_params_for_compute(p, cfg.adtype)
            return loss_fn(p, cfg, batch)

        def grad_fn(params, batch):
            return loop.value_and_grad(loss_of, params, batch, has_aux=True)
    nmb = tc.num_microbatches
    if nmb == 1:
        return grad_fn

    def accumulated(params, batch):
        return loop.accumulated_value_and_grad(
            None, params, batch, nmb, grad_fn=grad_fn, has_aux=True)
    return accumulated


def build_train_step(cfg: ModelConfig, mesh=None,
                     rules: Optional[LogicalRules] = None,
                     train_cfg: Optional[TrainConfig] = None,
                     batch_shardings=None, example_batch=None
                     ) -> Tuple[Callable, Dict]:
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients (:func:`make_value_and_grad`), compression, Adam (the module
    docstring). ``batch`` holds ``tokens`` (B, S) int (and ``labels``;
    qwen2-vl's stub ``embeddings`` and (3, B, S) ``positions``; whisper's
    ``enc_embeddings``), on the state's device or, on a mesh, anywhere
    (each row is moved to its device). Returns (step, info); on a mesh of
    more than one device info holds the JAX step's ``state``
    (NamedShardings), ``batch`` (from ``example_batch``'s specs, or
    ``batch_shardings``) and ``state_specs``; on one device it is empty.
    The metrics stay on the device (``lr`` is a host number)."""
    tc = train_cfg or TrainConfig()
    info: Dict = {}
    if _sharded_mesh(mesh):
        rules = rules or DEFAULT_RULES
        _, pspecs = param_specs(cfg, mesh, rules)
        state_specs = train_state_specs(
            pspecs, compression=tc.compression is not None)
        if example_batch is not None and batch_shardings is None:
            bspecs = batch_specs(cfg, example_batch["batch"], mesh, rules)
            batch_shardings = specs_to_shardings(bspecs, mesh)
        info = {"state": specs_to_shardings(state_specs, mesh),
                "batch": batch_shardings, "state_specs": state_specs}
    value_and_grad = make_value_and_grad(cfg, mesh, rules, tc)

    # repro: hot-path the step stays async: the engine's chunk read is its sync
    def step(state, batch):
        params = state["params"]
        (loss, aux), grads = value_and_grad(params, batch)
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

    return step, info


def make_train_step(cfg: ModelConfig, mesh=None,
                    rules: Optional[LogicalRules] = None,
                    train_cfg: Optional[TrainConfig] = None,
                    batch_shardings=None, example_batch=None
                    ) -> Tuple[Callable, Dict]:
    """The one-step form of :func:`build_train_step` (the JAX function
    jits and donates; the eager step already updates the state in
    place)."""
    return build_train_step(cfg, mesh, rules, train_cfg=train_cfg,
                            batch_shardings=batch_shardings,
                            example_batch=example_batch)


def batch_row_devices(mesh, rules: Optional[LogicalRules],
                      batch: int) -> List[torch.device]:
    """The device of each row of a sharded step's batch of ``batch``
    examples (one, the mesh's first, without a mesh of more than one
    device)."""
    if not _sharded_mesh(mesh):
        return [_mesh_device(mesh)] if mesh is not None else []
    return _row_devices(mesh, rules or DEFAULT_RULES, batch)


# the cards of one node, joined by NVLink (H100 SXM: 8), in consecutive
# mesh positions
NODE_CARDS = 8
# the kinds of ``parallel/collectives.tally``
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _link(group) -> str:
    return ("nvlink" if len({q // NODE_CARDS for q in group}) == 1
            else "ib")


def step_collective_bytes(cfg: ModelConfig, mesh,
                          rules: Optional[LogicalRules] = None,
                          batch: int = 1, *, train: bool = True,
                          step: str = "decode", seq: int = 1,
                          capacity: Optional[int] = None,
                          enc_len: int = 0) -> List[Dict]:
    """The bytes the port's sharded step moves into each mesh position: a
    list over positions of ``{"all-gather": bytes a step, "all-reduce":
    ..., "reduce-scatter": ..., "all-to-all": ..., "links": {kind:
    "nvlink" | "ib"}}``.

    Both steps run each row on its tensor-parallel group, and what their
    collectives and block-wise gathers move (``parallel/collectives.
    tally``) is counted in one run of the first row's first rank on meta
    tensors and given to every position of every row's group (their
    shares are alike); a position outside every group moves nothing.
    Training (``seq`` tokens a row; :func:`meta_train_step`): the group's
    all-reduces, all-gathers and reduce-scatters of the forward, the
    recomputed forward and the backward, the block gathers over 'data'
    (twice per block under full remat) and their backward's
    reduce-scatters, which hand each slice's gradient to the positions
    that hold it (counted as the bytes the rank sends back, which the
    layout's symmetry makes the bytes each position receives). Serving
    (``train=False``; ``step`` "prefill" of ``seq`` tokens a row, or
    "decode" at ``capacity``; :func:`meta_serving_step`: the group's sums
    and gathers, a sequence-split cache's all-to-alls, those of prefill
    from the KV-head ranks to the position ranks, and those of decode's
    partial softmax to the ranks of its heads).

    A collective's group is the positions that send or receive it; it
    crosses NVLink when they all lie in one node of ``NODE_CARDS``
    consecutive positions in row-major order, InfiniBand otherwise.
    ``mesh`` needs only ``shape``."""
    rules = rules or DEFAULT_RULES
    n = _mesh_size(mesh)
    out = [{**dict.fromkeys(COLL_KINDS, 0), "links": {}}
           for _ in range(n)]
    if not _sharded_mesh(mesh):
        return out
    groups = tp.groups(mesh, rules, batch)
    p = groups[0][0]
    inputs = _meta_inputs(cfg, "train" if train else step,
                          batch // len(groups), seq, enc_len)
    if train:
        run, _ = meta_train_step(cfg, mesh, rules, inputs, len(groups), p)
    else:
        run, _ = meta_serving_step(cfg, mesh, rules, step, inputs,
                                   len(groups), capacity or seq, enc_len, p)
    with coll.tally() as t:
        run()
    for g in groups:
        for q in g:
            out[q] = _tally_entry(t, p)
    return out


def _tally_entry(t: Dict, p: int) -> Dict:
    """Position ``p``'s :func:`step_collective_bytes` entry from a
    ``parallel/collectives.tally``."""
    out = {**dict.fromkeys(COLL_KINDS, 0), "links": {}}
    for kind in COLL_KINDS:
        if t.get(kind, {}).get(p):
            out[kind] = t[kind][p]
            out["links"][kind] = ("ib" if any(
                _link(sp) == "ib" for sp in t["spans"][kind]) else "nvlink")
    return out


def _meta_inputs(cfg: ModelConfig, step: str, batch: int, seq: int,
                 enc_len: int) -> Dict:
    """A row's inputs as meta tensors (``configs/registry.input_specs``'
    row): its tokens (the vision stub's patch embeddings and M-RoPE
    positions to a prefill, and labels to a train step; whisper's frame
    embeddings besides)."""
    meta = torch.device("meta")
    full = step in ("prefill", "train")
    if cfg.frontend == "vision" and full:
        out = {"embeddings": torch.empty((batch, seq, cfg.d_model),
                                         dtype=cfg.adtype, device=meta),
               "positions": torch.empty((3, batch, seq), dtype=torch.int32,
                                        device=meta)}
        if step == "train":
            out["labels"] = torch.empty((batch, seq), dtype=torch.int32,
                                        device=meta)
        return out
    out = {"tokens": torch.empty((batch, seq if full else 1),
                                 dtype=torch.int32, device=meta)}
    if cfg.is_encdec and full:
        out["enc_embeddings"] = torch.empty(
            (batch, enc_len or seq, cfg.d_model), dtype=cfg.adtype,
            device=meta)
    return out


def meta_serving_step(cfg: ModelConfig, mesh, rules: LogicalRules,
                      step: str, inputs: Dict, n_rows: int, capacity: int,
                      enc_len: int, position: int, whole_group: bool = False):
    """(run, args): one serving step of the rank at mesh position
    ``position`` (a rank of a row's tensor-parallel group) on meta
    tensors: ``run()`` runs it, its group's other ranks stood in for
    (``parallel/tp``: their shards meta, their collective terms empty
    buffers), or with ``whole_group`` run too, as a process that drives
    the mesh runs them; ``args`` are the state of the ranks run, ``[their
    param shards, their caches]``, which a count holds as arguments
    besides ``inputs`` (the row's: ``tokens`` (B, S), prefill's other
    batch leaves, or decode's (B, 1) tokens). The row is the group's; the
    MoE sees it as row 0 of ``n_rows`` (the global token groups)."""
    rules = LogicalRules(rules.rules)
    shapes, specs = param_specs(cfg, mesh, rules, cfg.adtype)
    params = tp.meta_params(shapes, specs, mesh)
    row_batch = _batch_size(inputs)
    groups = tp.groups(mesh, rules, row_batch * n_rows)
    g = next(g for g in groups if position in g)
    ranks = None if whole_group else [g.index(position)]
    group = coll.Group([torch.device("meta")] * len(g), g, ranks)
    shapes, layout = _rank_cache_plan(cfg, mesh, rules, row_batch * n_rows,
                                      n_rows, capacity, enc_len)
    caches = [tp.make_rank_cache(cfg, shapes, layout, group.size, "meta")
              for _ in group.ranks]
    kv_seq = tp.kv_seq(layout)
    src = tp.BlockSource(params, cfg, group, cfg.adtype)
    sharder = ActivationSharder().for_row(sh.RowContext(n_rows), 0)
    model = encdec if cfg.is_encdec else lm
    own = [l.shards[g[r]] for r in group.ranks
           for l in optim.tree_leaves(params)]

    def run():
        if step == "prefill":
            return _prefill_tp(cfg, mesh, rules, src, inputs, caches,
                               sharder, kv_seq)
        return model.decode_step_tp(src, cfg, inputs["tokens"],
                                    capacity - 1, caches, sharder=sharder,
                                    kv_seq=kv_seq)
    return run, [own, caches]


def meta_train_step(cfg: ModelConfig, mesh, rules: LogicalRules,
                    inputs: Dict, n_rows: int, position: int,
                    train_cfg: Optional[TrainConfig] = None):
    """(run, args): one train step of the rank at mesh position
    ``position`` (a rank of a row's tensor-parallel group) on meta
    tensors, as :func:`meta_serving_step` serves one: the cast of its
    master shards, its row's forward and backward (``inputs``: the row's
    batch) with the block-wise gathers, the gradient added into its
    buffers and divided by the rows, and Adam on its shards. Its group's
    other ranks are stood in for (their shards, compute copies and
    gradient buffers meta tensors made before the count). ``args`` are
    its state: [its f32 master shards, Adam's ``mu``, ``nu``], which a
    count holds as arguments; the gradient buffers and the cast are the step's own. The
    MoE sees the row as row 0 of ``n_rows`` and forms its load-balance
    term from the row's counts."""
    rules = LogicalRules(rules.rules)
    tc = train_cfg or TrainConfig()
    shapes, specs = param_specs(cfg, mesh, rules)
    params = tp.meta_params(shapes, specs, mesh)
    groups = tp.groups(mesh, rules, _batch_size(inputs) * n_rows)
    g = next(g for g in groups if position in g)
    group = coll.Group([torch.device("meta")] * len(g), g,
                       [g.index(position)])
    leaves, rebuild = _flatten(params)
    own = [l.shards[position] for l in leaves]
    # the other positions' compute copies and gradient buffers
    stand = [(torch.empty_like(m, dtype=cfg.adtype if tc.cast_params_once
                               and _casts(l, cfg.adtype) else m.dtype)
              .requires_grad_(), torch.empty_like(m))
             for l, m in zip(leaves, own)]
    mu = [torch.empty_like(m) for m in own]
    nu = [torch.empty_like(m) for m in own]

    def run():
        comp, bufs = [], []
        for l, m, (c0, g0) in zip(leaves, own, stand):
            cs, gs = [c0] * len(l.shards), [g0] * len(l.shards)
            cs[position] = _compute_shard(m, l, cfg, tc)
            gs[position] = torch.zeros_like(m)
            comp.append(Sharded(l.sharding, l.shape, cs))
            bufs.append(Sharded(l.sharding, l.shape, gs))
        src = tp.BlockSource(rebuild(comp), cfg, group, cfg.adtype,
                             rebuild(bufs))
        sharder = ActivationSharder().for_row(sh.RowContext(n_rows), 0)
        with torch.enable_grad():
            loss, _ = _loss_tp(cfg, mesh, rules, src, inputs, sharder)
            loss.backward()
        del loss, src, comp
        grads = [b.shards[position].div_(float(n_rows)) for b in bufs]
        return optim.adam_update(
            dict(enumerate(grads)), optim.AdamState(
                step=0, mu=dict(enumerate(mu)), nu=dict(enumerate(nu))),
            dict(enumerate(own)), tc.optimizer)
    return run, [own, mu, nu]


# ---------------------------------------------------------------- serving
def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               enc_len: int = 0, shardings=None, *,
               device: DeviceLike = None,
               rules: Optional[LogicalRules] = None):
    """Properly initialized cache (ring slot positions -1, not zeros) on
    the device (CUDA unless named). With ``shardings`` (``cache_specs``'s,
    as NamedShardings): a ``parallel/tp.RowCache``, for each row of the
    batch split of the mesh they name, each rank of the row's
    tensor-parallel group the shard its sharding gives its position
    (``tp.cache_layout``; ``rules``: the params' rules, which say how
    the SSM splits)."""
    if shardings is not None:
        leaves = tree_leaves(shardings)
        mesh = leaves[0].mesh
        entry = next(tuple(l.spec) for l in leaves if len(l.spec) >= 3)[1]
        groups = [_group(mesh, g) for g in tp.groups_for(mesh, entry)]
        size = groups[0].size
        _, pspecs = param_specs(cfg, mesh,
                                LogicalRules((rules or DEFAULT_RULES).rules))
        layout = tp.cache_layout(
            cfg, tree_map(lambda l: l.spec, shardings), pspecs, size)
        shapes = abstract_cache(cfg, batch // len(groups), capacity,
                                enc_len)
        rows = [[tp.make_rank_cache(cfg, shapes, layout, size, d)
                 for d in g.devices] for g in groups]
        return RowCache(cfg, rows, groups, _cache_axes(cfg), layout)
    dev = resolve_device(device)
    if cfg.is_encdec:
        return encdec.init_dec_cache(cfg, batch, capacity,
                                     enc_len or capacity, device=dev)
    return lm.init_cache(cfg, batch, capacity, device=dev)


def _group(mesh, positions: Sequence[int], ranks=None) -> coll.Group:
    devices = getattr(mesh, "devices", None)
    return coll.Group([torch.device("meta") if devices is None
                       else devices[p] for p in positions], positions,
                      ranks)


def tok_sharding(mesh, batch_size: int) -> NamedSharding:
    """The JAX decode step's token placement: the batch over
    ('pod', 'data') (or 'data') when it divides, else replicated."""
    n = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    data = ("pod", "data") if "pod" in mesh.shape else "data"
    return NamedSharding(mesh, P(data, None) if batch_size % n == 0
                         else P())


def _mesh_serving_info(cfg, mesh, rules, batch_size, capacity, enc_len):
    _, pspecs = param_specs(cfg, mesh, rules)
    _, cspecs = cache_specs(cfg, mesh, rules, batch_size, capacity, enc_len)
    return {"params": specs_to_shardings(pspecs, mesh),
            "cache": specs_to_shardings(cspecs, mesh),
            "cache_shapes": _cache_shapes(cfg, batch_size, capacity,
                                          enc_len)}


def _cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                  enc_len: int) -> Dict:
    return tree_map(lambda a: (tuple(a.shape), a.dtype),
                    abstract_cache(cfg, batch, capacity, enc_len))


def _serve_rows(cfg: ModelConfig, mesh, rules: LogicalRules, params,
                cache: RowCache, run):
    """``run(source, row inputs index, caches, sharder, kv_seq)`` for each
    row of
    ``cache`` in row order, each on its group's block source; the rows'
    logits joined on the first row's device (the MoE's token groups are
    the whole batch's: ``parallel/sharded.RowContext``)."""
    ctx = sh.RowContext(len(cache.groups))
    sharder = ActivationSharder()
    logits = []
    for r, (group, caches) in enumerate(zip(cache.groups, cache.rows)):
        src = tp.BlockSource(params, cfg, group, cfg.adtype)
        out = run(src, r, caches, sharder.for_row(ctx, r), cache.kv_seq)
        logits.append(out.to(cache.devices[0]))
    return torch.cat(logits)


def _prefill_tp(cfg: ModelConfig, mesh, rules: LogicalRules, src, batch,
                caches, sharder, kv_seq):
    """One row's prefill on its group (``models/lm.prefill_tp``)."""
    model = encdec if cfg.is_encdec else lm
    key = "tokens" if "tokens" in batch else "embeddings"
    b, s = batch[key].shape[:2]
    n = src.group.size
    sp = tp.seq_parallel(mesh, rules, b, s, n)
    if cfg.is_encdec:
        se = batch["enc_embeddings"].shape[1]
        sp_enc = tp.seq_parallel(mesh, rules, b, se, n)
        return model.prefill_tp(src, cfg, batch, caches, sp, sp_enc,
                                sharder=sharder, kv_seq=kv_seq)
    return model.prefill_tp(src, cfg, batch, caches, sp, sharder=sharder,
                            kv_seq=kv_seq)


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      rules: Optional[LogicalRules] = None,
                      batch_shardings=None, example_batch=None,
                      capacity: Optional[int] = None, batch_size: int = 1,
                      enc_len: int = 0) -> Tuple[Callable, Dict]:
    """``prefill(params, batch, cache) -> (last-token logits (B, V),
    cache)``, with the params cast for compute at each call (a leaf
    already cast passes through). Returns (step, info) where info holds
    ``cache_shapes`` (shape, dtype per leaf) as the JAX info holds its
    cache's ShapeDtypeStructs. On a mesh of more than one device the
    params are ``init_params(mesh=)``'s, the cache ``make_cache(
    shardings=info["cache"])``'s, each row runs on its tensor-parallel
    group (the module docstring), and info holds the JAX ``params`` and
    ``cache`` shardings too."""
    model = encdec if cfg.is_encdec else lm
    if _sharded_mesh(mesh):
        rules = rules or DEFAULT_RULES

        def sharded_step(params, batch, cache: RowCache):
            rows = split_batch(batch, cache.devices)
            return _serve_rows(cfg, mesh, rules, params, cache, lambda src, r,
                               caches, sharder, kv_seq: _prefill_tp(
                                   cfg, mesh, rules, src, rows[r], caches,
                                   sharder, kv_seq)), cache

        return sharded_step, _mesh_serving_info(
            cfg, mesh, rules, batch_size, capacity or 0, enc_len)

    def step(params, batch, cache):
        params = cast_params_for_compute(params, cfg.adtype)
        return model.prefill(params, cfg, batch, cache)

    return step, {"cache_shapes": _cache_shapes(cfg, batch_size,
                                                capacity or 0, enc_len)}


def make_decode_step(cfg: ModelConfig, mesh=None,
                     rules: Optional[LogicalRules] = None,
                     capacity: int = 1024, batch_size: int = 1,
                     enc_len: int = 0) -> Tuple[Callable, Dict]:
    """``decode(params, cache, tokens (B, 1), pos) -> (logits (B, V),
    cache)``; ``pos`` is a host int. On a mesh of more than one device the
    tokens are split as the cache's rows are, each row runs on its
    tensor-parallel group, and info holds the JAX ``tok_sharding``
    besides the params and cache shardings."""
    model = encdec if cfg.is_encdec else lm
    if _sharded_mesh(mesh):
        rules = rules or DEFAULT_RULES

        def sharded_step(params, cache: RowCache, tokens, pos):
            rows = split_batch({"tokens": tokens}, cache.devices)
            return _serve_rows(cfg, mesh, rules, params, cache, lambda src, r,
                               caches, sharder, kv_seq: model.decode_step_tp(
                                   src, cfg, rows[r]["tokens"], pos, caches,
                                   sharder=sharder, kv_seq=kv_seq)), cache

        info = _mesh_serving_info(cfg, mesh, rules, batch_size, capacity,
                                  enc_len)
        info["tok_sharding"] = tok_sharding(mesh, batch_size)
        return sharded_step, info

    def step(params, cache, tokens, pos):
        params = cast_params_for_compute(params, cfg.adtype)
        return model.decode_step(params, cfg, tokens, pos, cache)

    return step, {"cache_shapes": _cache_shapes(cfg, batch_size, capacity,
                                                enc_len)}
