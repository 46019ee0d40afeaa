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
* **Training splits the batch; the model axis only stores.** A train
  step splits its batch over the mesh axes its batch spec gives the batch
  dim (replicated, one row, when the batch does not divide), into equal
  rows in the spec's order; each row runs on the first device along the
  axes the split does not use (``launch/mesh.axes_devices``). Stated
  difference: the JAX step also splits compute over 'model' (tensor,
  expert and sequence parallelism); here training does not yet (ROADMAP
  A14.5c).
* **Serving splits the batch and computes over 'model'.** Each row of a
  prefill or decode step's batch split runs on its tensor-parallel group,
  the row's positions along 'model' (``parallel/tp.py``): every position
  computes its own heads, ``mlp`` columns, vocab rows, experts and SSM
  heads and the group sums or gathers what GSPMD's collectives would
  (``parallel/collectives.py``); under ``baseline``/``sp`` the prefill's
  stream between blocks is split along the sequence. No device holds a
  whole compute copy: each position gathers its slice of one block at a
  time, whole along 'data' (FSDP by block), and drops it after the block.
* **Training** follows ``cast_params_once``: each f32 master shard is cast
  to ``cfg.adtype`` on its own device, and the compute copy is gathered
  whole onto each row's device by ``sharded.gather_for_compute``, whose
  backward hands each position its slice of the row's gradient. The rows'
  forwards run first, in row order; then each row's backward in row
  order, its gradients added to the sum of the rows before on the owning
  shard's device; the sum is divided by the number of rows, as
  ``train/loop.data_parallel_grad_fn`` does (``make_value_and_grad``
  returns these gradients). With ``num_microbatches`` each micro-batch
  (the JAX step's: a contiguous slice of the global batch) goes through
  all of this in turn, and the micro-batches are summed in order and
  divided (``train/loop.accumulated_value_and_grad``). Compression and Adam run shard-locally; the clip's global norm
  counts each distinct slice once.
* **The MoE layer keeps the global batch's token groups**: a row's
  capacity slots continue the counts of the rows before it, and the
  load-balance loss is formed from every row's partial sums
  (``parallel/sharded.RowContext``), so the sharded step computes the
  function the JAX step computes, not one with per-row groups.
* **Serving caches** (``make_cache(shardings=)``): per row, each rank of
  its group holds its KV heads (or SSM heads) of the row's batch
  (``parallel/tp.RowCache``; stated difference: JAX's ``cache_specs``
  under ``baseline`` puts 'model' on the sequence dim instead). Tokens
  are split as the cache is; ``tok_sharding`` reports JAX's rule.
* **Memory**: ``train_state_bytes(mesh=)`` gives each position's bytes
  when training: its shards, the compute copy of its shards and, once for
  each device that runs a row, the gathered whole compute copy.
  ``param_bytes(mesh=)`` gives them when serving (``serving_bytes``): its
  shards and the largest block's slice the block-wise gather copies onto
  it (``serving_bytes`` adds a cache). ``check_fits(mesh=)`` holds each
  device's sum (positions sharing a card add up) against its free memory
  or ``device_bytes``.
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
                    cast: bool, gathered: bool = True) -> List[int]:
    """Each mesh position's bytes: ``per_param`` bytes for every byte of
    its param shards (params, and for training gradients, moments, error
    feedback), the compute copy of its shards (``cast``) and, with
    ``gathered``, the whole gathered compute copy once per device that
    runs a row (on the first row position there; a stand-in mesh's
    positions are each their own device), as the steps gather it."""
    shapes, specs = param_specs(cfg, mesh, LogicalRules(rules.rules),
                                compute_dtype)
    n = _mesh_size(mesh)
    out = [0] * n
    whole = 0
    for leaf, spec in zip(optim.tree_leaves(shapes),
                          optim.tree_leaves(specs)):
        numel = int(np.prod(NamedSharding(mesh, spec).shard_shape(
            tuple(leaf.shape))))
        item = leaf.element_size()
        narrow = cast and _casts(leaf, cfg.adtype)
        citem = _dtype_size(cfg.adtype) if narrow else item
        for p in range(n):
            out[p] += per_param * numel * item + (numel * citem if narrow
                                                  else 0)
        whole += leaf.numel() * citem
    if gathered:
        devices = getattr(mesh, "devices", None)
        seen = set()
        for p in _row_positions(mesh, rules):
            dev = p if devices is None else devices[p]
            if dev not in seen:
                seen.add(dev)
                out[p] += whole
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
                           compute_dtype, cast=False, gathered=False)


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


def serving_bytes(cfg: ModelConfig, mesh, rules: LogicalRules,
                  compute_dtype: Optional[torch.dtype] = None,
                  cache: Optional[Tuple[int, int, int]] = None
                  ) -> Dict[str, List[int]]:
    """Each mesh position's serving bytes, by term: ``shards`` (its param
    shards as ``init_params(mesh=, compute_dtype=)`` stores them),
    ``block`` (the largest block's slice that the block-wise gather copies
    onto it while the block runs: ``parallel/tp.BlockSource``; a slice
    that is its own shard, in its dtype, is a view and costs nothing) and
    ``cache`` (its rank's cache of its row, with ``cache`` = (batch,
    capacity, enc_len)). A position outside every row's group (the batch
    does not split over 'data') computes nothing: shards only.
    ``mesh`` needs only ``shape``."""
    rules = LogicalRules(rules.rules)
    shapes, specs = param_specs(cfg, mesh, rules, compute_dtype)
    n = _mesh_size(mesh)
    out = {"shards": shard_param_bytes(cfg, mesh, rules, compute_dtype),
           "block": [0] * n, "cache": [0] * n}
    groups = tp.groups(mesh, rules, n if cache is None else cache[0])
    size = len(groups[0])
    a_log = next((sp for path, sp in tp.walk(specs)
                  if path[-2:] == ("ssm", "A_log")), None)
    ssm_heads = a_log is not None and tp.ssm_split(
        cfg, tuple(a_log)[1:], size)
    blocks = {}
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
                view = item == leaf.element_size() and all(
                    len(w) == 1 and w[0] == (s.start, s.stop)
                    for w, s in zip(want, own[p]))
                if not view:
                    nbytes = item * int(np.prod(
                        [sum(b - a for a, b in w) for w in want]))
                    blocks.setdefault(p, {}).setdefault(key, 0)
                    blocks[p][key] += nbytes
    for p, by_key in blocks.items():
        out["block"][p] = max(by_key.values())
    if cache is not None:
        batch, capacity, enc_len = cache
        split = tp.splits(cfg, specs, size)
        per_row = abstract_cache(cfg, batch // len(groups), capacity,
                                 enc_len)
        nbytes = sum(int(np.prod(tp.local_cache_shape(
            cfg, path[-1], leaf.shape, split, size))) * leaf.element_size()
            for path, leaf in tp.walk(per_row))
        for g in groups:
            for p in g:
                out["cache"][p] = nbytes
    return out


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
    of more than one device: a list, each position's bytes of its shards
    and their compute copy, and on a row's device the gathered compute
    copy."""
    tc = train_cfg or TrainConfig()
    per = 4 + (tc.compression is not None)
    if _sharded_mesh(mesh):
        return _position_bytes(cfg, mesh, rules or DEFAULT_RULES, per, None,
                               cast=tc.cast_params_once)
    tree = _init_tree(cfg, KeyGen(0, "meta"))
    need = per * tree_bytes(tree)
    if tc.cast_params_once and cfg.adtype != torch.float32:
        item = torch.empty((), dtype=cfg.adtype).element_size()
        need += sum(a.numel() * item for a in tree_leaves(tree)
                    if a.dtype == torch.float32 and a.ndim >= 2)
    return int(need)


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
                held = ("its positions' shards and the gathered compute "
                        "copy" if train_cfg is not None else
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


def _sharded_value_and_grad(cfg: ModelConfig, mesh, rules: LogicalRules,
                            tc: TrainConfig) -> Callable:
    """``(params, batch) -> ((loss, aux), grads)`` of one (micro-)batch on
    a mesh: the batch split into rows, the compute copy cast per shard and
    gathered once onto each row's device, every row's forward in row
    order, then every row's backward in row order, summed on the owning
    shards' devices and divided by the number of rows. The gradients are
    ``Sharded`` leaves laid out as the params."""
    loss_fn = _loss_for(cfg)
    sharder = ActivationSharder(mesh, rules)

    def grad_fn(params, batch):
        devices = _row_devices(mesh, rules, _batch_size(batch))
        rows = split_batch(batch, devices)
        n_rows = len(devices)
        home = devices[0]
        leaves, rebuild = _flatten(params)
        masters = [[s.detach().requires_grad_(True) for s in leaf.shards]
                   for leaf in leaves]
        ctx = sh.RowContext(n_rows)
        copies: Dict = {}
        losses, auxes = [], []
        with torch.enable_grad():
            compute = [[m.to(cfg.adtype) if tc.cast_params_once
                        and _casts(leaf, cfg.adtype) else m for m in ms]
                       for leaf, ms in zip(leaves, masters)]
            for r, (dev, piece) in enumerate(zip(devices, rows)):
                if dev not in copies:       # one gathered copy per device
                    copies[dev] = rebuild([
                        sh.gather_for_compute(leaf, comp, dev)
                        for leaf, comp in zip(leaves, compute)])
                loss, aux = loss_fn(copies[dev], cfg, piece,
                                    sharder=sharder.for_row(ctx, r))
                losses.append(loss)
                auxes.append(aux)
            # a device divisor: a CUDA divide by a Python number multiplies
            # by its reciprocal (data_parallel_grad_fn divides so too)
            k = {d: torch.full((), float(n_rows), device=d)
                 for d in dict.fromkeys([home] + [m.device for ms in masters
                                                  for m in ms])}
            out_aux = {n: sum(a[n].detach().to(home) for a in auxes) / k[home]
                       for n, v in auxes[0].items()
                       if isinstance(v, torch.Tensor) and v.ndim == 0}
            if ctx.stats:
                losses, out_aux["moe_aux_loss"] = _moe_row_losses(
                    cfg, ctx, auxes, devices)
            flat = [m for ms in masters for m in ms]
            acc = None
            for loss in losses:
                # the casts and gathers are shared by the rows
                g = torch.autograd.grad(loss, flat, retain_graph=True,
                                        allow_unused=True,
                                        materialize_grads=True)
                acc = list(g) if acc is None else [
                    a + b for a, b in zip(acc, g)]
        total = sum(l.detach().to(home) for l in losses) / k[home]
        grads, i = [], 0
        for leaf, ms in zip(leaves, masters):
            grads.append(Sharded(leaf.sharding, leaf.shape,
                                 [a / k[a.device]
                                  for a in acc[i:i + len(ms)]]))
            i += len(ms)
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
    ..., "reduce-scatter": ..., "links": {kind: "nvlink" | "ib"}}``.

    Training, computed from the layout (nothing runs):

    * **The gathered compute copy** (all-gather): the whole tree in the
      compute dtype (``_casts`` leaves narrowed), received every step by
      each device that runs a row (the first row position there: a
      stand-in mesh's positions are each their own device).
    * **The row sums** (all-reduce): each row's gradient of every slice a
      position holds, added on the position's device in f32, so ``rows
      x`` its shards' bytes at 4 bytes an element. (The slice crosses in
      the gradient's dtype on the row's device, the compute dtype for cast
      leaves; counted here in f32, the dtype it is summed in.)

    Serving (``train=False``; ``step`` "prefill" of ``seq`` tokens a row,
    or "decode" at ``capacity``): what the tensor-parallel step's
    collectives and block-wise gathers move (``parallel/collectives.
    tally``), counted in one run of the first row's first rank on meta
    tensors (:func:`meta_serving_step`) and given to every position of
    every row's group (their shares are alike); a position outside every
    group moves nothing.

    A collective's group is the positions that send or receive it; it
    crosses NVLink when they all lie in one node of ``NODE_CARDS``
    consecutive positions in row-major order, InfiniBand otherwise.
    ``mesh`` needs only ``shape``."""
    rules = rules or DEFAULT_RULES
    n = _mesh_size(mesh)
    out = [{"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
            "links": {}} for _ in range(n)]
    if not _sharded_mesh(mesh):
        return out
    if not train:
        groups = tp.groups(mesh, rules, batch)
        p = groups[0][0]
        run, _ = meta_serving_step(
            cfg, mesh, rules, step, _meta_inputs(cfg, step, batch // len(
                groups), seq, enc_len), len(groups), capacity or seq,
            enc_len, p)
        with coll.tally() as t:
            run()
        for g in groups:
            for q in g:
                out[q] = _tally_entry(t, p)
        return out
    shapes, specs = param_specs(cfg, mesh, LogicalRules(rules.rules))
    rows = _row_positions(mesh, rules, batch)
    devices = getattr(mesh, "devices", None)
    gathers, seen = [], set()
    for p in rows:
        dev = p if devices is None else devices[p]
        if dev not in seen:
            seen.add(dev)
            gathers.append(p)
    whole, owners = 0, set()
    shard_f32 = [0] * n
    for leaf, spec in zip(optim.tree_leaves(shapes), optim.tree_leaves(specs)):
        sharding = NamedSharding(mesh, spec)
        item = (_dtype_size(cfg.adtype) if _casts(leaf, cfg.adtype)
                else leaf.element_size())
        whole += leaf.numel() * item
        owners.update(sharding.owners(tuple(leaf.shape)))
        numel = int(np.prod(sharding.shard_shape(tuple(leaf.shape))))
        for p in range(n):
            shard_f32[p] += numel * 4
    for p in gathers:
        out[p]["all-gather"] += whole
        out[p]["links"]["all-gather"] = _link(owners | {p})
    for p in range(n):
        out[p]["all-reduce"] = len(rows) * shard_f32[p]
        out[p]["links"]["all-reduce"] = _link(set(rows) | {p})
    return out


def _tally_entry(t: Dict, p: int) -> Dict:
    """Position ``p``'s :func:`step_collective_bytes` entry from a
    ``parallel/collectives.tally``."""
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "links": {}}
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        if t.get(kind, {}).get(p):
            out[kind] = t[kind][p]
            out["links"][kind] = ("ib" if any(
                _link(sp) == "ib" for sp in t["spans"][kind]) else "nvlink")
    return out


def _meta_inputs(cfg: ModelConfig, step: str, batch: int, seq: int,
                 enc_len: int) -> Dict:
    """A row's serving inputs as meta tensors: its tokens (the vision
    stub's patch embeddings and M-RoPE positions to a prefill; whisper's
    frame embeddings besides)."""
    meta = torch.device("meta")
    if cfg.frontend == "vision" and step == "prefill":
        return {"embeddings": torch.empty((batch, seq, cfg.d_model),
                                          dtype=cfg.adtype, device=meta),
                "positions": torch.empty((3, batch, seq), dtype=torch.int32,
                                         device=meta)}
    out = {"tokens": torch.empty((batch, seq if step == "prefill" else 1),
                                 dtype=torch.int32, device=meta)}
    if cfg.is_encdec and step == "prefill":
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
    split = tp.splits(cfg, specs, group.size)
    shapes = abstract_cache(cfg, row_batch, capacity, enc_len)
    caches = [tp.make_rank_cache(cfg, shapes, split, group.size, "meta")
              for _ in group.ranks]
    src = tp.BlockSource(params, cfg, group, cfg.adtype)
    sharder = ActivationSharder().for_row(sh.RowContext(n_rows), 0)
    model = encdec if cfg.is_encdec else lm
    own = [l.shards[g[r]] for r in group.ranks
           for l in optim.tree_leaves(params)]

    def run():
        if step == "prefill":
            return _prefill_tp(cfg, mesh, rules, src, inputs, caches,
                               sharder)
        return model.decode_step_tp(src, cfg, inputs["tokens"],
                                    capacity - 1, caches, sharder=sharder)
    return run, [own, caches]


# ---------------------------------------------------------------- serving
def make_cache(cfg: ModelConfig, batch: int, capacity: int,
               enc_len: int = 0, shardings=None, *,
               device: DeviceLike = None,
               rules: Optional[LogicalRules] = None):
    """Properly initialized cache (ring slot positions -1, not zeros) on
    the device (CUDA unless named). With ``shardings`` (``cache_specs``'s,
    as NamedShardings): a ``parallel/tp.RowCache``, for each row of the
    batch split of the mesh they name, each rank of the row's
    tensor-parallel group its own KV or SSM heads (``rules``: the params'
    rules, which say what the groups split)."""
    if shardings is not None:
        leaves = tree_leaves(shardings)
        mesh = leaves[0].mesh
        entry = next(tuple(l.spec) for l in leaves if len(l.spec) >= 3)[1]
        groups = [_group(mesh, g) for g in tp.groups_for(mesh, entry)]
        size = groups[0].size
        _, pspecs = param_specs(cfg, mesh,
                                LogicalRules((rules or DEFAULT_RULES).rules))
        split = tp.splits(cfg, pspecs, size)
        shapes = abstract_cache(cfg, batch // len(groups), capacity,
                                enc_len)
        rows = [[tp.make_rank_cache(cfg, shapes, split, size, d)
                 for d in g.devices] for g in groups]
        return RowCache(cfg, rows, groups, _cache_axes(cfg), split)
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
    """``run(source, row inputs index, caches, sharder)`` for each row of
    ``cache`` in row order, each on its group's block source; the rows'
    logits joined on the first row's device (the MoE's token groups are
    the whole batch's: ``parallel/sharded.RowContext``)."""
    ctx = sh.RowContext(len(cache.groups))
    sharder = ActivationSharder()
    logits = []
    for r, (group, caches) in enumerate(zip(cache.groups, cache.rows)):
        src = tp.BlockSource(params, cfg, group, cfg.adtype)
        out = run(src, r, caches, sharder.for_row(ctx, r))
        logits.append(out.to(cache.devices[0]))
    return torch.cat(logits)


def _prefill_tp(cfg: ModelConfig, mesh, rules: LogicalRules, src, batch,
                caches, sharder):
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
                                sharder=sharder)
    return model.prefill_tp(src, cfg, batch, caches, sp, sharder=sharder)


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
                               caches, sharder: _prefill_tp(
                                   cfg, mesh, rules, src, rows[r], caches,
                                   sharder)), cache

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
                               caches, sharder: model.decode_step_tp(
                                   src, cfg, rows[r]["tokens"], pos, caches,
                                   sharder=sharder)), cache

        info = _mesh_serving_info(cfg, mesh, rules, batch_size, capacity,
                                  enc_len)
        info["tok_sharding"] = tok_sharding(mesh, batch_size)
        return sharded_step, info

    def step(params, cache, tokens, pos):
        params = cast_params_for_compute(params, cfg.adtype)
        return model.decode_step(params, cfg, tokens, pos, cache)

    return step, {"cache_shapes": _cache_shapes(cfg, batch_size, capacity,
                                                enc_len)}
