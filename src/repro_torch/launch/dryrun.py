"""The port's dry run: every (arch x shape x mesh) cell, and the four apps'
render step, counted against H100 peaks (the JAX package's
``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fields   # paper's apps

It is the one entry point of the port that never touches a card, because
it computes nothing. What stands in for JAX's lower + compile on 512 forced
host devices is one step run on ``meta`` tensors under the counting mode
(``launch/roofline.Counter``): nothing is allocated on any device and no
CUDA is needed. The counts are the step's matrix-product FLOPs, HBM bytes,
its arguments and the peak of its live allocations, and the kernels' work
(``kernels/cost.py``, reported by the wrappers' meta routes).

* **The meshes** are the JAX package's, as stand-ins
  (``launch/mesh.make_production_mesh``): (16, 16) and (2, 16, 16)
  positions, 32 or 64 nodes of 8 H100 SXM cards.
* **LM cells** count what one position computes, at the position that
  holds the most bytes, and record that device's numbers.
  - *Training*: each row runs on its tensor-parallel group
    (``parallel/tp.py``), so a cell counts one rank of the first row's
    group (``api.meta_train_step``) at its row's local batch (the global
    batch, or with ``num_microbatches`` a micro-batch, over the rows:
    ``api.row_positions``): its arguments are its f32 master, ``mu`` and
    ``nu`` shards and its row of the batch; it counts the cast of its
    shards, the row's forward and backward with each block's slices
    gathered (twice under full remat) and their gradients added into its
    buffers, and Adam on its shards; the other ranks' collective terms
    are empty buffers of their size. ``state_bytes`` is its plan,
    ``train_state_bytes(mesh=)``. With ``num_microbatches`` one
    micro-batch is counted and its FLOPs, bytes, kernel work and
    collectives taken that many times (the peak is one micro-batch's).
  - *Serving*: each row runs on its tensor-parallel group
    (``parallel/tp.py``), so a cell counts one rank of the first row's
    group (``api.meta_serving_step``): its arguments are its param shards
    (bf16), its cache and its row's inputs; each block's slice it gathers
    is a temporary; the other ranks' collective terms are empty buffers
    of their size. ``state_bytes`` is its plan, ``param_bytes(mesh=)``
    (its shards and the largest block's copied slice).
  The MoE layer sees the row as row 0 of the sharded step
  (``parallel/sharded.RowContext``): the global token groups and their
  capacity. On a one-position mesh the cell runs the port's one-device
  step itself (``api.make_train_step``, ``make_prefill_step``,
  ``make_decode_step``).
* **Collectives** (``parallel/api.step_collective_bytes``): tallied in
  the run of the step on meta tensors (the group's all-reduces,
  all-gathers and reduce-scatters, the all-to-alls of a cache split
  along the sequence, the block-wise gathers over 'data' and, in
  training, their backward's reduce-scatters); each priced at NVLink or
  InfiniBand.
* **Depth.** The port has no ``lax.scan``: one count covers every layer,
  and every record says ``probe_meta: {"probe": "exact"}``, as JAX's
  depth-1 cells do. ``--no-probes`` is accepted and changes nothing.
* **Field cells** (``--fields``) count the fused render step of 4 apps x
  3 encodings (``core/pipeline.make_render_step`` on the 4k camera): 2^21
  pixels split over the mesh's positions (8,192 a position on 256), the
  tables replicated, one position's share counted.

Each record carries the keys of the JAX record, with ``fits_h100_80g`` in
place of ``fits_v5e_16g``; ``compile_s`` is the seconds of the count.
Records go into ``--out`` (default ``build/dryrun/dryrun.json``) one cell
at a time, and a run skips the cells already there (``--force`` redoes
them).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from repro_torch.common.partitioning import LogicalRules, rule_preset
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeCell, shape_applicable
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.models import encdec, lm
from repro_torch.obs import log as obs_log
from repro_torch.parallel import api, collectives as pcoll, tp
from repro_torch.train import loop, optim

_LOG = obs_log.get_logger("dryrun")

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun" / \
    "dryrun.json"

# per-cell step config (the JAX dry run's: it made these cells fit a v5e)
TRAIN_OVERRIDES = {
    ("qwen2-vl-72b", "train_4k"): {"num_microbatches": 8},
    ("qwen3-32b", "train_4k"): {"num_microbatches": 2},
    ("jamba-v0.1-52b", "train_4k"): {"num_microbatches": 16},
    ("qwen3-moe-30b-a3b", "train_4k"): {"num_microbatches": 2},
    ("olmoe-1b-7b", "train_4k"): {"num_microbatches": 2},
    ("whisper-base", "train_4k"): {"num_microbatches": 2},
}

ONE_POSITION = MeshShape(("data", "model"), (1, 1))


def _load(out: Path) -> dict:
    return json.loads(out.read_text()) if out.exists() else {}


def _save(out: Path, results: dict):
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _rows_of(batch: Dict, n: int) -> Dict:
    """One row of ``n`` of a batch of meta tensors (each leaf's example
    axis cut to its share)."""
    out = {}
    for k, v in batch.items():
        axis = loop._batch_axis(k, v)
        shape = list(v.shape)
        shape[axis] //= n
        out[k] = _meta(shape, v.dtype)
    return out


def _tree_meta(tree, fn):
    return {k: (_tree_meta(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _model(cfg):
    return encdec if cfg.is_encdec else lm


def _enc_len(cfg, cell: ShapeCell) -> int:
    """The encoder length of a serving cell's cache (whisper)."""
    if not cfg.is_encdec:
        return 0
    return cell.seq_len if cell.step == "prefill" else min(cell.seq_len,
                                                           32768)


def _serving_inputs(cfg, cell: ShapeCell, batch: int, specs: Dict):
    """(cache tree, step inputs) of a serving step at ``batch`` examples."""
    cache = api.abstract_cache(cfg, batch, cell.seq_len, _enc_len(cfg, cell))
    if cell.step == "prefill":
        return cache, _rows_of(specs["batch"], cell.global_batch // batch)
    return cache, {"tokens": _meta((batch, 1), specs["tokens"].dtype)}


def _count_one_device(cfg, cell: ShapeCell, specs: Dict,
                      tc: api.TrainConfig):
    """The port's one-device step, counted: the train step on an f32 master
    with Adam's moments, or a serving step on params in the compute
    dtype."""
    if cell.step == "train":
        params, _ = api.abstract_params(cfg)
        state = api.make_train_state(params)
        step, _ = api.make_train_step(cfg, train_cfg=tc)
        batch = specs["batch"]
        with roofline.Counter((state, batch)) as c:
            out = step(state, batch)
        c.outputs(out)
        return c.result(), api.train_state_bytes(cfg, tc)
    params, _ = api.abstract_params(cfg, compute_dtype=cfg.adtype)
    cache, inp = _serving_inputs(cfg, cell, cell.global_batch, specs)
    if cell.step == "prefill":
        step, _ = api.make_prefill_step(
            cfg, capacity=cell.seq_len, batch_size=cell.global_batch,
            enc_len=cell.seq_len if cfg.is_encdec else 0)
        args = (params, inp, cache)
    else:
        step, _ = api.make_decode_step(
            cfg, capacity=cell.seq_len, batch_size=cell.global_batch,
            enc_len=min(cell.seq_len, 32768) if cfg.is_encdec else 0)
        args = (params, cache, inp["tokens"], cell.seq_len - 1)
    with roofline.Counter(args[:3]) as c:
        out = step(*args)
    c.outputs(out)
    return c.result(), api.param_bytes(cfg, cfg.adtype)


def _count_position(cfg, cell: ShapeCell, specs: Dict, mesh,
                    rules: LogicalRules, tc: api.TrainConfig, p: int,
                    n_rows: int):
    """Position ``p``'s share of the sharded step (the module docstring),
    counted."""
    train = cell.step == "train"
    if not train:
        local = cell.global_batch // n_rows
        cache, inp = _serving_inputs(cfg, cell, local, specs)
        run, state = api.meta_serving_step(cfg, mesh, rules, cell.step, inp,
                                           n_rows, cell.seq_len,
                                           _enc_len(cfg, cell), p)
        with roofline.Counter((state, inp)) as c:
            out = run()
        c.outputs(out)
        return c.result(), api.param_bytes(cfg, cfg.adtype, mesh=mesh,
                                           rules=rules)[p]
    nmb = tc.num_microbatches
    row = _rows_of(specs["batch"], nmb * n_rows)
    run, state = api.meta_train_step(cfg, mesh, rules, row, n_rows, p, tc)
    with pcoll.tally() as moved, roofline.Counter((state, row)) as c:
        run()
    res = c.result()
    if nmb > 1:
        res = _scaled(res, nmb)
        moved = {k: ({q: n * nmb for q, n in v.items()} if k != "spans"
                     else v) for k, v in moved.items()}
    res["coll"] = api._tally_entry(moved, p)
    return res, api.train_state_bytes(cfg, tc, mesh=mesh, rules=rules)[p]


def count_group(cfg, cell: ShapeCell, mesh, rules: LogicalRules,
                specs: Optional[Dict] = None) -> Dict:
    """The first row's whole tensor-parallel group of a serving cell,
    counted on meta tensors as one process that drives the mesh runs it:
    every rank's shards and cache are arguments (``chip_smoke.py``'s
    ``dryrun`` holds this count to the card on a mesh of one card)."""
    specs = specs or registry.input_specs(cfg, cell)
    n_rows = len(api.row_positions(mesh, rules, cell.global_batch))
    _, inp = _serving_inputs(cfg, cell, cell.global_batch // n_rows, specs)
    p = tp.groups(mesh, rules, cell.global_batch)[0][0]
    run, state = api.meta_serving_step(cfg, mesh, rules, cell.step, inp,
                                       n_rows, cell.seq_len,
                                       _enc_len(cfg, cell), p,
                                       whole_group=True)
    with roofline.Counter((state, inp)) as c:
        out = run()
    c.outputs(out)
    return c.result()


@dataclasses.dataclass(frozen=True)
class _MetaMesh(MeshShape):
    """A stand-in mesh whose every position is the meta device: a step
    driven on it allocates nothing."""

    @property
    def devices(self):
        return [torch.device("meta")] * self.size


def count_mesh_train(cfg, cell: ShapeCell, shape, rules: LogicalRules,
                     specs: Optional[Dict] = None,
                     train_cfg: Optional[api.TrainConfig] = None) -> Dict:
    """A train cell's whole step on a mesh of ``shape`` ((data, model)),
    counted on meta tensors as one process that drives the mesh runs it:
    every row on its group, every rank (``api.make_train_step`` on a mesh
    of meta devices); every position's master, ``mu`` and ``nu`` shards
    are arguments (``chip_smoke.py``'s ``dryrun`` holds this count to the
    card on a mesh of one card)."""
    specs = specs or registry.input_specs(cfg, cell)
    mesh = _MetaMesh(("data", "model"), tuple(shape))
    shapes, pspecs = api.param_specs(cfg, mesh, rules)
    state = api.make_train_state(tp.meta_params(shapes, pspecs, mesh))
    step, _ = api.make_train_step(cfg, mesh, rules, train_cfg=train_cfg)
    shards = [s for tree in (state["params"], state["opt"].mu,
                             state["opt"].nu)
              for leaf in optim.tree_leaves(tree) for s in leaf.shards]
    with roofline.Counter((shards, specs["batch"])) as c:
        out = step(state, specs["batch"])
    c.outputs(out)
    return c.result()


def _scaled(res: Dict, n: int) -> Dict:
    """A micro-batch's count taken ``n`` times (the memory is one
    micro-batch's)."""
    out = dict(res)
    out["flops"] = res["flops"] * n
    out["flops_by_dtype"] = {k: v * n for k, v in
                             res["flops_by_dtype"].items()}
    out["bytes"], out["op_bytes"] = res["bytes"] * n, res["op_bytes"] * n
    out["kernels"] = {k: {kk: vv * n for kk, vv in v.items()}
                      for k, v in res["kernels"].items()}
    return out


def build_and_count(cfg, shape: Union[str, ShapeCell], mesh,
                    rules: LogicalRules, train_overrides: dict = None,
                    specs: Optional[Dict] = None):
    """Count one step of one cell on meta tensors (in place of JAX's
    ``build_and_compile``). ``specs`` replaces the cell's inputs
    (``registry.input_specs``), e.g. a train batch with ``labels``.
    Returns (the count, meta): meta holds the position counted, the rows,
    the rows' local batch, the position's state bytes as the memory plan
    gives them, and its collectives."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    specs = specs or registry.input_specs(cfg, cell)
    tc = api.TrainConfig(**(train_overrides or {}))
    train = cell.step == "train"
    split = cell.global_batch // (tc.num_microbatches if train else 1)
    rows = api.row_positions(mesh, rules, split)
    if not api._sharded_mesh(mesh):
        res, state = _count_one_device(cfg, cell, specs, tc)
        p = 0
        coll = api.step_collective_bytes(cfg, mesh, rules, split)[p]
    else:
        # every rank of every row's group computes
        plan = (api.train_state_bytes(cfg, tc, mesh=mesh, rules=rules)
                if train else
                api.param_bytes(cfg, cfg.adtype, mesh=mesh, rules=rules))
        p = max((q for g in tp.groups(mesh, rules, split) for q in g),
                key=lambda q: plan[q])
        res, state = _count_position(cfg, cell, specs, mesh, rules, tc, p,
                                     len(rows))
        coll = res.pop("coll", None)
        if coll is None:
            coll = api.step_collective_bytes(
                cfg, mesh, rules, split, train=False, step=cell.step,
                seq=cell.seq_len, capacity=cell.seq_len,
                enc_len=_enc_len(cfg, cell))[p]
    return res, {"position": p, "rows": len(rows),
                 "row_batch": split // len(rows), "state_bytes": int(state),
                 "coll": coll}


def lower_cell(arch: str, shape: str, multi_pod: bool,
               rules_name: str = "baseline", verbose: bool = True,
               train_overrides=None, probes: bool = True,
               moe_cf: float = None, cfg_overrides: dict = None):
    """One LM cell's record (``probes`` is accepted and changes nothing:
    one count covers every layer)."""
    cfg = registry.get_config(arch)
    if moe_cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=moe_cf))
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if train_overrides is None:
        train_overrides = TRAIN_OVERRIDES.get((arch, shape))
    skip = shape_applicable(cfg, shape)
    if skip:
        return {"cell": f"{arch}/{shape}", "skipped": skip}

    cell = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chip_count(mesh)
    rules = rule_preset(rules_name)

    t0 = time.time()
    counted, meta = build_and_count(cfg, shape, mesh, rules, train_overrides)
    t_count = time.time() - t0

    n_active = cfg.active_param_count()
    mf = roofline.model_flops(cfg, cell, n_active)
    name = f"{arch}/{shape}/{'multi' if multi_pod else 'single'}"
    rec = roofline.summarize(name, counted, chips, mf, coll=meta["coll"])
    ma = rec["memory_analysis"]
    ma["state_bytes"] = meta["state_bytes"]
    ma["input_bytes"] = ma["argument_bytes"] - meta["state_bytes"]
    rec.update({
        "rules": rules_name,
        "train_overrides": train_overrides,
        "compile_s": round(t_count, 1), "probe_s": 0.0,
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "probe_meta": {"probe": "exact"},
        "scan_cost_raw": {"flops": rec["flops_per_device"],
                          "bytes accessed": rec["hbm_bytes_per_device"]},
        "sharding_fallbacks": sorted(set(
            f"{p}[{d}]:{ax}" for (p, d, ax, _, _) in rules.fallbacks))[:40],
        "position": meta["position"], "rows": meta["rows"],
        "row_batch": meta["row_batch"], "n_ops": counted["n_ops"],
    })
    if verbose:
        _LOG.info("cell", name=name, count_s=round(t_count, 1),
                  dominant=rec["dominant"],
                  bound_ms=round(rec["bound_s"] * 1e3, 2),
                  flops_per_device=rec["flops_per_device"],
                  coll_bytes_per_device=rec["collective_bytes_per_device"])
        _LOG.info("memory_analysis", name=name,
                  argument_bytes=ma["argument_bytes"],
                  temp_bytes=ma["temp_bytes"],
                  fits_h100_80g=ma["fits_h100_80g"])
    return rec


def field_params(fcfg) -> Dict:
    """A field's param tree as meta tensors (f32 tables and weights)."""
    from repro_torch.core import fields
    return _tree_meta(fields.param_shapes(fcfg),
                      lambda s: _meta(s, torch.float32))


def count_render_step(fcfg, n_pixels: int, fused: bool = True,
                      n_samples: int = 32):
    """One position's share of the render step (``n_pixels`` pixel ids),
    counted on meta tensors."""
    from repro_torch.core import pipeline
    settings = pipeline.RenderSettings(fused=fused, n_samples=n_samples)
    render = pipeline.make_render_step(fcfg, settings)
    params = field_params(fcfg)
    pix = _meta((n_pixels,), torch.int32)
    with roofline.Counter((params, pix)) as c:
        out = render(params, pix)
    c.outputs(out)
    return c.result()


def field_cell(app: str, encoding: str, multi_pod: bool,
               verbose: bool = True, fused: bool = True,
               n_samples: int = 32):
    """The paper's apps: a batched render step (2^21 pixel requests, half
    a 4k frame) split over every position, the tables replicated; one
    position's share counted."""
    from repro_torch.core.fields import field_param_count
    fcfg = registry.field_config(app, encoding)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chip_count(mesh)
    n_pix = 1 << 21
    t0 = time.time()
    counted = count_render_step(fcfg, n_pix // chips, fused, n_samples)
    t = time.time() - t0
    name = (f"field-{app}-{encoding}"
            f"{'' if fused else '-unfused'}/"
            f"{'multi' if multi_pod else 'single'}")
    rec = roofline.summarize(name, counted, chips, model_fl=float("nan"))
    rec.update({"compile_s": round(t, 1), "fused": fused,
                "params_total": field_param_count(fcfg),
                "n_pixels": n_pix, "pixels_per_position": n_pix // chips,
                "n_ops": counted["n_ops"]})
    if verbose:
        _LOG.info("field_cell", name=name, count_s=round(t, 1),
                  dominant=rec["dominant"],
                  bound_ms=round(rec["bound_s"] * 1e3, 4),
                  temp_bytes=rec["memory_analysis"]["temp_bytes"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count every (arch x shape x mesh) cell, or the apps' "
                    "render step, on meta tensors against H100 peaks.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fields", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted; changes nothing (one count covers "
                         "every layer)")
    ap.add_argument("--moe-cf", type=float, default=None)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out)
    results = _load(out)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.fields:
        for app in registry.FIELD_APPS:
            for encoding in registry.FIELD_ENCODINGS:
                cells.append(("field", app, encoding))
    elif args.all:
        for arch in registry.list_archs():
            for shape in SHAPES:
                cells.append(("lm", arch, shape))
    else:
        if args.arch is None or args.shape is None:
            ap.error("give --arch and --shape, or --all, or --fields")
        cells.append(("lm", args.arch, args.shape))

    failures = 0
    for kind, a, b in cells:
        for multi in meshes:
            key = (f"{a}/{b}/{'multi' if multi else 'single'}"
                   if kind == "lm" else
                   f"field-{a}-{b}/{'multi' if multi else 'single'}")
            if args.rules != "baseline":
                key += f"@{args.rules}"
            if key in results and not args.force \
                    and "error" not in results[key]:
                _LOG.info("cached_skip", cell=key)
                continue
            try:
                rec = (lower_cell(a, b, multi, args.rules,
                                  probes=not args.no_probes,
                                  moe_cf=args.moe_cf)
                       if kind == "lm" else field_cell(a, b, multi))
            except Exception as e:  # noqa: BLE001 - record and continue
                traceback.print_exc()
                rec = {"cell": key, "error": f"{type(e).__name__}: {e}"}
                failures += 1
            results[key] = rec
            _save(out, results)
    _LOG.info("done", n_cells=len(cells) * len(meshes),
              failures=failures, out=str(out))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
