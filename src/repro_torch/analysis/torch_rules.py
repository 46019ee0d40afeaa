"""Torch-semantic rules (RT2xx): import the live code and check the
contracts the AST layer cannot see; the counterpart of the JAX package's
``analysis/jax_rules.py``.

Like the JAX rules they build *tiny* instances on the CPU (a 4-element
train state, an nvr scene of 2^8 rows a level, 8x8 and 16x12 cameras) and
never run a real workload, so the layer takes about a second. They pass
``device="cpu"`` explicitly: the linter is an analysis tool, not a path
that serves.

  RT201 smem-budget     — the Hopper resource budget of every Table-I
                          kernel plan (``analysis/budget.py``): shared
                          memory per block, level groups against their L2
                          shares.
  RT202 bucket-retrace  — the serve engine's one-tile-function-per-bucket
                          contract: equal ``BucketKey``s hash and compare
                          equal, no camera field enters the key, and an
                          engine serving two resolutions of one scene
                          builds one tile function (``serve.compiles``).
  RT203 in-place-state  — the counterpart of RJ203 ``donation``: the port
                          donates no buffers, its contract is that Adam
                          updates the train state in place
                          (``train/optim.adam_update``), so every leaf of
                          a 4-element state keeps its storage across a
                          two-step ``TrainEngine`` chunk.
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.analysis.registry import Finding, rule

_ENGINE = "src/repro_torch/serve/engine.py"
_OPTIM = "src/repro_torch/train/optim.py"
# fields of a camera: none may be a field of the bucket key
_CAMERA_FIELDS = {"camera", "cam", "height", "width", "resolution", "focal",
                  "c2w", "intrinsics", "viewpoint"}


@rule("smem-budget", "RT201", "semantic",
      "Hopper resources of every kernel plan for every Table-I (app, "
      "encoding) config at f32/bf16/int8/fp8 tables, from the kernels' own "
      "plan functions: shared memory per block and level groups against "
      "their L2 shares.")
def check_smem_budget() -> List[Finding]:
    from repro_torch.analysis import budget
    return budget.check()


@rule("bucket-retrace", "RT202", "semantic",
      "One tile function per bucket: BucketKey hash/eq stability across "
      "equal configs, no camera field in the key, and one serve.compiles "
      "for two resolutions of one scene.")
def check_bucket_retrace() -> List[Finding]:
    import numpy as np
    import torch

    from repro_torch.core import fields, render
    from repro_torch.core.pipeline import RenderSettings
    from repro_torch.serve.engine import (BucketKey, RenderEngine,
                                          RenderRequest)

    findings: List[Finding] = []

    def finding(message):
        findings.append(Finding(rule="bucket-retrace", code="RT202",
                                path=_ENGINE, line=0, message=message))

    def key(cfg):
        return BucketKey(app=cfg.app, encoding=cfg.grid.kind,
                         tile_pixels=4096, n_samples=32,
                         dtype="torch.float32", cfg=cfg)
    k1 = key(fields.make_field_config("nerf", "hash"))
    k2 = key(fields.make_field_config("nerf", "hash"))
    try:
        ok = hash(k1) == hash(k2) and k1 == k2 and {k1: 1}[k2] == 1
    except (TypeError, KeyError):
        ok = False
    if not ok:
        finding("equal BucketKeys do not hash/compare equal — every request "
                "would miss the bucket cache and build its tile function "
                "again; keep BucketKey and FieldConfig frozen, hashable "
                "dataclasses")

    in_key = {f.name for f in dataclasses.fields(BucketKey)} & _CAMERA_FIELDS
    if in_key:
        finding(f"BucketKey has camera fields {sorted(in_key)} — every new "
                "viewpoint or resolution would build a tile function; the "
                "camera must be data of the request")

    cfg = fields.make_field_config("nvr", "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=8))
    engine = RenderEngine(RenderSettings(tile_pixels=64, n_samples=4),
                          device="cpu")
    engine.add_scene("s0", cfg, fields.init_field(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    engine.warmup()
    eye = render.look_at((2.2, 1.6, 1.8), (0.0, 0.0, 0.0))
    for h, w in ((8, 8), (16, 12)):
        cam = render.Camera(height=h, width=w, focal=0.9 * w, c2w=eye)
        engine.submit(RenderRequest("s0", cam, np.arange(64))).result()
    compiles = engine.obs.counter("serve.compiles").value
    if compiles != 1:
        finding(f"two resolutions of one scene built {compiles:g} tile "
                "functions, not 1 (serve.compiles) — the camera entered "
                "the bucket")
    return findings


@rule("in-place-state", "RT203", "semantic",
      "TrainEngine state in place: every leaf of a 4-element Adam train "
      "state keeps its storage (data_ptr) across a two-step chunk; a "
      "rebinding update copies the state every step.")
def check_in_place_state() -> List[Finding]:
    import torch

    from repro_torch.train import loop, optim

    def loss_fn(params, batch):
        return torch.sum((params["w"] - batch) ** 2)

    state = loop.init_train_state({"w": torch.zeros(4)})
    leaves = {"params/w": state["params"]["w"],
              "opt/mu/w": state["opt"].mu["w"],
              "opt/nu/w": state["opt"].nu["w"]}
    before = {k: t.data_ptr() for k, t in leaves.items()}
    engine = loop.TrainEngine(
        loop.EngineConfig(steps=2, chunk_steps=2),
        loop.make_scanned_step(loss_fn, optim.AdamConfig(lr=0.1)),
        batch_fn=lambda step: torch.full((4,), float(step + 1)))
    out, _ = engine.run(state)
    after = {"params/w": out["params"]["w"].data_ptr(),
             "opt/mu/w": out["opt"].mu["w"].data_ptr(),
             "opt/nu/w": out["opt"].nu["w"].data_ptr()}
    moved = sorted(k for k in before if after[k] != before[k])
    if moved:
        return [Finding(
            rule="in-place-state", code="RT203", path=_OPTIM, line=0,
            message=(f"leaves {moved} left their storage across a two-step "
                     "chunk — the update rebinds the state instead of "
                     "updating it in place (adam_update's contract), so "
                     "every step allocates and copies it"))]
    if not bool(torch.all(out["params"]["w"] != 0)):
        return [Finding(
            rule="in-place-state", code="RT203", path=_OPTIM, line=0,
            message="two Adam steps left the params unchanged")]
    return []
