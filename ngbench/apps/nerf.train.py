"""nerf in a training cell: the reference's loss of a ray batch (samples,
the field, the composite, the mean squared error), the field's input
points of a batch and the counted FLOPs of a step."""
from __future__ import annotations

from typing import Dict

import torch

from ngbench import counts
from ngbench.reference import render as ref
from ngbench.reference.field import Field, grid_of, mlp_of

HEAD = "density_mlp"          # the MLP that field_fwd runs on the encoding


def loss(field: Field, batch: Dict, train: Dict) -> torch.Tensor:
    n_s = train["n_samples"]
    pts, dts = ref.sample_along_rays(batch["origins"], batch["dirs"],
                                     train["near"], train["far"], n_s)
    n = batch["origins"].shape[0]
    out = field.nerf(ref.normalize_to_unit(pts.reshape(-1, 3)),
                     torch.repeat_interleave(batch["dirs"], n_s, dim=0))
    out = out.reshape(n, n_s, 4)
    pred = ref.composite(out[..., :3], out[..., 3], dts.expand(n, n_s))
    return torch.mean((pred - batch["target"]) ** 2)


def points(batch: Dict, train: Dict) -> torch.Tensor:
    """The field's (rays x samples, 3) unit-cube input points."""
    pts, _ = ref.sample_along_rays(batch["origins"], batch["dirs"],
                                   train["near"], train["far"],
                                   train["n_samples"])
    return ref.normalize_to_unit(pts.reshape(-1, 3))


def step_compute(cfg: Dict, train: Dict, n_rays: int,
                 n_params: int) -> Dict[str, float]:
    return counts.nerf_train_step_compute(
        n_rays, train["n_samples"], grid_of(cfg), mlp_of(cfg, "density_mlp"),
        mlp_of(cfg, "mlp"), n_params)
