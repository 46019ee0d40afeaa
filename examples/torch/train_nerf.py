"""Train the NeRF app (density MLP + colour MLP, multi-res hashgrid)
against the analytic volumetric scene on the PyTorch/CUDA port, then
render a novel view. The twin of ``examples/train_nerf.py``: the same
steps and lines, through ``repro_torch``.

  PYTHONPATH=src python examples/torch/train_nerf.py [--steps 150] \
      [--device cpu]

It differs from the JAX example in two flags: ``--device`` (default
``cuda``: the hand-written kernels; ``cpu``: their plain versions), and
no ``--use-pallas``: the port has no XLA route to choose against.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import fields, pipeline, render  # noqa: E402
from repro_torch.core.train import psnr, train_field  # noqa: E402
from repro_torch.data import scenes  # noqa: E402

OUT_DIR = Path(__file__).parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume dir (rerun the same command "
                         "to continue an interrupted run)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = fields.make_field_config("nerf", "hash")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, log2_table_size=14))

    print(f"training NeRF for {args.steps} steps "
          f"({args.rays} rays/step, 32 samples/ray) ...")
    # training logs come from the engine's per-step metrics rows
    params, hist = train_field(
        cfg, steps=args.steps, batch_size=args.rays, seed=0, log_every=25,
        ckpt_dir=args.ckpt_dir, device=args.device,
        on_metrics=lambda i, row, st: (i % 25 == 0 or i == args.steps - 1)
        and print(f"  step {i:4d} loss {row['loss']:.5f} "
                  f"psnr {row['psnr']:.1f} dB"))

    # novel view (different camera than training distribution center)
    cam = render.Camera(96, 96, focal=86.0,
                        c2w=render.look_at((1.4, -2.2, 1.9), (0, 0, 0)))
    img = pipeline.render_frame(
        params, cfg, cam, pipeline.RenderSettings(tile_pixels=2048,
                                                  n_samples=48),
        device=args.device)
    ids = torch.arange(96 * 96, dtype=torch.int64, device=img.device)
    o, d = render.make_rays(cam, ids)
    gt = scenes.gt_render_rays(o, d, n_samples=48).cpu().numpy()
    img = img.cpu().numpy()
    mse = float(((img.reshape(-1, 3) - gt) ** 2).mean())
    print(f"novel-view PSNR: {psnr(mse):.1f} dB")
    np.save(OUT_DIR / "nerf_novel_view.npy", img)


if __name__ == "__main__":
    main()
