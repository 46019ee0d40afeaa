"""Quickstart on the PyTorch/CUDA port: train a GIA (gigapixel image
approximation) neural field — the paper's simplest app — then render a
frame with the fused field kernel. The twin of ``examples/quickstart.py``:
the same steps and lines, through ``repro_torch``.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

It differs from the JAX example in one flag: ``--device`` (default
``cuda``: the hand-written kernels; ``cpu``: their plain versions).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import fields, pipeline  # noqa: E402
from repro_torch.core.train import psnr, train_field  # noqa: E402
from repro_torch.data import scenes  # noqa: E402

STEPS = 300          # training steps, as in the JAX example
OUT_DIR = Path(__file__).parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    # Table I GIA config, with a laptop-scale table (T=2^14 vs 2^24);
    # with_grid recomputes the grid-dependent MLP dims
    cfg = fields.make_field_config("gia", "hash")
    cfg = cfg.with_grid(dataclasses.replace(cfg.grid, log2_table_size=14))

    print("training GIA on the procedural gigapixel image ...")
    # training logs come from the engine's per-step metrics rows
    # (loss/psnr/lr come to the host once per chunk)
    params, hist = train_field(
        cfg, steps=STEPS, batch_size=4096, seed=0, log_every=50,
        device=args.device,
        on_metrics=lambda i, row, st: (i % 50 == 0 or i == STEPS - 1)
        and print(f"  step {i:4d} loss {row['loss']:.5f} "
                  f"psnr {row['psnr']:.1f} dB lr {row['lr']:.4f}"))

    print("rendering a 128x128 frame through the fused pipeline ...")
    cam = scenes.default_camera(128, 128)
    img = pipeline.render_frame(params, cfg, cam,
                                pipeline.RenderSettings(tile_pixels=4096),
                                device=args.device)
    img = img.cpu().numpy()
    print(f"frame: {img.shape}, mean={img.mean():.3f}, "
          f"finite={np.isfinite(img).all()}")

    # compare against ground truth at the same pixels
    ys, xs = np.mgrid[0:128, 0:128]
    xy = np.stack([xs.ravel() / 128, ys.ravel() / 128], -1)
    gt = scenes.gigapixel_image(
        torch.from_numpy(xy.astype(np.float32))).numpy()
    mse = float(((img.reshape(-1, 3) - gt) ** 2).mean())
    print(f"reconstruction PSNR vs analytic image: {psnr(mse):.1f} dB")
    out = OUT_DIR / "quickstart_gia.npy"
    np.save(out, img)
    print(f"saved frame -> {out}")


if __name__ == "__main__":
    main()
