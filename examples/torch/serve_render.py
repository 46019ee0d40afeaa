"""End-to-end serving example on the PyTorch/CUDA port (the paper's
deployment scenario): train several small neural fields, then serve a
mixed multi-scene, multi-viewpoint request stream through the
RenderEngine — one tile function per bucket, the hand-written field,
MLP and compositing kernels on the card — and report p50/p99 latency +
Mpix/s. The twin of ``examples/serve_render.py``: the same steps and
JSON lines, through ``repro_torch.launch.serve``.

  PYTHONPATH=src python examples/torch/serve_render.py [--app nvr] \
      [--device cpu]

It differs from the JAX example in two flags, as the port's launcher
does: ``--device`` (default ``cuda``: the hand-written kernels; ``cpu``:
their plain versions), and no ``--pallas``: the port has no XLA route to
choose against.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.serve import serve_render  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="gia",
                    choices=["gia", "nsdf", "nvr", "nerf"])
    ap.add_argument("--encoding", default="hash",
                    choices=["hash", "dense", "tiled"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--cameras", type=int, default=3)
    ap.add_argument("--shard", action="store_true",
                    help="pixel-parallel split over the local devices' mesh")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    serve_render(args.app, args.encoding, train_steps=args.train_steps,
                 n_requests=args.requests, n_scenes=args.scenes,
                 n_cameras=args.cameras, shard=args.shard,
                 device=args.device)


if __name__ == "__main__":
    main()
