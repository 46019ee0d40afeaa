"""LM serving example on the PyTorch port: prefill + batched greedy
decode against the KV / SSM caches for any assigned architecture (reduced
scale). The twin of ``examples/serve_lm.py``: the same steps and JSON
lines, through ``repro_torch.launch.serve.serve_lm``.

  PYTHONPATH=src python examples/torch/serve_lm.py --arch mamba2-2.7b \
      [--device cpu]

It differs from the JAX example in one flag: ``--device`` (default
``cuda``; without a GPU it raises, it does not fall back).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.serve import serve_lm  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)
    serve_lm(args.arch, reduced=True, gen_len=args.gen, device=args.device)


if __name__ == "__main__":
    main()
