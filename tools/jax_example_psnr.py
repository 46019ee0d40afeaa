"""Runs the JAX package's field examples (``examples/quickstart.py`` and
``examples/train_nerf.py``) at their defaults with another training seed,
and prints their lines, the PSNR among them.

The examples fix ``seed=0``; this script swaps their ``train_field`` for
one that takes ``--seed``, and changes nothing else. The spread of the
PSNRs over seeds bounds how far the port's twins (``examples/torch/``),
whose random numbers are PyTorch's, may land from the JAX examples'.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_example_psnr.py \
      --example quickstart --seed 1
"""
import argparse
import importlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", required=True,
                    choices=["quickstart", "train_nerf"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "examples"))
    mod = importlib.import_module(args.example)
    train_field = mod.train_field

    def seeded(*a, **kw):
        return train_field(*a, **{**kw, "seed": args.seed})
    mod.train_field = seeded
    sys.argv = [args.example]
    mod.main()


if __name__ == "__main__":
    main()
