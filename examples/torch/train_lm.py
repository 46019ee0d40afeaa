"""Train a reduced LM arch on the synthetic motif stream with the port's
training machinery: the train step, async checkpointing, resume. The twin
of ``examples/train_lm.py``: the same flags and printed lines, through
``repro_torch.launch.train.train_loop``.

  PYTHONPATH=src python examples/torch/train_lm.py --arch olmoe-1b-7b \
      --steps 60 [--device cpu]
  # kill it mid-run and re-run with the same --ckpt-dir: it resumes

It differs from the JAX example in one flag: ``--device`` (default
``cuda``; without a GPU it raises, it does not fall back). The model runs
on that one device (the JAX example's mesh is one device too).
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.parallel import api  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compression", default=None,
                    choices=["topk", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    args = ap.parse_args(argv)

    cfg = registry.reduced_config(args.arch)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model}) "
          f"ckpt={ckpt}")
    tc = api.TrainConfig(compression=args.compression)
    _, losses = train_loop(cfg, steps=args.steps, seq_len=args.seq,
                           global_batch=args.batch, ckpt_dir=ckpt,
                           ckpt_every=20, train_cfg=tc, device=args.device)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(the motif stream is learnable; expect a clear drop)")


if __name__ == "__main__":
    main()
