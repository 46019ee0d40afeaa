"""Training launcher of the port, the JAX package's ``launch/train.py``:
an LM trained on one device or a ``(data, model)`` mesh through the
shared training engine, with checkpointing, resume and health hooks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The train step of ``parallel/api`` runs in the chunks of
``train/loop.TrainEngine``, and batches come from one source of truth,
``SyntheticTokens.batch(step)``, a pure function of the global step, so a
resumed run sees the stream it would have seen uninterrupted; the engine
stacks each chunk's batches and copies them to the card on a background
thread while the previous chunk runs. The engine's one host read a chunk
(every step's metrics at once) is the loop's only sync point.

``--data`` and ``--model`` build the mesh with ``launch/mesh.
make_local_mesh`` (which clamps to the devices there are, as the JAX
function does); on a mesh of more than one device the train state is
sharded and each row of the batch trains on its tensor-parallel group
along 'model' (``parallel/api``: heads, ``mlp``, vocab, experts and SSM
heads split, one block's slices gathered at a time); the engine copies
each whole batch to the mesh's first device and the step moves each row
to its group.

It differs from the JAX launcher in two places:

  * ``--device`` (default ``cuda``) picks the device type and the mesh's
    first device; without a GPU the default raises, it does not fall
    back.
  * A model whose train state (16 bytes a parameter and the compute copy;
    on a mesh, each device's shards, their compute copy and one block's
    gathered slices with their gradient: ``api.train_state_bytes``) does
    not fit is refused with ``MemoryError`` before anything is drawn.

As in the JAX package, whisper (an encoder-decoder, whose batches need
``enc_embeddings``) trains through ``parallel/api.build_train_step``, not
through this launcher; it says so rather than fail on a missing key.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.common.partitioning import DEFAULT_RULES
from repro_torch.configs import registry
from repro_torch.data import tokens as token_data
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.obs import log as obs_log
from repro_torch.obs.trace import TRACER
from repro_torch.parallel import api
from repro_torch.train import loop

_LOG = obs_log.get_logger("train")


def train_loop(cfg, mesh=None, *, steps: int, seq_len: int,
               global_batch: int, ckpt_dir=None, ckpt_every: int = 50,
               rules=None, train_cfg: Optional[api.TrainConfig] = None,
               log_every: int = 10, seed: int = 0, on_step=None,
               chunk_steps: int = 16, metrics_out: Optional[str] = None,
               device: DeviceLike = None):
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` x ``seq_len``
    synthetic tokens on ``mesh`` (sharded under ``rules``, default the JAX
    default rules, when it has more than one device; else its one device,
    or ``device``: CUDA unless named); resume from ``ckpt_dir``'s newest
    checkpoint. Returns (the final state, the loss of each step run in
    this call)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: an encoder-decoder trains through "
                         "parallel/api.build_train_step with enc_embeddings "
                         "in its batches, not through the token launcher")
    train_cfg = train_cfg or api.TrainConfig()
    rules = rules or DEFAULT_RULES.copy_with()
    example = {"batch": {"tokens": np.zeros((global_batch, seq_len),
                                            np.int32)}}
    raw_step, _ = api.build_train_step(cfg, mesh, rules, train_cfg=train_cfg,
                                       example_batch=example)
    params = api.init_params(cfg, seed, mesh, rules, device=device,
                             train_cfg=train_cfg)
    state = api.make_train_state(
        params, compression=train_cfg.compression is not None)

    # one source of truth for data: batch(step) is recomputable from the
    # step alone, so a resumed run sees the exact stream it would have
    # seen uninterrupted
    src = token_data.SyntheticTokens(token_data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed))
    engine = loop.TrainEngine(
        loop.EngineConfig(steps=steps, chunk_steps=chunk_steps,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        lambda state, step, batch: raw_step(state, batch),
        host_batch_fn=src.batch)

    losses = []

    def on_metrics(step, row, st):
        losses.append(row["loss"])
        if on_step:
            on_step(step, row["loss"], st)
        if step % log_every == 0:
            _LOG.info("step", step=step, loss=round(row["loss"], 4),
                      dt_ms=round(row["dt"] * 1e3))

    state, _ = engine.run(state, on_metrics=on_metrics)
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(engine.obs.to_json())
        _LOG.info("metrics_written", path=metrics_out)
    return state, losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", type=int, default=1,
                    help="mesh positions along 'data' (batch rows, FSDP)")
    ap.add_argument("--model", type=int, default=1,
                    help="mesh positions along 'model' (each row's "
                         "tensor-parallel group)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--chunk-steps", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "topk", "int8"])
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON (train.chunk events)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine metrics snapshot JSON here")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_out:
        TRACER.enable()
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    dev = resolve_device(args.device)
    mesh = make_local_mesh(args.data, args.model, device=dev)
    tc = api.TrainConfig(num_microbatches=args.microbatches,
                         compression=args.compression)
    _, losses = train_loop(cfg, mesh, steps=args.steps, seq_len=args.seq,
                           global_batch=args.batch,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           chunk_steps=args.chunk_steps, train_cfg=tc,
                           metrics_out=args.metrics_out, device=dev)
    if losses:
        _LOG.info("trained", loss_first=round(losses[0], 4),
                  loss_last=round(losses[-1], 4), n_steps=len(losses))
    if args.trace_out:
        TRACER.export(args.trace_out)
        _LOG.info("trace_written", path=args.trace_out,
                  n_events=len(TRACER.events()))


if __name__ == "__main__":
    main()
