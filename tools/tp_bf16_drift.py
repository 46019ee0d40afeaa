"""How far two bf16 runs of one LM drift apart when only the order of an
f32 sum differs, against depth: the tensor-parallel prefill on a (1, 4)
mesh of the CPU against the one-device prefill, and the one-device
prefill against itself with each swiglu's down projection summed as two
f32 halves (the same reordering, no tensor parallelism). Prints, for each
depth, the largest logit difference over the largest logit.

    PYTHONPATH=src python tools/tp_bf16_drift.py [--layers 2 8 32 64]

A narrow qwen3 (d 256, 8 heads over 4 KV heads, d_ff 512, vocab 4096),
random weights from seed 0, 4 prompts of 64 tokens, on the CPU (~1 min).
"""
import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.common.partitioning import rule_preset
from repro_torch.configs import registry
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.parallel import api

CPU = torch.device("cpu")
B, S = 4, 64


def _halves_swiglu(params, x, sharder=None, partial=False):
    """swiglu with its down projection summed as two f32 halves."""
    n = params["w_down"].shape[0] // 2
    parts = [layers.matmul_f32(
        torch.nn.functional.silu(x @ params["w_gate"][..., k:k + n].to(
            x.dtype)) * (x @ params["w_up"][..., k:k + n].to(x.dtype)),
        params["w_down"][k:k + n].to(x.dtype)) for k in (0, n)]
    return (parts[0] + parts[1]).to(x.dtype)


def prefill(cfg, toks, mesh=None):
    rules = rule_preset("baseline") if mesh is not None else None
    params = (api.init_params(cfg, 0, mesh, rules, compute_dtype=cfg.adtype)
              if mesh is not None else
              api.init_params(cfg, 0, device="cpu", compute_dtype=cfg.adtype))
    step, info = api.make_prefill_step(cfg, mesh, rules, capacity=S,
                                       batch_size=B)
    cache = (api.make_cache(cfg, B, S, shardings=info["cache"], rules=rules)
             if mesh is not None else api.make_cache(cfg, B, S,
                                                     device="cpu"))
    return step(params, {"tokens": toks}, cache)[0].float()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 8, 32, 64])
    args = ap.parse_args(argv)
    torch.set_num_threads(8)
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(1, 4),
                ("data", "model"))
    for n_layers in args.layers:
        cfg = dataclasses.replace(
            registry.reduced_config("qwen3-32b"), n_layers=n_layers,
            d_model=256, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512,
            vocab_size=4096)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)))
        one = prefill(cfg, toks)
        tp = prefill(cfg, toks, mesh)
        real = layers.swiglu
        layers.swiglu = _halves_swiglu
        try:
            halves = prefill(cfg, toks)
        finally:
            layers.swiglu = real
        scale = float(one.abs().max())
        sys.stdout.write(json.dumps({
            "layers": n_layers,
            "tp_vs_one": float((tp - one).abs().max()) / scale,
            "halves_vs_one": float((halves - one).abs().max()) / scale})
            + "\n")


if __name__ == "__main__":
    main()
