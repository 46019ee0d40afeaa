"""The system under test in a language-model cell: the port's LM training
path (``repro_torch.parallel.api.build_train_step`` under
``repro_torch.train.loop.TrainEngine``), and the one module of the
``lm_train`` kind that imports the port. It builds the model a
configuration file describes, hands the program the harness's batches,
reads back its state and the metrics rows, and maps the program's
parameter tree onto the plain reference's names.

``record_phases`` adds phases the LM readers read (``ssm``, ``moe``) to
those the program's tracer records in a traced run
(``program_spans.start``); loaded elsewhere it does nothing.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator, Sequence, Tuple

import torch

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.configs import registry                        # noqa: E402
from repro_torch.models import blocks                           # noqa: E402
from repro_torch.obs import trace                               # noqa: E402
from repro_torch.parallel import api                            # noqa: E402
from repro_torch.train import loop, optim                       # noqa: E402

from ngbench import program_spans                               # noqa: E402


def model_config(config: Dict, train: Dict):
    """The program's config of a configuration file: the port's arch
    (``config["arch"]``: its kinds of layer and options) with every size
    the file gives (its layers, widths, experts routed and held, scalars),
    the cell's activation dtype and recompute policy. Raises where the
    file's layer pattern is not the arch's."""
    base = registry.get_config(config["arch"])
    d, nq = config["hidden_size"], config["num_attention_heads"]
    cfg = dataclasses.replace(
        base, n_layers=config["num_hidden_layers"], d_model=d, n_heads=nq,
        n_kv_heads=config["num_key_value_heads"], head_dim=d // nq,
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        norm_eps=config["rms_norm_eps"],
        moe=dataclasses.replace(
            base.moe, n_experts=config["experts_routed"],
            top_k=config["num_experts_per_tok"],
            d_expert=config["intermediate_size"]),
        ssm=dataclasses.replace(
            base.ssm, d_state=config["mamba_d_state"],
            d_conv=config["mamba_d_conv"], expand=config["mamba_expand"],
            head_dim=config["mamba_d_head"],
            n_groups=config["mamba_n_groups"],
            chunk=config["mamba_chunk_size"]),
        embedding_multiplier=config["embedding_multiplier"],
        residual_multiplier=config["residual_multiplier"],
        attention_multiplier=config["attention_multiplier"],
        logits_scaling=config["logits_scaling"],
        shared_expert_width=config["shared_intermediate_size"],
        experts_held=config["num_local_experts"],
        act_dtype=train["act_dtype"], remat=train["remat"])
    kinds = ["attention" if cfg.layer_kind(l) == "attn" else "mamba"
             for l in range(cfg.n_layers)]
    if (kinds != config["layer_types"]
            or cfg.ssm.n_heads(d) != config["mamba_n_heads"]
            or config["first_expert_held"] != 0):
        raise ValueError(f"{config['name']}: {config['arch']} in the program "
                         f"has layers {kinds} and "
                         f"{cfg.ssm.n_heads(d)} Mamba-2 heads, unlike the "
                         "file")
    return cfg


def train_config(train: Dict) -> api.TrainConfig:
    """Adam with the cell's settings: no clipping, no warm-up."""
    return api.TrainConfig(optimizer=optim.AdamConfig(
        lr=train["lr"], b1=train["b1"], b2=train["b2"], eps=train["eps"]))


def train_step(cfg, train: Dict) -> Callable:
    """An engine step ``(state, step, batch) -> (state, metrics)``."""
    step, _ = api.build_train_step(cfg, train_cfg=train_config(train))
    return lambda state, i, batch: step(state, batch)


def init_params(cfg, seed: int, device, train: Dict) -> Dict:
    """f32 params drawn on ``device`` from ``seed`` (refused before any
    draw where the train state would not fit)."""
    return api.init_params(cfg, seed, device=device,
                           train_cfg=train_config(train))


def train_state(params: Dict) -> Dict:
    return api.make_train_state(params)


def train_engine(step_fn: Callable, batch_fn: Callable, steps: int,
                 chunk_steps: int) -> loop.TrainEngine:
    return loop.TrainEngine(loop.EngineConfig(steps=steps,
                                              chunk_steps=chunk_steps),
                            step_fn, batch_fn=batch_fn)


def adam_moment(state: Dict) -> Dict:
    """Adam's first moment of every leaf, as the optimizer holds it."""
    return state["opt"].mu


def params_of(state: Dict) -> Dict:
    return state["params"]


def reference_leaves(tree: Dict, cfg) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, view)`` of every leaf of a params-shaped tree (params, a
    moment, gradients) under the plain reference's names
    (``reference/granite_hybrid.py``): ``embedding``, ``final_norm`` and
    ``layers/<l>/...``, each layer's slice of the program's stacked
    periods, the attention's head axes flattened."""
    yield "embedding", tree["embedding"]["table"]
    yield "final_norm", tree["final_norm"]["scale"]
    period = blocks.block_period(cfg)
    d = cfg.d_model
    for l in range(cfg.n_layers):
        sub, i = tree["blocks"][f"sub{l % period}"], l // period
        pre = f"layers/{l}/"
        yield pre + "norm1", sub["norm1"]["scale"][i]
        yield pre + "norm2", sub["norm2"]["scale"][i]
        if "ssm" in sub:
            s = sub["ssm"]
            for name, key in (("in_proj", "w_in"), ("conv_w", "conv_w"),
                              ("conv_b", "conv_b"), ("dt_bias", "dt_bias"),
                              ("A_log", "A_log"), ("D", "D"),
                              ("norm", "norm_scale"), ("out_proj", "w_out")):
                yield pre + "mamba/" + name, s[key][i]
        else:
            a = sub["attn"]
            yield pre + "attn/q", a["wq"][i].reshape(d, -1)
            yield pre + "attn/k", a["wk"][i].reshape(d, -1)
            yield pre + "attn/v", a["wv"][i].reshape(d, -1)
            yield pre + "attn/o", a["wo"][i].reshape(-1, d)
        m = sub["moe"]
        for key in ("router", "w_gate", "w_up", "w_down"):
            yield pre + "moe/" + key, m[key][i]
        for key in ("w_gate", "w_up", "w_down"):
            yield pre + "moe/shared/" + key, m["shared"][key][i]


def record_phases(names: Sequence[str]) -> None:
    """In a traced run, record the program's ``names`` phases too."""
    program_spans.start()
    tracer = trace.TRACER
    if tracer.enabled and tracer.phases is not None:
        tracer.phases = tracer.phases | frozenset(names)
