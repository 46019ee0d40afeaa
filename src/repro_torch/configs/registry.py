"""Architecture registry of the port: ``--arch <id>`` resolution, the
reduced smoke configs and the dry run's per-(arch x shape) input specs,
the JAX package's ``configs/registry.py``."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Union

import torch

from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

FIELD_APPS = ["nerf", "nsdf", "gia", "nvr"]
FIELD_ENCODINGS = ["hash", "dense", "tiled"]


def list_archs():
    return list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Same family/feature set, laptop-scale: used by smoke tests."""
    cfg = get_config(arch)
    changes = dict(
        n_layers=max(2, (cfg.attn_every or 1)
                     * (2 if not cfg.attn_every else 1)),
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128, vocab_size=256,
    )
    if cfg.attn_every:   # keep one full period
        changes["n_layers"] = cfg.attn_every
        changes["attn_offset"] = min(cfg.attn_offset, cfg.attn_every - 1)
    if cfg.n_kv_heads == cfg.n_heads:     # preserve MHA
        changes["n_kv_heads"] = 4
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=8, chunk=16)
    if cfg.m_rope_sections is not None:
        changes["m_rope_sections"] = (2, 3, 3)   # sums to head_dim/2
    if cfg.swa_window is not None:
        changes["swa_window"] = 16
    return dataclasses.replace(cfg, **changes)


def input_specs(cfg: ModelConfig, shape: Union[str, ShapeCell]) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell (the JAX
    function's ``ShapeDtypeStruct``s): shapes and dtypes only, nothing
    allocated. Token ids are int32, as the JAX specs give them. ``shape``
    names a cell of ``SHAPES`` or is a ``ShapeCell``."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    f = cfg.adtype

    def sds(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if cell.step in ("train", "prefill"):
        if cfg.is_encdec:
            return {"batch": {
                "enc_embeddings": sds((b, s, cfg.d_model), f),
                "tokens": sds((b, s), i32)}}
        if cfg.frontend == "vision":
            batch = {"embeddings": sds((b, s, cfg.d_model), f)}
            if cell.step == "train":
                batch["labels"] = sds((b, s), i32)
            batch["positions"] = sds((3, b, s), i32)
            return {"batch": batch}
        return {"batch": {"tokens": sds((b, s), i32)}}

    # decode: one new token against a cache of s tokens
    return {"tokens": sds((b, 1), i32),
            "pos": sds((), i32)}


def field_config(app: str, encoding: str):
    from repro_torch.core.fields import make_field_config
    return make_field_config(app, encoding)
