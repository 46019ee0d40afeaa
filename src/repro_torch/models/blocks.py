"""Decoder blocks: (attn | ssm) mixer + (dense | moe | none) FFN, the JAX
package's ``models/blocks.py`` in plain PyTorch.

Heterogeneous stacks (jamba) are grouped into repeating *periods*: the
layer pattern within a period is static structure, and the model loops
over periods with each sub-layer's parameters stacked over them."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common.param import KeyGen
from repro_torch.models import attention, layers, moe as moe_lib, \
    ssm as ssm_lib
from repro_torch.models.config import ModelConfig


def block_period(cfg: ModelConfig) -> int:
    """Smallest repeating pattern of (mixer, ffn) kinds."""
    p = 1
    if cfg.attn_every:
        p = cfg.attn_every
    if cfg.moe is not None and cfg.moe.every > 1:
        p = math.lcm(p, cfg.moe.every)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def init_block(kg: KeyGen, cfg: ModelConfig, layer_idx: int,
               lead: Tuple[int, ...] = ()) -> Dict:
    """One block's params; ``lead`` stacks every leaf (the periods)."""
    kind = cfg.layer_kind(layer_idx)
    ffn = cfg.ffn_kind(layer_idx)
    p: Dict = {"norm1": layers.init_rmsnorm(kg, cfg.d_model, cfg.pdtype,
                                            lead=lead)}
    if kind == "attn":
        p["attn"] = attention.init_attention(kg, cfg, lead=lead)
    else:
        p["ssm"] = ssm_lib.init_ssm(kg, cfg, lead=lead)
    if ffn != "none":
        p["norm2"] = layers.init_rmsnorm(kg, cfg.d_model, cfg.pdtype,
                                         lead=lead)
        if ffn == "moe":
            p["moe"] = moe_lib.init_moe(kg, cfg, lead=lead)
        else:
            p["mlp"] = layers.init_swiglu(kg, cfg.d_model, cfg.d_ff,
                                          cfg.pdtype, lead=lead)
    return p


def _ffn(params, cfg: ModelConfig, layer_idx: int, x, sharder=None):
    """The block's FFN half: (x, aux)."""
    ffn = cfg.ffn_kind(layer_idx)
    if ffn == "none":
        return x, {}
    h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_lib.apply_moe(params["moe"], cfg, h, sharder=sharder)
    else:
        y, aux = layers.swiglu(params["mlp"], h, sharder=sharder), {}
    return x + y, aux


def apply_block(params, cfg: ModelConfig, layer_idx: int, x, positions,
                sharder=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence block. Returns (x, aux)."""
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if cfg.layer_kind(layer_idx) == "attn":
        mix = attention.attend_full(params["attn"], cfg, h, positions,
                                    sharder=sharder)
    else:
        mix = ssm_lib.apply_ssm(params["ssm"], cfg, h, sharder=sharder)
    x, aux = _ffn(params, cfg, layer_idx, x + mix, sharder=sharder)
    if sharder is not None:
        x = sharder(x, "batch", "act_seq", "act_embed")
    return x, aux


def init_block_cache(cfg: ModelConfig, layer_idx: int, batch: int,
                     capacity: int, device=None,
                     lead: Tuple[int, ...] = ()) -> Dict:
    if cfg.layer_kind(layer_idx) == "attn":
        ring = cfg.swa_window is not None
        return attention.init_kv_cache(cfg, batch, capacity, ring,
                                       device=device, lead=lead)
    return ssm_lib.init_ssm_cache(cfg, batch, device=device, lead=lead)


def block_cache_axes(cfg: ModelConfig, layer_idx: int) -> Dict:
    if cfg.layer_kind(layer_idx) == "attn":
        return attention.cache_logical_axes()
    return ssm_lib.ssm_cache_logical_axes()


def prefill_block(params, cfg: ModelConfig, layer_idx: int, x, positions,
                  cache, sharder=None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence block that fills its ``cache`` in place."""
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if cfg.layer_kind(layer_idx) == "attn":
        mix, cache = attention.prefill_into_cache(
            params["attn"], cfg, h, positions, cache, sharder=sharder)
    else:
        mix, st = ssm_lib.apply_ssm(params["ssm"], cfg, h, sharder=sharder,
                                    return_state=True)
        cache["ssm_state"].copy_(st["ssm_state"])
        cache["conv_state"].copy_(st["conv_state"])
    x, _ = _ffn(params, cfg, layer_idx, x + mix, sharder=sharder)
    return x, cache


def decode_block(params, cfg: ModelConfig, layer_idx: int, x, pos: int,
                 cache, sharder=None) -> Tuple[torch.Tensor, Dict]:
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps)
    if cfg.layer_kind(layer_idx) == "attn":
        mix, cache = attention.decode_step_attn(
            params["attn"], cfg, h, pos, cache, sharder=sharder)
    else:
        mix, cache = ssm_lib.decode_step_ssm(params["ssm"], cfg, h, cache)
    x, _ = _ffn(params, cfg, layer_idx, x + mix, sharder=sharder)
    return x, cache
