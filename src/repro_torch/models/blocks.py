"""Decoder blocks: (attn | ssm) mixer + (dense | moe | none) FFN, the JAX
package's ``models/blocks.py`` in plain PyTorch.

Heterogeneous stacks (jamba) are grouped into repeating *periods*: the
layer pattern within a period is static structure, and the model loops
over periods with each sub-layer's parameters stacked over them.

``apply_block_tp`` (training), ``prefill_block_tp`` and
``decode_block_tp`` (serving) are the blocks of a tensor-parallel group (``parallel/collectives.Group``): lists with one
entry per running rank of the group (params, residual stream, caches),
each rank's params its own slice (``parallel/api``). A mixer or FFN whose
split dim (heads, SSM heads, ``mlp``, experts) divides over the group
runs each rank's part and sums the f32 terms across the group; one whose
dim fell back runs whole on every rank. With ``sp`` (sequence
parallelism: the rules put 'act_seq' on 'model' and the prompt divides)
the residual stream between blocks is each rank's slice of the sequence:
gathered whole after each norm, and the sum scattered back in place of
the all-reduce."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common.param import KeyGen
from repro_torch.models import attention, layers, moe as moe_lib, \
    ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll


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


# ------------------------------------------------------ tensor parallelism
def mix_into(tp, xs, parts, partial: bool, sp: bool, biases=None):
    """The residual stream ``xs`` plus a mixer's or FFN's output: the
    group's sum of the f32 terms ``parts`` (``partial``; scattered along
    the sequence under ``sp``), or each rank's whole output (its own
    sequence slice under ``sp``), rounded to the stream's dtype, then
    ``biases`` (one per rank) added."""
    if partial:
        parts = (coll.reduce_scatter(tp, parts, 1) if sp
                 else coll.all_reduce(tp, parts))
    elif sp:
        n = xs[0].shape[1]
        parts = [y.narrow(1, r * n, n) for r, y in zip(tp.ranks, parts)]
    out = []
    for i, (x, y) in enumerate(zip(xs, parts)):
        y = y.to(x.dtype)
        if biases is not None:
            y = y + biases[i].to(x.dtype)
        out.append(x + y)
    return out


def whole_seq(tp, hs, sp: bool):
    """Each rank's normed stream whole along the sequence."""
    return coll.all_gather(tp, hs, 1) if sp else hs


def _heads_tp(cfg: ModelConfig, ps, name: str):
    """(the ranks' query heads, KV heads, True when the heads split)."""
    wq, wk = ps[0][name]["wq"], ps[0][name]["wk"]
    return wq.shape[1], wk.shape[1], wq.shape[1] < cfg.n_heads


def _ssm_tp(tp, ps, cfg, hs, caches=None):
    """Each rank's SSM heads (prefill, or decode with ``caches``): the
    gated norm over the whole d_inner takes the group's sum of squares."""
    partial = ps[0]["ssm"]["A_log"].shape[-1] < cfg.ssm.n_heads(cfg.d_model)
    inner, states = [], []
    for i, (p, h) in enumerate(zip(ps, hs)):
        if caches is None:
            y, z, st, conv = ssm_lib.ssm_inner(p["ssm"], cfg, h)
            states.append((st, conv))
        else:
            y, z = ssm_lib.decode_inner(p["ssm"], cfg, h, caches[i])
        inner.append((y, z))
    sumsq = None
    if partial:
        sumsq = coll.all_reduce(tp, [layers.sumsq_f32(y) for y, _ in inner])
    parts = [ssm_lib.ssm_out(p["ssm"], cfg, y, z,
                             sumsq=None if sumsq is None else sumsq[i],
                             partial=partial)
             for i, (p, (y, z)) in enumerate(zip(ps, inner))]
    return parts, partial, states


def ffn_tp(tp, ps, cfg: ModelConfig, layer_idx: int, xs, sp: bool,
           sharder=None):
    """The block's FFN half on the group (``mlp`` column/row-parallel, the
    MoE's experts split): (the new residual stream, the MoE's aux of the
    first running rank). The router logits are gathered whole on every
    rank, so every rank forms the same load-balance term; its gradient
    reaches each rank's router columns through the gather's backward."""
    ffn = cfg.ffn_kind(layer_idx)
    if ffn == "none":
        return xs, {}
    hs = whole_seq(tp, [layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
                        for p, x in zip(ps, xs)], sp)
    if ffn == "moe":
        e_local = ps[0]["moe"]["w_gate"].shape[0]
        partial = e_local < cfg.moe.n_experts
        logits = [(h.reshape(-1, h.shape[-1])
                   @ p["moe"]["router"].to(h.dtype)).float()
                  for p, h in zip(ps, hs)]
        if partial:
            logits = coll.all_gather(tp, logits, -1)
        outs = [moe_lib.apply_moe(p["moe"], cfg, h, sharder=sharder,
                                  logits=lg, first_expert=r * e_local,
                                  partial=partial)
                for r, p, h, lg in zip(tp.ranks, ps, hs, logits)]
        parts, aux = [y for y, _ in outs], outs[0][1]
    else:
        partial = ps[0]["mlp"]["w_gate"].shape[-1] < cfg.d_ff
        parts = [layers.swiglu(p["mlp"], h, partial=partial)
                 for p, h in zip(ps, hs)]
        aux = {}
    return mix_into(tp, xs, parts, partial, sp), aux


def prefill_block_tp(tp, ps, cfg: ModelConfig, layer_idx: int, xs,
                     positions, caches, sp: bool, sharder=None,
                     kv_seq: bool = False):
    """:func:`prefill_block` on the group (the module docstring):
    ``positions`` and ``caches`` one per rank, each cache the rank's shard
    (``parallel/tp.cache_layout``: its chunk of the positions when
    ``kv_seq``, else its KV heads or all of them; its SSM heads), filled
    in place. Returns the new stream."""
    hs = whole_seq(tp, [layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
                        for p, x in zip(ps, xs)], sp)
    if cfg.layer_kind(layer_idx) == "attn" and kv_seq:
        partial = _heads_tp(cfg, ps, "attn")[2]
        parts = attention.prefill_seq_tp(tp, [p["attn"] for p in ps], cfg,
                                         hs, positions, caches, partial)
    elif cfg.layer_kind(layer_idx) == "attn":
        heads, kv_heads, partial = _heads_tp(cfg, ps, "attn")
        parts = [attention.prefill_into_cache(
            p["attn"], cfg, h, pos, cache,
            kv_sel=attention.kv_select(cfg, heads, kv_heads, r),
            partial=partial)[0]
            for r, p, h, pos, cache in zip(tp.ranks, ps, hs, positions,
                                           caches)]
    else:
        parts, partial, states = _ssm_tp(tp, ps, cfg, hs)
        for cache, (st, conv) in zip(caches, states):
            cache["ssm_state"].copy_(st)
            cache["conv_state"].copy_(conv)
    xs = mix_into(tp, xs, parts, partial, sp)
    return ffn_tp(tp, ps, cfg, layer_idx, xs, sp, sharder)[0]


def apply_block_tp(tp, ps, cfg: ModelConfig, layer_idx: int, xs,
                   positions, sp: bool, sharder=None):
    """:func:`apply_block` on the group: :func:`prefill_block_tp` without a
    cache (each rank's heads through ``attention.attend_full``, its SSM
    heads without states). Returns (the new stream, the first running
    rank's aux)."""
    hs = whole_seq(tp, [layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
                        for p, x in zip(ps, xs)], sp)
    if cfg.layer_kind(layer_idx) == "attn":
        heads, kv_heads, partial = _heads_tp(cfg, ps, "attn")
        parts = [attention.attend_full(
            p["attn"], cfg, h, pos,
            kv_sel=attention.kv_select(cfg, heads, kv_heads, r),
            partial=partial)
            for r, p, h, pos in zip(tp.ranks, ps, hs, positions)]
    else:
        parts, partial, _ = _ssm_tp(tp, ps, cfg, hs)
    xs = mix_into(tp, xs, parts, partial, sp)
    return ffn_tp(tp, ps, cfg, layer_idx, xs, sp, sharder)


def decode_block_tp(tp, ps, cfg: ModelConfig, layer_idx: int, xs, pos: int,
                    caches, sharder=None, kv_seq: bool = False):
    """:func:`decode_block` on the group: one token, the stream whole on
    every rank (a sequence of one does not split); ``kv_seq`` as in
    :func:`prefill_block_tp`."""
    hs = [layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
          for p, x in zip(ps, xs)]
    if cfg.layer_kind(layer_idx) == "attn" and kv_seq:
        partial = _heads_tp(cfg, ps, "attn")[2]
        parts = attention.decode_seq_tp(tp, [p["attn"] for p in ps], cfg,
                                        hs, pos, caches, partial)
    elif cfg.layer_kind(layer_idx) == "attn":
        heads, kv_heads, partial = _heads_tp(cfg, ps, "attn")
        parts = [attention.decode_step_attn(
            p["attn"], cfg, h, pos, cache,
            kv_sel=attention.kv_select(cfg, heads, kv_heads, r),
            partial=partial)[0]
            for r, p, h, cache in zip(tp.ranks, ps, hs, caches)]
    else:
        parts, partial, _ = _ssm_tp(tp, ps, cfg, hs, caches)
    xs = mix_into(tp, xs, parts, partial, False)
    return ffn_tp(tp, ps, cfg, layer_idx, xs, False, sharder)[0]
