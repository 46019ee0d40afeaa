"""Mixture-of-Experts FFN with top-k token-choice routing (qwen3-moe,
olmoe, jamba), the JAX package's ``models/moe.py`` in plain PyTorch.

Dispatch is grouped gather/scatter: tokens split into independent groups
of ``moe_group_size``; within a group each (token, k) assignment takes a
slot in its expert's capacity ``moe_capacity`` from a cumsum over the
group's flat (token, k) order, so the assignments past capacity drop
exactly as in the JAX function; tokens scatter into a (G, E, C, d) buffer
(``index_put_`` with accumulation, the JAX scatter-add), the experts run
as batched products, and the results gather back weighted by the router's
renormalised top-k probabilities. The expert SiLU runs in f32 and is cast
back to the act dtype, as in the JAX function.

``torch.topk`` and ``jax.lax.top_k`` may order exactly tied router
probabilities differently; random f32 weights make ties rare, and the
tests check that their inputs have none.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import Boxed, KeyGen, scaled_init
from repro_torch.models.config import ModelConfig, MoEConfig


def init_moe(kg: KeyGen, cfg: ModelConfig, lead: Tuple[int, ...] = ()
             ) -> Dict:
    m = cfg.moe
    d, e, h = cfg.d_model, m.n_experts, m.d_expert
    dt = cfg.pdtype
    return {
        "router": Boxed(scaled_init(kg(), lead + (d, e), dtype=dt, fan_in=d),
                        ("embed", "expert")),
        "w_gate": Boxed(scaled_init(kg(), lead + (e, d, h), dtype=dt,
                                    fan_in=d),
                        ("expert", "embed", "expert_mlp")),
        "w_up": Boxed(scaled_init(kg(), lead + (e, d, h), dtype=dt,
                                  fan_in=d),
                      ("expert", "embed", "expert_mlp")),
        "w_down": Boxed(scaled_init(kg(), lead + (e, h, d), dtype=dt,
                                    fan_in=h),
                        ("expert", "expert_mlp", "embed")),
    }


def moe_group_size(m: MoEConfig, n_tokens: int) -> int:
    """Largest group <= 4096 tokens that divides n (shapes are pow2)."""
    target = min(4096, n_tokens)
    return next(g for g in range(target, 0, -1) if n_tokens % g == 0)


def moe_capacity(m: MoEConfig, group_size: int) -> int:
    per = group_size * m.top_k / m.n_experts
    return max(4, int(per * m.capacity_factor))


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (y (B, S, d), aux metrics as 0-d tensors)."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    gsz = moe_group_size(m, n)
    n_groups = n // gsz
    cap = moe_capacity(m, gsz)
    e, k = m.n_experts, m.top_k
    dt = x.dtype
    dev = x.device
    xt = x.reshape(n_groups, gsz, d)

    logits = (xt @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                    # (G, S, E)
    gate, expert_id = torch.topk(probs, k, dim=-1)           # (G, S, k)
    gate = gate / gate.sum(-1, keepdim=True)

    # dispatch: slot of each (token, k) in its expert, by a group-local
    # cumsum over the flat (token, k) order; past capacity -> dropped
    flat_expert = expert_id.reshape(n_groups, gsz * k)
    onehot = F.one_hot(flat_expert, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - 1
    flat_pos = torch.gather(pos, 2, flat_expert[..., None])[..., 0]
    keep = flat_pos < cap
    safe_pos = torch.where(keep, flat_pos, cap - 1)
    token_idx = torch.arange(gsz, device=dev).repeat_interleave(k)
    g_idx = torch.arange(n_groups, device=dev)[:, None].expand(
        n_groups, gsz * k)
    src = torch.where(keep[..., None], xt[:, token_idx],
                      torch.zeros((), dtype=dt, device=dev))
    buf = torch.zeros((n_groups, e, cap, d), dtype=dt, device=dev)
    buf.index_put_((g_idx, flat_expert, safe_pos), src, accumulate=True)

    # batched expert FFN (SwiGLU), one product per expert
    g_ = torch.einsum("gecd,edh->gech", buf, params["w_gate"].to(dt))
    u_ = torch.einsum("gecd,edh->gech", buf, params["w_up"].to(dt))
    h_ = F.silu(g_.float()).to(dt) * u_
    out = torch.einsum("gech,ehd->gecd", h_, params["w_down"].to(dt))

    # combine: each token's k picks, weighted, summed in k order
    picked = out[g_idx, flat_expert, safe_pos]               # (G, S*k, d)
    picked = torch.where(keep[..., None], picked,
                         torch.zeros((), dtype=dt, device=dev))
    weighted = picked * gate.reshape(n_groups, gsz * k, 1).to(dt)
    y = weighted.reshape(n_groups, gsz, k, d).sum(2)

    density = F.one_hot(expert_id, e).float().mean(dim=(0, 1, 2))
    router_mean = probs.mean(dim=(0, 1))
    aux = {
        "moe_aux_loss": e * torch.sum(density * router_mean),
        "moe_drop_frac": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d), aux
