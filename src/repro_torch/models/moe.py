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


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor, sharder=None,
              logits=None, first_expert: int = 0, partial: bool = False
              ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (y (B, S, d), aux metrics as 0-d tensors).

    Expert parallelism (``models/blocks``): ``params`` hold a position's
    experts, from ``first_expert`` on, ``logits`` are the router's (n, E)
    f32 logits of every expert (the group gathers its column-parallel
    pieces), and with ``partial`` the result is the position's f32 term of
    the group's sum: its experts' picks, weighted, summed over k. Routing,
    capacity and slots are the whole group's, on every position.

    On a sharded step (``sharder.rows`` set) ``x`` is one row of the
    step's batch: the token groups, their capacity and each assignment's
    slot are those of the whole batch, the slots continuing the counts of
    the rows before (``parallel/sharded.RowContext``), so every token
    takes the slot the JAX step's global cumsum gives it; the row's
    partial sums of the load-balance loss go to the context."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    rows = sharder.rows if sharder is not None else None
    n_rows, row = (rows.n_rows, sharder.row) if rows is not None else (1, 0)
    gsz = moe_group_size(m, n * n_rows)
    cap = moe_capacity(m, gsz)
    e, k = m.n_experts, m.top_k
    dt = x.dtype
    dev = x.device
    off = row * n                       # the row's first token in the batch
    g0 = off // gsz
    n_groups = (off + n - 1) // gsz - g0 + 1
    xt = x.reshape(n, d)
    if sharder is not None:
        # groups shard over the batch axes (a hint: no effect on values)
        sharder(xt.reshape(n_groups, n // n_groups, d)
                if n % n_groups == 0 else xt[None], "batch", None, None)

    if logits is None:
        logits = (xt @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                    # (n, E)
    gate, expert_id = torch.topk(probs, k, dim=-1)           # (n, k)
    gate = gate / gate.sum(-1, keepdim=True)

    # dispatch: the slot of each (token, k) in its expert is its group's
    # running count over the flat (token, k) order; past capacity ->
    # dropped. One cumsum over the row, less each group's count at its
    # start, plus the group's count in the rows before
    flat_expert = expert_id.reshape(n * k)
    onehot = F.one_hot(flat_expert, e).to(torch.int64)       # (n*k, E)
    csum = torch.cumsum(onehot, dim=0)
    token_idx = torch.arange(n, device=dev).repeat_interleave(k)
    flat_group = ((off + token_idx) // gsz - g0)             # local group
    starts = [max(0, (g0 + g) * gsz - off) * k for g in range(n_groups)]
    base = torch.stack([csum[j - 1] if j > 0 else torch.zeros_like(csum[0])
                        for j in starts])                    # (G, E)
    if rows is not None:
        prefix, first = rows.start(sharder.layer, row, n * n_rows // gsz,
                                   e, dev)
        base = base - prefix[g0:g0 + n_groups]
    pos = csum - 1 - base[flat_group]
    flat_pos = torch.gather(pos, 1, flat_expert[:, None])[:, 0]
    keep = flat_pos < cap
    safe_pos = torch.where(keep, flat_pos, cap - 1)
    # the position's experts: the rest of the assignments are others'
    e_local = params["w_gate"].shape[0]
    local_expert, mine = flat_expert, keep
    if e_local < e:
        local_expert = flat_expert - first_expert
        mine = keep & (local_expert >= 0) & (local_expert < e_local)
        local_expert = local_expert.clamp(0, e_local - 1)
    src = torch.where(mine[:, None], xt[token_idx],
                      torch.zeros((), dtype=dt, device=dev))
    buf = torch.zeros((n_groups, e_local, cap, d), dtype=dt, device=dev)
    buf.index_put_((flat_group, local_expert, safe_pos), src,
                   accumulate=True)
    if sharder is not None:   # (G, E, C, d): the token -> expert a2a
        buf = sharder(buf, "batch", "act_expert", None, None)

    # batched expert FFN (SwiGLU), one product per expert
    g_ = torch.einsum("gecd,edh->gech", buf, params["w_gate"].to(dt))
    u_ = torch.einsum("gecd,edh->gech", buf, params["w_up"].to(dt))
    h_ = F.silu(g_.float()).to(dt) * u_
    out = torch.einsum("gech,ehd->gecd", h_, params["w_down"].to(dt))
    if sharder is not None:   # expert -> token a2a back
        out = sharder(out, "batch", "act_expert", None, None)

    # combine: each token's k picks, weighted, summed in k order
    picked = out[flat_group, local_expert, safe_pos]         # (n*k, d)
    picked = torch.where(mine[:, None], picked,
                         torch.zeros((), dtype=dt, device=dev))
    weighted = picked * gate.reshape(n * k, 1).to(dt)
    # a partial term stays f32 for the group's sum
    y = weighted.reshape(n, k, d)
    y = y.float().sum(1) if partial else y.sum(1)

    counts = onehot.sum(0)
    density = counts.float() / (n * k)
    router_mean = probs.mean(dim=0)
    aux = {
        "moe_aux_loss": e * torch.sum(density * router_mean),
        "moe_drop_frac": 1.0 - keep.float().mean(),
    }
    if rows is not None and first:
        by_group = torch.zeros((n * n_rows // gsz, e), dtype=torch.int64,
                               device=dev)
        by_group.index_add_(0, flat_group + g0, onehot)
        rows.finish(sharder.layer, row, by_group, {
            "counts": counts, "router_sum": probs.sum(0),
            "kept": keep.sum(), "tokens": n})
    return y.reshape(b, s, d), aux
