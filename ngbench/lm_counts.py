"""Counted FLOPs of a language-model training step, from a configuration
file's keys (the published config.json names) and never from the
program: the yardstick of ``lm_train_mfu_pct``.

A layer's forward FLOPs a token, two a multiply-add:

* Mamba-2 (``mamba``): the input projection ``2 d (2 d_in + 2 g n + H)``,
  the depthwise conv ``2 K (d_in + 2 g n)``, the SSD scan as the chunked
  algorithm needs it (``ssd_flops``: the chunk's C B^T scores, their
  product with x, each chunk's state and the states' product with C) and
  the output projection ``2 d_in d``;
* attention (``attention``): the q, k, v and o projections and, causal,
  the scores and their product with v over the keys a query sees, S/2 on
  average (``4 (S/2) H hd``);
* the experts (``experts``): the router ``2 d E``, the held experts'
  SwiGLUs (``6 d f`` each) for the picks a token makes among them on
  average, ``k * held / E`` (uniform routing), and the shared SwiGLU
  ``6 d f_shared``;
* the logits ``2 d V`` a position.

A step is three times its forward (the backward's two products for each
of the forward's one): the model's FLOPs. The backward's recompute of
each block (``remat="full"``) is work the step does, not FLOPs the model
needs, and is not counted; nor are the norms, activations and Adam.

``H100_BF16_PEAK``: 989.4 TFLOP/s, the dense BF16 tensor-core rate of one
NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet, SXM5 part,
"BF16 Tensor Core 1,979 teraFLOPS" with sparsity, half of it dense), at
the full 700 W power limit.
"""
from __future__ import annotations

from typing import Dict

H100_BF16_PEAK = 989.4e12          # FLOP/s, dense BF16 (module docstring)


def ssd_flops(cfg: Dict) -> float:
    """A token's SSD FLOPs in one Mamba-2 layer, chunk ``Q``: scores
    ``2 Q g n``, scores times x ``2 Q H P``, the chunk's state ``2 H P n``
    and the state's product with C ``2 H P n``."""
    q = cfg["mamba_chunk_size"]
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return 2 * q * g * n + 2 * q * h * p + 4 * h * p * n


def mamba(cfg: Dict) -> float:
    d = cfg["hidden_size"]
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    gn = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    d_in = h * p
    return (2 * d * (2 * d_in + 2 * gn + h)
            + 2 * cfg["mamba_d_conv"] * (d_in + 2 * gn)
            + ssd_flops(cfg) + 2 * d_in * d)


def attention(cfg: Dict, seq: int) -> float:
    d = cfg["hidden_size"]
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // nq
    proj = 2 * d * (2 * nq * hd + 2 * nkv * hd)
    return proj + 4 * (seq / 2) * nq * hd


def experts(cfg: Dict) -> float:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    e, k = cfg["experts_routed"], cfg["num_experts_per_tok"]
    picks = k * cfg["num_local_experts"] / e
    return (2 * d * e + picks * 6 * d * f
            + 6 * d * cfg["shared_intermediate_size"])


def logits(cfg: Dict) -> float:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def forward_per_token(cfg: Dict, seq: int) -> Dict[str, float]:
    """A token's forward FLOPs by part: ``mamba``, ``attention``,
    ``experts`` (every layer's), ``logits``."""
    kinds = cfg["layer_types"]
    return {"mamba": sum(mamba(cfg) for t in kinds if t == "mamba"),
            "attention": sum(attention(cfg, seq) for t in kinds
                             if t == "attention"),
            "experts": len(kinds) * experts(cfg),
            "logits": logits(cfg)}


def train_step_flops(cfg: Dict, rows: int, seq: int) -> float:
    """A step's model FLOPs: three times the forward of ``rows`` x
    ``seq`` tokens."""
    return 3 * rows * seq * sum(forward_per_token(cfg, seq).values())


def compute_time_s(flops: float) -> float:
    """The least time of ``flops`` at the BF16 peak."""
    return flops / H100_BF16_PEAK
