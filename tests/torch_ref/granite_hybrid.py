"""Plain reference of granite-4.0-h-small, the hybrid Mamba-2 / attention
LM with a mixture of experts on every layer: its forward pass and its
training loss in plain ``torch`` float32, written from the published
config (https://huggingface.co/ibm-granite/granite-4.0-h-small,
config.json) and the Mamba-2 paper (arXiv:2405.21060). Gradients come from
autograd on it. It imports nothing of the system it checks.

The model, layer by layer (``cfg`` holds the config.json keys):

* the embedding times ``embedding_multiplier``;
* each layer ``x += r * mixer(rmsnorm(x))``, then ``x += r *
  (moe(h) + shared(h))`` with ``h = rmsnorm(x)`` and ``r`` the
  ``residual_multiplier``; the mixer is Mamba-2 or, where ``layer_types``
  says so, attention;
* Mamba-2: one input projection to ``[z, xBC, dt]``, a depthwise causal
  conv of width ``mamba_d_conv`` with bias and SiLU over ``xBC``, ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD scan over chunks
  of ``mamba_chunk_size`` (the paper's minimal chunked listing: the
  diagonal blocks by a masked segment sum, the states between chunks by a
  segment sum over chunk ends), ``y + D x``, the gated norm
  ``rmsnorm(y * silu(z))`` and the output projection;
* attention: grouped queries without positional encoding, the scores
  times ``attention_multiplier``, causal softmax, one query block at a
  time;
* the experts: the router's softmax over all ``experts_routed`` logits,
  the top ``num_experts_per_tok``, renormalised (the softmax over the
  picked logits), each held expert a SwiGLU of width
  ``intermediate_size`` run on every token and weighted by its gate (0
  where it was not picked: a dense mask, no capacity, nothing dropped);
  the shared SwiGLU of width ``shared_intermediate_size`` on every token;
* the final norm, the tied unembedding, the logits over
  ``logits_scaling``; the mean next-token cross entropy.

Departures from the published model, each stated:

* One device's share of an expert-parallel layer: the router keeps all
  ``experts_routed`` outputs and its top-k, but only the
  ``num_local_experts`` experts from ``first_expert_held`` on are held;
  the picks of the others are another device's part and are left out
  (the partial sum goes on to the next layer).
* The training loss adds the load-balance term ``router_aux_loss_coef``
  times the mean over the layers of ``E sum_e density_e mean_e(p)`` (the
  picks' share of each expert, no gradient, times its mean router
  probability); the config gives no coefficient.
* The weights are random, from a seed; the published ones are not used.

``loss`` takes ``density`` to be computed in row blocks: the load-balance
term of a batch uses the whole batch's pick counts (``pick_counts``, a
pass without gradients), and the cross entropy and the router means are
sums over rows over ``n_total`` tokens, so the rows' losses add up to the
batch's. The controls of a check are switches of ``loss``: ``shared``
(False leaves the shared expert out), ``drop_expert`` (one held expert's
picks left out) and ``round_fp8`` (the residual stream rounded to
float8 e4m3 after the embedding and after every layer, a precision below
the configuration's bfloat16).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0          # the largest float8 e4m3 (fn) value


def no_tf32() -> None:
    """Float32 products in float32 on the card, not in TF32 (every entry
    point sets it, through ``hidden``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------------------ Mamba-2
def segsum(a):
    """(..., T) -> (..., T, T): ``sum(a[j+1 .. i])`` at i >= j, -inf
    above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~keep, -math.inf)


def ssd(x, a, b, c, chunk: int):
    """The SSD scan of the Mamba-2 paper's minimal listing: ``x`` (B, S,
    H, P) already times dt, ``a`` (B, S, H) = A dt, ``b``, ``c`` (B, S, H,
    N). Returns y (B, S, H, P)."""
    bs, s, h, p = x.shape
    nc = s // chunk
    x, b, c = (t.reshape(bs, nc, chunk, *t.shape[2:]) for t in (x, b, c))
    a = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)      # (B, H, C, L)
    a_cum = torch.cumsum(a, dim=-1)
    # the diagonal blocks
    decay = torch.exp(segsum(a))                              # (B,H,C,L,L)
    scores = torch.einsum("bclhn,bcshn->bhcls", c, b) * decay
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, x)
    # each chunk's state, then the states between chunks
    to_end = torch.exp(a_cum[..., -1:] - a_cum)               # (B, H, C, L)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", b, to_end, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    between = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", between, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(bs, s, h, p)


def mamba(p: Dict, cfg: Dict, h):
    bs, s, _ = h.shape
    nh, hp = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    di = nh * hp
    zxbcdt = h @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    k = cfg["mamba_d_conv"]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :],
                    p["conv_b"], padding=k - 1, groups=xbc.shape[-1])
    xbc = F.silu(conv[..., :s].transpose(1, 2))
    x, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                        # (B, S, H)
    a = -torch.exp(p["A_log"])
    x = x.reshape(bs, s, nh, hp)
    b = b.reshape(bs, s, g, n).repeat_interleave(nh // g, dim=2)
    c = c.reshape(bs, s, g, n).repeat_interleave(nh // g, dim=2)
    # the scan is exact for any chunking: the largest that divides S
    chunk = max(size for size in range(1, min(cfg["mamba_chunk_size"], s) + 1)
                if s % size == 0)
    y = ssd(x * dt[..., None], a * dt, b, c, chunk)
    y = (y + p["D"][:, None] * x).reshape(bs, s, di)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return y @ p["out_proj"]


# ---------------------------------------------------------------- attention
def _attend_block(q, k, v, off: int, scale: float):
    """Queries from position ``off`` against every key, causal."""
    qb = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    qi = torch.arange(qb, device=q.device)[:, None] + off
    kj = torch.arange(k.shape[2], device=q.device)[None, :]
    scores = scores.masked_fill(kj > qi, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)


def attention(p: Dict, cfg: Dict, h, q_block: int = 1024):
    bs, s, _ = h.shape
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // nq
    q = (h @ p["q"]).reshape(bs, s, nq, hd).transpose(1, 2)
    k = (h @ p["k"]).reshape(bs, s, nkv, hd).transpose(1, 2)
    v = (h @ p["v"]).reshape(bs, s, nkv, hd).transpose(1, 2)
    k = k.repeat_interleave(nq // nkv, dim=1)
    v = v.repeat_interleave(nq // nkv, dim=1)
    outs = []
    for i in range(0, s, q_block):
        args = (q[:, :, i:i + q_block], k, v, i, cfg["attention_multiplier"])
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend_block(*args))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(bs, s, nq * hd)
    return out @ p["o"]


# ------------------------------------------------------------------ experts
def route(p: Dict, cfg: Dict, h):
    """(the router's probabilities (B, S, E), the picks (B, S, k), their
    renormalised weights)."""
    probs = torch.softmax(h @ p["router"], dim=-1)
    top, picks = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    return probs, picks, top / top.sum(-1, keepdim=True)


def experts(p: Dict, cfg: Dict, h, shared: bool = True,
            drop_expert: Optional[int] = None):
    """The held experts' weighted sum (a dense mask of the gates) plus the
    shared expert; returns (y, probs, picks)."""
    probs, picks, weights = route(p, cfg, h)
    gates = torch.zeros_like(probs).scatter(-1, picks, weights)
    first = cfg["first_expert_held"]
    y = torch.zeros_like(h)
    for j in range(cfg["num_local_experts"]):
        if j == drop_expert:
            continue
        out = swiglu(h, p["w_gate"][j], p["w_up"][j], p["w_down"][j])
        y = y + gates[..., first + j, None] * out
    if shared:
        y = y + swiglu(h, **p["shared"])
    return y, probs, picks


# -------------------------------------------------------------------- model
def _round_fp8(x):
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


def _layer(cfg: Dict, kind: str, switches: Dict, lp: Dict, x):
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = rmsnorm(x, lp["norm1"], eps)
    mix = mamba(lp["mamba"], cfg, h) if kind == "mamba" else \
        attention(lp["attn"], cfg, h)
    x = x + r * mix
    y, probs, picks = experts(lp["moe"], cfg, rmsnorm(x, lp["norm2"], eps),
                              switches["shared"], switches["drop_expert"])
    x = x + r * y
    if switches["round_fp8"]:
        x = _round_fp8(x)
    return x, probs, picks


def hidden(params: Dict, cfg: Dict, tokens, shared: bool = True,
           drop_expert: Optional[int] = None, round_fp8: bool = False,
           layer_checkpoint: bool = False):
    """The final-norm states (B, S, d) and each layer's (probs, picks)."""
    no_tf32()
    switches = {"shared": shared, "drop_expert": drop_expert,
                "round_fp8": round_fp8}
    x = params["embedding"][tokens] * cfg["embedding_multiplier"]
    if round_fp8:
        x = _round_fp8(x)
    routes = []
    for kind, lp in zip(cfg["layer_types"], params["layers"]):
        if layer_checkpoint and torch.is_grad_enabled():
            x, probs, picks = checkpoint(_layer, cfg, kind, switches, lp, x,
                                         use_reentrant=False)
        else:
            x, probs, picks = _layer(cfg, kind, switches, lp, x)
        routes.append((probs, picks))
    return rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"]), routes


def logits(params: Dict, cfg: Dict, tokens, **switches):
    x, _ = hidden(params, cfg, tokens, **switches)
    return x @ params["embedding"].t() / cfg["logits_scaling"]


def _ce_sum(table, x, labels, scaling: float):
    lg = x @ table.t() / scaling
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.sum(torch.logsumexp(lg, -1) - gold)


def pick_counts(params: Dict, cfg: Dict, tokens, **switches) -> List:
    """Each layer's picks of each routed expert, (E,) int64, without
    gradients."""
    with torch.no_grad():
        _, routes = hidden(params, cfg, tokens, **switches)
    e = cfg["experts_routed"]
    return [torch.bincount(picks.reshape(-1), minlength=e)
            for _, picks in routes]


def loss(params: Dict, cfg: Dict, tokens, labels, density=None,
         n_total: Optional[int] = None, seq_chunk: int = 1024,
         layer_checkpoint: bool = False, **switches):
    """The mean cross entropy plus the load-balance term (the module
    docstring); with ``density`` (each layer's pick shares over a whole
    batch of ``n_total`` tokens) the share of that batch's loss that these
    rows carry."""
    x, routes = hidden(params, cfg, tokens, layer_checkpoint=layer_checkpoint,
                       **switches)
    n = n_total or labels.numel()
    k, e = cfg["num_experts_per_tok"], cfg["experts_routed"]
    table = params["embedding"]
    ce = x.new_zeros(())
    for j in range(0, labels.shape[1], seq_chunk):
        args = (table, x[:, j:j + seq_chunk], labels[:, j:j + seq_chunk],
                cfg["logits_scaling"])
        ce = ce + (checkpoint(_ce_sum, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _ce_sum(*args))
    aux = x.new_zeros(())
    for l, (probs, picks) in enumerate(routes):
        if density is None:
            dens = torch.bincount(picks.reshape(-1), minlength=e).to(
                probs.dtype) / (picks.numel())
        else:
            dens = density[l]
        aux = aux + e * torch.sum(dens * probs.reshape(-1, e).sum(0)) / n
    coef = cfg["router_aux_loss_coef"] / len(routes)
    return ce / n + coef * aux
