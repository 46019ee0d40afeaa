"""Shared LM layers: norms, projections, embeddings, RoPE (incl. M-RoPE),
the JAX package's ``models/layers.py`` in plain PyTorch.

The rounding follows the JAX functions step for step, since it shows in
bf16: a norm's variance is an f32-accumulating reduction of the act-dtype
input (no f32 copy of ``x``) and its ``rsqrt`` is cast to the act dtype
before the multiply; the unembedding rounds both operands to bf16 and
accumulates in f32 whatever the act dtype; GELU is the tanh approximation
(``jax.nn.gelu``'s default); swiglu's SiLU stays in the act dtype."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import Boxed, KeyGen, normal_init, \
    scaled_init, zeros_init, ones_init


# ---------------------------------------------------------------- norms
def init_rmsnorm(kg: KeyGen, d: int, dtype=torch.float32,
                 axis_name: str = "embed", lead: Tuple[int, ...] = ()):
    return {"scale": Boxed(ones_init(kg(), lead + (d,), dtype),
                           (axis_name,))}


def sumsq_f32(x: torch.Tensor) -> torch.Tensor:
    """sum(x * x) over the last dim, accumulated in f32 without an f32
    copy of x (the reduction widens each element as it reads it)."""
    if x.dtype == torch.float32:
        return torch.einsum("...d,...d->...", x, x)
    n = torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32)
    return n * n


def rmsnorm(params, x, eps: float = 1e-6, sumsq=None, n=None):
    """``sumsq`` and ``n``: the f32 sum of squares and the width of the
    whole dim, when ``x`` is a position's slice of it (the SSM's gated
    norm under tensor parallelism: the group sums its slices' squares)."""
    if sumsq is None:
        sumsq, n = sumsq_f32(x), x.shape[-1]
    var = (sumsq / n)[..., None]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def init_layernorm(kg: KeyGen, d: int, dtype=torch.float32,
                   lead: Tuple[int, ...] = ()):
    return {"scale": Boxed(ones_init(kg(), lead + (d,), dtype), ("embed",)),
            "bias": Boxed(zeros_init(kg(), lead + (d,), dtype), ("embed",))}


def layernorm(params, x, eps: float = 1e-5):
    n = x.shape[-1]
    mu = (x.sum(-1, dtype=torch.float32) / n)[..., None]
    ex2 = (sumsq_f32(x) / n)[..., None]
    var = ex2 - mu * mu
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def head_rmsnorm(scale, x, eps: float = 1e-6):
    """qk-norm: RMSNorm over the head_dim of (B, S, H, hd)."""
    var = (sumsq_f32(x) / x.shape[-1])[..., None]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


# ---------------------------------------------------------------- linear
def init_linear(kg: KeyGen, d_in: int, d_out: int, axes,
                dtype=torch.float32, bias: bool = False, bias_axes=None,
                lead: Tuple[int, ...] = ()):
    p = {"w": Boxed(scaled_init(kg(), lead + (d_in, d_out), dtype=dtype,
                                fan_in=d_in), tuple(axes))}
    if bias:
        p["b"] = Boxed(zeros_init(kg(), lead + (d_out,), dtype),
                       tuple(bias_axes or (axes[-1],)))
    return p


class _F32Out(torch.autograd.Function):
    """(N, k) @ (k, M) of bf16 operands -> (N, M) f32 on the card: one bf16
    GEMM with an f32 output (``torch.mm(out_dtype=)``, which has no
    autograd formula of its own). The backward's two products are bf16
    GEMMs summing in f32, with the f32 cotangent rounded to bf16 first, as
    the JAX reference's default-precision products on a TPU round it; the
    CPU path keeps it in f32."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gb = g.to(x2.dtype)
        gx = torch.mm(gb, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x2.t(), gb) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x, w):
    """``x @ w`` summed and returned in f32 (``w`` in ``x``'s dtype): a
    position's term of a row-parallel product, rounded to the act dtype
    only after the tensor-parallel group's sum. bf16 operands on the card
    (and on meta tensors, for the dry run's count) are one GEMM with an f32
    output (``_F32Out``); the CPU widens them (the same products)."""
    if x.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda or x2.is_meta:
        out = _F32Out.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def linear(params, x, act_dtype=None):
    w = params["w"]
    if act_dtype is not None:
        w = w.to(act_dtype)
        x = x.to(act_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------- embedding
def init_embedding(kg: KeyGen, vocab: int, d: int, dtype=torch.float32):
    return {"table": Boxed(normal_init(kg(), (vocab, d), dtype=dtype),
                           ("vocab", "embed"))}


def embed(params, ids, act_dtype):
    return params["table"][ids].to(act_dtype)


def embed_tp(tp, tables, ids, act_dtype, vocab: int, sp: bool = False):
    """The embedding on a tensor-parallel group (``parallel/collectives.
    Group``): ``tables`` each running rank's rows of the (vocab, embed)
    table, ``ids`` its copy of the (B, S) ids. Vocab-parallel when the
    rows split: each rank looks up the ids in its rows, zero elsewhere,
    and the group sums (exact: one term is not zero); with ``sp`` each
    rank keeps its slice of the sequence. A whole table is looked up on
    every rank."""
    from repro_torch.parallel import collectives as coll
    rows = tables[0].shape[0]
    if rows == vocab:
        if sp:
            n = ids[0].shape[1] // tp.size
            ids = [i[:, r * n:(r + 1) * n] for r, i in zip(tp.ranks, ids)]
        return [embed({"table": t}, i, act_dtype)
                for t, i in zip(tables, ids)]
    parts = []
    for r, t, i in zip(tp.ranks, tables, ids):
        local = i - r * rows
        mine = (local >= 0) & (local < rows)
        e = t[local.clamp(0, rows - 1)].to(act_dtype)
        parts.append(torch.where(mine[..., None], e,
                                 torch.zeros((), dtype=act_dtype,
                                             device=e.device)))
    return (coll.reduce_scatter(tp, parts, 1) if sp
            else coll.all_reduce(tp, parts))


def unembed(params, x):
    """Logits against the (vocab, embed) table; f32 for the softmax. Both
    operands are rounded to bf16 and the products summed in f32, as the
    JAX function's bf16 einsum with an f32 result: on the card one bf16
    GEMM with an f32 output (``_F32Out``; on meta tensors too, so the dry
    run counts the card's product), on the CPU the same bf16 values
    widened."""
    table = params["table"].to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    x2 = xb.reshape(-1, xb.shape[-1])
    if x2.is_cuda or x2.is_meta:
        out = _F32Out.apply(x2, table.t())
    else:
        out = x2.float() @ table.float().t()
    return out.reshape(x.shape[:-1] + (table.shape[0],))


def unembed_tp(tp, tables, xs, vocab: int):
    """Logits on a tensor-parallel group: each rank's vocab columns of the
    logits (:func:`unembed` against its rows of the table), gathered whole
    on every rank; a whole table gives every rank the whole logits."""
    from repro_torch.parallel import collectives as coll
    parts = [unembed({"table": t}, x) for t, x in zip(tables, xs)]
    if tables[0].shape[0] == vocab:
        return parts
    return coll.all_gather(tp, parts, -1)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x (half-split layout)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    return _rotate(x, ang)


def apply_m_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, B, S) = (t, h, w) ids;
    the hd/2 frequency slots are partitioned into ``sections`` groups, each
    rotated by its own positional stream."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)
    angs = []
    start = 0
    for s, sec in enumerate(sections):
        f = freqs[start:start + sec]
        angs.append(positions[s][..., None].float() * f)
        start += sec
    return _rotate(x, torch.cat(angs, dim=-1))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper encoder's fixed sinusoidal embedding (S, d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    # -log(10000) / d in f32, as the JAX function computes it
    rate = -torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                   device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * rate)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------- FFNs
def init_swiglu(kg: KeyGen, d: int, d_ff: int, dtype=torch.float32,
                lead: Tuple[int, ...] = ()):
    return {
        "w_gate": Boxed(scaled_init(kg(), lead + (d, d_ff), dtype=dtype,
                                    fan_in=d), ("embed", "mlp")),
        "w_up": Boxed(scaled_init(kg(), lead + (d, d_ff), dtype=dtype,
                                  fan_in=d), ("embed", "mlp")),
        "w_down": Boxed(scaled_init(kg(), lead + (d_ff, d), dtype=dtype,
                                    fan_in=d_ff), ("mlp", "embed")),
    }


def swiglu(params, x, sharder=None, partial: bool = False):
    """``partial``: ``params`` are a position's ``mlp`` columns (rows of
    ``w_down``) and the result is its f32 term of the group's sum
    (:func:`matmul_f32`)."""
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    # silu stays in the activation dtype, as in the JAX function
    h = F.silu(g) * u
    if sharder is not None:
        h = sharder(h, "batch", "act_seq", "act_mlp")
    if partial:
        return matmul_f32(h, params["w_down"].to(dt))
    return h @ params["w_down"].to(dt)


def init_gelu_mlp(kg: KeyGen, d: int, d_ff: int, dtype=torch.float32,
                  lead: Tuple[int, ...] = ()):
    return {
        "w_up": Boxed(scaled_init(kg(), lead + (d, d_ff), dtype=dtype,
                                  fan_in=d), ("embed", "mlp")),
        "b_up": Boxed(zeros_init(kg(), lead + (d_ff,), dtype), ("mlp",)),
        "w_down": Boxed(scaled_init(kg(), lead + (d_ff, d), dtype=dtype,
                                    fan_in=d_ff), ("mlp", "embed")),
        "b_down": Boxed(zeros_init(kg(), lead + (d,), dtype), ("embed",)),
    }


def gelu_mlp(params, x, sharder=None, partial: bool = False):
    """``partial`` as in :func:`swiglu`, without ``b_down``: the caller
    adds it once, after the group's sum."""
    dt = x.dtype
    h = x @ params["w_up"].to(dt) + params["b_up"].to(dt)
    h = F.gelu(h, approximate="tanh")
    if sharder is not None:
        h = sharder(h, "batch", "act_seq", "act_mlp")
    if partial:
        return matmul_f32(h, params["w_down"].to(dt))
    return h @ params["w_down"].to(dt) + params["b_down"].to(dt)
