"""Mamba-2 (SSD, state-space duality) blocks, the JAX package's
``models/ssm.py`` in plain PyTorch.

Prefill: chunked SSD, an intra-chunk quadratic term of products and an
inter-chunk state recurrence, the latter a Python loop over chunks (the
JAX ``lax.scan``) carrying the (B, H, P, N) state. Decode: the O(1)
recurrent update, its state kept in the act dtype between steps.

The segment sums above the diagonal are not used, and their ``exp`` can
overflow once training grows ``dt``: the port sets them to -inf before
the ``exp``, which gives 0 there. The JAX function exponentiates, then
selects with ``where``: the same forward values, but in its backward an
overflowed ``exp`` times its zero cotangent is NaN (it turns mamba2-2.7b's
full-width training to NaN within 10 steps on the H100); the port's
gradient is JAX's wherever JAX's is finite. ``apply_ssm`` runs the largest chunk up to
``cfg.ssm.chunk`` that divides the sequence, so a prime prompt length
falls to chunk 1, a loop of one step per token: serve prompt lengths that
divide by the chunk.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.param import Boxed, KeyGen, normal_init, \
    scaled_init
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_ssm(kg: KeyGen, cfg: ModelConfig, lead: Tuple[int, ...] = ()
             ) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    g = s.n_groups * s.d_state
    conv_dim = di + 2 * g
    dt = cfg.pdtype
    dev = kg.device

    def rows(v):       # a (n,) host vector repeated over the stack axes
        return v.to(dt).expand(lead + v.shape).clone().to(dev)

    # the constant vectors are made on the host: on the meta device their
    # ops would import torch's Python meta kernels, seconds of start-up
    dt_bias = torch.log(torch.expm1(torch.full((nh,), 0.01,
                                               dtype=torch.float32)))
    return {
        # in_proj emits [z (di), x (di), B (g), C (g), dt (nh)]
        "w_in": Boxed(scaled_init(kg(), lead + (d, 2 * di + 2 * g + nh),
                                  dtype=dt, fan_in=d),
                      ("embed", "ssm_inner")),
        "conv_w": Boxed(normal_init(kg(), lead + (s.d_conv, conv_dim),
                                    dtype=dt, stddev=0.1),
                        ("conv", "ssm_inner")),
        "conv_b": Boxed(torch.zeros(lead + (conv_dim,), dtype=dt,
                                    device=dev), ("ssm_inner",)),
        "A_log": Boxed(rows(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32))), ("ssm_inner",)),
        "D": Boxed(torch.ones(lead + (nh,), dtype=dt, device=dev),
                   ("ssm_inner",)),
        "dt_bias": Boxed(rows(dt_bias), ("ssm_inner",)),
        "norm_scale": Boxed(torch.ones(lead + (di,), dtype=dt, device=dev),
                            ("ssm_inner",)),
        "w_out": Boxed(scaled_init(kg(), lead + (di, d), dtype=dt,
                                   fan_in=di), ("ssm_inner", "embed")),
    }


def _dims(params, cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, n_groups * d_state) of ``params``: the whole
    block's, or a position's heads under tensor parallelism (its columns
    of z, x and dt; B and C whole)."""
    return (params["norm_scale"].shape[-1], params["A_log"].shape[-1],
            cfg.ssm.n_groups * cfg.ssm.d_state)


def _split_in_proj(params, cfg: ModelConfig, zxbcdt):
    di, nh, g = _dims(params, cfg)
    return torch.split(zxbcdt, [di, di, g, g, nh], dim=-1)


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x (B, S, C), w (K, C). If ``state``
    ((B, K-1, C)) is given, prepends it (decode/streaming). Returns
    (silu(conv), the last K-1 inputs)."""
    k = w.shape[0]
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    out = out + b[None, None, :]
    return F.silu(out), xp[:, -(k - 1):]


def ssd_chunked(x, dt, A, B, C, chunk: int, sharder=None):
    """Chunked SSD scan.

    x (b, s, h, p); dt (b, s, h) [post-softplus, f32]; A (h,) [negative];
    B, C (b, s, g, n) with heads h divisible by groups g.
    Returns (y (b, s, h, p), final_state (b, h, p, n)).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g
    xd = x.dtype

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    if sharder is not None and nc > 1:
        # the chunks are sequence-parallel for the intra-chunk work
        xc = sharder(xc, "batch", "act_seq", None, "ssm_inner", None)
        dtc = sharder(dtc, "batch", "act_seq", None, "ssm_inner")
        Bc = sharder(Bc, "batch", "act_seq", None, None, None)
        Cc = sharder(Cc, "batch", "act_seq", None, None, None)

    dA = dtc * A[None, None, None, :]                 # (b, nc, q, h) <= 0
    cums = torch.cumsum(dA, dim=2)                    # within-chunk cumsum

    # --- intra-chunk (quadratic in chunk len) ---
    # L[i,j] = exp(cums_i - cums_j) * dt_j  for j <= i
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]   # (b,nc,q,q,h)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    L = torch.exp(torch.where(causal, seg, torch.tensor(
        float("-inf"), dtype=seg.dtype, device=x.device))) \
        * dtc[:, :, None, :, :]
    CB = torch.einsum("bcigm,bcjgm->bcijg", Cc, Bc)   # (b,nc,q,q,g)
    CBh = torch.repeat_interleave(CB, rep, dim=-1)    # (b,nc,q,q,h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", (CBh * L).to(xd), xc)

    # --- inter-chunk state recurrence ---
    decay_chunk = torch.exp(cums[:, :, -1]).to(xd)    # (b, nc, h)
    # each chunk's state: sum_j exp(cums_last - cums_j) dt_j B_j x_j
    w = (torch.exp(cums[:, :, -1:, :] - cums) * dtc).to(xd)   # (b,nc,q,h)
    Bh = torch.repeat_interleave(Bc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchpn", w[..., None] * Bh, xc)

    state = torch.zeros((b, h, p, n), dtype=xd, device=x.device)
    prev = []
    for c in range(nc):                               # state BEFORE chunk c
        prev.append(state)
        state = state * decay_chunk[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)            # (b, nc, h, p, n)

    # --- contribution of carried state to each position ---
    Ch = torch.repeat_interleave(Cc, rep, dim=-2).to(xd)      # (b,nc,q,h,n)
    outw = torch.exp(cums).to(xd)                             # (b,nc,q,h)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch * outw[..., None],
                           prev_states)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


def ssd_chunk(cfg: ModelConfig, s: int) -> int:
    """The largest chunk <= cfg.ssm.chunk that divides s."""
    return next(c for c in range(min(cfg.ssm.chunk, s), 0, -1)
                if s % c == 0)


def ssm_inner(params, cfg: ModelConfig, x, sharder=None):
    """The block up to its gated norm: (y (B, S, d_inner), the gate z, the
    final SSD state, the conv state). ``params`` may be a position's heads
    (:func:`_dims`)."""
    s_cfg = cfg.ssm
    dt_act = x.dtype
    b, s, d = x.shape
    di, nh, g = _dims(params, cfg)

    zxbcdt = x @ params["w_in"].to(dt_act)
    z, xin, B, C, dtp = _split_in_proj(params, cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"],
                                        params["conv_b"])
    xin, B, C = torch.split(conv_out, [di, g, g], dim=-1)
    # softplus in the activation dtype, then widened (the JAX order)
    dtv = F.softplus(dtp + params["dt_bias"].to(dt_act)).float()
    A = -torch.exp(params["A_log"].float())

    xh = xin.reshape(b, s, nh, s_cfg.head_dim)
    Bh = B.reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    Ch = C.reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    y, state = ssd_chunked(xh, dtv, A, Bh, Ch, ssd_chunk(cfg, s),
                           sharder=sharder)
    y = y + params["D"].to(dt_act)[None, None, :, None] * xh
    return y.reshape(b, s, di), z, state, conv_state


def ssm_out(params, cfg: ModelConfig, y, z, sumsq=None,
            partial: bool = False):
    """The gated RMSNorm and the out projection. The JAX package's order
    normalises, then gates; with ``cfg.ssm_gate_before_norm`` (granite,
    and Mamba-2's published ``norm_before_gate=False``) the gate comes
    first: ``rmsnorm(y * silu(z))``, over the whole d_inner (one group).
    A position's heads (``partial``) take the group's f32 sum of squares
    over the whole d_inner (``sumsq``) and give their f32 term of the out
    projection's sum."""
    if cfg.ssm_gate_before_norm:
        y = layers.rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z),
                           cfg.norm_eps)
    else:
        n = cfg.ssm.d_inner(cfg.d_model) if sumsq is not None else None
        y = layers.rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps,
                           sumsq=sumsq, n=n)
        y = y * F.silu(z)
    w = params["w_out"].to(y.dtype)
    return layers.matmul_f32(y, w) if partial else y @ w


def apply_ssm(params, cfg: ModelConfig, x, sharder=None,
              return_state: bool = False):
    """Full-sequence Mamba-2 block. x (B, S, d) -> (B, S, d)."""
    y, z, state, conv_state = ssm_inner(params, cfg, x, sharder=sharder)
    out = ssm_out(params, cfg, y, z)
    if return_state:
        return out, {"ssm_state": state, "conv_state": conv_state}
    return out


def ssm_cache_logical_axes() -> Dict:
    return {"ssm_state": ("batch", "ssm_inner", None, None),
            "conv_state": ("batch", None, "ssm_inner")}


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None,
                   lead: Tuple[int, ...] = ()) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    nh = s.n_heads(d)
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {
        "ssm_state": torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                                 dtype=cfg.adtype, device=device),
        "conv_state": torch.zeros(lead + (batch, s.d_conv - 1, conv_dim),
                                  dtype=cfg.adtype, device=device),
    }


def decode_inner(params, cfg: ModelConfig, x, cache):
    """One-token recurrence up to the gated norm: (y (B, 1, d_inner), z);
    ``cache`` (a position's heads under tensor parallelism) updated in
    place."""
    s_cfg = cfg.ssm
    dt_act = x.dtype
    b, _, d = x.shape
    di, nh, g = _dims(params, cfg)

    zxbcdt = x @ params["w_in"].to(dt_act)
    z, xin, B, C, dtp = _split_in_proj(params, cfg, zxbcdt)
    conv_in = torch.cat([xin, B, C], dim=-1)               # (B, 1, conv_dim)
    conv_out, conv_state = _causal_conv(conv_in, params["conv_w"],
                                        params["conv_b"],
                                        state=cache["conv_state"])
    xin, B, C = torch.split(conv_out, [di, g, g], dim=-1)
    dtv = F.softplus(dtp.float() + params["dt_bias"].float())[:, 0]
    A = -torch.exp(params["A_log"].float())                 # (h,)

    xh = xin.reshape(b, nh, s_cfg.head_dim)
    Bh = torch.repeat_interleave(
        B.reshape(b, s_cfg.n_groups, s_cfg.d_state),
        nh // s_cfg.n_groups, dim=1)                         # (b, h, n)
    Ch = torch.repeat_interleave(
        C.reshape(b, s_cfg.n_groups, s_cfg.d_state),
        nh // s_cfg.n_groups, dim=1)

    decay = torch.exp(dtv * A[None, :])                      # (b, h)
    state = cache["ssm_state"].float()
    state = state * decay[:, :, None, None] + \
        (dtv[:, :, None] * xh.float())[:, :, :, None] \
        * Bh.float()[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.float())
    y = y + params["D"].float()[None, :, None] * xh.float()
    cache["ssm_state"].copy_(state)
    cache["conv_state"].copy_(conv_state)
    return y.reshape(b, 1, di).to(dt_act), z


def decode_step_ssm(params, cfg: ModelConfig, x, cache) -> Tuple:
    """One-token recurrence. x (B, 1, d); ``cache`` updated in place."""
    y, z = decode_inner(params, cfg, x, cache)
    return ssm_out(params, cfg, y, z), cache
