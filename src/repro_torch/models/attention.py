"""Grouped-query attention with the pool's full option set, the JAX
package's ``models/attention.py`` in plain PyTorch: qk-norm (qwen3), QKV
bias (qwen2), sliding window (h2o-danube), M-RoPE (qwen2-vl),
cross-attention (whisper), full and ring KV caches.

Weights keep their logical 3-D head layout: wq (embed, heads, head_dim),
wk/wv (embed, kv_heads, head_dim), wo (heads, head_dim, embed). GQA is
computed grouped: the query heads of a KV head form one batch of rows
against that head's keys, so no KV head is repeated. The JAX function
repeats KV heads up to ``cfg.attn_kv_pad_to`` (16) when the heads divide
by it, so that its score tensor shards 16-way on a TPU mesh; repeated
heads attend identically, so on one device the port skips it (the
outputs are equal: ``tests/test_torch_lm_layers.py``).

Scores are f32 (the act-dtype operands widened, as the JAX einsum's f32
result), scaled by 1/sqrt(hd), masked with ``NEG_INF = -1e30`` (a finite
number: a row with no visible key softmaxes to uniform, not NaN), and the
probabilities are cast to the act dtype before the PV product.

Caches are updated in place and returned (the JAX steps donate theirs):
the ring cache's slot is ``pos % size`` and masking reads the stored
absolute slot positions (-1 = empty), so full and ring caches share one
decode path.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.param import Boxed, KeyGen, ones_init, \
    scaled_init, zeros_init
from repro_torch.models import layers, remat
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def init_attention(kg: KeyGen, cfg: ModelConfig, cross: bool = False,
                   lead: Tuple[int, ...] = ()) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = cfg.pdtype
    p = {
        "wq": Boxed(scaled_init(kg(), lead + (d, h, hd), dtype=dt, fan_in=d),
                    ("embed", "heads", "head_dim")),
        "wk": Boxed(scaled_init(kg(), lead + (d, kv, hd), dtype=dt,
                                fan_in=d),
                    ("embed", "kv_heads", "head_dim")),
        "wv": Boxed(scaled_init(kg(), lead + (d, kv, hd), dtype=dt,
                                fan_in=d),
                    ("embed", "kv_heads", "head_dim")),
        "wo": Boxed(scaled_init(kg(), lead + (h, hd, d), dtype=dt,
                                fan_in=h * hd),
                    ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = Boxed(zeros_init(kg(), lead + (h, hd), dt),
                        ("heads", "head_dim"))
        p["bk"] = Boxed(zeros_init(kg(), lead + (kv, hd), dt),
                        ("kv_heads", "head_dim"))
        p["bv"] = Boxed(zeros_init(kg(), lead + (kv, hd), dt),
                        ("kv_heads", "head_dim"))
    if cfg.qk_norm and not cross:
        p["q_norm"] = Boxed(ones_init(kg(), lead + (hd,), dt), ("head_dim",))
        p["k_norm"] = Boxed(ones_init(kg(), lead + (hd,), dt), ("head_dim",))
    return p


def _proj(x, w):
    """'bsd,dhe->bshe' as one (B*S, d) x (d, h*e) product."""
    d, h, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * e)).reshape(
        x.shape[:-1] + (h, e))


def _out_proj(out, wo, partial: bool = False):
    """'bshe,hed->bsd'; ``partial``: the f32 products of a position's
    heads, one term of a sum over the tensor-parallel group (rounded to
    the act dtype once, after the sum, as one product over every head
    rounds)."""
    h, e, d = wo.shape
    flat = out.reshape(out.shape[:-2] + (h * e,))
    w = wo.to(out.dtype).reshape(h * e, d)
    return layers.matmul_f32(flat, w) if partial else flat @ w


def kv_select(cfg: ModelConfig, heads: int, kv_heads: int, rank: int):
    """The KV heads that a position's ``heads`` query heads (the ``rank``-th
    block of them) read, of the ``kv_heads`` it holds: None for all of
    them (the heads whole, or the KV heads split alongside them); when the
    KV heads fall back whole under split query heads, a slice of them, or
    a list that repeats one where the local query heads' groups straddle
    (each run of ``gcd(heads, group)`` query heads reads one KV head)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if heads == h or kv_heads < kv:
        return None
    g = h // kv
    first, c = rank * heads, math.gcd(heads, g)
    sel = [(first + j * c) // g for j in range(heads // c)]
    if sel == list(range(sel[0], sel[0] + len(sel))):
        return slice(sel[0], sel[-1] + 1)
    return sel


def _take(kv: torch.Tensor, sel) -> torch.Tensor:
    """The selected KV heads (dim 2) of (B, S, KV, hd)."""
    return kv if sel is None else kv[:, :, sel]


def _project_qkv(params, cfg: ModelConfig, x, kv_x, positions,
                 rope: bool = True):
    dt = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(kv_x, params["wk"])
    v = _proj(kv_x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if "q_norm" in params:
        q = layers.head_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.head_rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope and cfg.use_rope:
        if cfg.m_rope_sections is not None:
            q = layers.apply_m_rope(q, positions, cfg.rope_theta,
                                    cfg.m_rope_sections)
            k = layers.apply_m_rope(k, positions, cfg.rope_theta,
                                    cfg.m_rope_sections)
        else:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_attend(q, k, v, mask, sharder=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask (1|B, Sq, Sk) bool."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    if sharder is not None:
        sharder(q.reshape(b, sq, kv, g, hd), "batch", "act_seq", "kv_heads",
                None, None)
    # (B, KV, G*Sq, hd): a KV head's query heads are rows of one product
    qg = q.reshape(b, sq, kv, g, hd).permute(0, 2, 3, 1, 4) \
        .reshape(b, kv, g * sq, hd)
    kt = k.permute(0, 2, 3, 1)                           # (B, KV, hd, Sk)
    scores = torch.matmul(qg.float(), kt.float())        # f32 products
    scores = scores.reshape(b, kv, g, sq, sk) / math.sqrt(hd)
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.reshape(b, kv, g * sq, sk),
                       v.permute(0, 2, 1, 3))            # (B, KV, G*Sq, hd)
    return out.reshape(b, kv, g, sq, hd).permute(0, 3, 1, 2, 4) \
        .reshape(b, sq, h, hd)


def causal_mask(sq: int, sk: int, window: Optional[int] = None,
                causal: bool = True, device=None) -> torch.Tensor:
    """(1, sq, sk) bool; query i may see key j. For prefill sq == sk."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device) \
        if not causal else (kj <= qi)
    if window is not None:
        m = m & (kj > qi - window)
    return m[None]


def q_chunk(cfg: ModelConfig, sq: int) -> Optional[int]:
    """The query block of chunked attention: the largest divisor of ``sq``
    up to ``cfg.attn_q_chunk`` when ``sq >= 2 * attn_q_chunk``, else None
    (one block)."""
    qc = cfg.attn_q_chunk
    if qc is None or sq < 2 * qc:
        return None
    return next(c for c in range(qc, 0, -1) if sq % c == 0)


def _attend_block(q, k, v, qc: int, off: int, window: Optional[int],
                  causal: bool, slice_keys: bool,
                  sharder=None) -> torch.Tensor:
    """One query block of chunked attention: the block's ``qc`` queries
    from absolute position ``off`` against the keys they can see."""
    sk = k.shape[1]
    qi = torch.arange(qc, device=q.device)[:, None] + off
    if slice_keys:
        kw = window + qc
        start = min(max(off - window + 1, 0), sk - kw)
        k, v = k[:, start:start + kw], v[:, start:start + kw]
        kj = torch.arange(kw, device=q.device)[None, :] + start
        m = (kj <= qi) & (kj > qi - window)
    else:
        kj = torch.arange(sk, device=q.device)[None, :]
        m = (kj <= qi) if causal else torch.ones(
            (qc, sk), dtype=torch.bool, device=q.device)
        if window is not None:
            m = m & (kj > qi - window)
    return _grouped_attend(q, k, v, m[None], sharder=sharder)


def _attend_maybe_chunked(q, k, v, cfg: ModelConfig,
                          causal: bool, sharder=None) -> torch.Tensor:
    """Full attention with q-block chunking when the score tensor would be
    large: each block materializes only (B, H, qc, Sk), the
    flash-attention memory shape, one block after another, and the
    backward recomputes each block's scores instead of keeping every
    block's probabilities (``models/remat.py``). With a sliding window a
    block [off, off+qc) reads only the ``window + qc`` keys from a clipped
    start: the keys it can see."""
    sq, sk = q.shape[1], k.shape[1]
    window = cfg.swa_window if causal else None
    qc = q_chunk(cfg, sq)
    if qc is None:
        mask = causal_mask(sq, sk, window=window, causal=causal,
                           device=q.device)
        return _grouped_attend(q, k, v, mask, sharder=sharder)
    slice_keys = window is not None and causal and sk > window + qc
    outs = [remat.checkpoint(
        functools.partial(_attend_block, qc=qc, off=i * qc + (sk - sq),
                          window=window, causal=causal,
                          slice_keys=slice_keys, sharder=sharder),
        q[:, i * qc:(i + 1) * qc], k, v) for i in range(sq // qc)]
    return torch.cat(outs, dim=1)


def attend_full(params, cfg: ModelConfig, x, positions, *,
                causal: bool = True, kv_x=None, rope: bool = True,
                sharder=None, kv_sel=None,
                partial: bool = False) -> torch.Tensor:
    """Training / prefill / cross attention over the full sequence.
    ``params`` may be a position's heads (``kv_sel``, ``partial``: the
    tensor-parallel path, ``models/blocks``)."""
    kv_x = x if kv_x is None else kv_x
    q, k, v = _project_qkv(params, cfg, x, kv_x, positions, rope=rope)
    if sharder is not None:
        q = sharder(q, "batch", "act_seq", "act_heads", "head_dim")
    out = _attend_maybe_chunked(q, _take(k, kv_sel), _take(v, kv_sel), cfg,
                                causal, sharder=sharder)
    return _out_proj(out, params["wo"], partial)


# ------------------------------------------------------------------ caches
def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, ring: bool,
                  device=None, lead: Tuple[int, ...] = ()) -> Dict:
    """One layer's KV cache (``lead`` stacks it). ``ring=True`` -> SWA ring
    buffer of size min(capacity, window) with explicit slot positions."""
    size = min(capacity, cfg.swa_window) if ring else capacity
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros(lead + (batch, size, kvh, hd), dtype=cfg.adtype,
                         device=device),
        "v": torch.zeros(lead + (batch, size, kvh, hd), dtype=cfg.adtype,
                         device=device),
        "slot_pos": torch.full(lead + (size,), -1, dtype=torch.int32,
                               device=device),
    }


def cache_logical_axes() -> Dict:
    return {"k": ("batch", "act_seq", "kv_heads", "head_dim"),
            "v": ("batch", "act_seq", "kv_heads", "head_dim"),
            "slot_pos": ("act_seq",)}


def _time_positions(positions) -> torch.Tensor:
    """The 1-D temporal position stream (lockstep batch; M-RoPE's t axis)."""
    while positions.ndim > 1:
        positions = positions[0]
    return positions


def prefill_into_cache(params, cfg: ModelConfig, x, positions, cache,
                       sharder=None, kv_sel=None, partial: bool = False
                       ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also fills ``cache`` in place (the
    last ``size`` tokens for a ring cache, rolled so slot = pos % size).
    ``kv_sel`` and ``partial`` as in :func:`attend_full`: the cache holds
    every KV head the position computes."""
    q, k, v = _project_qkv(params, cfg, x, x, positions)
    out = _attend_maybe_chunked(q, _take(k, kv_sel), _take(v, kv_sel), cfg,
                                causal=True, sharder=sharder)
    y = _out_proj(out, params["wo"], partial)

    size = cache["k"].shape[1]
    s = k.shape[1]
    pos_seq = _time_positions(positions).to(torch.int32)
    if s >= size:           # keep the trailing window, rotated
        roll = s % size
        cache["k"].copy_(torch.roll(k[:, -size:], roll, dims=1))
        cache["v"].copy_(torch.roll(v[:, -size:], roll, dims=1))
        cache["slot_pos"].copy_(torch.roll(pos_seq[-size:], roll))
    else:
        cache["k"][:, :s] = k
        cache["k"][:, s:] = 0
        cache["v"][:, :s] = v
        cache["v"][:, s:] = 0
        cache["slot_pos"][:s] = pos_seq
        cache["slot_pos"][s:] = -1
    return y, cache


def decode_step_attn(params, cfg: ModelConfig, x, pos: int, cache,
                     sharder=None, kv_sel=None, partial: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B, 1, d); ``pos`` a host int (lockstep batch).

    Full cache: slot == pos. Ring cache: slot == pos % size; masking is by
    stored absolute slot positions, so both are one code path. ``kv_sel``
    and ``partial`` as in :func:`attend_full`."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    if cfg.m_rope_sections is not None:
        positions = positions[None].expand((3,) + positions.shape)
    q, k, v = _project_qkv(params, cfg, x, x, positions)
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    cache["slot_pos"][slot] = pos
    spos = cache["slot_pos"]
    valid = (spos >= 0) & (spos <= pos)
    if cfg.swa_window is not None:
        valid = valid & (spos > pos - cfg.swa_window)
    out = _grouped_attend(q, _take(cache["k"], kv_sel),
                          _take(cache["v"], kv_sel), valid[None, None, :],
                          sharder=sharder)
    return _out_proj(out, params["wo"], partial), cache
