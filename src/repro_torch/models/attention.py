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

On a tensor-parallel group whose cache is split along the sequence
(``parallel/tp.cache_layout``: each rank a contiguous chunk of the
positions, or of the ring's slots, for every KV head),
:func:`prefill_seq_tp` writes each rank's chunk and :func:`decode_seq_tp`
attends as a split softmax: each rank scores its own slots, the group
combines the chunks' maxima and sums of exponentials in f32
(:func:`combine_stats`), and each rank's slots' probabilities, rounded
to the act dtype as the one-device softmax's are, weight its values in
an f32 term that the group sums in rank order. A rank whose chunk holds
no visible slot contributes exactly 0.
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
from repro_torch.parallel import collectives as coll

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

    image = cache_image(k, v, _time_positions(positions).to(torch.int32),
                        cache["k"].shape[1])
    for name, t in zip(("k", "v", "slot_pos"), image):
        cache[name].copy_(t)
    return y, cache


def _valid(cfg: ModelConfig, spos, pos: int):
    """The slots a token at ``pos`` sees: filled, not after it, and in
    the window."""
    valid = (spos >= 0) & (spos <= pos)
    if cfg.swa_window is not None:
        valid = valid & (spos > pos - cfg.swa_window)
    return valid


def _token_positions(cfg: ModelConfig, x, pos: int) -> torch.Tensor:
    """The positions of one decoded token of each example of ``x``
    (M-RoPE's three streams alike)."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    if cfg.m_rope_sections is not None:
        positions = positions[None].expand((3,) + positions.shape)
    return positions


def decode_step_attn(params, cfg: ModelConfig, x, pos: int, cache,
                     sharder=None, kv_sel=None, partial: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B, 1, d); ``pos`` a host int (lockstep batch).

    Full cache: slot == pos. Ring cache: slot == pos % size; masking is by
    stored absolute slot positions, so both are one code path. ``kv_sel``
    and ``partial`` as in :func:`attend_full`."""
    q, k, v = _project_qkv(params, cfg, x, x, _token_positions(cfg, x, pos))
    size = cache["k"].shape[1]
    slot = pos % size
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    cache["slot_pos"][slot] = pos
    valid = _valid(cfg, cache["slot_pos"], pos)
    out = _grouped_attend(q, _take(cache["k"], kv_sel),
                          _take(cache["v"], kv_sel), valid[None, None, :],
                          sharder=sharder)
    return _out_proj(out, params["wo"], partial), cache


# ------------------------------------------- the sequence-split cache
def cache_image(k, v, pos_seq, size: int):
    """The (k, v, slot_pos) that a prefill of ``k.shape[1]`` tokens at
    positions ``pos_seq`` leaves in a cache of ``size`` slots: the trailing
    window rolled so slot = pos % size (:func:`prefill_into_cache`), or
    the prompt followed by zeros and empty (-1) slots."""
    s = k.shape[1]
    if s >= size:
        roll = s % size
        return (torch.roll(k[:, -size:], roll, dims=1),
                torch.roll(v[:, -size:], roll, dims=1),
                torch.roll(pos_seq[-size:], roll))
    pad = (k.shape[0], size - s) + tuple(k.shape[2:])
    return (torch.cat([k, k.new_zeros(pad)], 1),
            torch.cat([v, v.new_zeros(pad)], 1),
            torch.cat([pos_seq, pos_seq.new_full((size - s,), -1)]))


def _write_chunks(cfg: ModelConfig, tp, caches, ks, vs, pos_seq) -> None:
    """Each rank's chunk of a prefill's cache contents into its cache:
    ``ks``, ``vs`` each rank's keys and values (B, S, KV heads it
    computes, hd). When the ranks split the KV heads, an all-to-all hands
    each rank its positions of every head; when each computes every
    head, it keeps its own positions."""
    n = caches[0]["k"].shape[1]
    size = n * tp.size
    imgs = [cache_image(k, v, pos_seq.to(k.device), size)
            for k, v in zip(ks, vs)]
    ks, vs = [i[0] for i in imgs], [i[1] for i in imgs]
    if ks[0].shape[2] < cfg.n_kv_heads:
        ks = coll.all_to_all(tp, ks, 1, 2)
        vs = coll.all_to_all(tp, vs, 1, 2)
    else:
        ks = [k.narrow(1, r * n, n) for r, k in zip(tp.ranks, ks)]
        vs = [v.narrow(1, r * n, n) for r, v in zip(tp.ranks, vs)]
    for r, c, k, v, img in zip(tp.ranks, caches, ks, vs, imgs):
        c["k"].copy_(k)
        c["v"].copy_(v)
        if "slot_pos" in c:
            c["slot_pos"].copy_(img[2].narrow(0, r * n, n))


def prefill_seq_tp(tp, ps, cfg: ModelConfig, hs, positions, caches,
                   partial: bool, encs=None) -> list:
    """:func:`prefill_into_cache` of each rank of the group ``tp`` (its
    attention params ``ps``, normed stream ``hs`` and ``positions``)
    into caches split along the sequence: each rank attends the freshly
    projected keys and values of its heads (as the one-device prefill
    does), then writes its chunk. With ``encs`` (the encoder's output,
    one per rank, whole) it is the cross-attention, its cache the
    encoder positions. Returns each rank's output (the f32 term of the
    group's sum when ``partial``)."""
    heads, kv_heads = ps[0]["wq"].shape[1], ps[0]["wk"].shape[1]
    cross = encs is not None
    parts, ks, vs = [], [], []
    for r, p, h, pos, e in zip(tp.ranks, ps, hs, positions, encs or hs):
        q, k, v = _project_qkv(p, cfg, h, e, pos, rope=not cross)
        sel = kv_select(cfg, heads, kv_heads, r)
        out = _attend_maybe_chunked(q, _take(k, sel), _take(v, sel), cfg,
                                    causal=not cross)
        parts.append(_out_proj(out, p["wo"], partial))
        ks.append(k)
        vs.append(v)
    pos_seq = (torch.arange(ks[0].shape[1], device=ks[0].device) if cross
               else _time_positions(positions[0]))
    _write_chunks(cfg, tp, caches, ks, vs, pos_seq.to(torch.int32))
    return parts


def chunk_scores(q, k, valid):
    """One rank's scores of a one-token query against its own slots: q
    (B, 1, H, hd) every query head, k (B, n, KV, hd) its chunk, valid (n,)
    bool (None: every slot). Returns the (B, KV, H / KV, n) f32 scores,
    scaled and masked as in :func:`_grouped_attend`, and the chunk's
    (maximum score, sum of its exponentials) per head, (B, H, 2) f32: a
    chunk with no visible slot gives (NEG_INF, 0)."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    s = torch.matmul(q.reshape(b, kv, h // kv, hd).float(),
                     k.permute(0, 2, 3, 1).float()) / math.sqrt(hd)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    return s, torch.cat([m, e.sum(-1, keepdim=True)], -1).reshape(b, h, 2)


def combine_stats(stats: torch.Tensor):
    """(R, B, H, 2) chunk statistics of :func:`chunk_scores` in rank order
    -> the row's maximum ``M = max_r m_r`` and sum of exponentials
    ``L = sum_r exp(m_r - M) l_r`` (summed in rank order), each (B, H)."""
    m = stats[..., 0]
    top = m.amax(0)
    return top, _rank_sum(torch.exp(m - top) * stats[..., 1])


def chunk_output(s, valid, top, den, v, dtype) -> torch.Tensor:
    """One rank's f32 term (B, H, hd) of the attention output: its slots'
    probabilities ``exp(s - M) / L``, rounded to ``dtype`` as the
    one-device softmax's are, times its values ``v`` (B, n, KV, hd),
    summed in f32. The group's sum of the terms is the output."""
    b, kv, g, _ = s.shape
    p = torch.exp(s - top.reshape(b, kv, g, 1))
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    p = (p / torch.where(den > 0, den, 1.0).reshape(b, kv, g, 1)).to(dtype)
    return torch.matmul(p.float(), v.permute(0, 2, 1, 3).float()).reshape(
        b, kv * g, -1)


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    return acc


def _split_softmax_tp(tp, qs, caches, valids, heads: int):
    """Each rank's (B, 1, h, hd) attention output from the ranks' queries
    ``qs`` (B, 1, h, hd) and their chunks: the queries of every head
    gathered (when the ranks split them); each rank's chunk statistics
    gathered and combined into the row's maximum and sum; each rank's
    term of the output, from its slots' probabilities; and the terms of
    the rank's heads from every rank summed in rank order (an all-to-all
    of the terms; an all-gather when every rank computes every head)."""
    split = qs[0].shape[2] < heads
    if split:
        qs = coll.all_gather(tp, qs, 2)
    scored = [chunk_scores(q, c["k"], ok)
              for q, c, ok in zip(qs, caches, valids)]
    stats = coll.all_gather(tp, [st[None] for _, st in scored], 0)
    terms = [chunk_output(s, ok, *combine_stats(st), c["v"], q.dtype)[None]
             for (s, _), st, ok, c, q in zip(scored, stats, valids, caches,
                                             qs)]
    terms = (coll.all_to_all(tp, terms, 2, 0) if split
             else coll.all_gather(tp, terms, 0))
    return [_rank_sum(t)[:, None] for t in terms]


def decode_seq_tp(tp, ps, cfg: ModelConfig, hs, pos: int, caches,
                  partial: bool) -> list:
    """:func:`decode_step_attn` of each rank of the group ``tp`` on caches
    split along the sequence: the new token's keys and values of every
    KV head (gathered when the ranks split them) go to the rank owning
    slot ``pos % size``, which alone writes it; then the split softmax
    over every rank's chunk, masked by its slot positions. Returns each
    rank's output (the f32 term of the group's sum when ``partial``)."""
    qs, ks, vs = [], [], []
    for p, h in zip(ps, hs):
        q, k, v = _project_qkv(p, cfg, h, h, _token_positions(cfg, h, pos))
        qs.append(q)
        ks.append(k)
        vs.append(v)
    if ks[0].shape[2] < cfg.n_kv_heads:
        ks = coll.all_gather(tp, ks, 2)
        vs = coll.all_gather(tp, vs, 2)
    n = caches[0]["k"].shape[1]
    owner, i = divmod(pos % (n * tp.size), n)
    for r, c, k, v in zip(tp.ranks, caches, ks, vs):
        if r == owner:
            c["k"][:, i:i + 1] = k
            c["v"][:, i:i + 1] = v
            c["slot_pos"][i] = pos
    outs = _split_softmax_tp(tp, qs, caches, [
        _valid(cfg, c["slot_pos"], pos) for c in caches], cfg.n_heads)
    return [_out_proj(o.to(h.dtype), p["wo"], partial)
            for p, h, o in zip(ps, hs, outs)]


def cross_decode_seq_tp(tp, ps, cfg: ModelConfig, hs, caches,
                        partial: bool) -> list:
    """One token's cross-attention of each rank's heads over the encoder
    positions split along the sequence (``caches``: the ranks' cross
    caches of one layer): the split softmax with no mask."""
    qs = [_proj(h, p["wq"]) for p, h in zip(ps, hs)]
    outs = _split_softmax_tp(tp, qs, caches, [None] * len(qs), cfg.n_heads)
    return [_out_proj(o.to(h.dtype), p["wo"], partial)
            for p, h, o in zip(ps, hs, outs)]
