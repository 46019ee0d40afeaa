"""Whisper-style encoder-decoder backbone (arch ``whisper-base``), the JAX
package's ``models/encdec.py`` in plain PyTorch.

The conv frontend is a stub: callers feed precomputed frame embeddings
(B, S_enc, d) straight into the encoder. Positions are fixed sinusoids
(encoder) and learned (decoder, 448 of them, tiled past the table for
longer decoder contexts); attention is non-rotary; norms are pre-LN
LayerNorms. Layers are stacked over depth and looped in Python. Serving
keeps a self-attention KV cache and a cross-attention cache of the
encoder's keys and values, filled at prefill; both are updated in place.

Training (``loss_fn``) recomputes as the LM does (``models/lm.py``): the
CE's sequence chunks and chunked attention's query blocks always, and
each encoder and decoder layer under ``cfg.remat``. The JAX package
checkpoints only the first two here; the per-layer recompute changes
memory, not the gradients.

``prefill_tp`` and ``decode_step_tp`` serve on a tensor-parallel group as
``models/lm.py``'s do (heads and ``mlp`` split, the tied table
vocab-parallel); each rank's self- and cross-attention caches are its
shards (``parallel/tp.cache_layout``): under ``baseline`` its chunk of
the positions, attended as ``models/attention``'s split softmax.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.common.param import Boxed, KeyGen, normal_init, \
    tree_from_numpy, tree_map, unbox, unstack
from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, layers, remat
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll

MAX_DEC_POSITIONS = 448


def _stacked(tree):
    return tree_map(lambda b: Boxed(b.value, ("layers",) + b.axes), tree,
                    is_leaf=lambda x: isinstance(x, Boxed))


def _init_enc_layers(kg: KeyGen, cfg: ModelConfig, n: int) -> Dict:
    lead = (n,)
    return _stacked({
        "ln1": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype, lead),
        "attn": attention.init_attention(kg, cfg, lead=lead),
        "ln2": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype, lead),
        "mlp": layers.init_gelu_mlp(kg, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                    lead),
    })


def _init_dec_layers(kg: KeyGen, cfg: ModelConfig, n: int) -> Dict:
    lead = (n,)
    return _stacked({
        "ln1": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype, lead),
        "attn": attention.init_attention(kg, cfg, lead=lead),
        "ln_x": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype, lead),
        "xattn": attention.init_attention(kg, cfg, cross=True, lead=lead),
        "ln2": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype, lead),
        "mlp": layers.init_gelu_mlp(kg, cfg.d_model, cfg.d_ff, cfg.pdtype,
                                    lead),
    })


def init_encdec(kg: KeyGen, cfg: ModelConfig,
                max_dec_positions: int = MAX_DEC_POSITIONS) -> Dict:
    return {
        "embedding": layers.init_embedding(kg, cfg.vocab_size, cfg.d_model,
                                           cfg.pdtype),
        "dec_pos": Boxed(normal_init(kg(), (max_dec_positions, cfg.d_model),
                                     dtype=cfg.pdtype), (None, "embed")),
        "enc_layers": _init_enc_layers(kg, cfg, cfg.n_layers),
        "dec_layers": _init_dec_layers(kg, cfg, cfg.n_layers),
        "enc_ln": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype),
        "dec_ln": layers.init_layernorm(kg, cfg.d_model, cfg.pdtype),
    }


def from_jax_params(np_tree, cfg: ModelConfig, device=None) -> Dict:
    """A JAX ``unbox(encdec.init_encdec(key, cfg))[0]`` tree, as numpy
    arrays, as the port's params on ``device`` (see
    ``lm.from_jax_params``)."""
    expected = unbox(init_encdec(KeyGen(0, "meta"), cfg))[0]
    return tree_from_numpy(np_tree, expected, resolve_device(device))


def _layer(stacked, i: int):
    return tree_map(lambda a: a[i], stacked)


def _enc_layer(cfg: ModelConfig, positions, sharder, lp, x):
    h = layers.layernorm(lp["ln1"], x)
    x = x + attention.attend_full(lp["attn"], cfg, h, positions,
                                  causal=False, sharder=sharder)
    h = layers.layernorm(lp["ln2"], x)
    x = x + layers.gelu_mlp(lp["mlp"], h, sharder=sharder)
    if sharder is not None:
        x = sharder(x, "batch", "act_seq", "act_embed")
    return x


def encode(params, cfg: ModelConfig, frames: torch.Tensor, sharder=None
           ) -> torch.Tensor:
    """frames (B, S_enc, d): stubbed conv-frontend output."""
    b, s, _ = frames.shape
    x = frames.to(cfg.adtype) + layers.sinusoidal_positions(
        s, cfg.d_model, frames.device).to(cfg.adtype)[None]
    positions = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    fn = remat.maybe_remat(functools.partial(_enc_layer, cfg, positions,
                                             sharder), cfg.remat)
    for lp in unstack(params["enc_layers"], cfg.n_layers):
        x = fn(lp, x)
    return layers.layernorm(params["enc_ln"], x)


def _dec_positions(params, cfg: ModelConfig, s: int) -> torch.Tensor:
    """The first ``s`` learned positions, tiled past the table."""
    table = params["dec_pos"]
    pos_emb = table[:min(s, table.shape[0])]
    if s > table.shape[0]:   # long decoder contexts: tile positions
        reps = -(-s // table.shape[0])
        pos_emb = pos_emb.repeat(reps, 1)[:s]
    return pos_emb.to(cfg.adtype)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, sharder=None) -> torch.Tensor:
    x = decode_hidden(params, cfg, tokens, enc_out, sharder=sharder)
    return layers.unembed(params["embedding"], x)


def decode_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, sharder=None) -> torch.Tensor:
    b, s = tokens.shape
    x = layers.embed(params["embedding"], tokens, cfg.adtype) \
        + _dec_positions(params, cfg, s)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    fn = remat.maybe_remat(functools.partial(_dec_layer, cfg, positions,
                                             sharder), cfg.remat)
    for lp in unstack(params["dec_layers"], cfg.n_layers):
        x = fn(lp, x, enc_out)
    return layers.layernorm(params["dec_ln"], x)


def _dec_layer(cfg: ModelConfig, positions, sharder, lp, x, enc_out):
    h = layers.layernorm(lp["ln1"], x)
    x = x + attention.attend_full(lp["attn"], cfg, h, positions,
                                  causal=True, sharder=sharder)
    h = layers.layernorm(lp["ln_x"], x)
    x = x + attention.attend_full(lp["xattn"], cfg, h, positions,
                                  causal=False, kv_x=enc_out, rope=False,
                                  sharder=sharder)
    h = layers.layernorm(lp["ln2"], x)
    return x + layers.gelu_mlp(lp["mlp"], h, sharder=sharder)


def loss_fn(params, cfg: ModelConfig, batch: Dict, sharder=None):
    """batch: enc_embeddings (B, S_enc, d), tokens (B, S_dec); CE
    seq-chunked (``lm.chunked_cross_entropy``)."""
    from repro_torch.models.lm import chunked_cross_entropy
    enc_out = encode(params, cfg, batch["enc_embeddings"], sharder=sharder)
    x = decode_hidden(params, cfg, batch["tokens"], enc_out, sharder=sharder)
    labels = batch["tokens"][:, 1:]
    ce = chunked_cross_entropy(x[:, :-1], params["embedding"]["table"],
                               labels)
    return ce, {}


# ----------------------------------------------------------------- serving
def init_dec_cache(cfg: ModelConfig, batch: int, capacity: int,
                   enc_len: int, device=None) -> Dict:
    """The decoder's self-attention cache and the cross-attention keys
    and values, stacked over layers, on ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    n = cfg.n_layers
    kvh, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "self": attention.init_kv_cache(cfg, batch, capacity, ring=False,
                                        device=device, lead=(n,)),
        "cross": {
            "k": torch.zeros((n, batch, enc_len, kvh, hd), dtype=cfg.adtype,
                             device=device),
            "v": torch.zeros((n, batch, enc_len, kvh, hd), dtype=cfg.adtype,
                             device=device)},
    }


def prefill(params, cfg: ModelConfig, batch: Dict, cache: Dict,
            sharder=None) -> Tuple[torch.Tensor, Dict]:
    """Encode the audio, prime the decoder caches with the prompt tokens
    (in place); returns (last-token logits (B, V), cache)."""
    enc_out = encode(params, cfg, batch["enc_embeddings"], sharder=sharder)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed(params["embedding"], tokens, cfg.adtype) \
        + _dec_positions(params, cfg, s)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = layers.layernorm(lp["ln1"], x)
        mix, _ = attention.prefill_into_cache(
            lp["attn"], cfg, h, positions, _layer(cache["self"], i),
            sharder=sharder)
        x = x + mix
        h = layers.layernorm(lp["ln_x"], x)
        xk = attention._proj(enc_out, lp["xattn"]["wk"])
        xv = attention._proj(enc_out, lp["xattn"]["wv"])
        cache["cross"]["k"][i] = xk
        cache["cross"]["v"][i] = xv
        q = attention._proj(h, lp["xattn"]["wq"])
        out = attention._attend_maybe_chunked(q, xk, xv, cfg, causal=False,
                                              sharder=sharder)
        x = x + attention._out_proj(out, lp["xattn"]["wo"])
        h = layers.layernorm(lp["ln2"], x)
        x = x + layers.gelu_mlp(lp["mlp"], h, sharder=sharder)
    x = layers.layernorm(params["dec_ln"], x[:, -1:])
    logits = layers.unembed(params["embedding"], x)[:, 0]
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos,
                cache: Dict, sharder=None) -> Tuple[torch.Tensor, Dict]:
    """One decoder token against the self and cross caches. tokens (B, 1);
    ``pos`` a host int. Past the learned table the last position repeats,
    as in the JAX step."""
    pos = int(pos)
    table = params["dec_pos"]
    pos_emb = table[min(pos, table.shape[0] - 1)][None]
    x = layers.embed(params["embedding"], tokens, cfg.adtype) \
        + pos_emb.to(cfg.adtype)[None]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = layers.layernorm(lp["ln1"], x)
        mix, _ = attention.decode_step_attn(lp["attn"], cfg, h, pos,
                                            _layer(cache["self"], i),
                                            sharder=sharder)
        x = x + mix
        h = layers.layernorm(lp["ln_x"], x)
        q = attention._proj(h, lp["xattn"]["wq"])
        ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
        mask = torch.ones((1, 1, ck.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = attention._grouped_attend(q, ck, cv, mask, sharder=sharder)
        x = x + attention._out_proj(out, lp["xattn"]["wo"])
        h = layers.layernorm(lp["ln2"], x)
        x = x + layers.gelu_mlp(lp["mlp"], h, sharder=sharder)
    x = layers.layernorm(params["dec_ln"], x)
    logits = layers.unembed(params["embedding"], x)[:, 0]
    return logits, cache


# ------------------------------------------------------ tensor parallelism
def _attn_tp(tp, cfg: ModelConfig, ps, name: str):
    """(each rank's KV selection, True when the heads split)."""
    heads, kv_heads, partial = blocks._heads_tp(cfg, ps, name)
    return [attention.kv_select(cfg, heads, kv_heads, r)
            for r in tp.ranks], partial


def _mlp_tp(tp, cfg: ModelConfig, ps, xs, ln: str, sp: bool):
    """The gelu MLP half of a layer on the group, its ``b_down`` added
    once after the sum."""
    hs = blocks.whole_seq(tp, [layers.layernorm(p[ln], x)
                               for p, x in zip(ps, xs)], sp)
    partial = ps[0]["mlp"]["w_up"].shape[-1] < cfg.d_ff
    parts = [layers.gelu_mlp(p["mlp"], h, partial=partial)
             for p, h in zip(ps, hs)]
    return blocks.mix_into(tp, xs, parts, partial, sp,
                           [p["mlp"]["b_down"] for p in ps]
                           if partial else None)


def _on_ranks(tp, t: torch.Tensor):
    return [t.to(tp.devices[r]) for r in tp.ranks]


def _seq_slice(tp, xs, sp: bool):
    if not sp:
        return xs
    n = xs[0].shape[1] // tp.size
    return [x[:, r * n:(r + 1) * n] for r, x in zip(tp.ranks, xs)]


def _enc_layer_tp(src, cfg: ModelConfig, i: int, positions, sp: bool,
                  *xs):
    """Encoder layer ``i`` on the group, its slices gathered inside (and
    dropped when it returns, before the next layer's)."""
    tp = src.group
    ps = src.block(("enc_layers",), i)
    sel, partial = _attn_tp(tp, cfg, ps, "attn")
    hs = blocks.whole_seq(tp, [layers.layernorm(p["ln1"], x)
                               for p, x in zip(ps, xs)], sp)
    parts = [attention.attend_full(p["attn"], cfg, h, pos, causal=False,
                                   kv_sel=k, partial=partial)
             for p, h, pos, k in zip(ps, hs, positions, sel)]
    xs = blocks.mix_into(tp, list(xs), parts, partial, sp)
    return tuple(_mlp_tp(tp, cfg, ps, xs, "ln2", sp))


def encode_tp(src, cfg: ModelConfig, frames: torch.Tensor, sp: bool,
              policy: str = "none"):
    """:func:`encode` on the group; the encoder's output whole on every
    rank (the decoder's cross-attention reads all of it). ``policy``: the
    remat policy of each layer (training: ``cfg.remat``)."""
    tp = src.group
    b, s, _ = frames.shape
    pe = layers.sinusoidal_positions(s, cfg.d_model, frames.device)
    xs = _seq_slice(tp, [(f.to(cfg.adtype) + e.to(cfg.adtype)[None])
                         for f, e in zip(_on_ranks(tp, frames),
                                         _on_ranks(tp, pe))], sp)
    positions = _on_ranks(tp, torch.zeros((b, s), dtype=torch.int32,
                                            device=frames.device))
    for i in range(cfg.n_layers):
        xs = remat.maybe_remat(functools.partial(
            _enc_layer_tp, src, cfg, i, positions, sp), policy)(*xs)
    xs = [layers.layernorm(p, x) for p, x in zip(src.block(("enc_ln",)), xs)]
    return blocks.whole_seq(tp, xs, sp)


def _cross_tp(tp, cfg, ps, hs, caches, i: int, enc=None,
              seq: bool = False):
    """Each rank's cross-attention heads against the encoder's keys and
    values (written into the cache at prefill, from ``enc``); ``seq``:
    the cache splits the encoder positions (``attention``'s split
    softmax)."""
    sel, partial = _attn_tp(tp, cfg, ps, "xattn")
    if seq:
        xps = [p["xattn"] for p in ps]
        cross = [_layer(c["cross"], i) for c in caches]
        if enc is not None:
            return attention.prefill_seq_tp(
                tp, xps, cfg, hs, [None] * len(hs), cross, partial,
                enc), partial
        return attention.cross_decode_seq_tp(tp, xps, cfg, hs, cross,
                                             partial), partial
    parts = []
    for j, (p, h, c, k) in enumerate(zip(ps, hs, caches, sel)):
        xp = p["xattn"]
        if enc is not None:
            c["cross"]["k"][i] = attention._proj(enc[j], xp["wk"])
            c["cross"]["v"][i] = attention._proj(enc[j], xp["wv"])
        ck, cv = c["cross"]["k"][i], c["cross"]["v"][i]
        q = attention._proj(h, xp["wq"])
        if enc is not None:
            out = attention._attend_maybe_chunked(
                q, attention._take(ck, k), attention._take(cv, k), cfg,
                causal=False)
        else:
            mask = torch.ones((1, 1, ck.shape[1]), dtype=torch.bool,
                              device=h.device)
            out = attention._grouped_attend(q, attention._take(ck, k),
                                            attention._take(cv, k), mask)
        parts.append(attention._out_proj(out, xp["wo"], partial))
    return parts, partial


def prefill_tp(src, cfg: ModelConfig, batch: Dict, caches, sp: bool,
               sp_enc: bool = False, sharder=None, kv_seq=None
               ) -> torch.Tensor:
    """:func:`prefill` on the group of ``src`` (``models/lm.prefill_tp``):
    ``sp_enc`` splits the encoder's stream, ``sp`` the decoder's;
    ``kv_seq`` says whether the ``self`` and ``cross`` caches split the
    sequence."""
    tp = src.group
    kv_seq = kv_seq or {}
    enc = encode_tp(src, cfg, batch["enc_embeddings"], sp_enc)
    tokens = batch["tokens"]
    b, s = tokens.shape
    xs = _embed_tp(src, cfg, tokens, sp)
    xs = [x + e for x, e in zip(xs, _seq_slice(tp, [
        _dec_positions({"dec_pos": t}, cfg, s)[None] for t in
        src.block(("dec_pos",))], sp))]
    positions = _on_ranks(tp, torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None].expand(b, s))
    for i in range(cfg.n_layers):
        ps = src.block(("dec_layers",), i)
        sel, partial = _attn_tp(tp, cfg, ps, "attn")
        hs = blocks.whole_seq(tp, [layers.layernorm(p["ln1"], x)
                                   for p, x in zip(ps, xs)], sp)
        if kv_seq.get("self"):
            parts = attention.prefill_seq_tp(
                tp, [p["attn"] for p in ps], cfg, hs, positions,
                [_layer(c["self"], i) for c in caches], partial)
        else:
            parts = [attention.prefill_into_cache(
                p["attn"], cfg, h, pos, _layer(c["self"], i), kv_sel=k,
                partial=partial)[0]
                for p, h, pos, c, k in zip(ps, hs, positions, caches, sel)]
        xs = blocks.mix_into(tp, xs, parts, partial, sp)
        hs = blocks.whole_seq(tp, [layers.layernorm(p["ln_x"], x)
                                   for p, x in zip(ps, xs)], sp)
        parts, partial = _cross_tp(tp, cfg, ps, hs, caches, i, enc,
                                   kv_seq.get("cross", False))
        xs = blocks.mix_into(tp, xs, parts, partial, sp)
        xs = _mlp_tp(tp, cfg, ps, xs, "ln2", sp)
        del ps
    last = [x[:, -1:] for x in xs]
    if sp:
        last = [x[:, -1:] for x in coll.all_gather(tp, last, 1)]
    return _logits_tp(src, cfg, last)


def _dec_layer_tp(src, cfg: ModelConfig, i: int, positions, sp: bool,
                  n: int, *args):
    """Decoder layer ``i`` on the group without a cache (training): the
    ranks' streams ``args[:n]`` and the encoder's output ``args[n:]``,
    each rank its self and cross attention heads."""
    tp = src.group
    xs, enc = list(args[:n]), args[n:]
    ps = src.block(("dec_layers",), i)
    sel, partial = _attn_tp(tp, cfg, ps, "attn")
    hs = blocks.whole_seq(tp, [layers.layernorm(p["ln1"], x)
                               for p, x in zip(ps, xs)], sp)
    parts = [attention.attend_full(p["attn"], cfg, h, pos, kv_sel=k,
                                   partial=partial)
             for p, h, pos, k in zip(ps, hs, positions, sel)]
    xs = blocks.mix_into(tp, xs, parts, partial, sp)
    sel, partial = _attn_tp(tp, cfg, ps, "xattn")
    hs = blocks.whole_seq(tp, [layers.layernorm(p["ln_x"], x)
                               for p, x in zip(ps, xs)], sp)
    parts = [attention.attend_full(p["xattn"], cfg, h, pos, causal=False,
                                   kv_x=e, rope=False, kv_sel=k,
                                   partial=partial)
             for p, h, pos, e, k in zip(ps, hs, positions, enc, sel)]
    xs = blocks.mix_into(tp, xs, parts, partial, sp)
    return tuple(_mlp_tp(tp, cfg, ps, xs, "ln2", sp))


def loss_fn_tp(src, cfg: ModelConfig, batch: Dict, sp: bool,
               sp_enc: bool = False, sharder=None):
    """:func:`loss_fn` on the group of ``src`` (built with gradient
    buffers: ``models/lm.loss_fn_tp``): the encoder and each decoder
    layer under ``cfg.remat``, then the vocab-parallel CE against the
    tied table. ``sp_enc`` splits the encoder's stream, ``sp`` the
    decoder's. Returns (the CE on the group's first running rank, {})."""
    from repro_torch.models.lm import chunked_cross_entropy_tp
    tp = src.group
    enc = encode_tp(src, cfg, batch["enc_embeddings"], sp_enc, cfg.remat)
    tokens = batch["tokens"]
    b, s = tokens.shape
    xs = _embed_tp(src, cfg, tokens, sp)
    xs = [x + e for x, e in zip(xs, _seq_slice(tp, [
        _dec_positions({"dec_pos": t}, cfg, s)[None] for t in
        src.block(("dec_pos",))], sp))]
    positions = _on_ranks(tp, torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None].expand(b, s))
    for i in range(cfg.n_layers):
        xs = remat.maybe_remat(functools.partial(
            _dec_layer_tp, src, cfg, i, positions, sp, len(xs)),
            cfg.remat)(*xs, *enc)
    xs = [layers.layernorm(p, x) for p, x in zip(src.block(("dec_ln",)), xs)]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    tables = [p["table"] for p in src.block(("embedding",))]
    ce = chunked_cross_entropy_tp(tp, xs, tables, labels, s - 1,
                                  cfg.vocab_size, sp)
    return ce, {}


def _embed_tp(src, cfg: ModelConfig, tokens, sp: bool):
    tables = [p["table"] for p in src.block(("embedding",))]
    return layers.embed_tp(src.group, tables, _on_ranks(src.group, tokens),
                           cfg.adtype, cfg.vocab_size, sp)


def _logits_tp(src, cfg: ModelConfig, xs):
    xs = [layers.layernorm(p, x) for p, x in zip(src.block(("dec_ln",)), xs)]
    tables = [p["table"] for p in src.block(("embedding",))]
    return layers.unembed_tp(src.group, tables, xs, cfg.vocab_size)[0][:, 0]


def decode_step_tp(src, cfg: ModelConfig, tokens: torch.Tensor, pos,
                   caches, sharder=None, kv_seq=None) -> torch.Tensor:
    """:func:`decode_step` on the group of ``src``: the logits (B, V) on
    its first rank, ``caches`` updated in place; ``kv_seq`` as in
    :func:`prefill_tp`."""
    tp = src.group
    kv_seq = kv_seq or {}
    pos = int(pos)
    xs = _embed_tp(src, cfg, tokens, False)
    xs = [x + t[min(pos, t.shape[0] - 1)][None].to(cfg.adtype)[None]
          for x, t in zip(xs, src.block(("dec_pos",)))]
    for i in range(cfg.n_layers):
        ps = src.block(("dec_layers",), i)
        sel, partial = _attn_tp(tp, cfg, ps, "attn")
        hs = [layers.layernorm(p["ln1"], x) for p, x in zip(ps, xs)]
        if kv_seq.get("self"):
            parts = attention.decode_seq_tp(
                tp, [p["attn"] for p in ps], cfg, hs, pos,
                [_layer(c["self"], i) for c in caches], partial)
        else:
            parts = [attention.decode_step_attn(
                p["attn"], cfg, h, pos, _layer(c["self"], i), kv_sel=k,
                partial=partial)[0]
                for p, h, c, k in zip(ps, hs, caches, sel)]
        xs = blocks.mix_into(tp, xs, parts, partial, False)
        hs = [layers.layernorm(p["ln_x"], x) for p, x in zip(ps, xs)]
        parts, partial = _cross_tp(tp, cfg, ps, hs, caches, i,
                                   seq=kv_seq.get("cross", False))
        xs = blocks.mix_into(tp, xs, parts, partial, False)
        xs = _mlp_tp(tp, cfg, ps, xs, "ln2", False)
        del ps
    return _logits_tp(src, cfg, xs)
