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
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.common.param import Boxed, KeyGen, normal_init, \
    tree_from_numpy, tree_map, unbox, unstack
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, remat
from repro_torch.models.config import ModelConfig

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
