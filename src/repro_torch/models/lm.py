"""Unified decoder-only LM: init / forward / loss / prefill / decode, the
JAX package's ``models/lm.py`` in plain PyTorch.

The parameter layout is the JAX one: each sub-layer of a block period
(``blocks.block_period``) is a subtree ``blocks/sub{p}`` whose leaves are
stacked over the ``n_periods`` periods, with a leading ``'layers'``
logical axis. The JAX package scans over that axis (``lax.scan``, via
``models/scan_util.py``); the port loops over it in Python and indexes
each period's slice, so it needs no ``scan_util``. Caches are stacked the
same way and are filled and updated in place (the JAX steps carry and
donate theirs); ``prefill`` and ``decode_step`` return them.

Training differentiates ``loss_fn`` with autograd and bounds its memory
as the JAX package does with ``jax.checkpoint``: each block runs under
``cfg.remat`` (``models/remat.py``: "full" keeps only the block's input
for the backward), and each sequence chunk of ``chunked_cross_entropy``
is recomputed by the backward, so no chunk's (B, c, V) logits are kept.
``hidden_states`` takes the period slices with ``common.param.unstack``
(one ``unbind`` a leaf, one gradient stack in the backward). The serving
path runs without autograd and recomputes nothing.

``prefill_tp`` and ``decode_step_tp`` serve on a tensor-parallel group
(``models/blocks``): the params come from a block source (``parallel/
api``), which hands each running rank its slice of one block at a time
(``src.block(path, period)``: the embedding, each sub-layer of a period,
the final norm, the unembedding), and each block's slices are dropped
once the block has run.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.common.param import Boxed, KeyGen, tree_from_numpy, \
    tree_map, unbox, unstack
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, remat
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll


def n_periods(cfg: ModelConfig) -> int:
    return cfg.n_layers // blocks.block_period(cfg)


def _with_layers_axis(tree):
    """Prepend the 'layers' logical axis to every Boxed leaf."""
    return tree_map(lambda b: Boxed(b.value, ("layers",) + b.axes), tree,
                    is_leaf=lambda x: isinstance(x, Boxed))


def init_lm(kg: KeyGen, cfg: ModelConfig) -> Dict:
    """Returns a Boxed tree. Layer params are stacked over periods with a
    leading 'layers' logical axis. ``kg``'s device is where they live
    (``KeyGen(seed, "meta")`` for shapes only)."""
    period = blocks.block_period(cfg)
    np_ = n_periods(cfg)
    params: Dict = {
        "embedding": layers.init_embedding(kg, cfg.vocab_size, cfg.d_model,
                                           cfg.pdtype),
        "final_norm": layers.init_rmsnorm(kg, cfg.d_model, cfg.pdtype),
    }
    if not cfg.tie_embeddings:
        params["unembedding"] = layers.init_embedding(
            kg, cfg.vocab_size, cfg.d_model, cfg.pdtype)
    params["blocks"] = {
        f"sub{p}": _with_layers_axis(
            blocks.init_block(kg, cfg, p, lead=(np_,)))
        for p in range(period)}
    return params


def from_jax_params(np_tree, cfg: ModelConfig, device=None) -> Dict:
    """A JAX ``unbox(lm.init_lm(key, cfg))[0]`` tree, as numpy arrays, as
    the port's params on ``device`` (CUDA unless named): the same keys and
    stacked shapes, dtypes kept; a missing or extra key or another shape
    raises."""
    expected = unbox(init_lm(KeyGen(0, "meta"), cfg))[0]
    return tree_from_numpy(np_tree, expected, resolve_device(device))


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Token ids or stubbed modality embeddings (audio frames / vision
    patches, per the assignment's frontend-stub rule)."""
    if "embeddings" in batch:
        return batch["embeddings"].to(cfg.adtype)
    return layers.embed(params["embedding"], batch["tokens"], cfg.adtype)


def _positions(cfg: ModelConfig, batch: Dict, b: int, s: int, device):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)
    if cfg.m_rope_sections is not None:
        pos = pos[None].expand(3, b, s)     # t == h == w for text
    return pos


def _index(tree, i: int):
    """Period ``i``'s slice of a stacked (params or cache) tree: views."""
    return tree_map(lambda a: a[i], tree)


def _unembed_table(params):
    return params.get("unembedding", params["embedding"])


def forward(params, cfg: ModelConfig, batch: Dict, sharder=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits (B, S, V), aux)."""
    x, aux = hidden_states(params, cfg, batch, sharder=sharder)
    return layers.unembed(_unembed_table(params), x), aux


def _layer_sharder(sharder, i: int, p: int):
    """``sharder`` inside period ``i``'s sub-layer ``p`` (None stays)."""
    return None if sharder is None else sharder.at_layer((i, p))


def hidden_states(params, cfg: ModelConfig, batch: Dict, sharder=None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Forward without the unembedding: (B, S, d) final-norm states."""
    x = _embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions(cfg, batch, b, s, x.device)
    period = blocks.block_period(cfg)
    np_ = n_periods(cfg)
    subs = [unstack(params["blocks"][f"sub{p}"], np_)
            for p in range(period)]
    # remat per block, not per period: a hybrid period (jamba: 8 layers)
    # as one unit would hold the whole period's intermediates in its
    # backward, as in the JAX package
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(np_):
        for p in range(period):
            fn = remat.maybe_remat(functools.partial(
                _apply_block, cfg, p, positions,
                _layer_sharder(sharder, i, p)), cfg.remat)
            x, aux = fn(subs[p][i], x)
            if "moe_aux_loss" in aux:
                aux_sum = aux_sum + aux["moe_aux_loss"]
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, {"moe_aux_loss": aux_sum}


def _apply_block(cfg: ModelConfig, p: int, positions, sharder, sub_params,
                 x):
    return blocks.apply_block(sub_params, cfg, p, x, positions,
                              sharder=sharder)


def _ce_chunk(table, xb, lb) -> torch.Tensor:
    """The summed CE of one sequence chunk (its logits are transient)."""
    logits = layers.unembed({"table": table}, xb)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, lb[..., None].long())[..., 0].float()
    return torch.sum(logz - gold)


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor,
                          seq_chunk: int = 512) -> torch.Tensor:
    """CE against a big vocab without materializing (B, S, V) logits: one
    sequence chunk's logits at a time, each chunk recomputed by the
    backward (saving them is the memory the chunking exists to avoid).
    The chunk is the largest divisor of S up to ``seq_chunk``, as in the
    JAX function: a prime S runs one position a chunk."""
    b, s, d = x.shape
    c = next(cc for cc in range(min(seq_chunk, s), 0, -1) if s % cc == 0)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(0, s, c):
        total = total + remat.checkpoint(_ce_chunk, table, x[:, j:j + c],
                                         labels[:, j:j + c])
    return total / (b * s)


def loss_fn(params, cfg: ModelConfig, batch: Dict, sharder=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (labels = batch['labels'] or shifted
    tokens), computed seq-chunked so full logits never hit memory."""
    x, aux = hidden_states(params, cfg, batch, sharder=sharder)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = batch["tokens"][:, 1:]
        x = x[:, :-1]
    ce = chunked_cross_entropy(x, _unembed_table(params)["table"], labels)
    loss = ce + 0.01 * aux.get("moe_aux_loss", 0.0) / max(cfg.n_layers, 1)
    return loss, {"ce": ce, **aux}


# --------------------------------------------------------------- serving
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> Dict:
    """Stacked (over periods) per-sublayer caches on ``device`` (CUDA
    unless named); ring slots start at -1 (empty), not 0."""
    device = resolve_device(device)
    np_ = n_periods(cfg)
    return {f"sub{p}": blocks.init_block_cache(cfg, p, batch, capacity,
                                               device=device, lead=(np_,))
            for p in range(blocks.block_period(cfg))}


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of :func:`init_cache`'s leaves."""
    return {f"sub{p}": {k: ("layers",) + ax for k, ax in
                        blocks.block_cache_axes(cfg, p).items()}
            for p in range(blocks.block_period(cfg))}


def prefill(params, cfg: ModelConfig, batch: Dict, cache: Dict,
            sharder=None) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt; returns (last-token logits (B, V), cache), the
    cache filled in place."""
    x = _embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions(cfg, batch, b, s, x.device)
    period = blocks.block_period(cfg)
    for i in range(n_periods(cfg)):
        for p in range(period):
            x, _ = blocks.prefill_block(
                _index(params["blocks"][f"sub{p}"], i), cfg, p, x,
                positions, _index(cache[f"sub{p}"], i),
                sharder=_layer_sharder(sharder, i, p))
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = layers.unembed(_unembed_table(params), x)[:, 0]
    return logits, cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                pos, cache: Dict, sharder=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens (B, 1) int; ``pos`` the new token's position
    (a host int: the lockstep batch's). The cache is updated in place."""
    pos = int(pos)
    x = layers.embed(params["embedding"], tokens, cfg.adtype)
    period = blocks.block_period(cfg)
    for i in range(n_periods(cfg)):
        for p in range(period):
            x, _ = blocks.decode_block(
                _index(params["blocks"][f"sub{p}"], i), cfg, p, x, pos,
                _index(cache[f"sub{p}"], i),
                sharder=_layer_sharder(sharder, i, p))
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = layers.unembed(_unembed_table(params), x)[:, 0]
    return logits, cache


# ------------------------------------------------------ tensor parallelism
def _on_ranks(tp, t: torch.Tensor):
    """``t`` on each running rank's device."""
    return [t.to(tp.devices[r]) for r in tp.ranks]


def _embed_inputs_tp(src, cfg: ModelConfig, batch: Dict, sp: bool):
    tp = src.group
    if "embeddings" in batch:
        xs = [e.to(cfg.adtype) for e in _on_ranks(tp, batch["embeddings"])]
        if sp:
            n = xs[0].shape[1] // tp.size
            xs = [x[:, r * n:(r + 1) * n] for r, x in zip(tp.ranks, xs)]
        return xs
    tables = [p["table"] for p in src.block(("embedding",))]
    return layers.embed_tp(tp, tables, _on_ranks(tp, batch["tokens"]),
                           cfg.adtype, cfg.vocab_size, sp)


def _logits_tp(src, cfg: ModelConfig, xs):
    """Final norm and unembedding of each rank's (B, 1, d): the logits
    (B, V) on rank 0 of the group."""
    xs = [layers.rmsnorm(p, x, cfg.norm_eps)
          for p, x in zip(src.block(("final_norm",)), xs)]
    key = "unembedding" if "unembedding" in src.keys else "embedding"
    tables = [p["table"] for p in src.block((key,))]
    return layers.unembed_tp(src.group, tables, xs, cfg.vocab_size)[0][:, 0]


def prefill_tp(src, cfg: ModelConfig, batch: Dict, caches, sp: bool,
               sharder=None, kv_seq=None) -> torch.Tensor:
    """:func:`prefill` on the tensor-parallel group of the block source
    ``src``: ``caches`` one per running rank (its shard of the cache),
    filled in place; ``sp`` splits the stream along the sequence;
    ``kv_seq`` which sub-layers' caches split the sequence
    (``parallel/tp.kv_seq``). Returns the last-token logits (B, V) on the
    group's first rank."""
    kv_seq = kv_seq or {}
    tp = src.group
    xs = _embed_inputs_tp(src, cfg, batch, sp)
    inp = batch["embeddings" if "embeddings" in batch else "tokens"]
    positions = _on_ranks(tp, _positions(cfg, batch, inp.shape[0],
                                         inp.shape[1], inp.device))
    period = blocks.block_period(cfg)
    for i in range(n_periods(cfg)):
        for p in range(period):
            xs = blocks.prefill_block_tp(
                tp, src.block(("blocks", f"sub{p}"), i), cfg, p, xs,
                positions, [_index(c[f"sub{p}"], i) for c in caches], sp,
                sharder=_layer_sharder(sharder, i, p),
                kv_seq=kv_seq.get(f"sub{p}", False))
    last = [x[:, -1:] for x in xs]
    if sp:          # the last token is the last rank's
        last = [x[:, -1:] for x in coll.all_gather(tp, last, 1)]
    return _logits_tp(src, cfg, last)


def _ce_chunk_tp(tp, vocab: int, sp: bool, n: int, *args):
    """One chunk of :func:`chunked_cross_entropy_tp`: each running rank's
    summed CE of the chunk (the same value on every rank)."""
    xs, tables, labels, valid = (list(args[i * n:(i + 1) * n])
                                 for i in range(4))
    if sp:
        xs = coll.all_gather(tp, xs, 1)
    logits = [layers.unembed({"table": t}, x) for t, x in zip(tables, xs)]
    rows = tables[0].shape[0]
    if rows == vocab:           # a whole table: every rank the whole CE
        lse = [torch.logsumexp(l, -1) for l in logits]
        gold = [torch.gather(l, -1, lb[..., None])[..., 0]
                for l, lb in zip(logits, labels)]
    else:
        lse = coll.all_gather(tp, [torch.logsumexp(l, -1)[..., None]
                                   for l in logits], -1)
        lse = [torch.logsumexp(v, -1) for v in lse]
        mine = []
        for r, l, lb in zip(tp.ranks, logits, labels):
            local = lb - r * rows
            own = (local >= 0) & (local < rows)
            g = torch.gather(l, -1, local.clamp(0, rows - 1)[..., None])
            mine.append(torch.where(own, g[..., 0], torch.zeros(
                (), dtype=g.dtype, device=g.device)))
        gold = coll.all_reduce(tp, mine)
    return tuple(torch.sum(torch.where(v, z - g, torch.zeros(
        (), dtype=z.dtype, device=z.device)))
        for z, g, v in zip(lse, gold, valid))


def chunked_cross_entropy_tp(tp, xs, tables, labels: torch.Tensor,
                             n_valid: int, vocab: int, sp: bool,
                             seq_chunk: int = 512) -> torch.Tensor:
    """:func:`chunked_cross_entropy` on a tensor-parallel group, the
    vocab split: ``xs`` each running rank's final states (B, S, d), or
    its slice of the sequence under ``sp``; ``tables`` each rank's rows of
    the (vocab, embed) table; ``labels`` (B, S) the label of every
    position of the whole sequence, of which the first ``n_valid`` count
    (the last has none when the labels are the shifted tokens). For each
    chunk each rank computes its vocab columns' f32 logits and their
    logsumexp, the group gathers the (B, c) values and combines them, and
    the gold logit comes from the rank owning the label, zero elsewhere,
    summed over the group: the logits are never whole on a rank. Under
    ``sp`` each chunk takes a slice of every rank's sequence, gathered
    (a chunk of ``c`` positions a rank). A table that does not split
    gives every rank the whole CE. Each chunk is recomputed by the
    backward. Returns the mean CE on the group's first running rank."""
    b, s_local = xs[0].shape[:2]
    n = len(xs)
    per = max(1, seq_chunk // tp.size) if sp else seq_chunk
    c = next(cc for cc in range(min(per, s_local), 0, -1)
             if s_local % cc == 0)
    devices = [x.device for x in xs]
    seq = torch.arange(s_local * (tp.size if sp else 1),
                       device=labels.device)
    total = None
    for j in range(0, s_local, c):
        if sp:
            idx = torch.cat([seq[q * s_local + j:q * s_local + j + c]
                             for q in range(tp.size)])
        else:
            idx = seq[j:j + c]
        lab = labels[:, idx].long()
        ok = (idx < n_valid)[None].expand(b, -1)
        part = remat.checkpoint(
            functools.partial(_ce_chunk_tp, tp, vocab, sp, n),
            *[x[:, j:j + c] for x in xs], *tables,
            *[lab.to(d) for d in devices], *[ok.to(d) for d in devices])
        total = part[0] if total is None else total + part[0]
    return total / (b * n_valid)


def _block_tp(src, cfg: ModelConfig, i: int, p: int, positions, sp: bool,
              sharder, *xs):
    """Period ``i``'s sub-layer ``p`` on the group, its slices gathered
    inside (a checkpointed block gathers them again in the backward):
    (the new stream, one per rank, then the first rank's MoE aux
    loss)."""
    out, aux = blocks.apply_block_tp(
        src.group, src.block(("blocks", f"sub{p}"), i), cfg, p, list(xs),
        positions, sp, sharder=sharder)
    return (*out, aux.get("moe_aux_loss", torch.zeros(
        (), dtype=torch.float32, device=out[0].device)))


def loss_fn_tp(src, cfg: ModelConfig, batch: Dict, sp: bool, sharder=None
               ) -> Tuple[torch.Tensor, Dict]:
    """:func:`loss_fn` on the tensor-parallel group of the block source
    ``src`` (built with gradient buffers: a train step): the embedding,
    each block under ``cfg.remat`` with its slices gathered inside the
    recomputed function (the backward gathers them again), the final
    norm and the vocab-parallel CE (:func:`chunked_cross_entropy_tp`).
    ``sp`` splits the stream along the sequence. Returns (the loss, its
    ``ce`` and ``moe_aux_loss``), on the group's first running rank (the
    MoE's aux summed over the layers as that rank formed it)."""
    tp = src.group
    xs = _embed_inputs_tp(src, cfg, batch, sp)
    inp = batch["embeddings" if "embeddings" in batch else "tokens"]
    b, s = inp.shape[:2]
    positions = _on_ranks(tp, _positions(cfg, batch, b, s, inp.device))
    aux_sum = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    for i in range(n_periods(cfg)):
        for p in range(blocks.block_period(cfg)):
            fn = remat.maybe_remat(functools.partial(
                _block_tp, src, cfg, i, p, positions, sp,
                _layer_sharder(sharder, i, p)), cfg.remat)
            *xs, aux = fn(*xs)
            aux_sum = aux_sum + aux
    xs = [layers.rmsnorm(p, x, cfg.norm_eps)
          for p, x in zip(src.block(("final_norm",)), xs)]
    if "labels" in batch:
        labels, n_valid = batch["labels"], s
    else:
        tok = batch["tokens"]
        labels = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], 1)
        n_valid = s - 1
    key = "unembedding" if "unembedding" in src.keys else "embedding"
    tables = [p["table"] for p in src.block((key,))]
    ce = chunked_cross_entropy_tp(tp, xs, tables, labels, n_valid,
                                  cfg.vocab_size, sp)
    loss = ce + 0.01 * aux_sum / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "moe_aux_loss": aux_sum}


def decode_step_tp(src, cfg: ModelConfig, tokens: torch.Tensor, pos,
                   caches, sharder=None, kv_seq=None) -> torch.Tensor:
    """:func:`decode_step` on the tensor-parallel group of ``src``: the
    logits (B, V) on the group's first rank; ``caches`` updated in
    place; ``kv_seq`` as in :func:`prefill_tp`."""
    tp = src.group
    kv_seq = kv_seq or {}
    pos = int(pos)
    xs = _embed_inputs_tp(src, cfg, {"tokens": tokens}, False)
    period = blocks.block_period(cfg)
    for i in range(n_periods(cfg)):
        for p in range(period):
            xs = blocks.decode_block_tp(
                tp, src.block(("blocks", f"sub{p}"), i), cfg, p, xs, pos,
                [_index(c[f"sub{p}"], i) for c in caches],
                sharder=_layer_sharder(sharder, i, p),
                kv_seq=kv_seq.get(f"sub{p}", False))
    return _logits_tp(src, cfg, xs)
