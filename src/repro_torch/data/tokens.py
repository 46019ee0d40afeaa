"""Synthetic-but-structured LM token stream, the JAX package's
``data/tokens.py`` (framework-free numpy, copied so that the port imports
nothing of the JAX package).

The stream mixes Zipfian unigrams with repeated n-gram motifs, so the
cross entropy falls during a run (uniform noise would not).
``SyntheticTokens.batch(step)`` is a pure function of ``(seed, step,
host_id)``: the same ``np.random.default_rng`` calls in the same order as
the JAX module, so its batches equal the JAX ones bit for bit, and a
resumed run sees the stream an uninterrupted one would have.

``Prefetcher`` runs an iterator on a background thread, ``depth`` items
ahead; its ``to_device`` callback moves each item to the device there
(the training engine pins the host arrays and copies them with
``non_blocking=True``, so the copy of the next chunk's batches overlaps
the current chunk's steps).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticTokens:
    """Deterministic infinite token stream (numpy RNG, on the host)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id, self.n_hosts = host_id, n_hosts
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.local_batch = cfg.global_batch // n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.motifs = rng.integers(
            0, v, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's batch of global step ``step``: ``{"tokens": (local
        batch, seq_len) int32}``."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, self.host_id))
        b, s = self.local_batch, cfg.seq_len
        toks = rng.choice(len(self.unigram), size=(b, s),
                          p=self.unigram).astype(np.int32)
        # splice in motifs (predictable structure: a learnable signal)
        n_splice = int(cfg.motif_prob * b * s / cfg.motif_len)
        rows = rng.integers(0, b, n_splice)
        cols = rng.integers(0, max(s - cfg.motif_len, 1), n_splice)
        ids = rng.integers(0, cfg.n_motifs, n_splice)
        for r, c, i in zip(rows, cols, ids):
            toks[r, c:c + cfg.motif_len] = self.motifs[i]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch, ``depth`` items ahead of the consumer.
    An exception raised by the iterator or ``to_device`` is raised again
    by ``__next__``."""

    def __init__(self, it: Iterator, depth: int = 2, to_device=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._to_device = to_device

        def work():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    if self._to_device is not None:
                        item = self._to_device(item)
                    self._q.put((True, item))
            except BaseException as e:      # handed to the consumer
                self._q.put((False, e))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        ok, item = self._q.get()
        if not ok:
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
