"""Training batches of token ids, drawn on the device from the seed and
the step: the generator of the language-model training mixes.

A mix file gives ``rows`` sequences a step of ``seq_len`` tokens. Each
step's ids are uniform over the configuration's whole vocabulary, drawn
by a generator seeded from the run's seed and the step, so a step's batch
is the same whichever run or chunk asks for it; the labels are the next
ids (``seq_len + 1`` are drawn a row), with no padding.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ngbench.scenes import generator

STREAM = 2000          # the batches' generator streams start here


def make(params: Dict, seed: int, device, vocab: int
         ) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``batch(step)``: ``{"tokens", "labels"}``, each (rows, seq_len)
    int64 on ``device``."""
    if params.get("generator") != "token_batches":
        raise ValueError(f"not a token_batches mix: "
                         f"{params.get('generator')!r}")
    rows, seq = params["rows"], params["seq_len"]

    def batch(step: int) -> Dict[str, torch.Tensor]:
        gen = generator(seed, STREAM + step, device)
        ids = torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                            device=device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    return batch
