"""granite's hybrid LM in a training cell: the reference's loss in row
blocks (its configuration is the file's: config.json keys), the controls
and the counted FLOPs of a step."""
from __future__ import annotations

from typing import Dict, List

import torch

from ngbench import lm_counts
from ngbench.reference import granite_hybrid as ref

# the controls of the check, each a switch of the reference's loss: the
# shared expert left out, the first held expert's picks left out, the
# residual stream rounded to float8 e4m3 between layers (a precision
# below the configuration's bfloat16)
CONTROLS = {"control_no_shared": {"shared": False},
            "control_drop_expert": {"drop_expert": 0},
            "control_fp8": {"round_fp8": True}}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The reference's params from leaves named as
    ``program_lm.reference_leaves`` names them."""
    out: Dict = {"embedding": flat["embedding"],
                 "final_norm": flat["final_norm"], "layers": []}
    layers: Dict[int, Dict] = {}
    for name, t in flat.items():
        if not name.startswith("layers/"):
            continue
        _, l, *path = name.split("/")
        node = layers.setdefault(int(l), {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    out["layers"] = [layers[l] for l in sorted(layers)]
    return out


def step_loss_and_grads(params: Dict[str, torch.Tensor], config: Dict,
                        batch: Dict[str, torch.Tensor], row_block: int,
                        switches: Dict) -> float:
    """One step's loss of the whole batch, its gradients accumulated into
    each leaf's ``.grad``, in blocks of ``row_block`` rows: the batch's
    pick counts first (no gradients), then each block's share of the loss
    and its backward, each layer recomputed by the backward."""
    tokens, labels = batch["tokens"], batch["labels"]
    nested = nest(params)
    rows = range(0, tokens.shape[0], row_block)
    counts: List = []
    for r in rows:
        c = ref.pick_counts(nested, config, tokens[r:r + row_block],
                            **switches)
        counts = c if not counts else [a + b for a, b in zip(counts, c)]
    k = config["num_experts_per_tok"]
    density = [c.float() / (labels.numel() * k) for c in counts]
    total = 0.0
    for r in rows:
        loss = ref.loss(nested, config, tokens[r:r + row_block],
                        labels[r:r + row_block], density=density,
                        n_total=labels.numel(), layer_checkpoint=True,
                        **switches)
        loss.backward()
        total += float(loss.detach())
    return total


def step_flops(config: Dict, rows: int, seq: int) -> float:
    return lm_counts.train_step_flops(config, rows, seq)
