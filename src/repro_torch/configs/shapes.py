"""The assigned input-shape cells (seq_len x global_batch) and per-arch
applicability rules."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str          # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable; else a human-readable skip reason (recorded in
    EXPERIMENTS.md — skips are per the assignment rules, not failures)."""
    if shape == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.swa_window is not None)
        if not sub_quadratic:
            return ("full-attention arch: long_500k requires sub-quadratic "
                    "attention (assignment: run for SSM/hybrid/linear-attn)")
        if cfg.is_encdec:
            return "enc-dec decoder is full-attention; skip long_500k"
    return None
