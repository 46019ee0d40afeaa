"""Fully-fused tiny MLPs: no biases, ReLU hidden activations, linear
output (Table I / tiny-cuda-nn). The plain PyTorch version of the JAX
package's ``core/mlp.py``; the CUDA kernel of ``kernels/fused_mlp`` holds
the same function."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    hidden_dim: int = 64
    n_hidden: int = 3          # Table I 'layers='
    out_dim: int = 16


def _scaled_normal(shape, generator, fan_in: int) -> torch.Tensor:
    """LeCun-style normal / sqrt(fan_in), as the JAX package initializes."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32)
            / math.sqrt(float(max(fan_in, 1))))


def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
    """Weights drawn on the CPU from ``generator``."""
    params = {
        "w_in": _scaled_normal((cfg.in_dim, cfg.hidden_dim), generator,
                               cfg.in_dim),
        "w_out": _scaled_normal((cfg.hidden_dim, cfg.out_dim), generator,
                                cfg.hidden_dim),
    }
    if cfg.n_hidden > 1:
        params["w_hidden"] = _scaled_normal(
            (cfg.n_hidden - 1, cfg.hidden_dim, cfg.hidden_dim), generator,
            cfg.hidden_dim)
    return params


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: MLPConfig) -> torch.Tensor:
    """(B, in_dim) -> (B, out_dim), f32. bf16 weights are widened to f32
    (exactly) before their product, as the JAX package promotes them."""
    h = torch.relu(x @ params["w_in"].float())
    for k in range(cfg.n_hidden - 1):
        h = torch.relu(h @ params["w_hidden"][k].float())
    return h @ params["w_out"].float()
