"""Model configuration covering all 10 assigned architectures: the JAX
package's ``models/config.py`` with torch dtypes.

``ModelConfig``, ``MoEConfig`` and ``SSMConfig`` keep every field of the
JAX dataclasses, so a config compares equal to its JAX twin field by
field (``dataclasses.asdict``). Two fields are inert in the port and kept
only for that: ``scan_layers`` and ``unroll_chunks`` (the port loops over
layer periods and SSD chunks in Python; there is no ``lax.scan`` to
unroll). ``remat`` is live: the training backward recomputes each block
as it says (``models/lm.py``). ``adtype`` and ``pdtype`` are
``torch.dtype``s."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    every: int = 1                # MoE on layers where (l % every) == offset
    offset: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length (train/prefill)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention options
    qk_norm: bool = False                   # qwen3
    qkv_bias: bool = False                  # qwen2
    swa_window: Optional[int] = None        # h2o-danube (mistral SWA)
    use_rope: bool = True                   # whisper: absolute positions
    rope_theta: float = 10000.0
    m_rope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # hybrid / ssm
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None        # jamba: 1 attn layer per period
    attn_offset: int = 4
    # encoder-decoder (whisper): n_layers applies to each side
    is_encdec: bool = False
    enc_seq_ratio: int = 1                  # encoder frames per decoder token
    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # the backward's recompute policy per block: "full" saves only each
    # block's input, "dots" also its weight products, "none" everything
    # (models/remat.maybe_remat)
    remat: str = "full"
    # the JAX package's layer / SSD-chunk scan switches: kept so that
    # configs compare equal, inert in the port (Python loops)
    scan_layers: bool = True
    unroll_chunks: bool = False
    # q-chunked attention: bound score materialization to
    # (B, H, q_chunk, S_k), the flash-attention memory shape, one query
    # block at a time. Active when seq >= 2*attn_q_chunk.
    attn_q_chunk: int = 1024
    # the JAX package repeats KV heads up to this count so the score tensor
    # shards 16-way on its TPU mesh (exact); the port attends grouped on
    # one device and never repeats them (models/attention.py)
    attn_kv_pad_to: int = 16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def adtype(self):
        return getattr(torch, self.act_dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' or 'ssm' for the mixer at this depth."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every:
            return ("attn" if layer_idx % self.attn_every == self.attn_offset
                    else "ssm")
        return "attn"

    def ffn_kind(self, layer_idx: int) -> str:
        """'dense' or 'moe' for the FFN at this depth."""
        if self.family == "ssm":
            return "none"                    # mamba2 blocks have no FFN
        if self.moe is None:
            return "dense"
        if layer_idx % self.moe.every == self.moe.offset:
            return "moe"
        return "dense"

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        d, hd = self.d_model, self.head_dim_
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for l in range(self.n_layers):
            if self.layer_kind(l) == "attn":
                total += d * (n_q + 2 * n_kv) + n_q * d
            else:
                s = self.ssm
                di = s.d_inner(d)
                g = s.n_groups * s.d_state
                total += d * (2 * di + 2 * g + s.n_heads(d)) + di * d
                total += s.d_conv * (di + 2 * g) + 2 * s.n_heads(d)
            fk = self.ffn_kind(l)
            if fk == "dense":
                total += 3 * d * self.d_ff
            elif fk == "moe":
                total += self.moe.n_experts * 3 * d * self.moe.d_expert
                total += d * self.moe.n_experts
            total += 2 * d                      # norms
        if self.is_encdec:                       # encoder side + cross-attn
            for _ in range(self.n_layers):
                total += 4 * d * d + 3 * d * self.d_ff / 1  # rough
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(1 for l in range(self.n_layers)
                         if self.ffn_kind(l) == "moe")
        inactive = (self.moe.n_experts - self.moe.top_k)
        total -= moe_layers * inactive * 3 * self.d_model * self.moe.d_expert
        return int(total)
