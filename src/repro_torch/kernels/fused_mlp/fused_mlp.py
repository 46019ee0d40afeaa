"""Launches the fully fused MLP kernel (``csrc/mlp.cu``).

It replaces the JAX package's ``kernels/fused_mlp/fused_mlp.py:
fused_mlp_pallas``. The products bound it on the card (29,056 flops against
140 bytes per row at NeRF's colour MLP), so it runs them on the tensor
cores: a persistent block per SM stages the weights once into shared
memory, and each warp carries 16 rows through every layer in registers
with ``mma.sync`` TF32 products in the 3xTF32 split, which keeps f32
accuracy. The source notes in ``csrc/mlp.cu`` and ``csrc/mlp.cuh`` say
more. Weights are f32 or bf16 (converted exactly as they are staged, as
the JAX kernel's ``astype(f32)``).

:func:`mlp_plan` is the kernel's shared-memory plan; the wrapper raises on
a width or a plan the kernel does not take.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.mlp import MLPConfig
from repro_torch.kernels.build import I64, INT, PTR, CudaKernel
from repro_torch.kernels.common import check_kernel_input

MLP_FWD = CudaKernel("mlp_fwd", [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                                 PTR, I64])
# shared memory a block may use on Hopper (csrc/mlp.cuh kMaxSmemBytes)
MAX_SMEM_BYTES = 232_448
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def tiles8(n: int) -> int:
    """8-wide tiles that cover n (csrc/mlp.cuh tiles8)."""
    return -(-n // 8)


def check_hidden(cfg: MLPConfig, max_hidden: int) -> int:
    """The padded hidden width the kernels are built for (64, or 128 where
    ``max_hidden`` allows it); raises on any other hidden width."""
    h = cfg.hidden_dim
    if h % 8 or not 8 <= h <= max_hidden:
        raise ValueError(f"hidden width {h}: the kernel takes a multiple of 8 "
                         f"from 8 to {max_hidden}")
    return 64 if h <= 64 else 128


def weight_bytes(cfg: MLPConfig, hidden_padded: int) -> int:
    """Shared memory of the staged weights: every matrix zero-padded to
    multiples of 8 (the hidden width to ``hidden_padded``), each f32 kept
    as a TF32 hi and lo pair (csrc/mlp.cuh weight_frags)."""
    nt = hidden_padded // 8
    frags = 32 * (tiles8(cfg.in_dim) * nt + (cfg.n_hidden - 1) * nt * nt
                  + nt * tiles8(cfg.out_dim))
    return frags * 16


def check_smem(what: str, smem: int) -> None:
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: the kernel's shared-memory plan needs "
                         f"{smem} bytes, more than the {MAX_SMEM_BYTES} a "
                         "block may use")


def mlp_plan(cfg: MLPConfig) -> Dict[str, int]:
    """The standalone MLP kernel's plan for ``cfg``: padded hidden width,
    warps per block, shared memory per block. Raises if the kernel does
    not take ``cfg``."""
    if min(cfg.in_dim, cfg.out_dim, cfg.n_hidden) < 1:
        raise ValueError(f"no MLP kernel for {cfg}")
    hp = check_hidden(cfg, 128)
    plan = {"hidden_padded": hp, "warps": 16 if hp == 64 else 8,
            "smem_bytes": weight_bytes(cfg, hp)}
    check_smem(f"MLP {cfg}", plan["smem_bytes"])
    return plan


def check_weights(w_in: torch.Tensor, w_hidden: Optional[torch.Tensor],
                  w_out: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Raise unless the weights are contiguous, of ``cfg``'s shapes and all
    f32 or all bf16; returns the tensor to pass for ``w_hidden`` (``w_in``,
    never read, when there is none)."""
    h = cfg.hidden_dim
    check_kernel_input("w_in", w_in, (cfg.in_dim, h), dtypes=WEIGHT_DTYPES)
    check_kernel_input("w_out", w_out, (h, cfg.out_dim), dtypes=WEIGHT_DTYPES)
    if cfg.n_hidden > 1:
        check_kernel_input("w_hidden", w_hidden, (cfg.n_hidden - 1, h, h),
                           dtypes=WEIGHT_DTYPES)
    else:
        w_hidden = w_in
    if len({w_in.dtype, w_hidden.dtype, w_out.dtype}) != 1:
        raise TypeError("the kernel takes weights of one dtype, got "
                        f"{w_in.dtype}, {w_hidden.dtype}, {w_out.dtype}")
    return w_hidden


def fused_mlp_cuda(x: torch.Tensor, w_in: torch.Tensor,
                   w_hidden: Optional[torch.Tensor], w_out: torch.Tensor,
                   cfg: MLPConfig) -> torch.Tensor:
    """x (B, in_dim) f32 -> (B, out_dim) f32, all on one CUDA device;
    weights f32 or bf16. x must be 8-byte aligned when in_dim is even."""
    mlp_plan(cfg)
    b = x.shape[0]
    check_kernel_input("x", x, (b, cfg.in_dim))
    if cfg.in_dim % 2 == 0 and x.data_ptr() % 8:
        # csrc/mlp.cu loads two floats at once from rows of an even width
        raise ValueError("x: rows of an even width must be 8-byte aligned")
    w_hidden = check_weights(w_in, w_hidden, w_out, cfg)
    out = torch.empty((b, cfg.out_dim), dtype=torch.float32, device=x.device)
    MLP_FWD(x.device, x.data_ptr(), w_in.data_ptr(), w_hidden.data_ptr(),
            w_out.data_ptr(), int(w_in.dtype == torch.bfloat16), cfg.in_dim,
            cfg.hidden_dim, cfg.n_hidden, cfg.out_dim, out.data_ptr(), b)
    return out
