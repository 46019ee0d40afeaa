"""Shared helpers of the kernel wrappers."""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.quant import qtypes


def pad_batch(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Pad dim 0 with zeros up to a multiple of ``block``.
    Returns (padded, orig_n)."""
    n = x.shape[0]
    padded = round_up(n, block)
    if padded == n:
        return x, n
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, padded - n]), n


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every tensor is a meta tensor: the wrapper then records
    its kernel's work on the active counter (``kernels/cost.record``) and
    returns an empty meta output of the kernel's shape and dtype. Nothing
    computes there, so this is no fallback: the plain version never runs
    on meta (its op-by-op count is not the kernel's work). A mix of meta
    and other devices raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"meta"}:
        return True
    if "meta" in kinds:
        raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}"
                         ": a meta call takes meta tensors only")
    return False


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the plain version should run: every tensor lies on the
    CPU. Tensors on a CUDA device go to the kernel, which checks them;
    a mix of devices, or any other device, raises (a wrapper takes meta
    tensors through :func:`on_meta` first)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                     "the kernels take tensors on one CUDA device, the plain "
                     "versions tensors on the CPU")


# Table dtypes the grid-encode kernels are instantiated for, and the code
# their C entry points take for each (csrc/encode.cuh TableDtype): f32 and
# bf16 are dense, int8 and fp8-e4m3 are codes with per-level scales.
TABLE_DTYPE_CODE = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2,
                    torch.bfloat16: 3}


def check_table_scales(tables: torch.Tensor, table_scales) -> None:
    """Raise unless a codec table comes with its per-level scales and a
    dense (f32 or bf16) table without: scales on a dense table, or none on a codec one,
    would render another scene without an error."""
    quantized = qtypes.is_quantized(tables)
    if quantized != (table_scales is not None):
        raise ValueError(f"tables dtype {tables.dtype} "
                         + ("requires" if quantized else "forbids")
                         + " table_scales")


def check_kernel_input(name: str, t: torch.Tensor, shape=None,
                       dtypes=(torch.float32,)) -> None:
    """Raise unless ``t`` is a contiguous tensor of one of ``dtypes`` (the
    kernel's own: float32 unless it says otherwise) and of ``shape``."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {list(dtypes)}, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd would record a call on ``tensors``: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@contextlib.contextmanager
def f32_matmuls():
    """Matrix products in true f32 inside the block, whatever the caller
    set: the backward passes' products (the JAX package's f32 XLA dots)
    must not drop to TF32 on the card. The flag is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
