"""Quantized number formats for neural-field parameters: the port of the
JAX package's ``quant/qtypes.py``.

Three codecs, one dequant formula:

  * ``int8``        — symmetric:  q = clip(round(x / s), -127, 127)
  * ``int8_affine`` — asymmetric: q = clip(round(x / s) + z, -128, 127)
  * ``fp8_e4m3``    — scaled cast to ``torch.float8_e4m3fn`` (saturating)

Dequant is ALWAYS ``q.float() * scale`` (affine subtracts the zero point
first). The quantized kernels (``csrc/encode.cuh``) and the plain versions
apply it per gathered table row, before the lerp, in that order.

Scale leaves are SIBLINGS of the leaf they scale: ``k + "_scale"`` (and
``k + "_zero"`` for affine), shaped to broadcast against ``k`` — ``(L, 1,
1)`` per level for the ``(L, T, F)`` grid tables, ``(1, 1)`` per tensor and
``(n, 1, 1)`` per layer for MLP weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

# storage formats the field codecs understand
QTYPES = ("int8", "int8_affine", "fp8_e4m3")
# formats the kernels dequantize per gather (affine needs the extra zero
# point and is dequantized on entry instead)
KERNEL_QTYPES = ("int8", "fp8_e4m3")

INT8_QMAX = 127.0
FP8_E4M3_MAX = 448.0          # largest finite float8_e4m3fn
_EPS = 1e-12                  # scale floor: all-zero tensors quantize to 0


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Frozen quantization recipe, part of the field's identity: it lives
    in the frozen ``FieldConfig``, so the serve engine never stacks a
    quantized scene with a dense one.

    ``table_qtype`` must be one the kernels dequantize
    (:data:`KERNEL_QTYPES`); ``mlp_qtype`` may be any codec (MLP weights
    are dequantized on entry). ``percentile`` is the abs-max percentile
    over table rows used at calibration (100 = exact abs-max)."""
    table_qtype: Optional[str] = "int8"
    mlp_qtype: Optional[str] = None
    percentile: float = 100.0

    def __post_init__(self):
        if self.table_qtype is not None \
                and self.table_qtype not in KERNEL_QTYPES:
            raise ValueError(
                f"table_qtype {self.table_qtype!r} not kernel-dequantizable"
                f" (one of {KERNEL_QTYPES})")
        if self.mlp_qtype is not None and self.mlp_qtype not in QTYPES:
            raise ValueError(f"mlp_qtype {self.mlp_qtype!r} not in {QTYPES}")
        if not 0.0 < self.percentile <= 100.0:
            raise ValueError(f"percentile {self.percentile} not in (0, 100]")

    @property
    def tag(self) -> str:
        """Short stable label for bucket names and report rows."""
        parts = []
        if self.table_qtype:
            parts.append(f"t:{self.table_qtype}")
        if self.mlp_qtype:
            parts.append(f"m:{self.mlp_qtype}")
        return "+".join(parts) or "dense"


def storage_dtype(qtype: str) -> torch.dtype:
    if qtype in ("int8", "int8_affine"):
        return torch.int8
    if qtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown qtype {qtype!r}")


def qmax(qtype: str) -> float:
    """Largest magnitude the format represents (scale = absmax / qmax)."""
    return FP8_E4M3_MAX if qtype == "fp8_e4m3" else INT8_QMAX


def is_quantized(x) -> bool:
    """True for tensors (or dtypes) stored in a codec dtype (int8 / fp8)."""
    dt = x.dtype if isinstance(x, torch.Tensor) else x
    return dt in (torch.int8, torch.float8_e4m3fn)


# ------------------------------------------------------------------ scales
def _dims(x: torch.Tensor, axis) -> Tuple[int, ...]:
    if axis is None:
        return tuple(range(x.ndim))
    axis = (axis,) if isinstance(axis, int) else axis
    return tuple(sorted(a % x.ndim for a in axis))


def percentile_lastdim(x: torch.Tensor, percentile: float,
                       fuse_hi: bool = False) -> torch.Tensor:
    """Linear-interpolated percentile over the last dim, rounded as XLA
    compiles ``jnp.percentile`` on the CPU, so that calibrated scales equal
    the JAX package's bit for bit (``torch.quantile`` differs in the last
    bit): the rank is ``p * ((n - 1) / 100)`` in f32, and the lerp
    ``lo * (1 - w) + hi * w`` is one fused multiply-add around the other
    product, rounded. XLA fuses ``lo``'s product when it reduces some axes
    of a tensor and ``hi``'s (``fuse_hi``) when it reduces all of them."""
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    rank = np.float32(percentile) * np.float32(np.float32(n - 1)
                                               / np.float32(100.0))
    lo = srt[..., min(max(math.floor(rank), 0), n - 1)]
    hi = srt[..., min(max(math.ceil(rank), 0), n - 1)]
    w_hi = float(np.float32(rank - np.float32(math.floor(rank))))
    w_lo = float(np.float32(1.0) - np.float32(w_hi))
    if fuse_hi:
        lo, hi, w_lo, w_hi = hi, lo, w_hi, w_lo
    # f64 holds one f32 product exactly, so the sum rounds once: the FMA
    return (lo.double() * w_lo + (hi * w_hi).double()).float()


def absmax_scale(x: torch.Tensor, qtype: str, *, axis=None,
                 percentile: float = 100.0) -> torch.Tensor:
    """Per-group scale from the abs-max (percentile) of ``x``.

    ``axis`` is the reduction group (None = per-tensor); the scale keeps
    those dims as 1, so it broadcasts against ``x``. ``percentile < 100``
    takes the percentile of per-ROW abs-maxes (rows = the last axis, a
    table row's F features) instead of the global max."""
    a = x.float().abs()
    dims = _dims(x, axis)
    keep_shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    if percentile >= 100.0:
        m = a.amax(dim=dims, keepdim=True)
    else:
        rows = a.amax(dim=-1, keepdim=True)                # per-row abs-max
        kept = [d for d in range(x.ndim) if d not in dims]
        flat = rows.permute(*kept, *dims).reshape(
            [x.shape[d] for d in kept] + [-1])
        m = percentile_lastdim(flat, percentile,
                               fuse_hi=not kept).reshape(keep_shape)
    m = torch.clamp(m, min=_EPS)
    # a CUDA divide by a Python number multiplies by its reciprocal; a
    # tensor divisor rounds the quotient on the card as on the CPU
    return m / torch.full_like(m, qmax(qtype))


# ------------------------------------------------------------------ codecs
def quantize(x: torch.Tensor, scale: torch.Tensor, qtype: str
             ) -> torch.Tensor:
    """Encode ``x`` into the storage dtype under broadcastable ``scale``."""
    # one f32 temporary, rounded and clipped in place: a 2 GiB table stack
    # (gia) takes 2 GiB more while it is encoded, not three times that
    y = x.float() / scale
    if qtype in ("int8", "int8_affine"):
        return y.round_().clamp_(-INT8_QMAX, INT8_QMAX).to(torch.int8)
    if qtype == "fp8_e4m3":
        return y.clamp_(-FP8_E4M3_MAX, FP8_E4M3_MAX).to(torch.float8_e4m3fn)
    raise ValueError(f"unknown qtype {qtype!r}")


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """THE dequant formula: ``q.float() * scale``. Every e4m3 and int8 value
    is exact in f32, so the conversion is exact; keep it one multiply."""
    return q.float() * scale


def affine_range_scale(x: torch.Tensor, *, axis=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero point f32) mapping [min, max] onto [-128, 127]."""
    xf = x.float()
    dims = _dims(x, axis)
    lo = xf.amin(dim=dims, keepdim=True)
    hi = xf.amax(dim=dims, keepdim=True)
    scale = torch.clamp(hi - lo, min=_EPS) / 255.0
    zero = torch.round(-128.0 - lo / scale)
    return scale, zero


def quantize_affine(x: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor) -> torch.Tensor:
    y = torch.round(x.float() / scale) + zero
    return torch.clamp(y, -128, 127).to(torch.int8)


def dequantize_affine(q: torch.Tensor, scale, zero) -> torch.Tensor:
    return (q.float() - zero) * scale
