"""The work of each kernel call, from its shapes and configs: HBM bytes,
f32 operations on the CUDA cores (``flops``), the MLP's products on the
tensor cores (``mlp_flops``) and one launch.

These are the counts the roofline bounds read: ``chip_smoke.py``'s
``kernels`` phase, which holds each kernel's time against its bound, and
the dry run (``launch/dryrun.py``), whose counting mode
(``launch/roofline.Counter``) collects them from the kernel wrappers' meta
routes (:func:`record`). Bytes count each input read once and each output
written once:

* the grid encode reads its points, the distinct table rows it gathers at
  the table's item size and, for int8 and fp8 codes, the per-level
  scales; per point, level and corner it does the d-linear weight (d
  multiplies), F multiply-adds and, for codes, F dequantizing multiplies;
* the MLP reads its input rows and its weights once, writes its output
  rows, and does 2 (in h + (n - 1) h^2 + h out) products per row;
* the composite reads rgb and sigma per sample (16 bytes), the dts and
  writes pixel and opacity (16 bytes a ray); 16 operations a sample;
* the encode's backward reads points and cotangent and writes the whole
  table gradient at the table's dtype; per corner d weight multiplies, F
  products and F atomic adds;
* Mamba-2's intra-chunk SSD reads each chunk's activations, scalars and
  C.B once and writes its outputs once; its products are bf16 on the
  tensor cores (``bf16_flops``), the rest f32 (:func:`ssd_intra_fwd`,
  :func:`ssd_intra_bwd`);
* its inter-chunk term reads x (dy), B, C and the per-position scalars
  once, writes its outputs once, and moves the (b, nc, h, p, n) states
  between its kernels: each written once and read once where a kernel
  hands it to the next (:func:`ssd_inter_fwd`, :func:`ssd_inter_bwd`).

Distinct table rows depend on the data. A caller that counted them
(``chip_smoke.py`` on its tiles) passes them in; otherwise each level
takes ``min(points x 2^d, the rows its gathers can reach)``
(:func:`distinct_rows`), which bounds the bytes from below, as a roofline
needs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.encoding import GridConfig
from repro_torch.core.mlp import MLPConfig

F32 = 4
BF16 = 2


def mlp_flops(m: MLPConfig) -> int:
    """The MLP's products per row (a multiply-add is 2)."""
    return 2 * (m.in_dim * m.hidden_dim
                + (m.n_hidden - 1) * m.hidden_dim ** 2
                + m.hidden_dim * m.out_dim)


def level_rows(cfg: GridConfig, level: int) -> int:
    """The table rows a level's gathers can reach: all T of a hashed level,
    the (res + 1)^d grid points of a dense one (at most T)."""
    if cfg.level_is_hashed(level):
        return cfg.table_size
    return min(cfg.table_size, (cfg.level_resolution(level) + 1) ** cfg.dim)


def distinct_rows(cfg: GridConfig, n_points: int) -> int:
    """A lower bound on the distinct rows the encode of ``n_points``
    gathers over all levels: each level's corners, or its reachable rows
    where there are fewer."""
    corners = n_points << cfg.dim
    return sum(min(corners, level_rows(cfg, l)) for l in range(cfg.n_levels))


def work(nbytes: int, flops: int = 0, mlp: int = 0) -> Dict[str, int]:
    return {"bytes": int(nbytes), "flops": int(flops), "mlp_flops": int(mlp),
            "launches": 1}


def grid_work(n_points: int, cfg: GridConfig, table_itemsize: int,
              quantized: bool, rows: Optional[int] = None) -> Dict[str, int]:
    """The encode's share of a call on ``n_points`` points: points in, the
    distinct rows (``rows``, or :func:`distinct_rows`) at the table's item
    size, the scales of a code table."""
    rows = distinct_rows(cfg, n_points) if rows is None else rows
    return work(n_points * cfg.dim * F32
                + rows * cfg.n_features * table_itemsize
                + (cfg.n_levels * F32 if quantized else 0),
                n_points * cfg.n_levels * (1 << cfg.dim)
                * (cfg.dim + (3 if quantized else 2) * cfg.n_features))


def encode_fwd(n_points: int, cfg: GridConfig, table_itemsize: int,
               quantized: bool, rows: Optional[int] = None) -> Dict[str, int]:
    """``encode_fwd``: the grid's share, the (B, L*F) f32 features out."""
    w = grid_work(n_points, cfg, table_itemsize, quantized, rows)
    w["bytes"] += n_points * cfg.out_dim * F32
    return w


def field_fwd(n_points: int, cfg: GridConfig, m: MLPConfig,
              table_itemsize: int, quantized: bool, weight_bytes: int,
              rows: Optional[int] = None) -> Dict[str, int]:
    """``field_fwd`` / ``field_fwd_q``: the grid's share, the weights once,
    the (B, out) f32 output, and the MLP's products."""
    w = grid_work(n_points, cfg, table_itemsize, quantized, rows)
    w["bytes"] += weight_bytes + n_points * m.out_dim * F32
    w["mlp_flops"] = n_points * mlp_flops(m)
    return w


def mlp_fwd(n_rows: int, m: MLPConfig, weight_bytes: int) -> Dict[str, int]:
    """``mlp_fwd``: the f32 rows in and out, the weights once."""
    return work(n_rows * (m.in_dim + m.out_dim) * F32 + weight_bytes,
                mlp=n_rows * mlp_flops(m))


# f32 operations a row of nerf's colour head adds to its MLP: the degree-4
# SH (csrc/mlp.cu sh_columns) 38, each sigmoid's negate, exp, add and
# divide 12, sigma's exp 1
HEAD_F32_OPS = 51


def mlp_fwd_head(n_rows: int, m: MLPConfig, weight_bytes: int
                 ) -> Dict[str, int]:
    """``mlp_fwd_head``, nerf's colour head in one launch: the density
    features (B, 16) and directions (B, 3) in, the (B, 4) [rgb, sigma] out,
    the weights once; the MLP's products and the head's f32 operations."""
    return work(n_rows * (16 + 3 + 4) * F32 + weight_bytes,
                n_rows * HEAD_F32_OPS, mlp=n_rows * mlp_flops(m))


def composite_fwd(n_rays: int, n_samples: int, dts_numel: int
                  ) -> Dict[str, int]:
    """``composite_fwd``: rgb + sigma a sample, the dts (one (1, S) row or
    (R, S)), pixel + opacity a ray; per sample -sigma dt, 2 exp, 1 - alpha,
    the scan's add, a subtract, a multiply and 4 multiply-adds."""
    b = n_rays * n_samples
    return work(b * 4 * F32 + dts_numel * F32 + n_rays * 4 * F32, b * 16)


def encode_bwd(n_points: int, cfg: GridConfig, table_numel: int,
               table_itemsize: int) -> Dict[str, int]:
    """``encode_bwd``: points and the (B, L*F) cotangent in, the whole
    table gradient out at the table's dtype."""
    corners = n_points * cfg.n_levels * (1 << cfg.dim)
    return work((n_points * cfg.dim + n_points * cfg.out_dim) * F32
                + table_numel * table_itemsize,
                corners * (cfg.dim + 2 * cfg.n_features))


def ssd_pairs(q: int) -> int:
    """(i, j) pairs with j <= i in a chunk of q positions."""
    return q * (q + 1) // 2


def ssd_intra_fwd(chunks: int, q: int, h: int, p: int, g: int
                  ) -> Dict[str, int]:
    """``ssd_intra_fwd`` over ``chunks`` (b * nc) chunks: x in and y out
    (bf16), cums and dt (f32) a position and head, C.B's lower triangle
    (bf16) once per group; per pair and head the decay's subtract, exp and
    two multiplies on the CUDA cores (``flops``) and the product's 2 p on
    the tensor cores in bf16 (``bf16_flops``)."""
    pairs = chunks * h * ssd_pairs(q)
    w = work(chunks * (q * h * (2 * p * BF16 + 2 * F32)
                       + g * ssd_pairs(q) * BF16), 4 * pairs)
    w["bf16_flops"] = 2 * p * pairs
    return w


def ssd_intra_bwd(chunks: int, q: int, h: int, p: int, g: int
                  ) -> Dict[str, int]:
    """``ssd_intra_bwd``: dy and x in, dx out (bf16), cums and dt in and
    their gradients out (f32), C.B's lower triangle in and the whole dCB
    out (bf16) once per group; per pair and head 12 f32 operations (the
    decay, m and the four sums) and two products of 2 p (dM and dx)."""
    pairs = chunks * h * ssd_pairs(q)
    w = work(chunks * (q * h * (3 * p * BF16 + 4 * F32)
                       + g * (ssd_pairs(q) + q * q) * BF16), 12 * pairs)
    w["bf16_flops"] = 4 * p * pairs
    return w


def ssd_inter_fwd(b: int, nc: int, q: int, h: int, p: int, g: int, n: int
                  ) -> Dict[str, int]:
    """``ssd_inter_fwd`` over b rows of nc chunks: x in and y_inter out
    (bf16), cums and dt (f32) a position and head, B and C (bf16) a
    position and group; the chunk states written and read by the
    recurrence, the states before each chunk written (kept for the
    backward) and read for y_inter, the final state written. Products: the
    chunk states' and y_inter's 2 q p n a chunk and head in bf16 on the
    tensor cores; f32: the weights (exp, subtract, multiply; exp), the
    products with B and C a position, head and state column, the
    recurrence's multiply and add a state element and chunk."""
    chunks = b * nc
    st = chunks * h * p * n
    w = work(chunks * q * (2 * h * p * BF16 + 2 * h * F32 + 2 * g * n * BF16)
             + 4 * st * BF16 + b * h * p * n * BF16,
             chunks * h * (4 * q + 2 * q * n) + 2 * st)
    w["bf16_flops"] = 4 * q * p * n * chunks * h
    return w


def ssd_inter_bwd(b: int, nc: int, q: int, h: int, p: int, g: int, n: int
                  ) -> Dict[str, int]:
    """``ssd_inter_bwd``: dy and x in, dx out (bf16); cums and dt in,
    their gradients out, and the weights' gradients written and read back
    (f32) a position and head; B and C in, dB and dC out (bf16); the states
    before each chunk read twice (the recurrence, dC), their gradient and
    the chunk states' written and read once, the final state's gradient
    in. Products: d prev, dv, du and dx, 2 q p n each a chunk and head, in
    bf16; f32: the products with the weights, B and C and their sums (6 a
    position, head and state column), the reverse recurrence's four a
    state element and chunk, a dozen a position and head for the
    scalars."""
    chunks = b * nc
    st = chunks * h * p * n
    w = work(chunks * q * (3 * h * p * BF16 + 8 * h * F32
                           + 4 * g * n * BF16)
             + 6 * st * BF16 + b * h * p * n * BF16,
             chunks * h * (12 * q + 6 * q * n) + 4 * st)
    w["bf16_flops"] = 8 * q * p * n * chunks * h
    return w


def tensor_bytes(tensors) -> int:
    """Bytes of the tensors (``None`` entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# ------------------------------------------------------- the active counter
_COUNTERS: List = []


def push(counter) -> None:
    """Make ``counter`` (anything with ``kernel(name, work)``) the one
    that :func:`record` reports to, until :func:`pop`."""
    _COUNTERS.append(counter)


def pop(counter) -> None:
    if not _COUNTERS or _COUNTERS[-1] is not counter:
        raise RuntimeError("kernel cost counters popped out of order")
    _COUNTERS.pop()


def record(name: str, w: Dict[str, int]) -> None:
    """Report one call of kernel ``name`` with its work ``w`` to the
    active counter. A wrapper's meta route calls it in place of the
    launch: outside a counter nothing would account for the call, so it
    raises ``ValueError``, as a wrapper does for tensors on a device it
    does not take."""
    if not _COUNTERS:
        raise ValueError(
            f"{name} on meta tensors outside a counting mode: a meta call "
            "computes nothing, and only launch/roofline.Counter accounts "
            "for it")
    _COUNTERS[-1].kernel(name, w)
