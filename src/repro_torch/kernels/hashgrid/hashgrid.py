"""Grid-encode level metadata for the CUDA kernels.

The encode body itself, the JAX package's
``kernels/hashgrid/hashgrid.py:encode_one_level``, is the device function
``encode_one_level`` in ``csrc/encode.cuh``; the fused field kernel
(``csrc/field.cu``) runs it for every level. The standalone encode kernel
(``hashgrid_encode_pallas``, the unfused route) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.encoding import GridConfig


def level_meta(cfg: GridConfig) -> np.ndarray:
    """(L, 2) int32 [resolution, is_hashed], built on the host. The
    resolutions come from ``GridConfig.level_resolution`` in Python doubles,
    never from f32 arithmetic on the device."""
    return np.ascontiguousarray(
        [[cfg.level_resolution(l), int(cfg.level_is_hashed(l))]
         for l in range(cfg.n_levels)], dtype=np.int32)
