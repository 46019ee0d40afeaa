"""CUDA's own numbers for one kernel instantiation: the query entry points
(``<kernel>_info`` in each ``csrc/*.cu``, through ``csrc/info.cuh``) that
``analysis/budget.py`` is held against on the card: by ``chip_smoke.py``'s
``analysis`` phase for every Table-I instantiation, and by
``tests/test_torch_cuda.py``'s ``test_budget_matches_cuda``.

:func:`kernel_info` takes an instantiation as ``budget.KernelEstimate``
names it (``instance``) and returns what a launch of it would see: the
threads per block and dynamic shared memory its launcher passes, and the
compiled kernel's static shared memory, registers per thread, local
memory and the blocks per SM ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
allows. It launches nothing and counts no launch; it needs a GPU.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

from repro_torch.kernels.build import INT, load_library

FIELDS = ("threads", "dynamic_smem", "static_smem", "registers",
          "local_bytes", "blocks_per_sm")
# entry point -> the int arguments before (device, out)
_ARGS = {"encode_fwd": 4, "encode_bwd": 4, "field_fwd": 7, "mlp_fwd": 4,
         "composite_fwd": 1, "ssd_intra_fwd": 2, "ssd_intra_bwd": 2,
         "ssd_inter_fwd": 4, "ssd_inter_bwd": 4}


def kernel_info(instance: Tuple, device_index: int = 0) -> Dict[str, int]:
    """The resources of ``instance`` = (entry, its int arguments...), e.g.
    ``("encode_fwd", dim, n_features, table dtype code, group)``; raises
    if CUDA refuses the query (no such instantiation)."""
    name, args = instance[0], tuple(int(a) for a in instance[1:])
    if name not in _ARGS or len(args) != _ARGS[name]:
        raise ValueError(f"no query for {instance}")
    fn = getattr(load_library(), f"{name}_info")
    fn.argtypes = [INT] * (len(args) + 1) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(FIELDS))()
    err = fn(*args, device_index, out)
    if err != 0:
        msg = load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}_info{args}: CUDA error {err} ({msg})")
    return dict(zip(FIELDS, out))
