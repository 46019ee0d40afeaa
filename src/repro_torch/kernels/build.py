"""Builds and loads the port's CUDA kernel library.

The kernels are CUDA C++ under ``repro_torch/csrc/`` with a plain C
interface. At first use :func:`load_library` compiles each ``.cu`` source
with its own ``nvcc`` process, all started together, links the objects into
one shared library and loads it with ``ctypes``. The library lands in
``build/repro_torch_kernels/<digest>/`` at the root of the checkout, where
the digest covers every source, header and compiler flag, so an edited
source builds anew and an unchanged one is loaded as it is.

:class:`CudaKernel` is one C entry point of that library. Calling it
launches the kernel on PyTorch's current stream, raises if the launch
failed, and counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``; raises if the CUDA toolkit is not installed."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA toolkit is needed to "
                       "build the kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into one shared library; returns its path. Reuses a library built
    from the same sources and flags. The compiler's resource report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library in ``build.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {s.name}\n{text}" for s, text in zip(sources, logs))
        (out_dir / "build.log").write_text(log)
        failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# ctypes argument kinds of the C entry points
PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong


class CudaKernel:
    """One C entry point of the kernel library, with its launch count.

    ``launches`` counts successful launches; it is the evidence that a run
    went through this kernel, and it is raised nowhere else."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        # the device index and the stream come last
        self.argtypes = list(argtypes) + [INT, PTR]
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load_library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, device.index, stream)
        if err != 0:
            msg = load_library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
