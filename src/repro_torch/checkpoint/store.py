"""Checkpoints: the JAX package's ``checkpoint/store.py`` on-disk format,
written and read by the port.

A checkpoint is a directory ``step_NNNNNNNN/`` of one ``leaf_NNNNN.npy``
per leaf and a ``manifest.json`` of each leaf's path, file, shape, dtype
and the CRC32 of its raw bytes. It is written under a temporary name and
renamed to commit, so a crash mid-write leaves no checkpoint behind, and
``latest_step`` counts only directories with a manifest. Either package
restores what the other wrote:

  * **Leaf paths and order** are those of ``jax.tree_util.keystr`` over
    ``tree_flatten_with_path``: dict keys sorted, ``['key']``; NamedTuple
    fields in field order, ``.field``; so a train state's leaves are
    ``['opt'].mu['grid']``, ``['opt'].step``, ``['params']['grid']``...
  * **Adam's step**, a host ``int`` in the port, goes to disk as the 0-d
    int32 leaf the JAX package writes and comes back as an ``int``.
  * **bf16 and fp8-e4m3** leaves go to disk as their raw 2-byte and 1-byte
    words under the header numpy writes for ml_dtypes' types (``<V2``,
    ``<V1``), the manifest naming the dtype; restore re-views the bytes
    under the manifest's dtype. No ml_dtypes is needed.

``AsyncCheckpointer.save`` snapshots the state to host memory before it
returns (CUDA leaves: copies into reused pinned buffers, queued on the
current stream, so the next step's in-place updates run after them), and
a writer thread waits for the copies' event and writes. The thread never
touches a device tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

# torch dtype -> (manifest dtype, the numpy dtype of its raw words, the
# .npy header's descr); extension dtypes are written as raw words
_EXT = {torch.bfloat16: ("bfloat16", np.uint16, "<V2"),
        torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, "<V1")}
_EXT_BY_NAME = {name: (dt, words) for dt, (name, words, _) in _EXT.items()}


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs of a tree of dicts and NamedTuples, in
    ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out.extend(_flatten(getattr(tree, name), f"{path}.{name}"))
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves)
                            for n in tree._fields))
    return next(leaves)


def _leaf_filename(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_numpy(leaf) -> Tuple[np.ndarray, str, Optional[str]]:
    """(array of the leaf's bytes, manifest dtype, .npy descr to write in
    place of the array's own, or None). Host leaves only."""
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise ValueError("checkpoint leaves must be on the host: "
                             "snapshot them first (AsyncCheckpointer)")
        t = leaf.detach().contiguous()
        if t.dtype in _EXT:
            name, words, descr = _EXT[t.dtype]
            raw = t.view(torch.int16 if words is np.uint16 else torch.uint8)
            return raw.numpy().view(words), name, descr
        arr = t.numpy()
    elif isinstance(leaf, int):
        # Adam's step: a 0-d int32, as the JAX package stores it
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    # np.require keeps a 0-d array 0-d (np.ascontiguousarray would not)
    return np.require(arr, requirements="C"), str(arr.dtype), None


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(arr.reshape(-1).view(np.uint8))) \
        & 0xFFFFFFFF


def _write_npy(path: Path, arr: np.ndarray, descr: Optional[str]) -> None:
    if descr is None:
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": arr.shape})
        f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def save(tree: Any, step: int, directory: str | os.PathLike,
         extra_meta: Optional[Dict] = None) -> Path:
    """Blocking save of a tree of host leaves (CPU tensors, numpy arrays,
    ints); returns the committed directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                dir=directory))
    manifest = {"step": step, "leaves": [], "meta": extra_meta or {}}
    try:
        for i, (name, leaf) in enumerate(_flatten(tree)):
            arr, dtype, descr = _to_numpy(leaf)
            fn = _leaf_filename(i)
            _write_npy(tmp / fn, arr, descr)
            manifest["leaves"].append({
                "path": name, "file": fn, "shape": list(arr.shape),
                "dtype": dtype, "crc32": _crc(arr)})
        (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _update_latest(directory, step)
    return final


def _update_latest(directory: Path, step: int):
    latest = directory / "LATEST"
    tmp = directory / ".LATEST.tmp"
    tmp.write_text(str(step))
    tmp.rename(latest)


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    """The newest committed step under ``directory`` (one with a
    manifest), or None."""
    latest = Path(directory) / "LATEST"
    if latest.exists():
        step = int(latest.read_text().strip())
        if (Path(directory) / f"step_{step:08d}" / MANIFEST).exists():
            return step
    # LATEST may be stale after a crash: scan
    steps = sorted(int(p.name.split("_")[1]) for p in
                   Path(directory).glob("step_*") if
                   (p / MANIFEST).exists())
    return steps[-1] if steps else None


def _load_leaf(path: Path, rec: Dict, verify: bool, name: str
               ) -> torch.Tensor:
    """One leaf as a CPU tensor of the manifest's dtype, bit for bit."""
    arr = np.load(path, allow_pickle=False)
    if verify and _crc(np.require(arr, requirements="C")) != rec["crc32"]:
        raise IOError(f"CRC mismatch for {name}: corrupt checkpoint")
    dtype = rec["dtype"]
    if dtype in _EXT_BY_NAME:
        # torch.from_numpy takes int16, not uint16: the same 2-byte words
        tdt, words = _EXT_BY_NAME[dtype]
        raw = np.frombuffer(arr.tobytes(), dtype=np.int16
                            if words is np.uint16 else np.uint8)
        return torch.from_numpy(raw.reshape(rec["shape"]).copy()).view(tdt)
    if str(arr.dtype) != dtype:
        arr = np.frombuffer(arr.tobytes(), dtype=np.dtype(dtype)).reshape(
            rec["shape"])
    return torch.from_numpy(np.array(arr, copy=True))


def restore(directory: str | os.PathLike, target: Any,
            step: Optional[int] = None, verify: bool = True) -> Any:
    """Restore into the structure of ``target``: a tree of tensors (each
    restored leaf takes its target's dtype and device) and ints (restored
    as ints, as Adam's step is)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / MANIFEST).read_text())
    leaves = _flatten(target)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(leaves)}: structure changed?")
    by_path = {l["path"]: l for l in manifest["leaves"]}
    out = []
    for name, tgt in leaves:
        rec = by_path.get(name)
        if rec is None:
            raise KeyError(f"leaf {name} missing from checkpoint")
        t = _load_leaf(d / rec["file"], rec, verify, name)
        tshape = list(tgt.shape) if isinstance(tgt, torch.Tensor) else []
        if list(t.shape) != tshape:
            raise ValueError(f"{name}: shape {list(t.shape)} != {tshape}")
        out.append(t.to(device=tgt.device, dtype=tgt.dtype)
                   if isinstance(tgt, torch.Tensor) else int(t))
    return _unflatten(target, iter(out))


def gc_old(directory: str | os.PathLike, keep: int = 3):
    """Delete all but the newest ``keep`` committed checkpoints."""
    directory = Path(directory)
    steps = sorted((int(p.name.split("_")[1]), p) for p in
                   directory.glob("step_*") if (p / MANIFEST).exists())
    for _, p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Off-the-step-path checkpoint writer (one outstanding save).
    ``blocked_s`` lists the seconds each ``save`` held its caller."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self.blocked_s: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[int, torch.Tensor] = {}

    def _snapshot(self, tree):
        """(host copy of ``tree``, the CUDA event its copies complete at,
        or None): CUDA leaves go to reused pinned buffers without waiting,
        host tensors are cloned (the caller updates them in place)."""
        leaves, event = [], None
        for i, (_, leaf) in enumerate(_flatten(tree)):
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                buf = self._pinned.get(i)
                if buf is None or buf.shape != leaf.shape \
                        or buf.dtype != leaf.dtype:
                    buf = self._pinned[i] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, pin_memory=True)
                buf.copy_(leaf.detach(), non_blocking=True)
                if event is None:
                    event = torch.cuda.Event()
                leaves.append(buf)
            elif isinstance(leaf, torch.Tensor):
                leaves.append(leaf.detach().clone())
            else:
                leaves.append(leaf)
        if event is not None:
            event.record()
        return _unflatten(tree, iter(leaves)), event

    def save(self, tree: Any, step: int, extra_meta=None):
        t0 = time.perf_counter()
        self.wait()                      # at most one outstanding save
        host_tree, event = self._snapshot(tree)

        def work():
            try:
                if event is not None:
                    event.synchronize()
                save(host_tree, step, self.directory, extra_meta)
                gc_old(self.directory, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.blocked_s.append(time.perf_counter() - t0)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
