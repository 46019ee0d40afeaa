"""Roofline terms of the port's dry run: the JAX package's
``launch/roofline.py`` for one H100 SXM card and a count made on meta
tensors in place of a compiled module.

compute    = FLOPs per device / peak FLOP/s
memory     = HBM bytes per device / HBM bytes/s
collective = collective bytes per device / the link rate they cross

:data:`H100_SXM` holds the card's published peaks (NVIDIA's data sheet,
SXM part, dense, at the full 700 W) under the JAX dict's key names, so
the JAX ``rooflines(..., hw=H100_SXM)`` and :func:`rooflines` give the
same terms; ``ici_link_bw`` is NVLink 4 within a node of 8 cards
(``parallel/api.NODE_CARDS``), and
``ib_bw`` InfiniBand NDR between nodes (50 GB/s a card). ``hbm_bytes``
is the 80 GB that the port's memory plans hold a card to.

:class:`Counter` is the counting mode: a ``TorchDispatchMode`` under which
a step runs once on meta tensors (nothing is allocated on any device and
nothing computes). It records

* matrix-product FLOPs by ``torch.utils.flop_counter``'s formulas, by the
  dtype of the operands (stated difference: XLA's ``cost_analysis`` also
  counts elementwise FLOPs; this count does not);
* HBM bytes: the input plus output bytes of every aten op that is not a
  view (``empty`` allocates and writes nothing: no bytes). Eager PyTorch
  fuses nothing, so each op's operands do cross HBM;
* the peak of the live bytes: every allocation until it is freed, the
  step's arguments besides. Meta storages are freed when Python (or
  autograd's saved tensors, or a checkpoint's) drop them, as CUDA storages
  are;
* each kernel call's work (``kernels/cost.py``), which the kernel
  wrappers' meta routes report by kernel name.

There is no HLO, so no ``collective_bytes(hlo_text)``: a sharded step's
collectives are computed from its layout
(``parallel/api.step_collective_bytes``) and passed to :func:`summarize`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

# ------------------------------------------------------------- HW constants
H100_SXM = {
    "name": "h100_sxm",
    "peak_flops_bf16": 989e12,     # dense bf16 / fp16 on the tensor cores
    "peak_flops_tf32": 495e12,     # TF32 on the tensor cores
    "peak_flops_f32": 67e12,       # f32 outside the tensor cores
    "hbm_bw": 3.35e12,             # bytes/s, HBM3
    "ici_link_bw": 450e9,          # NVLink 4, bytes/s a direction
    "ib_bw": 50e9,                 # InfiniBand NDR, bytes/s a card
    "hbm_bytes": 80e9,
}
# the field kernels' products: 3xTF32, three tensor-core passes a product
TF32_PASSES = 3
# matrix products by operand dtype: the peak that bounds them. f32 products
# run in true f32 (torch.backends.cuda.matmul.allow_tf32 is False)
_MATMUL_PEAK = {torch.bfloat16: "peak_flops_bf16",
                torch.float16: "peak_flops_bf16",
                torch.float32: "peak_flops_f32"}


def rooflines(cost: Optional[dict], coll_bytes: int, chips: int,
              hw: dict = H100_SXM) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0)) if cost else 0.0
    bytes_hbm = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    t_compute = flops / hw["peak_flops_bf16"]
    t_memory = bytes_hbm / hw["hbm_bw"]
    t_coll = coll_bytes / hw["ici_link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom,
            "bound_s": max(t_compute, t_memory, t_coll),
            "flops_per_device": flops, "hbm_bytes_per_device": bytes_hbm,
            "collective_bytes_per_device": float(coll_bytes),
            "chips": chips}


def model_flops(cfg, shape_cell, n_params_active: int) -> float:
    """MODEL_FLOPS: 6*N*D train; 2*N*B decode (per step); 2*N*D prefill."""
    tokens = shape_cell.global_batch * shape_cell.seq_len
    if shape_cell.step == "train":
        return 6.0 * n_params_active * tokens
    if shape_cell.step == "prefill":
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * shape_cell.global_batch  # decode: 1 tok


def kernel_ops_s(w: Dict, hw: dict = H100_SXM) -> float:
    """A kernel call's least time on its units: the MLP's products on the
    tensor cores (3 TF32 passes) beside the rest in f32 on the CUDA
    cores."""
    return max(TF32_PASSES * w["mlp_flops"] / hw["peak_flops_tf32"],
               w["flops"] / hw["peak_flops_f32"])


# ---------------------------------------------------------- counting mode
_NO_BYTES = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
             torch.ops.aten.empty_strided.default}


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class _StorageRef:
    """A weak reference to a tensor's storage (its StorageImpl), through
    ``torch.UntypedStorage``'s own calls: ``torch.Storage`` (a typed
    storage class) goes through a deprecation check on every call in some
    releases, which a sweep over every live storage at every allocation
    cannot afford."""

    __slots__ = ("cdata",)

    def __init__(self, storage):
        self.cdata = storage._weak_ref()

    def expired(self) -> bool:
        return torch.UntypedStorage._expired(self.cdata)

    def __del__(self):
        torch.UntypedStorage._free_weak_ref(self.cdata)


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in an op's arguments or result (tensors, and lists or
    tuples of them, as aten's schemas take them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_DECOMPOSES: Dict = {}


def _decomposes(func) -> bool:
    """True for an op without a FLOP formula that has a
    CompositeImplicitAutograd decomposition (``OpOverload.decompose``'s own
    test, made once per op: entering the mode to try costs more)."""
    got = _DECOMPOSES.get(func)
    if got is None:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        got = _DECOMPOSES[func] = (
            func._overloadpacket not in flop_registry
            and (dk in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), dk)))
    return got


class Counter(TorchDispatchMode):
    """Counts one step run on meta tensors (the module docstring).

    ``args``: the step's arguments (any tree of tensors): their distinct
    storages are ``argument_bytes``, held throughout and not counted as
    allocations. Use as ``with Counter(args) as c: out = step(...)``, then
    ``c.outputs(out)`` and ``c.result()``."""

    def __init__(self, args=None):
        super().__init__()
        self.matmul_flops: Dict[str, int] = {}
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self.temp_peak = 0
        self.n_ops = 0
        self._args = {}
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                self._args[_storage(t)._cdata] = _storage(t).nbytes()
        self.argument_bytes = sum(self._args.values())
        self.output_bytes = 0

    def __enter__(self):
        kcost.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.pop(self)
        return super().__exit__(*exc)

    # the kernels' meta routes report here (kernels/cost.record)
    def kernel(self, name: str, w: Dict[str, int]) -> None:
        acc = self.kernels.setdefault(
            name, {"bytes": 0, "flops": 0, "mlp_flops": 0, "launches": 0})
        for k in acc:
            acc[k] += w[k]

    def _allocate(self, outs, in_keys) -> None:
        new = 0
        for t in outs:
            s = _storage(t)
            key = s._cdata                    # the StorageImpl's address
            old = self._live.get(key)
            if key in in_keys or key in self._args or (
                    old is not None and not old[0].expired()):
                continue      # an input's, an argument's or a live storage
            in_keys.add(key)
            self._live[key] = (_StorageRef(s), s.nbytes())
            new += s.nbytes()
        if not new:
            return
        dead = [k for k, (r, _) in self._live.items() if r.expired()]
        for k in dead:
            del self._live[k]
        self._live_bytes = sum(n for _, n in self._live.values())
        self.temp_peak = max(self.temp_peak, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _decomposes(func):
            # as FlopCounterMode: an op it has no formula for may decompose
            # into ones it has
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        self.n_ops += 1
        ins = _tensors(args) + _tensors(tuple(kwargs.values()))
        packet = func._overloadpacket
        if packet in flop_registry:
            dtype = str(ins[0].dtype).replace("torch.", "")
            self.matmul_flops[dtype] = self.matmul_flops.get(dtype, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view:
            return out
        in_keys = {_storage(t)._cdata for t in ins}
        # an op whose outputs all share an input's storage without writing
        # it (detach, alias, _unsafe_view) moves no data
        aliases = all(_storage(t)._cdata in in_keys for t in outs)
        if func not in _NO_BYTES and (func._schema.is_mutable
                                      or not aliases):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        self._allocate(outs, in_keys)
        return out

    def outputs(self, out) -> None:
        """Record the step's outputs: bytes of those that are not its
        arguments (the JAX ``output_size_in_bytes``)."""
        keys = set()
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                key = _storage(t)._cdata
                if key not in self._args and key not in keys:
                    keys.add(key)
                    self.output_bytes += _storage(t).nbytes()

    def result(self) -> Dict:
        """The count: ``flops`` (matrix products, all dtypes), their split
        ``flops_by_dtype``, ``bytes`` (the ops' and the kernels'),
        ``kernels`` (by name), and the memory: ``argument_bytes``,
        ``output_bytes``, ``temp_bytes`` (the allocations' peak) and
        ``peak_bytes`` (arguments plus that)."""
        kbytes = sum(w["bytes"] for w in self.kernels.values())
        return {"flops": sum(self.matmul_flops.values()),
                "flops_by_dtype": dict(self.matmul_flops),
                "bytes": self.bytes + kbytes, "op_bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "n_ops": self.n_ops,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_peak,
                "peak_bytes": self.argument_bytes + self.temp_peak}


def compute_s(counted: Dict, hw: dict = H100_SXM) -> float:
    """The compute term on each unit's own peak: every dtype's matrix
    products at its rate, and each kernel's operations (:func:`kernel_ops_s`
    of its summed work; its launches run one after another)."""
    t = sum(f / hw[_MATMUL_PEAK.get(getattr(torch, d, None),
                                    "peak_flops_bf16")]
            for d, f in counted["flops_by_dtype"].items())
    return t + sum(kernel_ops_s(w, hw) for w in counted["kernels"].values())


def link_rate(link: str, hw: dict = H100_SXM) -> float:
    return hw["ici_link_bw"] if link == "nvlink" else hw["ib_bw"]


def summarize(cell_name: str, counted: Dict, chips: int, model_fl: float,
              coll: Optional[Dict] = None, hw: dict = H100_SXM) -> Dict:
    """The JAX ``summarize`` record from a :class:`Counter` result.

    ``coll`` (``parallel/api.step_collective_bytes``' per-position entry:
    bytes by collective kind, and the link each crosses) prices each
    collective at its own link. ``flops_per_device`` counts the matrix
    products and the kernels' operations; the compute term puts each at
    its unit's peak (:func:`compute_s`), where JAX's puts every FLOP at
    the bf16 peak. ``memory_analysis`` carries ``fits_h100_80g`` where the
    JAX record has ``fits_v5e_16g``."""
    coll = coll or {}
    kinds = {k: v for k, v in coll.items()
             if k not in ("links", "once") and v}
    links = coll.get("links", {})
    flops = counted["flops"] + sum(w["flops"] + w["mlp_flops"]
                                   for w in counted["kernels"].values())
    rl = rooflines({"flops": flops, "bytes accessed": counted["bytes"]},
                   sum(kinds.values()), chips, hw)
    rl["compute_s"] = compute_s(counted, hw)
    rl["collective_s"] = sum(v / link_rate(links.get(k, "ib"), hw)
                             for k, v in kinds.items())
    terms = {k: rl[k] for k in ("compute_s", "memory_s", "collective_s")}
    rl["dominant"] = max(terms, key=terms.get)
    rl["bound_s"] = max(terms.values())
    rl["model_flops_global"] = model_fl
    rl["useful_flops_ratio"] = (model_fl / (flops * chips) if flops
                                else float("nan"))
    rl["collectives"] = {**kinds,
                         **{f"link_{k}": links[k] for k in kinds
                            if k in links}}
    if coll.get("once"):
        rl["collectives"]["once"] = coll["once"]
    rl["kernels"] = counted["kernels"]
    rl["flops_by_dtype"] = counted["flops_by_dtype"]
    arg, tmp = counted["argument_bytes"], counted["temp_bytes"]
    rl["memory_analysis"] = {
        "argument_bytes": arg, "output_bytes": counted["output_bytes"],
        "temp_bytes": tmp, "peak_bytes": arg + tmp,
        "fits_h100_80g": bool(arg + tmp < hw["hbm_bytes"])}
    rl["cell"] = cell_name
    return rl
