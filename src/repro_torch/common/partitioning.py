"""Logical-axis to mesh-axis rules: the part of the JAX package's
``common/partitioning.py`` that the field path reads.

Every parameter or activation dimension carries a *logical* name
('batch', 'embed', 'field_batch', ...). A :class:`LogicalRules` table maps
each name to physical mesh axes ('pod', 'data', 'model'). The field apps
read one entry, ``'field_batch'``: the pixels of a render tile
(``serve/sharding.py``) and the rays or points of a training batch
(``train/loop.data_parallel_grad_fn``) split over the mesh axes it names
that the mesh has (:func:`present_axes`).

The table is the JAX package's, entry for entry, so a rule set means the
same in both packages. What it is there for beyond the field path waits
for the LM stack (ROADMAP A14): the JAX module's ``divisible_fallback``,
``logical_to_spec``, ``specs_to_shardings``, ``constrain`` and
``ActivationSharder`` turn the rules into sharded LM parameters and
activations, and with them goes ``LogicalRules.fallbacks``, the record
those functions keep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass
class LogicalRules:
    """Ordered mapping of logical axis name -> mesh axes."""
    rules: Dict[str, MeshAxes]

    def copy_with(self, **overrides) -> "LogicalRules":
        new = dict(self.rules)
        new.update(overrides)
        return LogicalRules(new)

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical, None)


# The JAX package's production default: 'data' does DP+FSDP, 'model'
# TP/EP, 'pod' cross-pod DP; the field apps' pixels and rays are fully DP.
DEFAULT_RULES = LogicalRules({
    # --- activations ---
    "batch": ("pod", "data"),
    "act_seq": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_expert": "model",
    # --- parameters ---
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "stage": None,
    # --- neural fields (the paper's models) ---
    "level": None,            # multi-res levels stay device-local
    "table": "data",          # hash tables sharded for training only (LM)
    "feature": None,
    "field_batch": ("pod", "data", "model"),  # pixels/rays: fully DP
    "width": None,
})


def rule_preset(name: str) -> LogicalRules:
    """The JAX package's named rule sets (a fresh copy each call)."""
    presets = {
        "baseline": lambda: DEFAULT_RULES.copy_with(),
        "sp": lambda: DEFAULT_RULES.copy_with(),
        "nosp": lambda: DEFAULT_RULES.copy_with(act_seq=None),
        "noz": lambda: DEFAULT_RULES.copy_with(embed=None, table=None),
        "ep2d": lambda: DEFAULT_RULES.copy_with(expert=("model", "data")),
        "tinydp": lambda: DEFAULT_RULES.copy_with(
            batch=("pod", "data", "model"), act_seq=None, act_heads=None,
            act_mlp=None, act_expert=None, mlp=None, heads=None,
            kv_heads=None, vocab=None, expert=None, ssm_inner=None),
    }
    return presets[name]()


def _axes_size(mesh, axes: MeshAxes) -> int:
    """Devices along ``axes`` of ``mesh`` (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def present_axes(mesh, axes: MeshAxes) -> MeshAxes:
    """The subset of ``axes`` that ``mesh`` has (None if none): a
    single-pod mesh has no 'pod' axis."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh.shape else None
    kept = tuple(a for a in axes if a in mesh.shape)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]
