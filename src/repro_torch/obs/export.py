"""Chrome-trace export + dependency-free schema validation.

``write_chrome_trace`` emits the Trace Event Format JSON object
(``{"traceEvents": [...]}``, timestamps/durations in microseconds) that
``chrome://tracing`` and Perfetto load directly.

``validate`` implements the JSON-Schema subset the repo's checked-in
schemas use (``type``, ``properties``, ``required``, ``items``,
``additionalProperties``, ``enum``, ``minimum``) so CI can validate the
metrics-snapshot artifact without a jsonschema dependency; the schema
files stay standard JSON Schema, so external tooling can use them too.

A copy of the JAX package's ``obs/export.py`` (which is framework-free),
so that the port imports nothing of that package. The default schema is
the same checked-in file: ``parents[3]`` of ``src/repro_torch/obs/`` is
the repo root.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


# ------------------------------------------------------------ chrome trace
def chrome_trace(events: List[Dict], dropped: int = 0) -> Dict:
    """Wrap tracer events in the Trace Event Format envelope."""
    obj = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    if dropped:
        obj["metadata"] = {"dropped_events": dropped}
    return obj


def write_chrome_trace(path, events: List[Dict], dropped: int = 0) -> Dict:
    obj = chrome_trace(events, dropped=dropped)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(obj) + "\n")
    return obj


def validate_chrome_trace(obj: Dict):
    """Raise ValueError unless ``obj`` is a loadable Chrome trace: a
    ``traceEvents`` list of complete ("X") events with µs ``ts``/``dur``
    and pid/tid — the invariants the viewers require."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("chrome trace: missing 'traceEvents'")
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("chrome trace: 'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"chrome trace event[{i}]: missing {k!r}")
        if not isinstance(ev["name"], str):
            raise ValueError(f"chrome trace event[{i}]: name not a string")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(
                    f"chrome trace event[{i}]: X event needs dur >= 0")
        if ev["ts"] < 0:
            raise ValueError(f"chrome trace event[{i}]: ts < 0")


# ------------------------------------------------------- schema validation
_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "number": (int, float),
    "integer": int,
}


def validate(instance, schema: Dict, path: str = "$"):
    """Validate ``instance`` against the supported JSON-Schema subset;
    raises ValueError naming the failing path."""
    t = schema.get("type")
    if t is not None:
        py = _TYPES.get(t)
        if py is None:
            raise ValueError(f"{path}: unsupported schema type {t!r}")
        ok = isinstance(instance, py)
        if t in ("number", "integer") and isinstance(instance, bool):
            ok = False
        if not ok:
            raise ValueError(f"{path}: expected {t}, "
                             f"got {type(instance).__name__}")
    if "enum" in schema and instance not in schema["enum"]:
        raise ValueError(f"{path}: {instance!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(instance, (int, float)) \
            and not isinstance(instance, bool) \
            and instance < schema["minimum"]:
        raise ValueError(f"{path}: {instance} < minimum "
                         f"{schema['minimum']}")
    if isinstance(instance, dict):
        for k in schema.get("required", ()):
            if k not in instance:
                raise ValueError(f"{path}: missing required key {k!r}")
        props = schema.get("properties", {})
        for k, sub in props.items():
            if k in instance:
                validate(instance[k], sub, f"{path}.{k}")
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for k, v in instance.items():
                if k not in props:
                    validate(v, extra, f"{path}.{k}")
        elif extra is False:
            unknown = set(instance) - set(props)
            if unknown:
                raise ValueError(
                    f"{path}: unexpected keys {sorted(unknown)}")
    if isinstance(instance, list) and "items" in schema:
        for i, v in enumerate(instance):
            validate(v, schema["items"], f"{path}[{i}]")


def load_schema(path) -> Dict:
    return json.loads(Path(path).read_text())


def validate_snapshot(snapshot: Dict, schema_path=None):
    """Validate a ``Registry.snapshot()`` object against the checked-in
    metrics-snapshot schema (default: the repo copy next to the
    benchmarks)."""
    if schema_path is None:
        schema_path = (Path(__file__).resolve().parents[3] / "benchmarks"
                       / "schemas" / "metrics_snapshot.schema.json")
    validate(snapshot, load_schema(schema_path))
