"""Pure-AST rules (RA1xx) of the port's linter: the counterpart of the JAX
package's ``analysis/ast_rules.py`` for PyTorch's hazards.

Scope model: every rule reasons per *function*. A function is

  * hot-path  — marked ``# repro: hot-path`` (serve submit-side code that
    must never wait for the device: ``RenderEngine.submit``).
  * boundary  — marked ``# repro: sync-boundary <reason>`` (a designated
    host-sync point, ``Ticket.result``-style); the host-sync rule skips
    its body.

A function defined inside a marked one carries its marks: a closure of a
sync boundary is part of that boundary, one of a hot path part of it.

Taint is reduced against the JAX rules', which know every traced
parameter of a jitted function. Eager PyTorch has no tracing, and the AST
does not know which values are tensors, so a value *shows a tensor* only
where the AST shows one: the result of a ``torch.`` call that returns a
tensor (not ``torch.cuda.*``, ``torch.device``, ``torch.Generator``,
``torch.is_*`` and the like: :data:`NON_TENSOR_CALLS`), or a name assigned
from an expression that shows one, in the same function. Parameters are
not tainted. Reading ``.shape``/``.ndim``/``.dtype``/``.device`` or
calling ``.numel()``/``.size()``/``.dim()``/``.data_ptr()``-style methods
(host metadata, no sync), ``is``/``is not``/``in``/``not in``
comparisons and ``len()``/``isinstance()``-style calls untaint.

Rules:
  RA101 host-sync        — ``torch.cuda.synchronize`` and
      ``.synchronize()`` (an event's or a stream's) anywhere outside a
      sync boundary; inside a hot path also ``.item()``, ``.tolist()``,
      ``.cpu()``, ``.numpy()``, ``.to("cpu")``/``.to(device="cpu")``,
      ``np.asarray``/``np.array``, and ``float()``/``int()``/``bool()`` of
      a value that shows a tensor.
  RA102 tensor-branch    — a Python ``if``/``while`` on a value that
      shows a tensor inside a hot path: an implicit ``.item()``.
  RA104 mutable-default  — the JAX rule's copy; always a warning here,
      since the port has no trace cache for a default to leak into.
  RA105 print            — the JAX rule's copy.

The JAX rules RA103 ``pytree-aux`` and RA106 ``donated-reuse`` have no
counterpart: the port registers no pytrees and donates no buffers
(``donate_argnums``); its in-place optimizer state is checked by the
semantic rule RT203 ``in-place-state`` instead.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set

from repro_torch.analysis.registry import FileContext, Finding, rule

# attribute reads that yield host metadata of a tensor (no sync)
SAFE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
              "requires_grad", "is_leaf", "names"}
# tensor methods that return host metadata (no sync)
SAFE_METHODS = {"numel", "nelement", "size", "dim", "ndimension", "stride",
                "element_size", "data_ptr", "storage_offset",
                "is_contiguous", "is_floating_point", "is_complex",
                "get_device"}
# calls whose result is static regardless of argument taint
STATIC_CALLS = {"len", "isinstance", "hasattr", "type", "getattr", "range",
                "id", "callable"}
# torch calls (dotted prefixes) whose result is not a tensor
NON_TENSOR_CALLS = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                    "torch.profiler.", "torch.utils.", "torch.autograd.",
                    "torch.device", "torch.Generator", "torch.no_grad",
                    "torch.enable_grad", "torch.inference_mode",
                    "torch.is_", "torch.get_", "torch.set_",
                    "torch.manual_seed", "torch.finfo", "torch.iinfo",
                    "torch.Size", "torch.dtype")
_CONVERSIONS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_PULLS = {"item": "pulls a scalar to the host",
          "tolist": "copies the tensor to a host list",
          "cpu": "copies the tensor to the host",
          "numpy": "copies the tensor to the host"}


def dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class FunctionInfo:
    def __init__(self, node: ast.FunctionDef, ctx: FileContext,
                 parent: Optional["FunctionInfo"] = None):
        self.node = node
        self.name = node.name
        self.hot = ctx.has_marker(ctx.hot_path_lines, node) or bool(
            parent and parent.hot)
        self.boundary = ctx.has_marker(ctx.boundary_lines, node) or bool(
            parent and parent.boundary)


def collect_functions(ctx: FileContext) -> List[FunctionInfo]:
    """All function defs, nested ones with their enclosing function's
    marks."""
    infos: List[FunctionInfo] = []

    def visit(node: ast.AST, parent: Optional[FunctionInfo]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(child, ctx, parent)
                infos.append(fi)
                visit(child, fi)
            else:
                visit(child, parent)
    visit(ctx.tree, None)
    return infos


def _body_statements(fn: ast.FunctionDef) -> Iterator[ast.stmt]:
    """Statements of ``fn`` in source order, NOT descending into nested
    function/class defs (those are analyzed as their own scopes)."""
    stack: List[ast.stmt] = list(reversed(fn.body))
    while stack:
        stmt = stack.pop()
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            stack.extend(reversed(getattr(stmt, field, [])))
        for h in getattr(stmt, "handlers", []):
            stack.extend(reversed(h.body))


def _scope_nodes(body: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """Every AST node under ``body`` exactly once, pruning nested
    function/class defs (each nested scope is analyzed separately)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def is_tensor_call(node: ast.Call) -> bool:
    """A ``torch.`` call whose result is a tensor."""
    name = dotted(node.func)
    return name.startswith("torch.") and not name.startswith(
        NON_TENSOR_CALLS)


def shows_tensor(node: ast.AST, tainted: Set[str]) -> bool:
    """Does evaluating ``node`` involve a value the AST shows is a tensor?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in SAFE_ATTRS:
            return False
        return shows_tensor(node.value, tainted)
    if isinstance(node, ast.Call):
        if dotted(node.func) in STATIC_CALLS:
            return False
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in SAFE_METHODS):
            return False
        if is_tensor_call(node):
            return True
        return any(shows_tensor(a, tainted) for a in node.args) or any(
            shows_tensor(kw.value, tainted) for kw in node.keywords) or (
            shows_tensor(node.func, tainted))
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return (shows_tensor(node.left, tainted)
                or any(shows_tensor(c, tainted) for c in node.comparators))
    for child in ast.iter_child_nodes(node):
        if shows_tensor(child, tainted):
            return True
    return False


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in target.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def compute_taint(fn: FunctionInfo) -> Set[str]:
    """Forward pass over the function body: the names bound to a value
    that shows a tensor (a name rebound to one that does not is dropped)."""
    tainted: Set[str] = set()
    for stmt in _body_statements(fn.node):
        if isinstance(stmt, ast.Assign):
            hit = shows_tensor(stmt.value, tainted)
            for t in stmt.targets:
                for n in _target_names(t):
                    (tainted.add if hit else tainted.discard)(n)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            hit = shows_tensor(stmt.value, tainted)
            for n in _target_names(stmt.target):
                (tainted.add if hit else tainted.discard)(n)
        elif isinstance(stmt, ast.AugAssign):
            if shows_tensor(stmt.value, tainted):
                tainted.update(_target_names(stmt.target))
        elif isinstance(stmt, ast.For):
            if shows_tensor(stmt.iter, tainted):
                tainted.update(_target_names(stmt.target))
    return tainted


# --------------------------------------------------------------------- RA101
def _finding(ctx: FileContext, node: ast.AST, message: str) -> Finding:
    return Finding(rule="host-sync", code="RA101", path=ctx.path,
                   line=node.lineno, message=message)


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` (any "cpu..." string)."""
    vals = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and isinstance(v.value, str)
               and v.value.startswith("cpu") for v in vals)


@rule("host-sync", "RA101", "ast",
      "torch.cuda.synchronize() and event/stream .synchronize() outside "
      "designated '# repro: sync-boundary' functions; in "
      "'# repro: hot-path' functions also .item()/.tolist()/.cpu()/"
      ".numpy()/.to('cpu')/np.asarray, and float()/int()/bool() of a "
      "value the AST shows is a tensor.")
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    for fn in collect_functions(ctx):
        if fn.boundary:
            continue
        tainted = compute_taint(fn) if fn.hot else set()
        for node in _scope_nodes(fn.node.body):
            if isinstance(node, ast.Call):
                yield from _check_sync_call(ctx, node, fn.hot, tainted)
    # module-level statements (script bodies): explicit syncs only
    for node in _scope_nodes(ctx.tree.body):
        if isinstance(node, ast.Call):
            yield from _check_sync_call(ctx, node, False, set())


def _check_sync_call(ctx: FileContext, node: ast.Call, hot: bool,
                     tainted: Set[str]) -> Iterator[Finding]:
    name = dotted(node.func)
    method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    if name == "torch.cuda.synchronize" or method == "synchronize":
        yield _finding(ctx, node, (
            f"{name or '.synchronize'}() blocks the host until the device "
            "work finishes — mark the function '# repro: sync-boundary "
            "<reason>' if this is a designated boundary, or "
            "allow[host-sync] the line"))
        return
    if not hot:
        return
    if name in _CONVERSIONS:
        yield _finding(ctx, node, (
            f"{name}() in a hot-path function copies a tensor to the host "
            "(a device sync); convert at a sync boundary"))
    elif method in _PULLS:
        yield _finding(ctx, node, (
            f".{method}() in a hot-path function {_PULLS[method]} — a "
            "per-call device sync"))
    elif method == "to" and _to_cpu(node):
        yield _finding(ctx, node, (
            ".to('cpu') in a hot-path function copies the tensor to the "
            "host — a per-call device sync"))
    elif (name in ("float", "int", "bool") and node.args
          and shows_tensor(node.args[0], tainted)):
        yield _finding(ctx, node, (
            f"{name}() of a tensor in a hot-path function reads its value "
            "on the host — an implicit .item(), a per-call device sync"))


# --------------------------------------------------------------------- RA102
@rule("tensor-branch", "RA102", "ast",
      "Python `if`/`while` on a value the AST shows is a tensor inside a "
      "'# repro: hot-path' function — an implicit .item(), a device sync "
      "per call; branch on host values or use torch.where.")
def check_tensor_branch(ctx: FileContext) -> Iterator[Finding]:
    for fn in collect_functions(ctx):
        if not fn.hot or fn.boundary:
            continue
        tainted = compute_taint(fn)
        for stmt in _body_statements(fn.node):
            if isinstance(stmt, (ast.If, ast.While)) and shows_tensor(
                    stmt.test, tainted):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                yield Finding(
                    rule="tensor-branch", code="RA102", path=ctx.path,
                    line=stmt.lineno,
                    message=(f"Python `{kind}` on a tensor in hot-path "
                             f"function {fn.name!r} reads it on the host "
                             f"(an implicit .item()) — branch on host "
                             f"values, or use torch.where"))


# --------------------------------------------------------------------- RA104
_UNHASHABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)
_UNHASHABLE_CALLS = {"list", "dict", "set", "bytearray"}


@rule("mutable-default", "RA104", "ast",
      "Mutable default argument ([] / {} / set()): shared across calls. "
      "A warning: the port has no trace cache for it to leak into.")
def check_mutable_default(ctx: FileContext) -> Iterator[Finding]:
    for fn in collect_functions(ctx):
        a = fn.node.args
        for d in list(a.defaults) + [d for d in a.kw_defaults if d]:
            bad = (isinstance(d, _UNHASHABLE_DISPLAYS)
                   or (isinstance(d, ast.Call)
                       and dotted(d.func) in _UNHASHABLE_CALLS))
            if bad:
                yield Finding(
                    rule="mutable-default", code="RA104", path=ctx.path,
                    line=d.lineno, severity="warning",
                    message=(f"mutable default argument in function "
                             f"{fn.name!r} — use None and construct inside"))


# --------------------------------------------------------------------- RA105
@rule("print", "RA105", "ast",
      "print() outside repro_torch.obs.log — stdout writes bypass the "
      "structured logger (and sync implicitly when printing tensors).")
def check_print(ctx: FileContext) -> Iterator[Finding]:
    path = ctx.path.replace("\\", "/")
    if path.endswith("obs/log.py"):
        return
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            yield Finding(
                rule="print", code="RA105", path=ctx.path, line=node.lineno,
                message=("print() outside obs/log — use "
                         "repro_torch.obs.log (or allow[print] with a reason "
                         "for stdout-contract output)"))

