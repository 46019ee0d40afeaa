"""Rule registry, findings, and the suppression grammar of the port's
linter: a copy of the JAX package's ``analysis/registry.py``.

Every rule has a stable ``name`` (the suppression token) and a ``code``
(``RAxxx`` for pure-AST rules, ``RTxxx`` for torch-semantic rules that
import the code). Where a rule means what a JAX rule means, it keeps the
JAX rule's name, so one ``allow[host-sync]`` serves both linters.
Findings carry a severity: ``error`` findings fail the lint gate,
``warning`` findings are reported but do not affect the exit code (used
for *documented* degradations, e.g. the tiled grid's 16 MiB levels, each
over the encode backward's 8 MiB L2 share on its own: ``analysis/budget.py``).

Suppression / marker grammar (comments, parsed with ``tokenize`` so
they work on any statement):

  ``# repro: allow[rule-a,rule-b] <reason>``
      Suppress those rules on this line (or the line directly below —
      the comment-above-the-statement idiom). A reason is required by
      convention and carried into the JSON report.
  ``# repro: allow-file[rule] <reason>``
      Suppress a rule for the whole file.
  ``# repro: hot-path``
      Marks a function as serve-hot-path: host-sync conversions inside
      it are lint errors (the ``RenderEngine.submit`` contract).
  ``# repro: sync-boundary <reason>``
      Marks a function as a *designated* host-sync boundary
      (``Ticket.result``-style): the host-sync rule skips its body.

This module is dependency-free (no torch import) so the AST layer stays
cheap to run anywhere.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple


@dataclasses.dataclass
class Finding:
    """One rule violation (or suppressed/waived occurrence)."""
    rule: str
    code: str
    path: str
    line: int
    message: str
    severity: str = "error"          # 'error' | 'warning'
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = {"error": "", "warning": " (warning)"}[self.severity]
        sup = (f"  [suppressed: {self.suppress_reason or 'no reason'}]"
               if self.suppressed else "")
        return (f"{self.path}:{self.line}: {self.code}[{self.rule}]{tag} "
                f"{self.message}{sup}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    code: str
    kind: str                        # 'ast' | 'semantic'
    doc: str
    fn: Callable


RULES: Dict[str, Rule] = {}


def rule(name: str, code: str, kind: str, doc: str):
    """Register a rule. AST rules receive a :class:`FileContext`;
    semantic rules receive nothing (they import the live code)."""
    def deco(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name=name, code=code, kind=kind, doc=doc, fn=fn)
        return fn
    return deco


def rule_catalog() -> List[Dict]:
    return [{"name": r.name, "code": r.code, "kind": r.kind, "doc": r.doc}
            for r in sorted(RULES.values(), key=lambda r: r.code)]


# ------------------------------------------------------------ file context
_ALLOW_RE = re.compile(
    r"#\s*repro:\s*(allow|allow-file)\[([\w\-, ]+)\]\s*(.*)$")
_MARKER_RE = re.compile(r"#\s*repro:\s*(hot-path|sync-boundary)\b\s*(.*)$")


class FileContext:
    """Parsed source + comment directives for one file."""

    def __init__(self, path, src: Optional[str] = None):
        import ast
        self.path = str(path)
        self.src = Path(path).read_text() if src is None else src
        self.tree = ast.parse(self.src, filename=self.path)
        # line -> {rule -> reason}
        self.allow: Dict[int, Dict[str, str]] = {}
        self.allow_file: Dict[str, str] = {}
        self.hot_path_lines: Set[int] = set()
        self.boundary_lines: Set[int] = set()
        self._parse_comments()

    def _parse_comments(self):
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.src).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                self._parse_comment(tok.start[0], tok.string)
        except tokenize.TokenError:
            pass

    def _parse_comment(self, line: int, text: str):
        m = _ALLOW_RE.search(text)
        if m:
            kind, rules, reason = m.groups()
            for r in (x.strip() for x in rules.split(",")):
                if not r:
                    continue
                if kind == "allow-file":
                    self.allow_file[r] = reason.strip()
                else:
                    self.allow.setdefault(line, {})[r] = reason.strip()
            return
        m = _MARKER_RE.search(text)
        if m:
            kind = m.group(1)
            (self.hot_path_lines if kind == "hot-path"
             else self.boundary_lines).add(line)

    def suppression(self, rule_name: str, line: int
                    ) -> Optional[Tuple[bool, str]]:
        """(True, reason) if ``rule_name`` is suppressed at ``line``."""
        if rule_name in self.allow_file:
            return True, self.allow_file[rule_name]
        # same line, or a directive on the line above the statement
        for ln in (line, line - 1):
            hit = self.allow.get(ln)
            if hit and rule_name in hit:
                return True, hit[rule_name]
        return None

    def has_marker(self, lines: Set[int], node) -> bool:
        """Marker on the def line, the decorator lines, or directly above."""
        span = set(range(node.lineno - 1, getattr(node, "body", [node])[0]
                         .lineno if getattr(node, "body", None) else
                         node.lineno + 1))
        span.add(node.lineno)
        return bool(span & lines)


# ----------------------------------------------------------------- running
def iter_python_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return out


def run_paths(paths: Iterable[str], rules: Optional[Iterable[str]] = None,
              semantic: bool = True) -> List[Finding]:
    """Run the suite over ``paths``; returns ALL findings (including
    suppressed ones — callers filter on ``.suppressed`` / severity)."""
    # import registers the rules
    from repro_torch.analysis import ast_rules  # noqa: F401
    if semantic:
        from repro_torch.analysis import torch_rules  # noqa: F401

    selected = {n: r for n, r in RULES.items()
                if rules is None or n in set(rules)}
    findings: List[Finding] = []
    files = iter_python_files(paths)
    for f in files:
        try:
            ctx = FileContext(f)
        except SyntaxError as e:
            findings.append(Finding(
                rule="parse", code="RA000", path=str(f),
                line=e.lineno or 0, message=f"syntax error: {e.msg}"))
            continue
        for r in selected.values():
            if r.kind != "ast":
                continue
            for finding in r.fn(ctx):
                sup = ctx.suppression(r.name, finding.line)
                if sup:
                    finding.suppressed = True
                    finding.suppress_reason = sup[1]
                findings.append(finding)
    if semantic:
        for r in selected.values():
            if r.kind != "semantic":
                continue
            findings.extend(r.fn())
    return findings


def report(findings: List[Finding], n_files: int = 0) -> Dict:
    """The JSON report object (schema:
    benchmarks/schemas/analysis_report.schema.json)."""
    active = [f for f in findings if not f.suppressed]
    return {
        "version": 1,
        "tool": "repro-torch-lint",
        "rules": rule_catalog(),
        "findings": [f.to_json() for f in findings],
        "summary": {
            "files": n_files,
            "errors": sum(1 for f in active if f.severity == "error"),
            "warnings": sum(1 for f in active if f.severity == "warning"),
            "suppressed": sum(1 for f in findings if f.suppressed),
        },
    }
