# repro: allow-file[print] the CLI's human/JSON report IS its stdout contract
"""The port's linter on the command line:
``python -m repro_torch.analysis [paths]`` (default ``src/repro_torch``),
with the JAX package's flags (``python -m repro.analysis``).

Exit status: 0 when no *unsuppressed error* findings remain (warnings —
documented degrades — don't fail the gate), 1 otherwise, 2 on usage
errors. ``--json`` prints the machine report (schema:
benchmarks/schemas/analysis_report.schema.json); ``--json-out PATH``
writes it alongside the human output — the CI artifact.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis import registry


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="Torch- and Hopper-aware static analysis of the "
                    "PyTorch/CUDA port.")
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files or directories to lint "
                        "(default: src/repro_torch)")
    p.add_argument("--json", action="store_true",
                   help="print the JSON report instead of human output")
    p.add_argument("--json-out", metavar="PATH",
                   help="also write the JSON report to PATH")
    p.add_argument("--no-semantic", action="store_true",
                   help="skip the RT2xx rules (no torch import; pure AST)")
    p.add_argument("--rules", metavar="NAMES",
                   help="comma-separated rule names to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--show-suppressed", action="store_true",
                   help="include suppressed findings in human output")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        # force registration of both layers
        from repro_torch.analysis import ast_rules  # noqa: F401
        try:
            from repro_torch.analysis import torch_rules  # noqa: F401
        except ImportError:
            pass
        for r in registry.rule_catalog():
            print(f"{r['code']}  {r['name']:<16} ({r['kind']})  {r['doc']}")
        return 0

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    findings = registry.run_paths(args.paths, rules=rules,
                                  semantic=not args.no_semantic)
    n_files = len(registry.iter_python_files(args.paths))
    rep = registry.report(findings, n_files=n_files)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=2)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        shown = [f for f in findings
                 if not f.suppressed or args.show_suppressed]
        shown.sort(key=lambda f: (f.path, f.line, f.code))
        for f in shown:
            print(f.format())
        s = rep["summary"]
        print(f"repro-torch-lint: {s['files']} files, {s['errors']} errors, "
              f"{s['warnings']} warnings, {s['suppressed']} suppressed")

    return 1 if rep["summary"]["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
