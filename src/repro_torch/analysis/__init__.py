"""The port's static analysis of its performance invariants: the
counterpart of the JAX package's ``repro.analysis`` for PyTorch and the
H100.

Two layers:
  * AST rules (RA1xx, ``repro_torch.analysis.ast_rules``) — pure-source
    lint: torch host syncs (``.item()``, ``.cpu()``, ``.tolist()``,
    ``torch.cuda.synchronize``, ...) outside designated sync boundaries
    and in the serve hot path, Python branches on tensors in the hot path,
    mutable defaults, stray print(). No torch import needed.
  * semantic rules (RT2xx, ``repro_torch.analysis.torch_rules``) — import
    the live code: the Hopper shared-memory and L2 budget of every
    Table-I kernel plan (``analysis/budget.py``), the serve engine's
    one-tile-function-per-bucket contract, the train state's in-place
    updates.

Run: ``python -m repro_torch.analysis [paths]`` (default
``src/repro_torch``). Suppress with ``# repro: allow[rule] reason``; the
grammar is the JAX linter's (``repro_torch.analysis.registry``), and so
are the rule names where the meaning carries over.
"""
from repro_torch.analysis.registry import (Finding, RULES, report,  # noqa: F401
                                           rule_catalog, run_paths)
