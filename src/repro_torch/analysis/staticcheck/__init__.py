"""torchcheck — the port's AST-level invariant linter for the serving hot
path (port of ``repro.analysis.staticcheck``, with rules for PyTorch).

``python -m repro_torch.analysis.staticcheck src/repro_torch`` runs every
rule over a tree; see ``core`` for the engine and ``rules/`` for the
invariants.
"""
from repro_torch.analysis.staticcheck import rules  # noqa: F401  (registers rules)
from repro_torch.analysis.staticcheck.core import (RULES, Finding,  # noqa: F401
                                                   check_file, check_source,
                                                   hot_functions, run_paths)

__all__ = ["RULES", "Finding", "check_source", "check_file", "run_paths",
           "hot_functions"]
