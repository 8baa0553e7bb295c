"""torchcheck CLI: ``python -m repro_torch.analysis.staticcheck src/repro_torch``.

The reference's CLI, over the port's rules.

Exit codes: 0 clean; 1 findings (new findings, unused suppressions, or
baseline entries missing a justification); 2 usage error.

``--write-baseline`` grandfathers the current findings: each entry
needs a hand-written ``justification`` string (the write keeps any
already present); the run fails until every entry has one, so a
baseline is never a silent rug.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.staticcheck import rules  # noqa: F401  (registers)
from repro_torch.analysis.staticcheck.core import (RULES, apply_baseline,
                                                   load_baseline, run_paths,
                                                   write_baseline)

DEFAULT_BASELINE = "torchcheck-baseline.json"


def _list_rules() -> str:
    width = max(len(r) for r in RULES)
    return "\n".join(f"{name:<{width}}  {rule.invariant}"
                     for name, rule in sorted(RULES.items()))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="AST-level invariant linter for the port's serving "
                    "hot path")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to scan")
    parser.add_argument("--select", action="append", default=None,
                        metavar="RULE",
                        help="run only this rule (repeatable)")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON of grandfathered findings "
                             f"(default: {DEFAULT_BASELINE}; missing file "
                             "= empty)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "(keeps existing justifications)")
    parser.add_argument("--json", dest="json_out", metavar="PATH",
                        help="also write the full report as JSON "
                             "('-' for stdout)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if not args.paths:
        parser.print_usage(sys.stderr)
        print("torchcheck: error: no paths given", file=sys.stderr)
        return 2
    unknown = [r for r in (args.select or [])
               if r not in RULES]
    if unknown:
        print(f"torchcheck: error: unknown rule(s): "
              f"{', '.join(unknown)} (see --list-rules)", file=sys.stderr)
        return 2

    findings, n_files = run_paths(args.paths, args.select)
    baseline = load_baseline(args.baseline)

    if args.write_baseline:
        empty = write_baseline(args.baseline, findings, baseline)
        print(f"torchcheck: wrote {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} to "
              f"{args.baseline}")
        if empty:
            print(f"torchcheck: {empty} entr"
                  f"{'y needs' if empty == 1 else 'ies need'} a "
                  f"justification before the baseline is valid",
                  file=sys.stderr)
            return 1
        return 0

    new, grandfathered, stale, unjustified = apply_baseline(
        findings, baseline)

    if args.json_out:
        report = {
            "files_scanned": n_files,
            "rules": sorted(RULES),
            "new": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in grandfathered],
            "stale_baseline_entries": stale,
            "unjustified_baseline_entries": unjustified,
        }
        blob = json.dumps(report, indent=2) + "\n"
        if args.json_out == "-":
            sys.stdout.write(blob)
        else:
            with open(args.json_out, "w", encoding="utf-8") as fh:
                fh.write(blob)

    for f in new:
        print(f.render())
    for e in unjustified:
        print(f"{e['path']}: baseline: entry {e['fingerprint']} "
              f"({e['rule']}) has no justification — write one or fix "
              f"the finding")
    for e in stale:
        print(f"torchcheck: note: stale baseline entry "
              f"{e['fingerprint']} ({e['rule']} in {e['path']}) no "
              f"longer fires — remove it", file=sys.stderr)

    ok = not new and not unjustified
    summary = (f"torchcheck: {n_files} files, "
               f"{len(new)} finding{'s' if len(new) != 1 else ''}"
               + (f", {len(grandfathered)} baselined"
                  if grandfathered else ""))
    print(summary, file=sys.stderr if ok else sys.stdout)
    return 0 if ok else 1
