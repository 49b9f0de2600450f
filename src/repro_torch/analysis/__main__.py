"""CLI for the contract checker.

    python -m repro_torch.analysis [--root PATH] [--json PATH] [--rules IDS]

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.core import default_rules, run_analysis


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Check the repo's determinism / layering / "
                    "telemetry contracts (see CONTRACTS.md).")
    parser.add_argument("--root", default=None,
                        # Port: the package (repro/analysis/__main__.py:22)
                        help="repo root holding src/repro_torch or "
                             "repro_torch (default: auto-detect from this "
                             "package)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="also write machine-readable results here")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the OK summary line")
    args = parser.parse_args(argv)

    root = args.root
    if root is None:
        # .../src/repro_torch/analysis -> repo root is 3 dirs up
        # (Port: the same depth as repro/analysis/__main__.py:35)
        pkg = os.path.dirname(os.path.abspath(__file__))
        root = os.path.dirname(os.path.dirname(os.path.dirname(pkg)))
    rules = default_rules()
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",")}
        known = {r.id for r in rules}
        unknown = wanted - known
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}; "
                  f"known: {', '.join(sorted(known))}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]
    try:
        result = run_analysis(root, rules)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)),
                    exist_ok=True)
        with open(args.json_path, "w") as f:
            f.write(result.to_json())
    if not (args.quiet and result.ok):
        print(result.format())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
