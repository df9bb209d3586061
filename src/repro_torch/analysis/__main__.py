"""repro-lint CLI for the port: ``python -m repro_torch.analysis [ROOT]``.

Exit status: 0 when every finding is grandfathered in the baseline (or
there are none), 1 when new findings exist, 2 on usage errors.  The flags
and report formats are the JAX package's (``python -m repro.analysis``).

Examples::

    python -m repro_torch.analysis                    # lint src/repro_torch
    python -m repro_torch.analysis --format json      # machine-readable
    python -m repro_torch.analysis --rules DET001,TORCH001
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from . import baseline as baseline_mod
from .core import Finding, load_project, run_rules
from .rules import ALL_RULES, select_rules

_PKG_ROOT = Path(__file__).resolve().parents[1]      # src/repro_torch


def _default_tests_dir(root: Path) -> Optional[Path]:
    """tests/ next to the src tree, when scanning the real package."""
    for candidate in (root.parent.parent / "tests",
                      root.parent / "tests"):
        if candidate.is_dir():
            return candidate
    return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=("repro-lint: determinism & device-safety static "
                     "analysis for the PyTorch/CUDA port"))
    parser.add_argument(
        "root", nargs="?", default=str(_PKG_ROOT),
        help="directory (or single file) to scan [default: src/repro_torch]")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids/slugs to run [default: all]")
    parser.add_argument(
        "--baseline", default=None,
        help=("baseline JSON path [default: the committed "
              "analysis/baseline.json]"))
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="grandfather all current findings into the baseline file")
    parser.add_argument(
        "--output", default=None,
        help="also write the report to this file")
    parser.add_argument(
        "--tests-dir", default=None,
        help=("test-suite directory for the contract rule, which reads "
              "its test_torch_*.py files [default: auto-detected tests/ "
              "next to the scanned root]"))
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    return parser


def _render_text(new: List[Finding], old: List[Finding],
                 rule_count: int) -> str:
    lines = [f"{f.location()}: {f.rule} ({f.name}) {f.message}"
             for f in new]
    lines.append(
        f"repro-lint: {len(new)} finding(s)"
        f"{f', {len(old)} baselined' if old else ''} "
        f"across {rule_count} rule(s)")
    return "\n".join(lines)


def _render_json(project, new: List[Finding], old: List[Finding],
                 rules) -> str:
    new_fps = baseline_mod.fingerprints(project, new)
    old_fps = baseline_mod.fingerprints(project, old)
    return json.dumps({
        "findings": [dict(f.to_dict(), fingerprint=fp)
                     for f, fp in zip(new, new_fps)],
        "baselined": [dict(f.to_dict(), fingerprint=fp)
                      for f, fp in zip(old, old_fps)],
        "summary": {
            "new": len(new), "baselined": len(old),
            "rules": sorted(r.id for r in rules),
            "files": len(project.files),
        },
    }, indent=2) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in ALL_RULES:
            scope = ", ".join(rule.paths) if rule.paths else "all files"
            print(f"{rule.id}  {rule.name:24s} [{scope}]  "
                  f"{rule.description}")
        return 0
    try:
        rules = select_rules(
            args.rules.split(",") if args.rules else None)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2

    root = Path(args.root)
    if not root.exists():
        print(f"no such path: {root}", file=sys.stderr)
        return 2
    tests_dir = (Path(args.tests_dir) if args.tests_dir
                 else _default_tests_dir(root.resolve()))
    project = load_project(root, tests_dir=tests_dir)
    findings = run_rules(project, rules)

    if args.write_baseline:
        path = baseline_mod.write(
            Path(args.baseline) if args.baseline else None,
            project, findings)
        print(f"wrote {len(findings)} finding(s) to {path}")
        return 0

    base = ({} if args.no_baseline
            else baseline_mod.load(
                Path(args.baseline) if args.baseline else None))
    new, old = baseline_mod.partition(project, findings, base)

    report = (_render_json(project, new, old, rules)
              if args.format == "json"
              else _render_text(new, old, len(rules)) + "\n")
    sys.stdout.write(report)
    if args.output:
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report, encoding="utf-8")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
