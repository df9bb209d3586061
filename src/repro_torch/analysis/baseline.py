"""Baseline suppression: grandfathered findings, committed as JSON.

A finding's fingerprint is ``rule:path:crc32(stripped line):occurrence``
— keyed on the *content* of the flagged line rather than its number, so
unrelated edits that shift lines don't invalidate the baseline, while
editing the flagged line itself (the moment to actually fix it) does.
The file format is the JAX package's (``repro.analysis.baseline``): a
baseline written by either package loads in the other.

``baseline.json`` lives next to this module and is committed empty; a
run fails on any finding not in it.  Never grow it to sneak a new
finding past review: fix the code, or pragma a false positive with its
reason beside it.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding, Project, line_fingerprint

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def fingerprints(project: Project,
                 findings: Sequence[Finding]) -> List[str]:
    """One stable fingerprint per finding (order-aligned)."""
    seen: Counter = Counter()
    out: List[str] = []
    for f in findings:
        ctx = project.get(f.path)
        crc = line_fingerprint(ctx, f.line) if ctx is not None else 0
        key = (f.rule, f.path, crc)
        out.append(f"{f.rule}:{f.path}:{crc:08x}:{seen[key]}")
        seen[key] += 1
    return out


def load(path: Optional[Path] = None) -> Dict[str, dict]:
    """fingerprint → recorded finding dict (empty when absent)."""
    p = Path(path) if path else DEFAULT_BASELINE
    if not p.is_file():
        return {}
    data = json.loads(p.read_text(encoding="utf-8"))
    return dict(data.get("findings", {}))


def write(path: Optional[Path], project: Project,
          findings: Sequence[Finding]) -> Path:
    p = Path(path) if path else DEFAULT_BASELINE
    entries = {
        fp: {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message}
        for fp, f in zip(fingerprints(project, findings), findings)}
    payload = {
        "version": 1,
        "comment": ("grandfathered repro-lint findings; shrink when "
                    "fixing, never grow to bypass a new finding"),
        "findings": dict(sorted(entries.items())),
    }
    p.write_text(json.dumps(payload, indent=2, sort_keys=False) + "\n",
                 encoding="utf-8")
    return p


def partition(project: Project, findings: Sequence[Finding],
              baseline: Dict[str, dict]
              ) -> Tuple[List[Finding], List[Finding]]:
    """(new, grandfathered) split of ``findings`` against ``baseline``."""
    new: List[Finding] = []
    old: List[Finding] = []
    for fp, f in zip(fingerprints(project, findings), findings):
        (old if fp in baseline else new).append(f)
    return new, old
