"""repro-lint engine for the port: file contexts, the Rule protocol,
pragma filtering.

Walk ``.py`` files under a root, parse each once into a
:class:`FileContext`, hand every context to every registered rule
(``check_file``), then give project-level rules one shot at the whole
corpus (``check_project``: the kernel↔plain contract cross-references
``kernels/__init__.py``, the wrapper modules, ``csrc/`` and the test
suite).  Findings are filtered through per-line
``# repro-lint: disable=RULE`` pragmas before they reach the caller;
baseline suppression lives in :mod:`repro_torch.analysis.baseline`.

Paths are reported relative to the scanned root (posix form), so a rule
scoped to e.g. ``fl/`` fires identically on ``src/repro_torch/fl/`` and
on a fixture corpus mirroring that layout.  The pragma syntax, the
finding fields and the line fingerprint are the JAX package's
(``repro.analysis.core``), so pragmas and baselines mean the same thing
in both packages; this module is the port's own copy and imports nothing
of that package.
"""
from __future__ import annotations

import ast
import re
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

# severity is informational — any non-baselined finding fails the run
SEV_ERROR = "error"

_PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\- ]+)")

# directories never worth parsing
_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache"}

# the port's tests: the contract rule reads only these files of the suite
TEST_GLOB = "test_torch_*.py"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete source location."""
    rule: str                   # rule id, e.g. "DET001"
    name: str                   # rule slug, e.g. "unseeded-random"
    path: str                   # posix path relative to the scan root
    line: int                   # 1-based
    message: str
    severity: str = SEV_ERROR

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "name": self.name, "path": self.path,
                "line": self.line, "message": self.message,
                "severity": self.severity}


def line_fingerprint(ctx: "FileContext", line: int) -> int:
    """CRC of the stripped source line — stable across pure renumbering
    (the baseline keys on it instead of the line number)."""
    text = ""
    if 1 <= line <= len(ctx.lines):
        text = ctx.lines[line - 1].strip()
    return zlib.crc32(text.encode("utf-8"))


class FileContext:
    """One parsed source file plus its pragma map."""

    def __init__(self, path: Path, relpath: str,
                 source: Optional[str] = None):
        self.path = path
        self.relpath = relpath
        self.source = (path.read_text(encoding="utf-8")
                       if source is None else source)
        self.lines = self.source.splitlines()
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(
                self.source, filename=str(path))
        except SyntaxError as exc:        # surfaced as its own finding
            self.tree = None
            self.syntax_error = exc
        self._pragmas: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                self._pragmas[i] = {
                    p.strip().lower()
                    for p in m.group(1).split(",") if p.strip()}

    def suppressed(self, finding: Finding) -> bool:
        ids = self._pragmas.get(finding.line)
        if not ids:
            return False
        return ("all" in ids or finding.rule.lower() in ids
                or finding.name.lower() in ids)


@dataclass
class Project:
    """The full scanned corpus, handed to project-level rules."""
    root: Path                          # the scanned package root
    files: List[FileContext] = field(default_factory=list)
    # directory holding the test suite (None when scanning a corpus that
    # has no tests — contract rules then skip their test-coverage leg)
    tests_dir: Optional[Path] = None

    def get(self, relpath: str) -> Optional[FileContext]:
        for ctx in self.files:
            if ctx.relpath == relpath:
                return ctx
        return None

    def test_sources(self) -> List[str]:
        """The port's test files (``test_torch_*.py``) of ``tests_dir``."""
        if self.tests_dir is None or not self.tests_dir.is_dir():
            return []
        return [p.read_text(encoding="utf-8")
                for p in sorted(self.tests_dir.glob(TEST_GLOB))]


class Rule:
    """Base rule: subclass and override ``check_file`` and/or
    ``check_project``.  ``id`` is the stable code (pragma/baseline key),
    ``name`` the human slug; ``paths`` restricts ``check_file`` to
    relpaths matching any of the given prefixes (empty = all files)."""

    id: str = ""
    name: str = ""
    description: str = ""
    severity: str = SEV_ERROR
    paths: Sequence[str] = ()

    def applies(self, relpath: str) -> bool:
        if not self.paths:
            return True
        return any(relpath == p or relpath.startswith(p)
                   for p in self.paths)

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        return iter(())

    def check_project(self, project: Project) -> Iterator[Finding]:
        return iter(())

    # ---- helpers for subclasses --------------------------------------
    def finding(self, ctx_or_path, line: int, message: str) -> Finding:
        path = (ctx_or_path.relpath if isinstance(ctx_or_path, FileContext)
                else str(ctx_or_path))
        return Finding(rule=self.id, name=self.name, path=path, line=line,
                       message=message, severity=self.severity)


def iter_source_files(root: Path) -> Iterator[Path]:
    for path in sorted(root.rglob("*.py")):
        if any(part in _SKIP_DIRS for part in path.parts):
            continue
        yield path


def load_project(root: Path,
                 tests_dir: Optional[Path] = None) -> Project:
    root = root.resolve()
    project = Project(root=root, tests_dir=tests_dir)
    if root.is_file():
        project.files.append(
            FileContext(root, root.name))
        return project
    for path in iter_source_files(root):
        rel = path.relative_to(root).as_posix()
        project.files.append(FileContext(path, rel))
    return project


def run_rules(project: Project, rules: Iterable[Rule]) -> List[Finding]:
    """All non-pragma-suppressed findings, ordered by (path, line, rule)."""
    rules = list(rules)
    findings: List[Finding] = []
    for ctx in project.files:
        if ctx.syntax_error is not None:
            findings.append(Finding(
                rule="E000", name="syntax-error", path=ctx.relpath,
                line=ctx.syntax_error.lineno or 1,
                message=f"file does not parse: {ctx.syntax_error.msg}"))
            continue
        for rule in rules:
            if not rule.applies(ctx.relpath):
                continue
            for f in rule.check_file(ctx, project):
                if not ctx.suppressed(f):
                    findings.append(f)
    for rule in rules:
        for f in rule.check_project(project):
            ctx = project.get(f.path)
            if ctx is None or not ctx.suppressed(f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---- shared AST utilities (used across rule modules) -----------------
def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def imported_module_aliases(tree: ast.Module, module: str) -> Set[str]:
    """Local names bound to ``module`` by a plain import / import-as."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    aliases.add(a.asname or a.name)
    return aliases


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def keyword(node: ast.Call, name: str) -> Optional[ast.expr]:
    """The value of keyword argument ``name`` of a call, if given."""
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def str_constants(expr: ast.AST) -> Iterator[ast.Constant]:
    """Every string literal inside ``expr``."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub


def module_str_consts(tree: ast.Module) -> Dict[str, str]:
    """``NAME = "literal"`` assignments at module level."""
    consts: Dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            consts[node.targets[0].id] = node.value.value
    return consts


def walk_scope(scope: ast.AST) -> Iterator[ast.AST]:
    """Nodes belonging to ``scope``'s own body, *excluding* nested
    function subtrees (which are their own scopes for rules that reason
    about one function at a time)."""
    stack = list(getattr(scope, "body", []))
    while stack:
        node = stack.pop()
        yield node
        # nested defs are yielded (callers may want the node itself)
        # but never descended into
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
