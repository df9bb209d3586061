"""Contract rules: cross-file invariants the parity suites key on.

CON003 — every kernel wrapper named in the ``KERNELS`` tuple of
``kernels/__init__.py`` needs (a) its plain PyTorch version exported as
``<name>_plain`` (a ``*_sharded`` wrapper maps to its unsharded plain
version), (b) a wrapper module that binds a library whose
``csrc/<lib>.cu`` source exists, and (c) a ``tests/test_torch_*.py`` that
names both the wrapper and its plain version (the parity surface: on the
CPU the wrapper runs the plain version, on the card the kernel, and the
tests and ``chip_smoke.py`` hold one against the other).  The JAX
package's CON001 asks for ``kernels/ref.py`` oracles instead; the port
keeps each plain version beside its kernel.

CON002 — the dict literals each ``TraceRecorder`` sink emits must match
the key-set declared in ``RECORD_SCHEMAS`` (``faas/trace.py``): trace
tests compare *bytes*, so an undeclared key silently added to a record
breaks every trace comparison with the JAX package at once.  The JAX
package's rule, unchanged.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import (FileContext, Finding, Project, Rule, call_name,
                    module_str_consts, walk_scope)

KERNELS_INIT = "kernels/__init__.py"
TRACE_MODULE = "faas/trace.py"
CSRC_DIR = "csrc"
_SHARDED = "_sharded"
_PLAIN = "_plain"


def _all_names(tree: ast.Module) -> Set[str]:
    """The strings of the module's ``__all__``."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "__all__"
                and isinstance(node.value, (ast.List, ast.Tuple))):
            return {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return set()


def _kernel_entries(tree: ast.Module) -> List[Tuple[str, int]]:
    """(name, lineno) for each Name in the module-level ``KERNELS``."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "KERNELS"
                and isinstance(node.value, (ast.List, ast.Tuple))):
            return [(e.id, e.lineno) for e in node.value.elts
                    if isinstance(e, ast.Name)]
    return []


def _import_sources(tree: ast.Module) -> Dict[str, str]:
    """Imported name → the ``kernels/<module>.py`` it comes from, for the
    package's relative imports (``from .fed_agg import fed_agg``)."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if (isinstance(node, ast.ImportFrom) and node.level == 1
                and node.module):
            path = "kernels/" + node.module.replace(".", "/") + ".py"
            for a in node.names:
                out[a.asname or a.name] = path
    return out


def _bound_libraries(tree: ast.Module) -> List[str]:
    """The library names a module binds: ``build.bind("<lib>", ...)`` /
    ``build.load("<lib>")`` with a literal name."""
    libs: List[str] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and (call_name(node) or "").endswith(("build.bind",
                                                      "build.load"))
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            libs.append(node.args[0].value)
    return libs


def plain_name(kernel: str) -> str:
    """``fed_agg_sharded`` → ``fed_agg_plain``; ``topk_mask`` →
    ``topk_mask_plain``."""
    base = kernel[:-len(_SHARDED)] if kernel.endswith(_SHARDED) else kernel
    return base + _PLAIN


def _names_word(src: str, name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", src) is not None


class KernelPlainParityRule(Rule):
    """CON003: kernel wrappers need a plain version, a CUDA source and a
    parity test."""

    id = "CON003"
    name = "kernel-plain-parity"
    description = ("every kernels.KERNELS wrapper needs an exported "
                   "*_plain version, a csrc/*.cu its module binds, and a "
                   "test_torch_*.py naming both")

    def check_project(self, project: Project) -> Iterator[Finding]:
        init_ctx = project.get(KERNELS_INIT)
        if init_ctx is None or init_ctx.tree is None:
            return
        exported = _all_names(init_ctx.tree)
        sources = _import_sources(init_ctx.tree)
        tests = project.test_sources()
        for kernel, lineno in _kernel_entries(init_ctx.tree):
            plain = plain_name(kernel)
            if plain not in exported:
                yield self.finding(
                    KERNELS_INIT, lineno,
                    f"kernel `{kernel}` has no plain version exported "
                    f"from kernels/__init__.py (expected `{plain}`)")
            yield from self._check_library(project, kernel, lineno,
                                           sources.get(kernel))
            if tests and not any(_names_word(src, kernel)
                                 and _names_word(src, plain)
                                 for src in tests):
                yield self.finding(
                    KERNELS_INIT, lineno,
                    f"no test_torch_*.py names both `{kernel}` and its "
                    f"plain version `{plain}` — the parity surface is "
                    f"unguarded")

    def _check_library(self, project: Project, kernel: str, lineno: int,
                       module: Optional[str]) -> Iterator[Finding]:
        ctx = project.get(module) if module else None
        if ctx is None or ctx.tree is None:
            yield self.finding(
                KERNELS_INIT, lineno,
                f"kernel `{kernel}` is not imported from a kernels/ module "
                f"of the scanned tree")
            return
        libs = _bound_libraries(ctx.tree)
        if not libs:
            yield self.finding(
                KERNELS_INIT, lineno,
                f"kernel `{kernel}`'s module {module} binds no library "
                f"(build.bind(\"<lib>\", ...) in its _library())")
        for lib in libs:
            if not (project.root / CSRC_DIR / f"{lib}.cu").is_file():
                yield self.finding(
                    KERNELS_INIT, lineno,
                    f"kernel `{kernel}`'s module {module} binds library "
                    f"{lib!r}, but {CSRC_DIR}/{lib}.cu does not exist")


def _resolve_key(node: ast.AST,
                 consts: Dict[str, str]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _parse_schemas(tree: ast.Module, consts: Dict[str, str]
                   ) -> Optional[Dict[str, dict]]:
    """The ``RECORD_SCHEMAS`` dict literal, with REC_* names resolved."""
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "RECORD_SCHEMAS"
                and isinstance(node.value, ast.Dict)):
            continue
        schemas: Dict[str, dict] = {}
        for key_node, val_node in zip(node.value.keys,
                                      node.value.values):
            rec_type = _resolve_key(key_node, consts)
            if rec_type is None or not isinstance(val_node, ast.Dict):
                continue
            spec = {"required": set(), "optional": set(), "open": False}
            for k, v in zip(val_node.keys, val_node.values):
                field = _resolve_key(k, consts)
                if field in ("required", "optional"):
                    if isinstance(v, (ast.List, ast.Tuple, ast.Set)):
                        spec[field] = {
                            e.value for e in v.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
                elif field == "open" and isinstance(v, ast.Constant):
                    spec["open"] = bool(v.value)
            schemas[rec_type] = spec
        return schemas
    return None


class TraceSchemaRule(Rule):
    """CON002: emitted trace-record key-sets match RECORD_SCHEMAS."""

    id = "CON002"
    name = "trace-record-schema"
    description = ("TraceRecorder record literals must match the "
                   "declared RECORD_SCHEMAS key-sets")
    paths = (TRACE_MODULE,)

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        consts = module_str_consts(ctx.tree)
        schemas = _parse_schemas(ctx.tree, consts)
        if schemas is None:
            yield self.finding(
                ctx, 1,
                "faas/trace.py declares no RECORD_SCHEMAS — the golden "
                "tests key on exact record key-sets; declare them")
            return
        funcs = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))]
        for fn in funcs:
            yield from self._check_sink(ctx, fn, consts, schemas)

    def _record_literals(self, fn: ast.AST, consts: Dict[str, str]
                         ) -> Iterator[Tuple[str, Optional[str],
                                             ast.Dict]]:
        """(var name, record type, dict node) for each ``X = {...}`` or
        ``self._append({...})`` whose literal carries a "type" key."""
        for node in walk_scope(fn):
            dict_node, var = None, None
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Dict)):
                dict_node, var = node.value, node.targets[0].id
            elif (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Dict)):
                dict_node, var = node.args[0], ""
            if dict_node is None:
                continue
            rec_type = None
            for k, v in zip(dict_node.keys, dict_node.values):
                if _resolve_key(k, consts) == "type":
                    rec_type = _resolve_key(v, consts)
            if rec_type is not None:
                yield var, rec_type, dict_node

    def _check_sink(self, ctx: FileContext, fn: ast.AST,
                    consts: Dict[str, str],
                    schemas: Dict[str, dict]) -> Iterator[Finding]:
        for var, rec_type, dict_node in self._record_literals(fn,
                                                              consts):
            spec = schemas.get(rec_type)
            if spec is None:
                yield self.finding(
                    ctx, dict_node.lineno,
                    f"record type {rec_type!r} is emitted but not "
                    f"declared in RECORD_SCHEMAS")
                continue
            keys = {_resolve_key(k, consts)
                    for k in dict_node.keys} - {None, "type"}
            missing = spec["required"] - keys
            extra = keys - spec["required"] - spec["optional"]
            if missing:
                yield self.finding(
                    ctx, dict_node.lineno,
                    f"{rec_type!r} record is missing declared required "
                    f"keys: {sorted(missing)}")
            if extra:
                yield self.finding(
                    ctx, dict_node.lineno,
                    f"{rec_type!r} record writes undeclared keys "
                    f"{sorted(extra)} — declare them in RECORD_SCHEMAS "
                    f"(golden traces key on exact key-sets)")
            if not var:
                continue
            # conditional writes after the literal: rec["k"] = ...
            for node in walk_scope(fn):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Subscript)
                        and isinstance(node.targets[0].value, ast.Name)
                        and node.targets[0].value.id == var):
                    key = _resolve_key(node.targets[0].slice, consts)
                    if (key is not None and key != "type"
                            and key not in spec["required"]
                            and key not in spec["optional"]):
                        yield self.finding(
                            ctx, node.lineno,
                            f"{rec_type!r} record gains undeclared key "
                            f"{key!r}; declare it as optional in "
                            f"RECORD_SCHEMAS")
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "update"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == var
                        and not spec["open"]):
                    yield self.finding(
                        ctx, node.lineno,
                        f"{rec_type!r} record takes open **extra but "
                        f"RECORD_SCHEMAS does not mark it open")

RULES = (TraceSchemaRule(), KernelPlainParityRule())
