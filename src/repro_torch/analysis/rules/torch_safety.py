"""Torch device-safety rules: host syncs under ``torch.func`` transforms,
libraries built or bound outside their one place, mesh-axis names
outside the declared vocabulary, and ``REPRO_*`` environment switches.

These are the static twins of what the card shows only when a run drives
the broken path: a host sync inside the executor's
``vmap(grad_and_value(...))`` body stalls every step of every round (the
card's default FL path, ``fl/executor.py``); a library loaded outside
``kernels/build.py`` skips its content-hashed name and its signatures; a
``torch.compile`` built inside a per-round function recompiles every
round; an axis name no mesh declares fails only on a multi-device run;
an environment switch is a fallback the port's no-fallback rule forbids.

The JAX package's use-after-donate rule (JAX002) has no counterpart: the
port donates no buffer, every kernel wrapper returns fresh tensors
(``kernels/fed_agg.py``'s wrappers allocate their outputs).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import (FileContext, Finding, Project, Rule, call_name,
                    keyword, module_str_consts, str_constants, walk_scope)

# the mesh-axis vocabulary module — MESH_AXES is the declared set of axis
# names every mesh of the port may use (TORCH004 reads it by AST)
AXIS_RULES_RELPATH = "sharding/rules.py"

# the one module that compiles and loads the CUDA libraries
BUILD_RELPATH = "kernels/build.py"

# the torch.func transforms whose function argument runs traced
TRANSFORMS = {"vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
              "jacfwd"}
# dotted prefixes under which those names are torch.func's
_TRANSFORM_PREFIXES = {"torch.func", "func", "torch", "functorch"}

# tensor methods that copy to the host or wait for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_ARRAY_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"}
_HOST_SCALARS = {"float", "int", "bool"}
# a scalar built from these is a host value already (shapes, lengths)
_HOST_SIZE_ATTRS = {"shape", "ndim"}
_HOST_SIZE_METHODS = {"size", "dim", "numel", "__len__"}

_FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


def _parents(tree: ast.Module) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _enclosing(node: ast.AST, parents: Dict[ast.AST, ast.AST], kinds):
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, kinds):
        cur = parents.get(cur)
    return cur


def _host_size_expr(expr: ast.AST) -> bool:
    """``x.shape[i]``, ``x.ndim``, ``len(x)``, ``x.size(i)``, ``x.numel()``:
    values that live on the host, so a scalar of them does not sync."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute) and expr.attr in _HOST_SIZE_ATTRS:
        return True
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) and expr.func.id == "len":
            return True
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _HOST_SIZE_METHODS):
            return True
    return False


class HostSyncInTransformRule(Rule):
    """TORCH001: host synchronization inside a ``torch.func``-transformed
    function.

    ``x.item()`` / ``float(x)`` / ``x.cpu()`` / ``np.asarray(x)`` on a
    tensor inside a function handed to ``vmap`` / ``grad`` /
    ``grad_and_value`` / ``vjp`` / ``jvp`` / ``jacrev`` / ``jacfwd``
    either fails under the transform (a batched tensor has no single
    value) or makes the host wait for the card on every call: the
    executor's step would stall the queue it exists to keep full.  The
    rule resolves the transformed function in the same module: a name
    (a module-level or enclosing def), ``self.<method>`` (a method of
    the enclosing class), a lambda or ``functools.partial(f, ...)``,
    through nested transforms (``vmap(grad_and_value(self._loss))``),
    and follows that function's own calls of such names, transitively.
    Scalars of shapes and lengths (``int(x.shape[0])``) are host values
    and pass.
    """

    id = "TORCH001"
    name = "host-sync-in-transform"
    description = (".item()/.tolist()/.cpu()/.numpy()/np.asarray/float() "
                   "inside a function a torch.func transform runs")

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        aliases = self._transform_aliases(ctx.tree)
        parents = _parents(ctx.tree)
        seen: Set[Tuple[int, str]] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            transform = self._transform_of(node, aliases)
            if transform is None:
                continue
            for fn, label in self._transformed(node, aliases, parents,
                                               ctx.tree):
                for line, what in self._syncs(fn):
                    if (line, what) in seen:
                        continue
                    seen.add((line, what))
                    yield self.finding(
                        ctx, line,
                        f"{what} inside `{label}`, which runs under "
                        f"torch.func.{transform} (line {node.lineno}), "
                        f"syncs with the host; keep the value on the "
                        f"device and read it after the transform")

    # ---- which calls are transforms ----------------------------------
    @staticmethod
    def _transform_aliases(tree: ast.Module) -> Dict[str, str]:
        """Local name → transform for ``from torch.func import vmap``."""
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom)
                    and node.module in ("torch.func", "functorch", "torch")):
                for a in node.names:
                    if a.name in TRANSFORMS:
                        out[a.asname or a.name] = a.name
        return out

    @staticmethod
    def _transform_of(node: ast.Call,
                      aliases: Dict[str, str]) -> Optional[str]:
        dotted = call_name(node)
        if dotted is None:
            return None
        if dotted in aliases:
            return aliases[dotted]
        prefix, _, last = dotted.rpartition(".")
        if last in TRANSFORMS and prefix in _TRANSFORM_PREFIXES:
            return last
        return None

    # ---- resolving the transformed function --------------------------
    def _transformed(self, call: ast.Call, aliases, parents,
                     tree: ast.Module) -> Iterator[Tuple[ast.AST, str]]:
        """(function node, label) for every function the transform at
        ``call`` runs: the one it is handed and, transitively, the ones
        that function calls by a resolvable name."""
        fn_expr = call.args[0] if call.args else keyword(call, "func")
        if fn_expr is None:
            return
        todo = list(self._resolve(fn_expr, call, aliases, parents, tree))
        done: Set[int] = set()
        while todo:
            fn, label = todo.pop()
            if id(fn) in done:
                continue
            done.add(id(fn))
            yield fn, label
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) and sub is not fn:
                    todo.extend(self._resolve(sub.func, sub, aliases,
                                              parents, tree))

    def _resolve(self, expr: ast.AST, site: ast.AST, aliases, parents,
                 tree: ast.Module) -> Iterator[Tuple[ast.AST, str]]:
        if isinstance(expr, ast.Lambda):
            yield expr, "<lambda>"
        elif isinstance(expr, ast.Call):
            # a nested transform, or functools.partial(f, ...)
            if (self._transform_of(expr, aliases) is not None
                    or call_name(expr) in ("functools.partial",
                                           "partial")):
                if expr.args:
                    yield from self._resolve(expr.args[0], site, aliases,
                                             parents, tree)
        elif isinstance(expr, ast.Name):
            fn = self._def_named(expr.id, site, parents, tree)
            if fn is not None:
                yield fn, expr.id
        elif (isinstance(expr, ast.Attribute)
              and isinstance(expr.value, ast.Name)
              and expr.value.id == "self"):
            cls = _enclosing(site, parents, ast.ClassDef)
            if cls is not None:
                for item in cls.body:
                    if isinstance(item, _FuncDef) and item.name == expr.attr:
                        yield item, f"self.{expr.attr}"

    @staticmethod
    def _def_named(name: str, site: ast.AST, parents,
                   tree: ast.Module) -> Optional[ast.AST]:
        """The def ``name`` visible at ``site``: in an enclosing
        function's body first, then at module level."""
        scope = _enclosing(site, parents, _FuncDef)
        while scope is not None:
            for node in walk_scope(scope):
                if isinstance(node, _FuncDef) and node.name == name:
                    return node
            scope = _enclosing(scope, parents, _FuncDef)
        for node in tree.body:
            if isinstance(node, _FuncDef) and node.name == name:
                return node
        return None

    # ---- the syncs ------------------------------------------------------
    @staticmethod
    def _syncs(fn: ast.AST) -> Iterator[Tuple[int, str]]:
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            dotted = call_name(sub)
            if dotted in _HOST_ARRAY_CALLS:
                yield sub.lineno, f"{dotted}()"
            elif (isinstance(func, ast.Attribute)
                  and func.attr in _SYNC_METHODS
                  and (func.attr == "cpu" or not sub.args)):
                yield sub.lineno, f".{func.attr}()"
            elif (isinstance(func, ast.Name) and func.id in _HOST_SCALARS
                  and len(sub.args) == 1
                  and not isinstance(sub.args[0], ast.Constant)
                  and not _host_size_expr(sub.args[0])):
                yield sub.lineno, f"{func.id}()"


class KernelBuildInRoundPathRule(Rule):
    """TORCH003: a library built or bound outside its one place, or
    ``torch.compile`` in a per-round function.

    ``kernels/build.py`` alone compiles and loads the CUDA libraries: it
    names each by a hash of its sources and flags, builds every missing
    one in parallel and caches the handle.  A ``ctypes.CDLL``, a
    ``build.build`` or an ``nvcc`` subprocess elsewhere skips all that.
    A kernel module binds its library in one module-level ``_library()``
    (built at first use, never at import); ``build.bind`` / ``build.load``
    anywhere else rebinds on every call.  A ``torch.compile`` built
    inside a function body under ``core/``, ``fl/`` or ``kernels/``
    starts with an empty cache on every call: construction belongs at
    module scope or in ``__init__``.
    """

    id = "TORCH003"
    name = "kernel-build-in-round-path"
    description = ("CDLL/build.build/nvcc outside kernels/build.py, "
                   "build.bind/load outside a module-level _library(), "
                   "torch.compile inside a round-path function")
    _COMPILE_SCOPE = ("core/", "fl/", "kernels/")

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        parents = _parents(ctx.tree)
        in_build = ctx.relpath == BUILD_RELPATH
        compile_scope = ctx.relpath.startswith(self._COMPILE_SCOPE)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = call_name(node) or ""
            last = dotted.rpartition(".")[2]
            fn = _enclosing(node, parents, _FuncDef)
            if not in_build:
                if last == "CDLL" or dotted.endswith("cdll.LoadLibrary"):
                    yield self.finding(
                        ctx, node.lineno,
                        f"{dotted}() loads a library outside "
                        f"kernels/build.py; bind it through build.bind in "
                        f"the module's _library()")
                elif dotted.endswith("build.build"):
                    yield self.finding(
                        ctx, node.lineno,
                        "build.build() outside kernels/build.py; a kernel "
                        "module binds its library with build.bind in its "
                        "_library(), which builds it at first use")
                elif self._nvcc_subprocess(node, dotted):
                    yield self.finding(
                        ctx, node.lineno,
                        "nvcc run outside kernels/build.py; the build "
                        "module names, builds and caches every library")
            if dotted.endswith(("build.bind", "build.load")) and not (
                    fn is not None and fn.name == "_library"
                    and isinstance(parents.get(fn), ast.Module)):
                yield self.finding(
                    ctx, node.lineno,
                    f"{dotted}() outside a module-level _library(); bind "
                    f"the library once there and call _library() at "
                    f"launch time")
            if (compile_scope and dotted == "torch.compile"
                    and fn is not None
                    and fn.name != "__init__"):
                yield self.finding(
                    ctx, node.lineno,
                    f"torch.compile constructed inside `{fn.name}`; hoist "
                    f"to module scope / __init__, or memoize and pragma "
                    f"with the cache justification")

    @staticmethod
    def _nvcc_subprocess(node: ast.Call, dotted: str) -> bool:
        if not dotted.startswith(("subprocess.", "os.system", "os.popen")):
            return False
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)
                        and "nvcc" in sub.value):
                    return True
                if (isinstance(sub, ast.Call)
                        and (call_name(sub) or "").endswith("nvcc_path")):
                    return True
        return False


# callees whose string arguments are mesh-axis names
# (its ``axes`` keyword is caught as an axis-named keyword)
_MESH_CALLS = {"Mesh": 1, "AbstractMesh": 0}
_SPEC_CALLS = {"P", "PartitionSpec"}


def _is_axis_param(name: Optional[str]) -> bool:
    return bool(name) and (name in ("axis_name", "axes", "axis")
                           or name.endswith(("_axis", "_axes")))


def _mesh_shape(expr: ast.AST) -> bool:
    """``<x>.shape`` where a string subscript makes it a mesh's shape."""
    return isinstance(expr, ast.Attribute) and expr.attr == "shape"


class UndeclaredMeshAxisRule(Rule):
    """TORCH004: a mesh-axis literal outside the declared vocabulary.

    Every mesh of the port (``launch/mesh.py``'s ``Mesh`` and
    ``AbstractMesh``) names its axes from ``sharding/rules.MESH_AXES``.
    A literal axis name that is not in that tuple is a typo or a mesh the
    sharding rules know nothing about; both fail only at run time, on a
    multi-device run.  Checked: the ``axes`` of a ``Mesh`` /
    ``AbstractMesh``, the entries of a ``PartitionSpec`` (``P``), keyword
    arguments and parameter defaults named ``axis``, ``axes``,
    ``axis_name`` or ``*_axis`` / ``*_axes`` (``seq_axis="model"``), the
    string arguments of a callee whose name mentions an axis
    (``_axis_size(mesh, "model")``), and a mesh's ``shape`` looked up by
    name (``mesh.shape["data"]``, ``.get("data")``, ``"data" in
    mesh.shape``).  Axis names that arrive through variables are out of
    scope (they were resolved from the declared constants already).
    """

    id = "TORCH004"
    name = "undeclared-mesh-axis"
    description = ("mesh/PartitionSpec/axis literal not declared in "
                   "sharding/rules.py MESH_AXES")

    def _declared_axes(self, project: Project) -> Set[str]:
        """AST-parse MESH_AXES from the project's sharding/rules.py:
        string elements directly, Name elements resolved against the
        module's own string-constant assignments (CLIENT_AXIS)."""
        ctx = project.get(AXIS_RULES_RELPATH)
        if ctx is None or ctx.tree is None:
            return set()
        consts = module_str_consts(ctx.tree)
        axes: Set[str] = set()
        for node in ctx.tree.body:
            target, value = None, None
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                target, value = node.targets[0].id, node.value
            elif (isinstance(node, ast.AnnAssign)
                    and isinstance(node.target, ast.Name)):
                target, value = node.target.id, node.value
            if target != "MESH_AXES" or not isinstance(
                    value, (ast.Tuple, ast.List)):
                continue
            for e in value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    axes.add(e.value)
                elif isinstance(e, ast.Name) and e.id in consts:
                    axes.add(consts[e.id])
        return axes

    @staticmethod
    def _candidate_exprs(node: ast.AST) -> List[ast.AST]:
        """The sub-expressions of ``node`` that carry axis names."""
        if isinstance(node, _FuncDef):
            args = node.args
            positional = args.posonlyargs + args.args
            pairs = list(zip(positional[len(positional)
                                        - len(args.defaults):],
                             args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults) if d]
            return [d for a, d in pairs if _is_axis_param(a.arg)]
        if isinstance(node, ast.Subscript) and _mesh_shape(node.value):
            return [node.slice]
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                and _mesh_shape(node.comparators[-1]):
            return [node.left]
        if not isinstance(node, ast.Call):
            return []
        exprs = [kw.value for kw in node.keywords if _is_axis_param(kw.arg)]
        dotted = call_name(node) or ""
        last = dotted.rpartition(".")[2]
        if last in _MESH_CALLS:
            if len(node.args) > _MESH_CALLS[last]:
                exprs.append(node.args[_MESH_CALLS[last]])
        elif last in _SPEC_CALLS:
            exprs.extend(node.args)
        elif "axis" in last.lower() or "axes" in last.lower():
            exprs.extend(node.args)
        elif (last == "get" and isinstance(node.func, ast.Attribute)
              and _mesh_shape(node.func.value) and node.args):
            exprs.append(node.args[0])
        return exprs

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        declared = self._declared_axes(project)
        seen: Set[Tuple[int, str]] = set()
        for node in ast.walk(ctx.tree):
            for expr in self._candidate_exprs(node):
                for lit in str_constants(expr):
                    axis = lit.value
                    if axis in declared or (lit.lineno, axis) in seen:
                        continue
                    seen.add((lit.lineno, axis))
                    yield self.finding(
                        ctx, lit.lineno,
                        f"mesh axis {axis!r} is not declared in "
                        f"sharding/rules.py MESH_AXES; add it to the "
                        f"vocabulary (or use the declared constant)")


class NoEnvGateRule(Rule):
    """GATE002: a ``REPRO_*`` environment read anywhere in the port.

    The JAX package keeps runtime kill switches (``REPRO_AGG_KERNEL``,
    ``REPRO_COMPRESS``, ...) in a registry, each reverting a path to a
    reference implementation.  The port has no such switch by its
    no-fallback rule: a kernel wrapper runs its plain version only on a
    CPU tensor, never because a variable says so.  So there is no
    registry to read through, and any ``os.environ`` / ``os.getenv``
    access to a ``REPRO_*`` name is a finding (``CUDA_HOME`` and other
    names are not).
    """

    id = "GATE002"
    name = "no-env-gate"
    description = "REPRO_* environment switch read in the port"

    @staticmethod
    def _gate_name(node: ast.AST) -> Optional[str]:
        """The REPRO_* string touched by this expression, if any."""
        def repro(expr):
            return (isinstance(expr, ast.Constant)
                    and isinstance(expr.value, str)
                    and expr.value.startswith("REPRO_"))

        def environ(expr):
            return (isinstance(expr, ast.Attribute)
                    and expr.attr == "environ") or (
                isinstance(expr, ast.Name) and expr.id == "environ")

        if isinstance(node, ast.Subscript):
            if environ(node.value) and repro(node.slice):
                return node.slice.value
        elif isinstance(node, ast.Compare):
            if (repro(node.left) and environ(node.comparators[-1])
                    and all(isinstance(op, (ast.In, ast.NotIn))
                            for op in node.ops)):
                return node.left.value
        elif isinstance(node, ast.Call):
            dotted = call_name(node) or ""
            if dotted.endswith(("environ.get", "environ.setdefault",
                                "environ.pop", "getenv")):
                if node.args and repro(node.args[0]):
                    return node.args[0].value
        return None

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            gate = self._gate_name(node)
            if gate:
                yield self.finding(
                    ctx, node.lineno,
                    f"environment switch {gate}: the port has no REPRO_* "
                    f"switch (no path falls back to a plain version on a "
                    f"variable's say); take the choice as an argument")


RULES = (HostSyncInTransformRule(), KernelBuildInRoundPathRule(),
         UndeclaredMeshAxisRule(), NoEnvGateRule())
