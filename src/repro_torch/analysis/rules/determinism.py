"""Determinism rules: the bug classes that silently break same-seed
byte-identical traces (the property every EUR/cost/time comparison and
every parity test against the JAX package rests on).

DET002–DET004 are the JAX package's rules unchanged; DET001 also flags
the draws of torch's process-global default generator.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from ..core import (FileContext, Finding, Project, Rule, call_name,
                    imported_module_aliases, keyword)

# stdlib-random functions that draw from (or reseed) the hidden global
# Mersenne state — anything here inside simulation code is a different
# run every time the import order or another caller changes
_STDLIB_DRAWS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "paretovariate",
    "lognormvariate", "weibullvariate", "getrandbits", "randbytes",
    "seed",
}

# np.random attributes that are *not* the legacy global-state API
_NP_RANDOM_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937", "RandomState",
}

# torch factory draws: global default generator unless generator= is given
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
}

# in-place tensor draws: global default generator unless generator= is given
_TORCH_INPLACE_DRAWS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
}

# calls that reseed torch's global generators (a hidden stream shared by
# every caller in the process); an explicit torch.Generator(...)
# .manual_seed(n) is not among them
_TORCH_RESEEDS = {
    "manual_seed", "seed", "random.manual_seed", "random.seed",
    "cuda.manual_seed", "cuda.manual_seed_all", "cuda.seed",
    "cuda.seed_all",
}

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "date.today", "datetime.date.today",
    "uuid.uuid1", "uuid.uuid4", "uuid4", "uuid1",
}


class UnseededRandomRule(Rule):
    """DET001: draws from a hidden global RNG stream.

    ``random.random()`` / ``np.random.rand()`` / ``torch.randn(...)``
    without ``generator=`` consume global state whose sequence depends on
    every other caller in the process — two same-seed runs only stay
    byte-identical when every stream is an explicitly seeded
    ``np.random.default_rng(seed)`` or ``torch.Generator().manual_seed(s)``
    handed to the draw.  Reseeding torch's global generators
    (``torch.manual_seed``) is flagged too: it hides a stream rather than
    threading one through.
    """

    id = "DET001"
    name = "unseeded-random"
    description = ("call into the global random/np.random/torch state "
                   "instead of an explicitly seeded Generator")

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        random_aliases: Set[str] = imported_module_aliases(
            ctx.tree, "random")
        torch_aliases: Set[str] = imported_module_aliases(ctx.tree, "torch")
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            torch_msg = self._torch_draw(node, torch_aliases)
            if torch_msg:
                yield self.finding(ctx, node.lineno, torch_msg)
            dotted = call_name(node)
            if dotted is None:
                continue
            parts = dotted.split(".")
            # stdlib: random.<draw>()
            if (len(parts) == 2 and parts[0] in random_aliases
                    and parts[1] in _STDLIB_DRAWS):
                yield self.finding(
                    ctx, node.lineno,
                    f"{dotted}() draws from the process-global stdlib "
                    f"RNG; use a seeded np.random.default_rng / "
                    f"jax.random key instead")
            # numpy legacy global state: np.random.<fn>() — the
            # Generator construction surface is allowed
            if (len(parts) >= 3 and parts[-2] == "random"
                    and parts[0] in ("np", "numpy")
                    and parts[-1] not in _NP_RANDOM_OK):
                yield self.finding(
                    ctx, node.lineno,
                    f"{dotted}() uses numpy's legacy global RNG state; "
                    f"thread an explicit np.random.Generator through "
                    f"instead")

    @staticmethod
    def _torch_draw(node: ast.Call, torch_aliases: Set[str]
                    ) -> Optional[str]:
        """The message for a draw from (or reseed of) torch's global
        generator, else None."""
        has_gen = keyword(node, "generator") is not None
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in _TORCH_INPLACE_DRAWS and not has_gen):
            return (f".{func.attr}() without generator= draws from torch's "
                    f"process-global generator; pass an explicit "
                    f"torch.Generator")
        dotted = call_name(node)
        if dotted is None or "." not in dotted:
            return None
        head, rest = dotted.split(".", 1)
        if head not in torch_aliases:
            return None
        if rest in _TORCH_DRAWS and not has_gen:
            return (f"{dotted}() without generator= draws from torch's "
                    f"process-global generator; pass an explicit "
                    f"torch.Generator")
        if rest in _TORCH_RESEEDS:
            return (f"{dotted}() reseeds torch's process-global generator; "
                    f"seed an explicit torch.Generator(...).manual_seed(n) "
                    f"and hand it to each draw instead")
        return None


class WallClockRule(Rule):
    """DET002: wall-clock / uuid reads inside the simulation.

    Everything in ``faas/``, ``fl/`` and ``core/`` runs on the *virtual*
    clock — a single ``time.time()`` or ``uuid4()`` leaking into a
    record or a decision makes same-seed traces diverge byte-by-byte.
    (``launch/`` and the examples legitimately time walls; they are out
    of scope by path.)
    """

    id = "DET002"
    name = "wallclock-in-sim"
    description = ("wall-clock time / uuid read inside a virtual-clock "
                   "simulation path")
    paths = ("faas/", "fl/", "core/")

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = call_name(node)
            if dotted in _WALLCLOCK_CALLS:
                yield self.finding(
                    ctx, node.lineno,
                    f"{dotted}() reads the wall clock / host entropy in "
                    f"a simulation path; use the virtual clock (event "
                    f"time) or a seeded stream")


class BuiltinHashRule(Rule):
    """DET003: builtin ``hash()`` anywhere in the package.

    ``hash(str)`` is salted per process (PYTHONHASHSEED), so any seed or
    key derived from it differs between runs; the client seeds derive
    with crc32 for that reason.  Use ``zlib.crc32`` / ``hashlib`` for
    stable derivation.
    """

    id = "DET003"
    name = "builtin-hash"
    description = "builtin hash() is salted per process; derive with crc32"

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "hash"):
                yield self.finding(
                    ctx, node.lineno,
                    "builtin hash() output changes with PYTHONHASHSEED; "
                    "use zlib.crc32 / hashlib for stable derivation")


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset")):
        return True
    # set ops on set expressions, e.g. set(a) - set(b)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class SetIterationRule(Rule):
    """DET004: iterating a set where order reaches an accumulator.

    Set iteration order depends on insertion history and the per-process
    hash seed; feeding it into any order-sensitive consumer (float
    accumulation, trace emission, cohort lists) is nondeterminism with a
    delay.  ``sorted(set(...))`` and membership tests are fine.
    """

    id = "DET004"
    name = "set-iteration-order"
    description = ("raw set iteration order is hash-seed dependent; "
                   "sort before iterating")
    paths = ("core/", "faas/", "fl/", "kernels/")

    def check_file(self, ctx: FileContext,
                   project: Project) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if _is_set_expr(node.iter):
                    yield self.finding(
                        ctx, node.lineno,
                        "for-loop iterates a set directly; wrap in "
                        "sorted() to pin the order")
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp, ast.SetComp)):
                for gen in node.generators:
                    # building another set from a set is order-free
                    if (_is_set_expr(gen.iter)
                            and not isinstance(node, ast.SetComp)):
                        yield self.finding(
                            ctx, node.lineno,
                            "comprehension iterates a set directly; "
                            "wrap in sorted() to pin the order")
            elif isinstance(node, ast.Call):
                fn = node.func
                if (isinstance(fn, ast.Name)
                        and fn.id in ("list", "tuple", "enumerate",
                                      "iter", "next")
                        and node.args and _is_set_expr(node.args[0])):
                    yield self.finding(
                        ctx, node.lineno,
                        f"{fn.id}(set) materializes hash-seed-dependent "
                        f"order; use sorted() instead")


RULES = (UnseededRandomRule(), WallClockRule(), BuiltinHashRule(),
         SetIterationRule())
