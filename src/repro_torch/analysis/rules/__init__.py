"""Rule registry: every repro-lint rule of the port, by family.

Reference rule → the port's:

  DET001–DET004  same ids (DET001 also flags torch's global generator)
  JAX001         TORCH001 host-sync-in-transform (torch.func, not jit)
  JAX002         none: the port donates no buffer (every kernel wrapper
                 returns fresh tensors), so nothing can be read after a
                 donation
  JAX003         TORCH003 kernel-build-in-round-path
  JAX004         TORCH004 undeclared-mesh-axis
  GATE001        GATE002 no-env-gate (the port has no REPRO_* switch, so
                 no gates registry)
  CON001         CON003 kernel-plain-parity (plain versions beside each
                 kernel instead of kernels/ref.py oracles)
  CON002         same id

A rule whose check is unchanged keeps the JAX package's id and slug, so
a pragma means the same thing in both packages; a rule whose meaning
changed has a new id.

Adding a rule = subclass :class:`repro_torch.analysis.core.Rule` in the
matching family module, instantiate it in that module's ``RULES`` tuple,
and add a known-bad fixture under ``tests/torch_analysis_fixtures/``
with its (rule, path, line) in ``EXPECTED`` of
``tests/test_torch_analysis.py`` (a meta-test asserts every registered
rule fires on the corpus).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..core import Rule
from .contracts import RULES as CONTRACT_RULES
from .determinism import RULES as DETERMINISM_RULES
from .torch_safety import RULES as TORCH_SAFETY_RULES

ALL_RULES: Sequence[Rule] = (
    DETERMINISM_RULES + TORCH_SAFETY_RULES + CONTRACT_RULES)

_BY_KEY: Dict[str, Rule] = {}
for _r in ALL_RULES:
    _BY_KEY[_r.id.lower()] = _r
    _BY_KEY[_r.name.lower()] = _r


def select_rules(spec: Optional[Sequence[str]] = None) -> List[Rule]:
    """Resolve ``--rules`` ids/slugs (None = everything)."""
    if not spec:
        return list(ALL_RULES)
    picked: List[Rule] = []
    for key in spec:
        rule = _BY_KEY.get(key.strip().lower())
        if rule is None:
            raise KeyError(
                f"unknown rule {key!r}; available: "
                + ", ".join(sorted({r.id for r in ALL_RULES})))
        if rule not in picked:
            picked.append(rule)
    return picked
