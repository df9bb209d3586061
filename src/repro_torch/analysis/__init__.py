"""repro-lint for the PyTorch/CUDA port: determinism & device-safety
static analysis of ``src/repro_torch``.

The port's claims (traces byte-identical to the JAX package's, every
kernel held against its plain version, a vmapped executor step the card
never waits on) rest on invariants that parity tests can only check
after the fact, along the paths their inputs drive.  This package checks
them statically, across every source file:

  determinism   draws from a hidden global RNG (``random``,
                ``np.random`` and torch's default generator: every draw
                takes an explicit ``torch.Generator``), wall-clock/uuid
                reads in simulation paths, builtin ``hash()``, raw set
                iteration feeding order-sensitive accumulation
  torch-safety  host syncs inside a function handed to a ``torch.func``
                transform, libraries built or bound outside their one
                place (``kernels/build.py``, a module's ``_library()``)
                and ``torch.compile`` in per-round code, mesh-axis names
                outside ``sharding/rules.MESH_AXES``, and any
                ``REPRO_*`` environment switch (the port has none)
  contract      every kernel wrapper in ``kernels.KERNELS`` has its
                ``*_plain`` version exported, a ``csrc/*.cu`` source and a
                test naming both; ``TraceRecorder`` record key-sets match
                the schema declared in ``faas/trace.py``

Run it with ``python -m repro_torch.analysis`` (see ``__main__.py``).
Suppress a single line with ``# repro-lint: disable=RULE`` and a reason
beside it; the committed ``baseline.json`` is empty.  The pragma and
baseline formats are the JAX package's; the engine is this package's own
copy.  Nothing here imports torch.
"""
from __future__ import annotations

__all__: list = []
