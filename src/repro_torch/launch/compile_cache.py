"""Persistent build cache of the hand-written kernels.

The counterpart of the JAX package's launch/compile_cache.py, which points
JAX's persistent compilation cache at a directory so that a later process
skips XLA's compiles.  The port's only compiled artifacts are the nvcc
libraries of csrc/ (kernels/build.py), already keyed on a hash of their
sources and flags; ``enable_compilation_cache(path)`` makes ``path`` their
build directory, so a later process, or another checkout pointed at the
same directory, loads them without running nvcc.  Wired into
``ExperimentConfig.compilation_cache_dir`` (fl/experiment.py).  Nothing is
built when the cache is enabled: a library is built at its first launch.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..kernels import build


def enable_compilation_cache(path: str) -> None:
    """Make ``path`` (created if missing) the kernels' build directory."""
    path = Path(path).expanduser().resolve()
    path.mkdir(parents=True, exist_ok=True)
    build.set_build_dir(path)


def cache_dir() -> Optional[str]:
    """The active cache directory, or None when not enabled."""
    if build.BUILD_DIR == build.DEFAULT_BUILD_DIR:
        return None
    return str(build.BUILD_DIR)
