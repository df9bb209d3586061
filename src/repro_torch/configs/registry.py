"""Architecture registry.

Each assigned architecture lives in ``src/repro_torch/configs/<id>.py`` (file
named exactly after the assignment id, loaded via importlib since ids
contain dashes/dots) and defines a module-level ``CONFIG: ArchConfig``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List

from ..models.config import ArchConfig

_DIR = Path(__file__).parent
_SKIP = {"__init__.py", "registry.py", "shapes.py"}


def _load_file(path: Path) -> ArchConfig:
    spec = importlib.util.spec_from_file_location(
        "repro_torch_config_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONFIG


# the configs the port holds and the JAX package does not (parity tests
# leave them out)
PORT_ONLY = ("nemotron-3-nano-30b-a3b",)


def list_architectures() -> List[str]:
    return sorted(p.stem for p in _DIR.glob("*.py") if p.name not in _SKIP)


def get_config(arch_id: str) -> ArchConfig:
    path = _DIR / f"{arch_id}.py"
    if not path.exists():
        raise KeyError(f"unknown architecture {arch_id!r}; "
                       f"available: {list_architectures()}")
    return _load_file(path)


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in list_architectures()}
