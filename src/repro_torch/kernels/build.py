"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface.  The file name carries a hash of the
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is reused.  Libraries land
in ``src/repro_torch/_build/`` (git-ignored), or in the directory that
``set_build_dir`` (launch/compile_cache.py) names.  Nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch
from torch.distributed.tensor import DTensor

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def set_build_dir(path: Path) -> None:
    """Build and look up the libraries in ``path`` from now on, for the
    whole process (a library already loaded stays loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on its source, the
    headers of csrc/ and the flags."""
    src = b"".join(path.read_bytes() for path in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build every missing library, one nvcc process per source, all
    started together.  nvcc writes a temporary file that is renamed into
    place, so a reader never sees half a library.  Returns nvcc's output
    (ptxas' registers, shared memory and spills) for each source built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for name in names:
        if library_path(name).exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        started.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures, logs = [], {}
    for name, tmp, proc in started:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            Path(tmp).unlink(missing_ok=True)
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def bind(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """``load(name)`` with the C signatures set: each entry point in
    ``signatures`` takes its argument types and returns an int status, and
    ``<name>_error_string`` turns a status into its message."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_status(lib: ctypes.CDLL, name: str, code: int, kernel: str) -> None:
    """Raise if a launch of ``kernel`` from library ``name`` returned a
    CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({code})")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise ``TypeError`` when an input of ``kernel`` is a DTensor: its
    ``data_ptr()`` is no device pointer, so the kernel takes each rank's
    local tensors inside a ``local_map`` region (launch/sharded.py).  The
    plain version raises too, so a missed region fails on the CPU."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{kernel} takes plain tensors, not DTensors: call "
                        f"it on local shards inside a local_map region")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an input of ``kernel`` requires grad.
    The hand-written kernels have no backward (the JAX package's Pallas
    kernels have none either, so ``jax.grad`` cannot differentiate them):
    their outputs would leave autograd with no gradient and no error.  The
    plain version raises too, so a CPU run fails where the card would.
    A DTensor input raises first (``refuse_dtensor``)."""
    refuse_dtensor(kernel, *tensors)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: its hand-written kernel's output "
            f"would carry no gradient, and the JAX package cannot "
            f"differentiate its Pallas kernel either; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C side takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream
